"""CUT / FastCUT contrastive unpaired translation
(``joligen_tpu/models/cut_model.py``) along the options the ``cut`` example
configs reach: a generator G of any name the factory builds (resnet,
resnet_attn, segformer, the unet Gs, uvit, hdit, hat, ittr; its encoder
taps are the NCE layers, ``select_nce_layers``), the ``PatchSampleF``
projector F with
the PatchNCE, MoNCE or SRC + hDCE loss (identity NCE, ``MSE_idt``), and one
or more discriminators (the vision-aided one among them) with the fake
pool, DiffAugment, ``D_noise``, one-sided label smoothing and
``D_dropout``; G EMA with ``train_G_ema``; and the semantic-mask branch
(``train_semantic_mask``): the segmenter f_s, trained on the label masks of
A (and of B with ``train_mask_f_s_B``), whose cross-entropy on G's fake
(and identity) joins G's loss, and the out-of-mask identity loss
(``train_mask_out_mask``).

One step (``optimize_prepared``), in the JAX step's order
(``cut_model.py:685-950``):

1. with ``train_semantic_mask``, f_s (and ``f_s_B``) on the real images and
   their masks, with its own Adam; its loss at or below
   ``f_s_semantic_threshold`` opens the gate of G's semantic terms (a
   device tensor: nothing waits for the host);
2. G and F together: G's loss (the GAN terms of every D on the augmented
   fake, the NCE terms, the semantic terms through the updated f_s, whose
   parameters take no gradient) and its gradients, then Adam on G (and its
   EMA) and on F;
3. the fake (before G's update) through the pool;
4. each D on the augmented real and pooled images, with its own Adam.

Images are NHWC at the networks' boundaries, as in the JAX package. The
random draws (DiffAugment, patch ids, the pool, ``D_noise``, dropout) come
from the model's generator on the device where they are used; ``draws``
feeds any of them instead (tests feed the JAX step's draws): keys
``g_aug``, ``g_dropout`` ({D name: masks}), ``nce`` and ``nce_idt`` (id
lists), ``pool``, ``d_noise`` ((real, fake)), ``d_real_aug``,
``d_fake_aug`` and ``d_dropout`` ({D name: (real masks, fake masks)}).

In phase ``test`` only G (and its EMA) is built and loaded.

``train_sem_use_label_B``, which the glasses configs set, is read by
nothing in the JAX package; the port reads it nowhere either. Options off
this path raise ``NotImplementedError`` naming the option
(``UNPORTED_OPTIONS``), as does an ``f_s_net`` other than ``unet``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.diff_aug import apply_diff_augment, draw_diff_augment
from ..utils.clip_vit import load_clip_ref_encoder
from ..utils.dinov2 import load_dino_into
from .base import BaseModel, dequantize, quantize_batch
from .gan_networks import (define_D, define_F, define_G, flax_default_init,
                           init_raw_leaves)
from .modules.cut_networks import (gan_loss, monce_loss, patch_nce_loss,
                                   sample_patch_ids, src_hdce_loss)
from .modules.image_pool import ImagePool
from .modules.projected_d import load_efficientnet_trunk
from .modules.segformer import load_mit_backbone
from .modules.semantic_networks import check_f_s_net, define_f
from .train_state import apply_updates, param_grads, scheme_from_opt

_LEFT = "ROADMAP Queue 1 item 10, what is left of the GAN families"
# option -> where its port stands; each raises when it is set
UNPORTED_OPTIONS = {
    "train_semantic_cls": _LEFT + " (semantic networks: the classifier)",
    "dataaug_APA": _LEFT + " (adaptive pseudo augmentation)",
    "dataaug_D_diffusion": _LEFT + " (diffusion-noise D augmentation)",
    "train_use_contrastive_loss_D": _LEFT + " (contrastive D loss)",
    "alg_cut_flip_equivariance": _LEFT + " (FastCUT flips)",
    "alg_cut_supervised_loss": _LEFT + " (supervised and perceptual losses)",
}
PATCH_DS = ("basic", "n_layers", "pixel")


def check_unported(opt):
    if opt.model_type in ("re_cut", "re_cut_semantic_mask"):
        raise NotImplementedError(
            f"model type {opt.model_type} (re-CUT) is not ported ({_LEFT})")
    for name, where in UNPORTED_OPTIONS.items():
        v = getattr(opt, name, None)
        if isinstance(v, (list, tuple)):
            v = any(s for s in v)
        if v:
            raise NotImplementedError(f"option {name} is not ported ({where})")
    if getattr(opt, "train_semantic_mask", False):
        check_f_s_net(opt)


def init_discriminator(name, netD, generator, opt):
    """A D's init (``cut_model.py:194-217``, ``cycle_gan_model.py:54-80``):
    the PatchGAN Ds take the init scheme; the projected and vision-aided
    Ds keep flax's default init, then their frozen trunks load their
    weights files where those exist. Returns ``netD``."""
    if any(t in name for t in PATCH_DS):
        return scheme_from_opt(netD, generator, opt)
    flax_default_init(netD, generator)
    if "vision_aided" in name:
        load_clip_ref_encoder(netD)
        load_dino_into(netD)
    elif netD.mit:
        load_mit_backbone(netD, "feature_network")
    else:
        load_efficientnet_trunk(netD.feature_network)
    return netD


def init_generator(opt, generator):
    """``define_G`` at flax's init of its raw leaves, then the init scheme
    (``train_state.py:252-260``)."""
    return scheme_from_opt(init_raw_leaves(define_G(opt), generator),
                           generator, opt)


def select_nce_layers(opt):
    """The NCE taps (``cut_model.py:316-327``): the segformer G's four
    stages, ITTR's blocks, the unet Gs' ``G_nblocks * i - 1`` for each
    level i, else the config's ``alg_cut_nce_layers``."""
    netG = opt.G_netG
    if "segformer" in netG:
        return [0, 1, 2, 3]
    if "ittr" in netG:
        return list(range(opt.G_nblocks))
    if "unet" in netG or "uvit" in netG:
        return [opt.G_nblocks * i - 1
                for i in range(1, len(opt.G_unet_mha_channel_mults) + 1)]
    return [int(i) for i in str(opt.alg_cut_nce_layers).split(",")]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class CUTModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        check_unported(opt)
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        g = lambda name, default: getattr(opt, name, default)  # noqa: E731
        self.gan_mode = g("train_gan_mode", "lsgan")
        self.lambda_gan = float(g("alg_gan_lambda", 1.0))
        self.lambda_nce = float(g("alg_cut_lambda_NCE", 1.0))
        self.lambda_src = float(g("alg_cut_lambda_SRC", 0.0))
        self.nce_idt = bool(g("alg_cut_nce_idt", True))
        self.nce_T = float(g("alg_cut_nce_T", 0.07))
        self.nce_loss = g("alg_cut_nce_loss", "monce")
        self.num_patches = int(g("alg_cut_num_patches", 256))
        self.include_all_neg = bool(g(
            "alg_cut_nce_includes_all_negatives_from_minibatch", False))
        self.use_ema = bool(g("train_G_ema", False))
        self.ema_beta = float(g("train_G_ema_beta", 0.999))
        self.mse_idt = bool(g("alg_cut_MSE_idt", False))
        self.lambda_mse_idt = float(g("alg_cut_lambda_MSE_idt", 1.0) or 1.0)
        self.hdce_gamma = float(g("alg_cut_HDCE_gamma", 50) or 50)
        self.d_label_smooth = 0.1 if g("dataaug_D_label_smooth", False) else 0.0
        self.d_dropout = bool(g("D_dropout", False))
        self.diff_policy = g("dataaug_diff_aug_policy", "") or ""
        self.diff_prob = float(g("dataaug_diff_aug_proba", 0.5))
        self.d_noise = float(g("dataaug_D_noise", 0.0) or 0.0)
        self.context = int(g("data_online_context_pixels", 0) or 0)
        self.nce_layers = select_nce_layers(opt)
        # the semantic-mask branch (cut_model.py:58-92)
        self.semantic_mask = bool(g("train_semantic_mask", False))
        self.mask_lambda = float(g("train_sem_mask_lambda", 1.0))
        self.out_mask = bool(g("train_mask_out_mask", False))
        self.lambda_out_mask = float(g("train_mask_lambda_out_mask", 10.0))
        self.sem_idt = bool(g("train_sem_idt", False))
        self.mask_for_removal = bool(g("train_mask_for_removal", False))
        self.sem_net_output = bool(g("train_sem_net_output", False))
        self.fs_threshold = float(g("f_s_semantic_threshold", 1.0) or 1.0)
        self.no_train_f_s_A = bool(g("train_mask_no_train_f_s_A", False))
        self.disjoint_f_s = bool(g("train_mask_disjoint_f_s", False))
        # disjoint segmenters force B's training (base_model.py:304)
        self.mask_f_s_B = (bool(g("train_mask_f_s_B", False))
                           or self.disjoint_f_s)
        self.fs_weights = [float(w) for w in (g("f_s_class_weights", [])
                                              or [])]
        self.out_mask_loss = g("train_mask_loss_out_mask", "L1") or "L1"
        self.charbonnier_eps = float(g("train_mask_charbonnier_eps", 1e-6)
                                     or 1e-6)

        init_gen = torch.Generator().manual_seed(self.seed)
        netG = init_generator(opt, init_gen)
        # the MiT weights file, where it exists, after the scheme
        # (cut_model.py:162-168)
        load_mit_backbone(netG)
        self.add_net("G_A", netG, use_ema=self.use_ema,
                     lr=g("train_G_lr", 2e-4))
        self.d_names = []
        if not self.is_train:
            return
        netF = define_F(opt, netG.layer_channels(self.nce_layers))
        self.add_net("F", scheme_from_opt(netF, init_gen, opt),
                     lr=g("train_G_lr", 2e-4))
        for name, netD in define_D(opt).items():
            # the frozen towers stay in the optimizer, as in optax's tree:
            # zero gradients, so adam leaves them as they are
            self.add_net(name, init_discriminator(name, netD, init_gen, opt),
                         lr=g("train_D_lr", 2e-4))
            self.d_names.append(name)
        if self.semantic_mask:
            # f_s (and, disjoint, f_s_B) at flax's default init, with its
            # own Adam (cut_model.py:241-279)
            for name in ("f_s", "f_s_B")[:1 + self.disjoint_f_s]:
                net_f = flax_default_init(define_f(opt), init_gen)
                if name == "f_s":
                    # the segformer f_s's MiT weights, where they exist
                    # (f_s_B keeps its init, as in cut_model.py:262-279)
                    load_mit_backbone(net_f)
                self.add_net(name, net_f, lr=g("train_sem_lr_f_s", 2e-4))
        size = opt.data_crop_size
        self.pool = ImagePool(int(g("train_pool_size", 50)),
                              (size, size, opt.model_output_nc), self.device)

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """The images, and the label masks (``cut_model.py:330-345``): A's
        when the batch has them, B's with ``train_mask_f_s_B`` or
        ``train_sem_idt``."""
        out = {"real_A": batch["A"], "real_B": batch["B"]}
        if "A_label_mask" in batch:
            out["mask_A"] = batch["A_label_mask"]
        if "B_label_mask" in batch and (self.mask_f_s_B or self.sem_idt):
            out["mask_B"] = batch["B_label_mask"]
        return out

    def prepare_batch(self, batch):
        """set_input, uint8 wire compression (the masks as labels), device
        upload."""
        return self.put_batch(quantize_batch(
            self.set_input(batch), float_keys=("real_A", "real_B"),
            int_keys=("mask_A", "mask_B")))

    def _ce(self, logits, labels):
        """Softmax cross-entropy over the last axis of ``logits`` (fp32) with
        integer ``labels``, mean over pixels; with ``f_s_class_weights``
        torch's weighted form sum(w·ce) / sum(w) (``cut_model.py:383-391``).
        A label out of range has an all-zero one-hot, as ``jax.nn.one_hot``
        gives: its cross-entropy is 0."""
        n = logits.shape[-1]
        classes = torch.arange(n, device=labels.device)
        onehot = (labels[..., None] == classes).to(logits.dtype)
        ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
        if not self.fs_weights:
            return ce.mean()
        table = torch.tensor(self.fs_weights, dtype=ce.dtype,
                             device=ce.device)
        w = table[labels.clamp(0, len(self.fs_weights) - 1)]
        return (ce * w).sum() / torch.clamp(w.sum(), min=1e-8)

    def _out_mask_crit(self, a, b):
        """L1, MSE or Charbonnier (``cut_model.py:403-412``)."""
        d = a - b
        if self.out_mask_loss == "MSE":
            return torch.mean(d * d)
        if self.out_mask_loss == "Charbonnier":
            return torch.mean(torch.sqrt(d * d + self.charbonnier_eps ** 2))
        return torch.mean(torch.abs(d))

    def _f_s_update(self, real_A, real_B, mask_A, mask_B):
        """f_s's step before G's (``cut_model.py:719-748``): its loss on A
        (unless ``train_mask_no_train_f_s_A``) and on B (with
        ``train_mask_f_s_B`` and B's masks; f_s_B's when disjoint), Adam on
        each segmenter. Returns the loss (a device scalar)."""
        states = [self.states["f_s"]]
        if self.disjoint_f_s:
            states.append(self.states["f_s_B"])
        loss = torch.zeros((), device=real_A.device)
        if not self.no_train_f_s_A:
            loss = loss + self._ce(self.nets["f_s"](real_A), mask_A[..., 0])
        if self.mask_f_s_B and mask_B is not None:
            net = self.nets["f_s_B" if self.disjoint_f_s else "f_s"]
            loss = loss + self._ce(net(real_B), mask_B[..., 0])
        params = [p for st in states for p in st.params]
        grads = (param_grads(loss, params) if loss.requires_grad
                 else [torch.zeros_like(p) for p in params])
        start = 0
        for st in states:
            apply_updates(st, grads[start:start + len(st.params)])
            start += len(st.params)
        return loss.detach()

    def _augment(self, img, draws):
        """DiffAugment of an NHWC batch (``draws`` None: drawn here)."""
        if not self.diff_policy:
            return img
        x = _nchw(img)
        if draws is None:
            draws = draw_diff_augment(self.generator, x.shape,
                                      self.diff_policy, self.diff_prob,
                                      x.device)
        return _nhwc(apply_diff_augment(x, draws, self.diff_policy))

    def _d(self, name, x, dropout=None):
        """Apply D ``name``; PatchGAN Ds take live dropout with
        ``D_dropout`` (fed masks, or the model's generator)."""
        if self.d_dropout and any(t in name for t in ("basic", "n_layers")):
            return self.nets[name](
                x, dropout=self.generator if dropout is None else dropout)
        return self.nets[name](x)

    def _compose_context(self, fake, real_src):
        """With online context pixels G owns only the inner crop; the margin
        comes from the source image (``cut_model.py:461-470``)."""
        c = self.context
        if c <= 0:
            return fake
        out = real_src.clone()
        out[:, c:-c, c:-c, :] = fake[:, c:-c, c:-c, :]
        return out

    def _nce_features(self, feats_k, tgt_img, ids=None):
        """F's queries (with a graph) and keys (without: the losses detach
        them) for one NCE term (``cut_model.py:437-452``): ``feats_k`` are
        the encoder taps of the source image."""
        netG, netF = self.nets["G_A"], self.nets["F"]
        feats_q = netG(tgt_img, extract_layer_ids=self.nce_layers)
        if ids is None:
            ids = sample_patch_ids(self.generator, feats_k, self.num_patches)
        fq = netF(feats_q, ids)
        with torch.no_grad():
            fk = netF([f.detach() for f in feats_k], ids)
        return fq, fk

    def _nce_terms(self, groups, batch):
        """The NCE loss of each (queries, keys) group: the mean over layers
        of each layer's mean loss, and of its SRC term (``cut_model.py:
        424-459``). Where every layer of every group has the same patch
        count and width (256 patches of 256 channels in horse2zebra), the
        groups' layers run as one batch of the loss, so MoNCE's 50 Sinkhorn
        iterations launch once a step rather than once a layer and term.
        Returns (nce, src): tensors of one value a group."""
        pairs = [(q, k) for fq, fk in groups for q, k in zip(fq, fk)]
        n_layers = len(groups[0][0])
        if len({q.shape for q, _ in pairs}) == 1:
            q = torch.cat([q for q, _ in pairs])
            k = torch.cat([k for _, k in pairs])
            per = 1 if self.include_all_neg else batch
            loss, src = self._nce_per_patch(q, k, len(pairs) * per, False)
            loss = loss.reshape(len(groups), n_layers, -1).mean(-1)
            src = (src.reshape(len(groups), n_layers, -1).mean(-1)
                   if torch.is_tensor(src) else torch.zeros_like(loss))
        else:
            rows = [self._nce_per_patch(q, k, batch, self.include_all_neg)
                    for q, k in pairs]
            loss = torch.stack([r[0].mean() for r in rows])
            src = torch.stack([r[1].mean() if torch.is_tensor(r[1])
                               else torch.zeros_like(r[0][0]) for r in rows])
            loss = loss.reshape(len(groups), n_layers)
            src = src.reshape(len(groups), n_layers)
        return loss.mean(1), src.mean(1)

    def _nce_per_patch(self, fq, fk, batch, include_all_neg):
        """The configured loss per patch, and SRC's per patch (or 0)."""
        if self.nce_loss == "patchnce":
            return patch_nce_loss(fq, fk, self.nce_T, batch,
                                  include_all_neg), 0.0
        if self.nce_loss == "monce":
            return monce_loss(fq, fk, self.nce_T, batch, self.num_patches,
                              include_all_neg), 0.0
        return src_hdce_loss(fq, fk, self.nce_T, batch, self.num_patches,
                             include_all_neg, gamma=self.hdce_gamma)

    def _g_loss(self, real_A, real_B, draws, mask_A=None, mask_B=None,
                fs_gate=None):
        """G's losses on NHWC fp32 images; the semantic terms where
        ``mask_A`` (int, NHWC) is given, scaled by ``fs_gate``. Returns
        (total, losses, fake_B)."""
        netG = self.nets["G_A"]
        fake_B, feats_A = netG(real_A, with_features=self.nce_layers)
        fake_for_D = self._augment(self._compose_context(fake_B, real_A),
                                   draws.get("g_aug"))
        g_gan = 0.0
        for name in self.d_names:
            pred = self._d(name, fake_for_D,
                           draws.get("g_dropout", {}).get(name))
            if self.gan_mode in ("projected", "wgangp"):
                g_gan = g_gan - torch.mean(pred)
            else:
                # the smoothed real target reaches G too (cut_model.py:541)
                g_gan = g_gan + gan_loss(pred, True, self.gan_mode,
                                         smooth=self.d_label_smooth)
        losses = {"G_GAN": g_gan * self.lambda_gan}
        groups = [self._nce_features(feats_A, fake_B, draws.get("nce"))]
        idt_B = None
        if self.nce_idt or self.mse_idt or self.sem_idt:
            idt_B, feats_B = netG(real_B, with_features=self.nce_layers)
        if self.nce_idt:
            groups.append(self._nce_features(feats_B, idt_B,
                                             draws.get("nce_idt")))
        nce, src = self._nce_terms(groups, real_A.shape[0])
        losses["G_NCE"] = nce[0] * self.lambda_nce
        if self.lambda_src > 0:
            losses["G_SRC"] = src[0] * self.lambda_src
        if self.nce_idt:
            losses["G_NCE"] = (losses["G_NCE"]
                               + nce[1] * self.lambda_nce) * 0.5
        if self.mse_idt:
            losses["G_MSE_idt"] = self.lambda_mse_idt * torch.mean(
                torch.abs(real_B - idt_B))
        if self.semantic_mask and mask_A is not None:
            losses.update(self._semantic_terms(real_A, real_B, fake_B, idt_B,
                                               mask_A, mask_B, fs_gate))
        total = sum(losses.values())
        return total, losses, fake_B

    def _semantic_terms(self, real_A, real_B, fake_B, idt_B, mask_A, mask_B,
                        gate):
        """G's semantic-mask terms (``cut_model.py:644-681``) through the
        updated f_s, whose parameters take no gradient: f_s's cross-entropy
        on the fake against A's mask (all 0 with ``train_mask_for_removal``;
        f_s's own prediction on A with ``train_sem_net_output``), on the
        identity with ``train_sem_idt``, and the out-of-mask identity loss
        with ``train_mask_out_mask``."""
        f_s = self.nets["f_s"]
        f_s_B = self.nets["f_s_B" if self.disjoint_f_s else "f_s"]
        label_A = mask_A[..., 0]
        terms = {}

        def predicted(net, img):
            with torch.no_grad():
                return torch.argmax(net(img), dim=-1)

        if self.mask_for_removal:
            label_fake = torch.zeros_like(label_A)
        elif self.sem_net_output:
            label_fake = predicted(f_s, real_A)
        else:
            label_fake = label_A
        terms["G_sem_mask"] = gate * self.mask_lambda * self._ce(
            f_s_B(fake_B), label_fake)
        if self.sem_idt and idt_B is not None:
            if self.mask_for_removal:
                label_idt = torch.zeros_like(label_A)
            elif self.sem_net_output or mask_B is None:
                label_idt = predicted(f_s_B, real_B)
            else:
                label_idt = mask_B[..., 0]
            terms["G_sem_mask_idt"] = gate * self.mask_lambda * self._ce(
                f_s_B(idt_B), label_idt)
        if self.out_mask:
            m = torch.clamp(mask_A.to(fake_B.dtype), 0, 1)
            terms["G_out_mask"] = self.lambda_out_mask * self._out_mask_crit(
                fake_B * (1 - m), real_A * (1 - m))
        return terms

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        draws = draws or {}
        real_A = dequantize(dev["real_A"], "image")
        real_B = dequantize(dev["real_B"], "image")
        mask_A = dequantize(dev.get("mask_A"), "label")
        mask_B = dequantize(dev.get("mask_B"), "label")
        heads, fs_gate = {}, None
        if self.semantic_mask and mask_A is not None:
            heads["f_s"] = self._f_s_update(real_A, real_B, mask_A, mask_B)
            fs_gate = (heads["f_s"] <= self.fs_threshold).float()
        sG, sF = self.states["G_A"], self.states["F"]
        total, losses, fake_B = self._g_loss(real_A, real_B, draws, mask_A,
                                             mask_B, fs_gate)
        grads = param_grads(total, sG.params + sF.params)
        apply_updates(sG, grads[:len(sG.params)], self.ema_beta)
        apply_updates(sF, grads[len(sG.params):])
        losses["G_tot"] = total
        losses = {k: v.detach() for k, v in losses.items()}

        fake = self._compose_context(fake_B, real_A).detach()
        pooled = self.pool.query(fake, draws.get("pool") or
                                 self.pool.draw_query(self.generator,
                                                      fake.shape[0]))
        real_in, fake_in = real_B, pooled
        if self.d_noise > 0:
            noise = draws.get("d_noise") or tuple(
                torch.randn(x.shape, generator=self.generator,
                            device=x.device) for x in (real_in, fake_in))
            real_in = real_in + self.d_noise * noise[0]
            fake_in = fake_in + self.d_noise * noise[1]
        real_in = self._augment(real_in, draws.get("d_real_aug"))
        fake_in = self._augment(fake_in, draws.get("d_fake_aug"))
        for name in self.d_names:
            keep_r, keep_f = draws.get("d_dropout", {}).get(name, (None, None))
            logits_real = self._d(name, real_in, keep_r)
            logits_fake = self._d(name, fake_in, keep_f)
            loss = 0.5 * (gan_loss(logits_real, True, self.gan_mode,
                                   smooth=self.d_label_smooth)
                          + gan_loss(logits_fake, False, self.gan_mode))
            state = self.states[name]
            apply_updates(state, param_grads(loss, state.params))
            losses[f"D_{name}"] = loss.detach()
        # the semantic heads were updated before G (their gate)
        losses.update(heads)
        self.loss_log = losses
        return losses

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    # ------------------------------------------------------------------
    def inference(self, batch, use_ema=None):
        """NHWC float32 fakes in [-1, 1] for ``batch["A"]``, from G's EMA
        when ``use_ema`` (default: ``train_G_ema``) and it exists."""
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get("G_A") if use_ema else None
        net = net if net is not None else self.nets["G_A"]
        dev = self.put_batch({"real_A": np.asarray(batch["A"], np.float32)})
        with torch.inference_mode():
            return net(dev["real_A"]).cpu().numpy()

    def attention_visuals(self, batch, max_masks=5):
        """resnet_attn's masks mapped to [-1, 1] for display
        (``cut_model.py:953-969``); {} for other generators."""
        from .modules.resnet_generator import ResnetGeneratorAttn
        if not isinstance(self.nets["G_A"], ResnetGeneratorAttn):
            return {}
        dev = self.put_batch({"real_A": np.asarray(batch["A"], np.float32)})
        with torch.inference_mode():
            _, att = self.nets["G_A"](dev["real_A"], return_attention=True)
        att = att.cpu().numpy()
        return {f"attention_{i}": att[..., i:i + 1] * 2.0 - 1.0
                for i in range(min(att.shape[-1], max_masks))}

    def compute_miou(self, batch):
        """Soft mIoU of f_s on a batch (``cut_model.py:971-1001``): on real A
        against its mask, on real B against B's (when the batch has it,
        through f_s_B when disjoint) and on G's fake against A's mask; {}
        without the semantic branch or A's masks."""
        if not self.semantic_mask or "A_label_mask" not in batch:
            return {}
        f_s = self.nets["f_s"]
        f_s_B = self.nets.get("f_s_B", f_s)

        def iou(logits, target):
            pred = torch.softmax(logits.float(), dim=-1)
            n = pred.shape[-1]
            onehot = (target.clamp(0, n - 1)[..., None] == torch.arange(
                n, device=target.device)).float()
            inter = (pred * onehot).sum()
            union = (pred + onehot).sum() - inter
            return float(inter / torch.clamp(union, min=1e-8))

        dev = self.put_batch({k: np.asarray(batch[s]) for k, s in (
            ("real_A", "A"), ("real_B", "B"), ("mask_A", "A_label_mask"),
            ("mask_B", "B_label_mask")) if s in batch})
        mask_A = dev["mask_A"][..., 0]
        with torch.inference_mode():
            out = {"miou_real_A": iou(f_s(dev["real_A"]), mask_A)}
            if "mask_B" in dev:
                out["miou_real_B"] = iou(f_s_B(dev["real_B"]),
                                         dev["mask_B"][..., 0])
            out["miou_fake_B"] = iou(f_s_B(self.nets["G_A"](dev["real_A"])),
                                     mask_A)
        return out

    def compute_D_accuracy(self, batch):
        """Precision, recall and accuracy of each D on a batch, logits
        above 0.5 counting as real (``cut_model.py:472-492``)."""
        dev = self.put_batch({k: np.asarray(batch[s], np.float32)
                              for k, s in (("real_A", "A"), ("real_B", "B"))})
        out = {}
        with torch.inference_mode():
            fake = self.nets["G_A"](dev["real_A"])
            for name in self.d_names:
                pr = self.nets[name](dev["real_B"]).cpu().numpy().ravel()
                pf = self.nets[name](fake).cpu().numpy().ravel()
                tp, fn = float((pr > 0.5).sum()), float((pr <= 0.5).sum())
                tn, fp = float((pf <= 0.5).sum()), float((pf > 0.5).sum())
                eps = 1e-8
                out[f"{name}_prec_real"] = tp / (tp + fp + eps)
                out[f"{name}_rec_real"] = tp / (tp + fn + eps)
                out[f"{name}_acc"] = (tp + tn) / (tp + tn + fp + fn + eps)
        return out
