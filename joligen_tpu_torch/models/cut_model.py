"""CUT / FastCUT contrastive unpaired translation
(``joligen_tpu/models/cut_model.py``) along the options the ``cut`` example
configs reach: a resnet generator G, the ``PatchSampleF`` projector F with
the PatchNCE, MoNCE or SRC + hDCE loss (identity NCE, ``MSE_idt``), and one
or more discriminators with the fake pool, DiffAugment, ``D_noise``,
one-sided label smoothing and ``D_dropout``; G EMA with ``train_G_ema``.

One step (``optimize_prepared``), in the JAX step's order
(``cut_model.py:685-950``):

1. G and F together: G's loss (the GAN terms of every D on the augmented
   fake, the NCE terms) and its gradients, then Adam on G (and its EMA) and
   on F;
2. the fake (before G's update) through the pool;
3. each D on the augmented real and pooled images, with its own Adam.

Images are NHWC at the networks' boundaries, as in the JAX package. The
random draws (DiffAugment, patch ids, the pool, ``D_noise``, dropout) come
from the model's generator on the device where they are used; ``draws``
feeds any of them instead (tests feed the JAX step's draws): keys
``g_aug``, ``g_dropout`` ({D name: masks}), ``nce`` and ``nce_idt`` (id
lists), ``pool``, ``d_noise`` ((real, fake)), ``d_real_aug``,
``d_fake_aug`` and ``d_dropout`` ({D name: (real masks, fake masks)}).

In phase ``test`` only G (and its EMA) is built and loaded.

Options off this path raise ``NotImplementedError`` naming the option
(``UNPORTED_OPTIONS``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.diff_aug import apply_diff_augment, draw_diff_augment
from .base import BaseModel, dequantize, quantize_batch
from .gan_networks import define_D, define_F, define_G, flax_default_init
from .modules.cut_networks import (gan_loss, monce_loss, patch_nce_loss,
                                   sample_patch_ids, src_hdce_loss)
from .modules.image_pool import ImagePool
from .modules.projected_d import load_efficientnet_trunk
from .train_state import apply_updates, param_grads, scheme_from_opt

_LEFT = "ROADMAP Queue 1 item 10, what is left of the GAN families"
# option -> where its port stands; each raises when it is set
UNPORTED_OPTIONS = {
    "train_semantic_cls": _LEFT + " (semantic networks)",
    "train_semantic_mask": _LEFT + " (semantic networks)",
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


def select_nce_layers(opt):
    """The NCE taps (``cut_model.py:316-327``)."""
    netG = opt.G_netG
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

        init_gen = torch.Generator().manual_seed(self.seed)
        netG = scheme_from_opt(define_G(opt), init_gen, opt)
        self.add_net("G_A", netG, use_ema=self.use_ema,
                     lr=g("train_G_lr", 2e-4))
        self.d_names = []
        if not self.is_train:
            return
        netF = define_F(opt, netG.encoder.layer_channels(self.nce_layers))
        self.add_net("F", scheme_from_opt(netF, init_gen, opt),
                     lr=g("train_G_lr", 2e-4))
        for name, netD in define_D(opt).items():
            if any(t in name for t in PATCH_DS):
                # only the PatchGAN Ds take the init scheme (cut_model.py:
                # 194-197); the projected D keeps flax's default init
                scheme_from_opt(netD, init_gen, opt)
            else:
                flax_default_init(netD, init_gen)
                load_efficientnet_trunk(netD.feature_network)
            self.add_net(name, netD, lr=g("train_D_lr", 2e-4))
            self.d_names.append(name)
        size = opt.data_crop_size
        self.pool = ImagePool(int(g("train_pool_size", 50)),
                              (size, size, opt.model_output_nc), self.device)

    # ------------------------------------------------------------------
    def set_input(self, batch):
        return {"real_A": batch["A"], "real_B": batch["B"]}

    def prepare_batch(self, batch):
        """set_input, uint8 wire compression, device upload."""
        return self.put_batch(quantize_batch(
            self.set_input(batch), float_keys=("real_A", "real_B")))

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

    def _g_loss(self, real_A, real_B, draws):
        """G's losses on NHWC fp32 images. Returns (total, losses, fake_B)."""
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
        if self.nce_idt or self.mse_idt:
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
        total = sum(losses.values())
        return total, losses, fake_B

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        draws = draws or {}
        real_A = dequantize(dev["real_A"], "image")
        real_B = dequantize(dev["real_B"], "image")
        sG, sF = self.states["G_A"], self.states["F"]
        total, losses, fake_B = self._g_loss(real_A, real_B, draws)
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
