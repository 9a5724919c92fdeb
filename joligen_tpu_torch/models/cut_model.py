"""CUT / FastCUT contrastive unpaired translation
(``joligen_tpu/models/cut_model.py``) along every option of the JAX model: a
generator G of any name the factory builds
(resnet, resnet_attn, segformer, the unet Gs, uvit, hdit, hat, ittr; its
encoder taps are the NCE layers, ``select_nce_layers``), the
``PatchSampleF`` projector F with the PatchNCE, MoNCE or SRC + hDCE loss
(identity NCE, ``MSE_idt``), and one or more discriminators (the
vision-aided one among them) with the fake pool, DiffAugment, ``D_noise``,
one-sided label smoothing and ``D_dropout``; G EMA with ``train_G_ema``;
the semantic-mask branch (``train_semantic_mask``): the segmenter f_s,
trained on the label masks of A (and of B with ``train_mask_f_s_B``), whose
cross-entropy on G's fake (and identity) joins G's loss, and the
out-of-mask identity loss (``train_mask_out_mask``); the gumbel ``mask`` D,
which judges the one-hot label masks of A against the gumbel-softmax of
f_s on G's fakes and trains on the D side only (with it, G's
``G_sem_mask`` target is f_s's own prediction on A); the classifier C
(``train_semantic_cls``, ``define_C``: ``basic`` or a ResNet template),
trained on the class labels of A (and of B with ``train_sem_cls_B``), whose
cross-entropy (or regression loss, ``train_cls_regression``) on G's fake
(and, with ``train_sem_idt``, on the identity against B's labels) joins
G's loss; FastCUT's flips
(``alg_cut_flip_equivariance``), the contrastive D
(``train_use_contrastive_loss_D``), adaptive pseudo augmentation
(``dataaug_APA``), diffusion-noise D augmentation (``dataaug_D_diffusion``),
the supervised pixel and perceptual terms (``alg_cut_supervised_loss``);
and ReCUT (model types ``re_cut`` and ``re_cut_semantic_mask``, over the
``nuplet`` dataset mode): a frame predictor P_B (``define_P``) and G's
``G_recut`` term; the GAN video mode (``D_netDs`` with ``temporal``, over
``temporal_labeled_mask_online`` clips (B, F, H, W, C)): every frame
folds into the batch, G runs per frame, the temporal projected D judges
whole clips (the fake clips in G's term, the real and the detached fake
clips in its own update, no augmentation) every ``D_temporal_every`` G
steps, and ``G_temporal``, ``train_temporal_criterion_lambda`` times the
MSE of consecutive fake frames, joins G's loss.

One step (``optimize_prepared``), in the JAX step's order
(``cut_model.py:685-950``):

1. with ``train_semantic_cls``, C on the real images and their class
   labels, with its own Adam at ``train_sem_lr_cls``; its loss at or below
   ``cls_semantic_threshold`` opens the gate of G's classifier terms (a
   device tensor);
2. with ``train_semantic_mask``, f_s (and ``f_s_B``) on the real images and
   their masks, with its own Adam; its loss at or below
   ``f_s_semantic_threshold`` opens the gate of G's semantic terms (a
   device tensor: nothing waits for the host);
3. ReCUT: P_B on the channel stack of B's frames 0..N-2 against frame N-1,
   10 · L1 (``P_proj_real_B``), with its own Adam at ``alg_re_P_lr``; its
   loss at or below ``alg_re_projection_threshold`` opens the gate of G's
   ReCUT terms (a device tensor; P's calls in G's loss run whatever the
   gate, as in the JAX step);
4. G and F together: with flips, A and B mirrored on a step's Bernoulli
   draw; G's loss (the GAN terms of every D on the augmented fake, or the
   contrastive term of D on the real and the fake; the NCE terms, whose
   queries a flipped step mirrors back; ReCUT's NCE of A's last frame
   against P(the stack of the fakes), P's parameters taking no gradient,
   and with ``alg_re_adversarial_loss_p`` every D's term on that
   prediction; the supervised L1 or MSE and LPIPS/DISTS terms against B;
   the semantic terms through the updated C and f_s, whose parameters take
   no gradient; on clips the temporal D's term and ``G_temporal``) and its
   gradients, then Adam on G (and its EMA) and on F;
5. the fake (before G's update; frames) through the pool;
6. each D on the real images and the pooled fakes (``D_noise``, then the
   diffusion noise, DiffAugment, and APA's pool images in place of reals;
   the mask D on A's one-hot masks and softmax(f_s(fake) + gumbel noise),
   none of those augmentations; the temporal D on the real and fake clips
   as they are, and on a step off its cadence not at all: its loss 0, its
   parameters and Adam state as they were), the GAN or the contrastive
   loss, with its own Adam; then APA's p (every
   step) and the diffusion noise's p (every ``dataaug_D_diffusion_every``
   G steps) adapt from the first D's real logits and real loss.

Images are NHWC at the networks' boundaries, as in the JAX package. The
random draws (DiffAugment, patch ids, the pool, ``D_noise``, dropout) come
from the model's generator on the device where they are used; ``draws``
feeds any of them instead (tests feed the JAX step's draws): keys
``g_aug``, ``g_dropout`` ({D name: masks}), ``nce``, ``nce_idt`` and
``nce_recut`` (id lists), ``flip`` (a bool tensor), ``pool``, ``d_noise``
((real, fake)), ``d_diffusion`` ({"real", "fake"}: (t (B,) ints, 0 for an
image left clean; noise)), ``d_real_aug``, ``d_fake_aug``, ``apa``
({"idx", "u"}), ``d_dropout`` ({D name: (real masks, fake masks)}) and
``gumbel`` ({D name: the uniform draws u in [1e-6, 1 - 1e-6] of the
gumbel noise -log(-log u), NHWC like f_s's logits}).
APA's and the diffusion noise's p are device scalars carried across steps
(``apa_p``, ``d_diff_p``) and logged as ``APA_p`` and ``D_diff_p``.

In phase ``test`` only G (and its EMA) is built and loaded.

``train_sem_use_label_B``, which the glasses configs set, and
``alg_re_no_train_P_fake_images`` are read by nothing in the JAX package;
the port reads them nowhere either. ``f_s_net: sam`` raises
``NotImplementedError`` naming its ROADMAP item; a ``mask`` D without
``train_semantic_mask`` raises ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.diff_aug import apply_diff_augment, draw_diff_augment
from ..ops.schedules import make_beta_schedule
from ..utils.clip_vit import load_clip_ref_encoder
from ..utils.dinov2 import load_dino_into
from .base import BaseModel, dequantize, quantize_batch
from .gan_networks import (define_D, define_F, define_G, define_P,
                           flax_default_init, init_raw_leaves)
from .modules.cut_networks import (contrastive_gan_loss, gan_loss,
                                   monce_loss, patch_nce_loss,
                                   sample_patch_ids, src_hdce_loss)
from .modules.image_pool import ImagePool
from .modules.projected_d import load_efficientnet_trunk
from .modules.segformer import load_mit_backbone
from .modules.semantic_networks import (check_f_s_net, define_C, define_f,
                                        init_segmenter, load_resnet_template,
                                        load_vgg_fcn8s_trunk)
from .train_state import apply_updates, param_grads, scheme_from_opt

# option -> where its port stands; each raises when it is set. Every option
# of the JAX model runs since the semantic networks' slice.
UNPORTED_OPTIONS = {}
# the Ds that take the init scheme (cut_model.py:194-197)
PATCH_DS = ("basic", "n_layers", "pixel", "mask")
# the Ds that take live dropout with D_dropout (cut_model.py:375-381)
DROPOUT_DS = ("basic", "n_layers", "mask")
# D diffusion's timesteps (cut_model.py:827-830)
D_DIFF_T_MIN, D_DIFF_T_MAX = 10, 1000


def check_unported(opt):
    for name, where in UNPORTED_OPTIONS.items():
        v = getattr(opt, name, None)
        if isinstance(v, (list, tuple)):
            v = any(s for s in v)
        if v:
            raise NotImplementedError(f"option {name} is not ported ({where})")
    if getattr(opt, "train_semantic_mask", False):
        check_f_s_net(opt)
    elif any("mask" in n for n in opt.D_netDs):
        raise ValueError("D_netDs 'mask' requires --train_semantic_mask "
                         "(the gumbel mask D judges f_s predictions)")


def init_discriminator(name, netD, generator, opt):
    """A D's init (``cut_model.py:194-217``, ``cycle_gan_model.py:54-80``):
    the PatchGAN Ds (the mask D among them) take the init scheme; the
    others keep flax's default init, then the projected and vision-aided
    Ds' frozen trunks load their weights files where those exist (the
    ResNet-template Ds load nothing). Returns ``netD``."""
    if any(t in name for t in PATCH_DS):
        return scheme_from_opt(netD, generator, opt)
    flax_default_init(netD, generator)
    if "vision_aided" in name:
        load_clip_ref_encoder(netD)
        load_dino_into(netD)
    elif "projected" in name or "temporal" in name:
        if netD.mit:
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


def init_predictor(opt, generator, scheme):
    """A frame predictor P (``define_P``) at flax's init of its raw leaves,
    then the init scheme where ``scheme`` (ReCUT's P_B,
    ``cut_model.py:303-307``); without it (ReCycleGAN's P_A and P_B,
    ``cycle_gan_model.py:111-117``) flax's default init: the unet Ps'
    init of ``diffusion_networks.init_weights`` (their zero-initialised
    layers zero), the resnet Ps' ``flax_default_init``."""
    from .diffusion_networks import init_weights
    net = init_raw_leaves(define_P(opt), generator)
    if scheme:
        return scheme_from_opt(net, generator, opt)
    if "unet" in (getattr(opt, "alg_re_netP", "unet_128") or "unet_128"):
        return init_weights(net, generator)
    return flax_default_init(net, generator)


def channel_stack(seq):
    """(B, N, H, W, C) frames -> (B, H, W, N·C), frame i at channels
    i·C..(i+1)·C - 1 (``jnp.concatenate`` of the frames on the last
    axis)."""
    b, n, h, w, c = seq.shape
    return seq.permute(0, 2, 3, 1, 4).reshape(b, h, w, n * c)


def fold_nuplets(batch, keys):
    """The nuplet batch (B, N, H, W, C) of each of ``keys`` (batch key, out
    key) folded: frames 0..N-2 into the batch, and frame N-1 (``<out>_last``)
    and frames 0..N-2 (``<out>_seq``) kept (``cut_model.py:346-366``,
    ``cycle_gan_model.py:127-138``)."""
    out = {}
    for key, name in keys:
        x = np.asarray(batch[key])
        out[name] = x[:, :-1].reshape((-1,) + x.shape[2:])
        out[f"{name}_last"] = x[:, -1]
        out[f"{name}_seq"] = x[:, :-1]
    return out


def fold_frames(batch, drop_last=True):
    """A batch's images and masks with each 5-D entry folded as the step
    folds it (the JAX models' ``inference``, D accuracy and mIoU go through
    ``set_input``): a nuplet's frames 0..N-2 into the batch
    (``drop_last``), or every frame of a clip (CUT's video mode,
    ``cut_model.py:413-416``)."""
    def fold(v):
        v = np.asarray(v)
        return (v[:, :-1] if drop_last else v).reshape((-1,) + v.shape[2:])
    return {k: fold(v) if np.ndim(v) == 5 else v
            for k, v in batch.items()
            if k in ("A", "B", "A_label_mask", "B_label_mask")}



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
        self.nclasses_fs = int(g("f_s_semantic_nclasses", 2) or 2)
        self.out_mask_loss = g("train_mask_loss_out_mask", "L1") or "L1"
        self.has_mask_d = any("mask" in n for n in opt.D_netDs)
        # the classifier C (cut_model.py:58-88)
        self.semantic_cls = bool(g("train_semantic_cls", False))
        self.cls_lambda = float(g("train_sem_cls_lambda", 1.0))
        self.cls_threshold = float(g("cls_semantic_threshold", 1.0) or 1.0)
        self.sem_cls_B = bool(g("train_sem_cls_B", False))
        self.cls_regression = bool(g("train_cls_regression", False))
        self.cls_l1_regression = bool(g("train_cls_l1_regression", False))
        self.cls_weights = [float(w) for w in (g("cls_class_weights", [])
                                               or [])]
        self.charbonnier_eps = float(g("train_mask_charbonnier_eps", 1e-6)
                                     or 1e-6)
        # FastCUT flips, the contrastive D, the supervised and perceptual
        # terms, APA and D diffusion (cut_model.py:102-141)
        self.flip_equivariance = bool(g("alg_cut_flip_equivariance", False))
        self.contrastive_d = bool(g("train_use_contrastive_loss_D", False))
        self.supervised = [k for k in (g("alg_cut_supervised_loss", [""])
                                       or [""]) if k]
        self.lambda_supervised = float(g("alg_cut_lambda_supervised", 1.0)
                                       or 1.0)
        self.lambda_perceptual = float(g("alg_cut_lambda_perceptual", 1.0)
                                       or 1.0)
        self.apa = bool(g("dataaug_APA", False))
        self.apa_target = float(g("dataaug_APA_target", 0.6))
        self.apa_every = int(g("dataaug_APA_every", 4) or 4)
        self.apa_nimg = float(g("dataaug_APA_nimg", 50) or 50)
        self.d_diffusion = bool(g("dataaug_D_diffusion", False))
        self.d_diffusion_every = int(g("dataaug_D_diffusion_every", 4) or 4)
        # ReCUT (cut_model.py:286-307)
        self.recut = opt.model_type in ("re_cut", "re_cut_semantic_mask")
        self.nuplet = int(g("alg_re_nuplet_size", 3) or 3)
        self.p_threshold = float(g("alg_re_projection_threshold", 1.0) or 1.0)
        self.p_adversarial = bool(g("alg_re_adversarial_loss_p", False))
        # GAN video mode (cut_model.py:117, 367-373, 418-421): a temporal D
        # judges whole clips every D_temporal_every steps; G_temporal
        # holds consecutive fake frames together
        self.temporal_d = any("temporal" in n for n in opt.D_netDs)
        self.d_temporal_every = int(g("D_temporal_every", 4) or 1)
        self.temporal_criterion = bool(g("train_temporal_criterion", False))
        self.lambda_temporal = float(g("train_temporal_criterion_lambda",
                                       1.0) or 1.0)

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
        if self.semantic_cls:
            # C at flax's default init, with its own Adam; a ResNet template
            # takes its ImageNet weights with train_sem_cls_pretrained
            # (cut_model.py:228-240)
            net_c = flax_default_init(define_C(opt), init_gen)
            template = g("train_sem_cls_template", "basic")
            if template and template != "basic" and g(
                    "train_sem_cls_pretrained", False):
                load_resnet_template(net_c, template)
            self.add_net("CLS", net_c, lr=g("train_sem_lr_cls", 2e-4))
        if self.semantic_mask:
            # f_s (and, disjoint, f_s_B) at flax's default init, with its
            # own Adam (cut_model.py:241-279)
            for name in ("f_s", "f_s_B")[:1 + self.disjoint_f_s]:
                net_f = init_segmenter(define_f(opt), init_gen)
                if name == "f_s":
                    # the segformer f_s's MiT weights or the vgg f_s's VGG16
                    # trunk, where they exist (f_s_B keeps its init, as in
                    # cut_model.py:262-279)
                    load_mit_backbone(net_f)
                    if g("f_s_net", "") == "vgg":
                        load_vgg_fcn8s_trunk(net_f)
                self.add_net(name, net_f, lr=g("train_sem_lr_f_s", 2e-4))
        if self.recut:
            self.add_net("P_B", init_predictor(opt, init_gen, scheme=True),
                         lr=float(g("alg_re_P_lr", 2e-4) or 2e-4))
        size = opt.data_crop_size
        self.pool = ImagePool(int(g("train_pool_size", 50)),
                              (size, size, opt.model_output_nc), self.device)
        self.apa_p = torch.tensor(float(g("dataaug_APA_p", 0.0) or 0.0),
                                  device=self.device)
        self.d_diff_p = torch.zeros((), device=self.device)
        if self.d_diffusion:
            # sqrt(alpha_bar) of the linear schedule, 1 at t = 0
            # (cut_model.py:826-830)
            gbar = np.sqrt(np.cumprod(1.0 - make_beta_schedule(
                "linear", D_DIFF_T_MAX, 1e-4, 2e-2)))
            self.d_diff_gbar = torch.tensor(
                np.concatenate([[1.0], gbar]), dtype=torch.float32,
                device=self.device)

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """The images, the label masks and classes (``cut_model.py:
        330-345``): A's when the batch has them, B's masks with
        ``train_mask_f_s_B`` or ``train_sem_idt``, B's classes with
        ``train_sem_cls_B`` or ``train_sem_idt``. ReCUT's nuplets (B, N, H,
        W, C) fold frames 0..N-2 into the batch and keep ``real_A_last``,
        ``real_B_last`` and ``real_B_seq`` (``fold_nuplets``; no classes, as
        in the JAX model); any other clip (B, F, H, W, C) stays whole, its
        masks folded with all F frames (the step folds the clip); a 4-D
        batch (a request) passes as it is."""
        if self.recut and np.ndim(batch["A"]) == 5:
            out = fold_nuplets(batch, (("A", "real_A"), ("B", "real_B")))
            del out["real_A_seq"]
        else:
            out = {"real_A": batch["A"], "real_B": batch["B"]}
            if "A_label_cls" in batch:
                out["cls_A"] = np.asarray(batch["A_label_cls"], np.int32)
            if "B_label_cls" in batch and (self.sem_cls_B or self.sem_idt):
                out["cls_B"] = np.asarray(batch["B_label_cls"], np.int32)
        masks = fold_frames(batch, drop_last=self.recut)
        if "A_label_mask" in masks:
            out["mask_A"] = masks["A_label_mask"]
        if "B_label_mask" in masks and (self.mask_f_s_B or self.sem_idt):
            out["mask_B"] = masks["B_label_mask"]
        return out

    def prepare_batch(self, batch):
        """set_input, uint8 wire compression (the masks as labels; ReCUT's
        last frames and sequences stay float32, as in the JAX step), device
        upload."""
        return self.put_batch(quantize_batch(
            self.set_input(batch), float_keys=("real_A", "real_B"),
            int_keys=("mask_A", "mask_B")))

    def _ce(self, logits, labels, weights):
        """Softmax cross-entropy over the last axis of ``logits`` (fp32) with
        integer ``labels``, mean over pixels (or images); with class
        ``weights`` torch's weighted form sum(w·ce) / sum(w), the label
        clipped for the lookup only (``cut_model.py:383-391``). A label out
        of range has an all-zero one-hot, as ``jax.nn.one_hot`` gives: its
        cross-entropy is 0."""
        n = logits.shape[-1]
        classes = torch.arange(n, device=labels.device)
        onehot = (labels[..., None] == classes).to(logits.dtype)
        ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
        if not weights:
            return ce.mean()
        table = torch.tensor(weights, dtype=ce.dtype, device=ce.device)
        w = table[labels.clamp(0, len(weights) - 1)]
        return (ce * w).sum() / torch.clamp(w.sum(), min=1e-8)

    def _cls_crit(self, pred, label):
        """C's criterion (``cut_model.py:393-401``): ``_ce`` with
        ``cls_class_weights``, or with ``train_cls_regression`` the MSE (L1
        with ``train_cls_l1_regression``) of the first logit against the
        label."""
        if self.cls_regression:
            d = pred.reshape(pred.shape[0], -1)[:, 0] - label.to(pred.dtype)
            return (torch.mean(torch.abs(d)) if self.cls_l1_regression
                    else torch.mean(d * d))
        return self._ce(pred, label, self.cls_weights)

    def _cls_update(self, real_A, real_B, cls_A, cls_B):
        """C's step before f_s's and G's (``cut_model.py:702-717``): its
        criterion on A (and on B with ``train_sem_cls_B``), Adam. Returns
        (loss, gate), device scalars."""
        net = self.nets["CLS"]
        loss = self._cls_crit(net(real_A), cls_A)
        if self.sem_cls_B and cls_B is not None:
            loss = loss + self._cls_crit(net(real_B), cls_B)
        state = self.states["CLS"]
        apply_updates(state, param_grads(loss, state.params))
        loss = loss.detach()
        return loss, (loss <= self.cls_threshold).float()

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
            loss = loss + self._ce(self.nets["f_s"](real_A), mask_A[..., 0],
                                   self.fs_weights)
        if self.mask_f_s_B and mask_B is not None:
            net = self.nets["f_s_B" if self.disjoint_f_s else "f_s"]
            loss = loss + self._ce(net(real_B), mask_B[..., 0],
                                   self.fs_weights)
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
        """Apply D ``name``; PatchGAN Ds (the mask D too) take live dropout
        with ``D_dropout`` (fed masks, or the model's generator)."""
        if self.d_dropout and any(t in name for t in DROPOUT_DS):
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

    def _nce_features(self, feats_k, tgt_img, ids=None, flipped=None):
        """F's queries (with a graph) and keys (without: the losses detach
        them) for one NCE term (``cut_model.py:437-452``): ``feats_k`` are
        the encoder taps of the source image. On a flipped step
        (``flipped``, a bool tensor) the queries are mirrored back, and only
        they (``:447-449``)."""
        netG, netF = self.nets["G_A"], self.nets["F"]
        feats_q = netG(tgt_img, extract_layer_ids=self.nce_layers)
        if flipped is not None:
            feats_q = [torch.where(flipped, f.flip(2), f) for f in feats_q]
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
                fs_gate=None, recut=None, cls=None, video=None):
        """G's losses on NHWC fp32 images; the semantic terms where
        ``mask_A`` (int, NHWC) is given, scaled by ``fs_gate``; ReCUT's
        terms where ``recut`` is given ({"a_last": A's last frames,
        "gate": P's gate}); C's terms where ``cls`` is given ({"A", "B":
        the class labels (B's or None), "gate": C's gate}). The mask D
        trains on the D side only: it has no G term. On a flipped step the
        images come mirrored. On clips, ``video`` ({"clip": (B, F),
        "real_B": B's clips, "temporal_on": whether the temporal D counts
        this step}): the images are the folded frames, the temporal D
        judges the fake clips and ``G_temporal`` joins. Returns (total,
        losses, fake_B)."""
        netG = self.nets["G_A"]
        flipped = draws.get("flip")
        fake_B, feats_A = netG(real_A, with_features=self.nce_layers)
        fake_clip = (None if video is None else fake_B.reshape(
            tuple(video["clip"]) + tuple(fake_B.shape[1:])))
        fake_for_D = self._augment(self._compose_context(fake_B, real_A),
                                   draws.get("g_aug"))
        g_gan = 0.0
        for name in self.d_names:
            if "mask" in name:       # cut_model.py:523-525
                continue
            temporal = "temporal" in name and fake_clip is not None
            if ("temporal" in name and self.d_temporal_every > 1
                    and not (video or {}).get("temporal_on", True)):
                continue             # an off step adds 0 (:546-551)
            pred = self._d(name, fake_clip if temporal else fake_for_D,
                           draws.get("g_dropout", {}).get(name))
            if self.contrastive_d:
                # cut_model.py:532-538: D on the real B, without dropout
                g_gan = g_gan + contrastive_gan_loss(
                    -self.nets[name](video["real_B"] if temporal
                                     else real_B), -pred)
            elif self.gan_mode in ("projected", "wgangp"):
                g_gan = g_gan - torch.mean(pred)
            else:
                # the smoothed real target reaches G too (cut_model.py:541)
                g_gan = g_gan + gan_loss(pred, True, self.gan_mode,
                                         smooth=self.d_label_smooth)
        losses = {"G_GAN": g_gan * self.lambda_gan}
        if fake_clip is not None and (self.temporal_criterion
                                      or self.temporal_d):
            # the MSE of consecutive fake frames (cut_model.py:555-561)
            losses["G_temporal"] = self.lambda_temporal * torch.mean(
                (fake_clip[:, 1:] - fake_clip[:, :-1]) ** 2)
        groups = [self._nce_features(feats_A, fake_B, draws.get("nce"),
                                     flipped)]
        idt_B = None
        if self.nce_idt or self.mse_idt or self.sem_idt:
            idt_B, feats_B = netG(real_B, with_features=self.nce_layers)
        if self.nce_idt:
            groups.append(self._nce_features(feats_B, idt_B,
                                             draws.get("nce_idt"), flipped))
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
        if recut is not None:
            losses.update(self._recut_terms(fake_B, recut, draws, flipped))
        if self.supervised:
            losses["G_supervised"] = self._supervised(fake_B, real_B)
        if cls is not None:
            # through C's updated parameters, which take no gradient
            # (cut_model.py:632-643)
            net = self.nets["CLS"]
            losses["G_sem_cls"] = cls["gate"] * self.cls_lambda * \
                self._cls_crit(net(fake_B), cls["A"])
            if self.sem_idt and idt_B is not None and cls["B"] is not None:
                losses["G_sem_cls_idt"] = cls["gate"] * self.cls_lambda * \
                    self._cls_crit(net(idt_B), cls["B"])
        if self.semantic_mask and mask_A is not None:
            losses.update(self._semantic_terms(real_A, real_B, fake_B, idt_B,
                                               mask_A, mask_B, fs_gate))
        total = sum(losses.values())
        return total, losses, fake_B

    def _recut_terms(self, fake_B, recut, draws, flipped):
        """ReCUT's G terms (``cut_model.py:584-613``): P_B (its parameters
        take no gradient) on the channel stack of each nuplet's fakes
        predicts the next frame, held against A's last frame by the NCE
        loss (keys from A's last frame, mirrored on a flipped step; no
        flip of the queries: that call passes none); with
        ``alg_re_adversarial_loss_p`` each D but the mask and temporal ones
        judges the prediction (-mean for projected and wgangp, else the GAN
        loss without smoothing). Both scaled by P's gate."""
        n1 = self.nuplet - 1
        seq = fake_B.reshape((-1, n1) + tuple(fake_B.shape[1:]))
        # G's update asks for no gradient of P's parameters
        proj_fake = self.nets["P_B"](channel_stack(seq))
        a_last = recut["a_last"]
        if flipped is not None:
            a_last = torch.where(flipped, a_last.flip(2), a_last)
        with torch.no_grad():
            feats_k = self.nets["G_A"](a_last,
                                       extract_layer_ids=self.nce_layers)
        group = self._nce_features(feats_k, proj_fake,
                                   draws.get("nce_recut"))
        gate = recut["gate"]
        terms = {"G_recut": gate * self._nce_terms([group],
                                                   a_last.shape[0])[0][0]}
        if self.p_adversarial:
            adv = 0.0
            for name in self.d_names:
                if "mask" in name or "temporal" in name:
                    continue
                pred = self.nets[name](proj_fake)
                adv = adv + (-torch.mean(pred)
                             if self.gan_mode in ("projected", "wgangp")
                             else gan_loss(pred, True, self.gan_mode))
            terms["G_proj_fake_B_adversarial"] = gate * adv
        return terms

    def _supervised(self, fake_B, real_B):
        """The supervised terms of aligned data (``cut_model.py:615-630``):
        MSE, else L1, times ``alg_cut_lambda_supervised``, plus
        ``alg_cut_lambda_perceptual`` times the LPIPS/DISTS distances
        (``perceptual_terms``, the VGG input normalised by
        ``alg_cut_dists_mean``/``_std``)."""
        sup = 0.0
        if "MSE" in self.supervised:
            sup = self.lambda_supervised * torch.mean((fake_B - real_B) ** 2)
        elif "L1" in self.supervised:
            sup = self.lambda_supervised * torch.mean(
                torch.abs(fake_B - real_B))
        if "LPIPS" in self.supervised or "DISTS" in self.supervised:
            terms = self.perceptual_terms(
                fake_B, real_B, self.supervised,
                mean=getattr(self.opt, "alg_cut_dists_mean", None),
                std=getattr(self.opt, "alg_cut_dists_std", None))
            sup = sup + self.lambda_perceptual * sum(terms.values())
        return sup

    def _semantic_terms(self, real_A, real_B, fake_B, idt_B, mask_A, mask_B,
                        gate):
        """G's semantic-mask terms (``cut_model.py:644-681``) through the
        updated f_s, whose parameters take no gradient: f_s's cross-entropy
        on the fake against A's mask (all 0 with ``train_mask_for_removal``;
        f_s's own prediction on A with ``train_sem_net_output`` or a mask
        D), on the identity with ``train_sem_idt``, and the out-of-mask
        identity loss with ``train_mask_out_mask``."""
        f_s = self.nets["f_s"]
        f_s_B = self.nets["f_s_B" if self.disjoint_f_s else "f_s"]
        label_A = mask_A[..., 0]
        terms = {}

        def predicted(net, img):
            with torch.no_grad():
                return torch.argmax(net(img), dim=-1)

        if self.mask_for_removal:
            label_fake = torch.zeros_like(label_A)
        elif self.sem_net_output or self.has_mask_d:
            label_fake = predicted(f_s, real_A)
        else:
            label_fake = label_A
        terms["G_sem_mask"] = gate * self.mask_lambda * self._ce(
            f_s_B(fake_B), label_fake, self.fs_weights)
        if self.sem_idt and idt_B is not None:
            if self.mask_for_removal:
                label_idt = torch.zeros_like(label_A)
            elif self.sem_net_output or mask_B is None:
                label_idt = predicted(f_s_B, real_B)
            else:
                label_idt = mask_B[..., 0]
            terms["G_sem_mask_idt"] = gate * self.mask_lambda * self._ce(
                f_s_B(idt_B), label_idt, self.fs_weights)
        if self.out_mask:
            m = torch.clamp(mask_A.to(fake_B.dtype), 0, 1)
            terms["G_out_mask"] = self.lambda_out_mask * self._out_mask_crit(
                fake_B * (1 - m), real_A * (1 - m))
        return terms

    def _p_update(self, seq, last):
        """P_B's step before G's (``cut_model.py:749-771``): 10 · L1 of
        P_B(the channel stack of ``seq``) against ``last``, its Adam.
        Returns (loss, gate), device scalars."""
        state = self.states["P_B"]
        loss = 10.0 * torch.mean(torch.abs(
            self.nets["P_B"](channel_stack(seq)) - last))
        apply_updates(state, param_grads(loss, state.params))
        loss = loss.detach()
        return loss, (loss <= self.p_threshold).float()

    def _mask_d_inputs(self, fake, mask_A, u=None):
        """The gumbel mask D's inputs (``cut_model.py:864-876``): A's label
        mask, clipped to the classes, one-hot (real); the softmax of f_s's
        logits on the fake (the updated f_s, no gradient) plus gumbel noise
        -log(-log u), u uniform in [1e-6, 1 - 1e-6] (fake)."""
        with torch.no_grad():
            logits = self.nets["f_s"](fake)
        if u is None:
            u = torch.rand(logits.shape, generator=self.generator,
                           device=logits.device) * (1.0 - 2e-6) + 1e-6
        d_fake = torch.softmax(logits - torch.log(-torch.log(u)), dim=-1)
        n = self.nclasses_fs
        labels = mask_A[..., 0].clamp(0, n - 1)
        d_real = (labels[..., None] == torch.arange(
            n, device=labels.device)).to(fake.dtype)
        return d_real, d_fake

    def _draw_flip(self, draws):
        """FastCUT's flip of this step: a device bool, fed or drawn."""
        if "flip" not in draws:
            draws["flip"] = torch.rand((), generator=self.generator,
                                       device=self.device) < 0.5
        return draws["flip"]

    def _d_diffusion_noise(self, x, fed):
        """q-sample of each image of ``x`` at its own t (``cut_model.py:
        832-846``): t of weight ∝ t up to 10 + p · 990, kept for
        min(64 p, 48) / 64 of the images (0, clean, for the rest); ``fed``
        is (t, noise)."""
        if fed is None:
            b = x.shape[0]
            ar = torch.arange(1, D_DIFF_T_MAX + 1, device=x.device,
                              dtype=torch.float32)
            t_cur = D_DIFF_T_MIN + self.d_diff_p * (D_DIFF_T_MAX
                                                    - D_DIFF_T_MIN)
            weights = torch.where(ar <= t_cur, ar, torch.zeros_like(ar))
            t = torch.multinomial(weights, b, replacement=True,
                                  generator=self.generator) + 1
            frac = torch.clamp(self.d_diff_p * 64.0, max=48.0) / 64.0
            use = torch.rand((b,), generator=self.generator,
                             device=x.device) < frac
            fed = (torch.where(use, t, torch.zeros_like(t)),
                   torch.randn(x.shape, generator=self.generator,
                               device=x.device))
        t, noise = fed
        g = self.d_diff_gbar[t].reshape(-1, 1, 1, 1).to(x.dtype)
        return g * x + torch.sqrt(1.0 - g * g) * noise

    def _apa(self, real_in, fed):
        """APA (``cut_model.py:853-859``): each real image replaced by a
        pool image (``ImagePool.get_random``) with probability p."""
        b = real_in.shape[0]
        if fed is None:
            fed = {"idx": torch.randint(0, max(self.pool.count, 1), (b,),
                                        generator=self.generator,
                                        device=real_in.device),
                   "u": torch.rand((b,), generator=self.generator,
                                   device=real_in.device)}
        use = (fed["u"] < self.apa_p).reshape(-1, 1, 1, 1)
        return torch.where(use, self.pool.get_random(fed["idx"]), real_in)

    def _adapt(self, niter, logits_real, loss_real, batch, losses):
        """APA's p, every step, and the diffusion noise's p, on the
        ``dataaug_D_diffusion_every`` cadence of G's step count, from the
        first D's real logits and real loss (``cut_model.py:924-942``);
        both logged. All on the device."""
        if self.d_diffusion:
            if niter % self.d_diffusion_every == 0:
                step = batch * self.d_diffusion_every / (100.0 * 1000.0)
                self.d_diff_p = torch.clamp(
                    self.d_diff_p + torch.sign(loss_real - 0.9) * step,
                    0.0, 1.0)
            losses["D_diff_p"] = self.d_diff_p
        if self.apa:
            step = batch * self.apa_every / (self.apa_nimg * 1000.0)
            adjust = torch.sign(torch.mean(torch.sign(logits_real))
                                - self.apa_target)
            self.apa_p = torch.clamp(self.apa_p + adjust * step, 0.0, 1.0)
            losses["APA_p"] = self.apa_p

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        draws = dict(draws or {})
        real_A = dequantize(dev["real_A"], "image")
        real_B = dequantize(dev["real_B"], "image")
        mask_A = dequantize(dev.get("mask_A"), "label")
        mask_B = dequantize(dev.get("mask_B"), "label")
        # G's step count before its update: the host decides the cadences
        niter = self.states["G_A"].step
        video = None
        if real_A.ndim == 5:
            # clips (GAN video mode): every frame folds into the batch;
            # the temporal D judges them whole (cut_model.py:413-416)
            video = {"clip": real_A.shape[:2], "real_B": real_B,
                     "temporal_on": niter % self.d_temporal_every == 0}
            real_A, real_B = real_A.flatten(0, 1), real_B.flatten(0, 1)
        heads, fs_gate, recut, cls = {}, None, None, None
        if self.semantic_cls and "cls_A" in dev:
            cls = {"A": dev["cls_A"], "B": dev.get("cls_B")}
            heads["CLS"], cls["gate"] = self._cls_update(
                real_A, real_B, cls["A"], cls["B"])
        if self.semantic_mask and mask_A is not None:
            heads["f_s"] = self._f_s_update(real_A, real_B, mask_A, mask_B)
            fs_gate = (heads["f_s"] <= self.fs_threshold).float()
        if self.recut and "real_B_seq" in dev:
            heads["P_proj_real_B"], gate = self._p_update(
                dev["real_B_seq"], dev["real_B_last"])
            recut = {"a_last": dev["real_A_last"], "gate": gate}
        g_A, g_B = real_A, real_B
        if self.flip_equivariance:
            # FastCUT (cut_model.py:506-513): the step's images mirrored
            flip = self._draw_flip(draws)
            g_A = torch.where(flip, real_A.flip(2), real_A)
            g_B = torch.where(flip, real_B.flip(2), real_B)
        sG, sF = self.states["G_A"], self.states["F"]
        total, losses, fake_B = self._g_loss(g_A, g_B, draws, mask_A,
                                             mask_B, fs_gate, recut, cls,
                                             video)
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
        if self.d_diffusion:
            fed = draws.get("d_diffusion", {})
            real_in = self._d_diffusion_noise(real_in, fed.get("real"))
            fake_in = self._d_diffusion_noise(fake_in, fed.get("fake"))
        real_in = self._augment(real_in, draws.get("d_real_aug"))
        fake_in = self._augment(fake_in, draws.get("d_fake_aug"))
        if self.apa:
            real_in = self._apa(real_in, draws.get("apa"))
        first = None
        for name in self.d_names:
            keep_r, keep_f = draws.get("d_dropout", {}).get(name, (None, None))
            d_real, d_fake = real_in, fake_in
            temporal = "temporal" in name and video is not None
            cadenced = "temporal" in name and self.d_temporal_every > 1
            if cadenced and not (video or {}).get("temporal_on", True):
                # an off step (cut_model.py:904-915): no compute, its
                # parameters and Adam state as they were
                losses[f"D_{name}"] = torch.zeros((), device=self.device)
                continue
            if temporal:
                # the clips as they are: no noise, augmentation or APA
                d_real = video["real_B"]
                d_fake = fake_B.detach().reshape(d_real.shape)
            elif "mask" in name and mask_A is not None:
                d_real, d_fake = self._mask_d_inputs(
                    fake, mask_A, draws.get("gumbel", {}).get(name))
            logits_real = self._d(name, d_real, keep_r)
            logits_fake = self._d(name, d_fake, keep_f)
            if self.contrastive_d:
                loss_real = contrastive_gan_loss(logits_real, logits_fake)
                loss_fake = contrastive_gan_loss(-logits_fake, -logits_real)
            else:
                loss_real = gan_loss(logits_real, True, self.gan_mode,
                                     smooth=self.d_label_smooth)
                loss_fake = gan_loss(logits_fake, False, self.gan_mode)
            loss = 0.5 * (loss_real + loss_fake)
            state = self.states[name]
            apply_updates(state, param_grads(loss, state.params))
            losses[f"D_{name}"] = loss.detach()
            if first is None and not cadenced:
                first = (logits_real.detach(), loss_real.detach())
        if first is not None:
            self._adapt(niter, *first, real_B.shape[0], losses)
        # the semantic heads and P were updated before G (their gates)
        losses.update(heads)
        self.loss_log = losses
        return losses

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    # ------------------------------------------------------------------
    def inference(self, batch, use_ema=None):
        """NHWC float32 fakes in [-1, 1] for ``batch["A"]`` (5-D batches
        folded: a nuplet's frames 0..N-2, a clip's every frame), from G's EMA
        when ``use_ema`` (default: ``train_G_ema``) and it exists."""
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get("G_A") if use_ema else None
        net = net if net is not None else self.nets["G_A"]
        batch = fold_frames(batch, drop_last=self.recut)
        dev = self.put_batch({"real_A": np.asarray(batch["A"], np.float32)})
        with torch.inference_mode():
            return net(dev["real_A"]).cpu().numpy()

    def attention_visuals(self, batch, max_masks=5):
        """resnet_attn's masks mapped to [-1, 1] for display
        (``cut_model.py:953-969``); {} for other generators."""
        from .modules.resnet_generator import ResnetGeneratorAttn
        if not isinstance(self.nets["G_A"], ResnetGeneratorAttn):
            return {}
        batch = fold_frames(batch, drop_last=self.recut)
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
        batch = fold_frames(batch, drop_last=self.recut)

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
        batch = fold_frames(batch, drop_last=self.recut)
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
