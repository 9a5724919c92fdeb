"""MAT inpainting (``joligen_tpu/models/mat_model.py``): the MAT generator
and its two-trunk discriminator (``modules/mat.py``), StyleGAN2 training,
on images and, with ``alg_mat_motion``, on clips.

One step (``optimize_prepared``), in the JAX step's order:

1. G: the generator on (real, mask, z) with its noise (``noise_mode_train``)
   and style mixing; the loss softplus(-D(fake)) + softplus(-D_stg1(stg1))
   + ``pcp_ratio`` x the perceptual distance over the fixed seeded VGG16
   trunk (``utils/metrics.py``); L1 logged only; D's parameters take no
   gradient. Adam, then the EMA at the kimg half-life (``_ema_beta``, from
   G's step before the update).
2. ``w_avg`` moves 0.005 toward the batch's mean w.
3. D on the detached fakes and the reals (softplus losses on both trunks),
   plus, when D's step is a multiple of ``alg_mat_d_reg_every`` (a host
   decision), the R1 penalty: the squared gradient of both trunks' summed
   logits at the real image (fed to both), x gamma / 2 x d_reg_every,
   through a double backward. Adam.

Masks: the label mask marks the region to regenerate; MAT's mask is
1 = keep (``set_input`` inverts it).

Random draws come from the model's generator on its device; ``draws``
feeds them instead (tests feed the JAX step's): ``z``, ``noise`` (the
``MATGenerator.noise_shapes`` dict; used unless the mode is ``none``) and
``mix``. The ``const`` noise mode draws from a generator seeded 0 at each
call (the JAX package's key 0 gives other values). ``inference`` runs the
EMA weights with truncation toward ``w_avg`` (which, as in the JAX
package, is not saved with the checkpoint).

``alg_mat_transformer_lr`` > 0 trains the parameters whose path holds
``tran``, ``motion`` or ``attn`` with their own Adam at that rate.

Video MAT (``alg_mat_motion``; ``data_temporal_number_frames`` frames a
clip, 5-D batches): the generator's motion module takes the options'
heads, blocks and longest clip (``or`` defaults 4, 1 and 25, as the JAX
model's; the parsed options give 8, 2 and 8). ``set_input`` keeps every
history frame whole (mask all "keep"), and with
``alg_mat_motion_prob_use_previous_frames`` < 1 each sample it drops (a
host draw from ``np.random``, as in the JAX package) takes copies of its
last frame and mask as history. The generator decodes the last frame
only; D, its losses, R1 and the perceptual term see the last frame alone.
``inference`` returns the clip, the history frames as they came in.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.metrics import _VGGish
from .base import BaseModel
from .modules.mat import MATDiscriminator, MATGenerator, init_mat
from .train_state import apply_updates, make_optimizer, param_grads

TRANSFORMER_KEYS = ("tran", "motion", "attn")


def last_frame(t):
    """The last frame of a (B, F, H, W, C) clip; an image as it is."""
    return t[:, -1] if t.ndim == 5 else t


def r1_penalty(logits_sum, real):
    """R1: the mean over the batch of the squared gradient of
    ``logits_sum`` at ``real`` (built with ``create_graph``, so that the
    penalty has its own gradient)."""
    grad, = torch.autograd.grad(logits_sum, real, create_graph=True)
    return torch.mean(torch.sum(grad ** 2, dim=(1, 2, 3)))


class ParamGroups:
    """Adams over disjoint groups of one net's parameters, as one
    optimizer: ``update(grads)`` takes the gradients of every parameter in
    the net's order and gives each group its own."""

    def __init__(self, groups, index):
        self.groups = groups      # name -> optimizer
        self.index = index        # name -> parameter positions

    def update(self, grads):
        for name, tx in self.groups.items():
            tx.update([grads[i] for i in self.index[name]])

    def state_dict(self):
        return {n: tx.state_dict() for n, tx in self.groups.items()}

    def load_state_dict(self, state):
        for n, tx in self.groups.items():
            tx.load_state_dict(state[n])


class MATModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        g = lambda name, default: getattr(opt, name, default)  # noqa: E731
        # the JAX model's ``or`` defaults: a 0 takes the default
        self.z_dim = int(g("alg_mat_z_dim", 512) or 512)
        self.w_dim = int(g("alg_mat_w_dim", 512) or 512)
        self.pcp_ratio = float(g("alg_mat_pcp_ratio", 0.1) or 0.1)
        self.r1_gamma = float(g("alg_mat_r1_gamma", 10.0) or 10.0)
        self.r1_every = int(g("alg_mat_d_reg_every", 16) or 16)
        self.truncation_psi = float(g("alg_mat_truncation_psi", 1.0) or 1.0)
        self.ema_kimg = float(g("alg_mat_ema_kimg", 10.0) or 10.0)
        self.ema_rampup = float(g("alg_mat_ema_rampup", 0.05) or 0.0)
        self.noise_mode_train = g("alg_mat_noise_mode_train",
                                  "random") or "random"
        self.noise_mode_eval = g("alg_mat_noise_mode_eval", "const") or "const"
        self.mask_class_cond = bool(g("alg_mat_mask_class_conditioning",
                                      False))
        keep = g("alg_mat_motion_prob_use_previous_frames", None)
        self.motion_keep_prob = float(keep) if keep is not None else 1.0
        # G takes (B, F, H, W, C) clips (the JAX model's ``motion``)
        self.is_video = bool(g("alg_mat_motion", False))
        self.num_frames = int(g("data_temporal_number_frames", 1) or 1)
        size = opt.data_crop_size
        cout = opt.model_output_nc
        dtype = self.device_dtype
        init_gen = torch.Generator().manual_seed(self.seed)
        netG = init_mat(MATGenerator(
            size, cout, base=max(16, int(g("G_ngf", 64))), w_dim=self.w_dim,
            z_dim=self.z_dim, mask_class=self.mask_class_cond,
            style_mixing_prob=float(g("alg_mat_style_mixing_prob", 0.0)
                                    or 0.0),
            stage1_dim=int(g("alg_mat_first_stage_dim", 180) or 180),
            frames=self.num_frames if self.is_video else 1,
            motion_heads=int(g("alg_mat_motion_num_attention_heads", 4)
                             or 4),
            motion_blocks=int(g("alg_mat_motion_num_transformer_blocks", 1)
                              or 1),
            motion_max_frames=int(g("alg_mat_motion_max_frames", 25) or 25),
            dtype=dtype), init_gen)
        self.add_net("G_A", netG, use_ema=True, lr=g("train_G_lr", 2e-3))
        self.w_avg = torch.zeros(self.w_dim, device=self.device)
        if not self.is_train:
            return
        tf_lr = float(g("alg_mat_transformer_lr", 0) or 0)
        if tf_lr > 0:
            names = [n.lower() for n, _ in netG.named_parameters()]
            tf = [i for i, n in enumerate(names)
                  if any(k in n for k in TRANSFORMER_KEYS)]
            base = [i for i in range(len(names)) if i not in set(tf)]
            params = self.states["G_A"].params
            self.states["G_A"].tx = ParamGroups(
                {"base": make_optimizer(opt, g("train_G_lr", 2e-3), {
                    names[i]: params[i] for i in base}),
                 "tf": make_optimizer(opt, tf_lr, {
                     names[i]: params[i] for i in tf})},
                {"base": base, "tf": tf})
        netD = init_mat(MATDiscriminator(
            size, cout, base=max(16, int(g("D_ndf", 64))), dtype=dtype),
            init_gen)
        self.add_net("D", netD, lr=g("train_D_lr", 2e-3))
        # the perceptual trunk: fixed, seeded (the JAX model's key 0)
        self.vgg = _VGGish(generator=torch.Generator().manual_seed(0)).to(
            self.device).requires_grad_(False)

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """Host batch -> {real, mask (1 = keep), mask_class}, numpy fp32. A
        clip of more than one frame: the history frames all "keep", or, for
        the samples dropped in training, copies of the last frame and its
        mask (JAX ``mat_model.py:139-171``)."""
        real = np.asarray(batch["B"], np.float32)
        label_mask = batch.get("B_label_mask")
        if label_mask is None:
            label_mask = batch.get("A_label_mask")
        ids = np.asarray(label_mask, np.float32)
        m = np.clip(ids, 0.0, 1.0)
        keep = 1.0 - m
        if real.ndim == 5 and keep.shape[1] > 1:
            real, ids, m, keep = (a.copy() for a in (real, ids, m, keep))
            keep[:, :-1] = 1.0
            if self.phase == "train" and self.motion_keep_prob < 1.0:
                drop = np.random.rand(keep.shape[0]) >= self.motion_keep_prob
                n_hist = real.shape[1] - 1
                for a in (real, ids, m):
                    a[drop, :-1] = np.repeat(a[drop, -1:], n_hist, axis=1)
                keep[drop, :-1] = np.repeat(1.0 - m[drop, -1:], n_hist,
                                            axis=1)
        out = {"real": real, "mask": keep}
        if self.mask_class_cond:
            out["mask_class"] = ids * m
        return out

    def prepare_batch(self, batch):
        return self.put_batch(self.set_input(batch))

    # ------------------------------------------------------------------
    def _pcp(self, a, b):
        """Mean over the VGG stages of the mean squared feature distance;
        ``b`` (the real image) takes no gradient."""
        def feats(x):
            if x.shape[-1] == 1:
                x = x.expand(*x.shape[:-1], 3)
            return self.vgg(x)
        fa = feats(a)
        with torch.no_grad():
            fb = feats(b)
        return sum(torch.mean((x - y) ** 2) for x, y in zip(fa, fb)) \
            / len(fa)

    def _ema_beta(self, step, batch):
        """0.5 ** (batch / half-life): ``ema_kimg`` thousand images, ramped
        to ``ema_rampup`` x the images seen, (step + 1) x batch, where G's
        ``step`` is its count before this update. fp32, as in JAX."""
        f32 = np.float32
        nimg = (f32(step) + f32(1.0)) * f32(batch)
        halflife = f32(self.ema_kimg) * f32(1000.0)
        if self.ema_rampup > 0:
            halflife = min(halflife, nimg * f32(self.ema_rampup))
        return float(f32(0.5) ** (f32(batch) / max(halflife, f32(1e-8))))

    def _noise(self, mode, batch, fed, generator, frames=1):
        """The generator's ``noise`` for ``mode`` and a batch of ``batch``
        clips of ``frames``: none, the fed draws, or draws from
        ``generator`` (``const``: seeded 0)."""
        if mode == "none":
            return None
        if fed is not None:
            return fed
        net = self.nets["G_A"]
        if mode == "const":
            generator = torch.Generator(self.device).manual_seed(0)
        return net.draw_noise(generator, batch, frames)

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        draws = draws or {}
        netG, netD = self.nets["G_A"], self.nets["D"]
        sG, sD = self.states["G_A"], self.states["D"]
        real, mask = dev["real"], dev["mask"]
        mask_class = dev.get("mask_class")
        b = real.shape[0]
        frames = real.shape[1] if real.ndim == 5 else 1
        z = draws.get("z")
        if z is None:
            z = torch.randn((b, self.z_dim), generator=self.generator,
                            device=self.device)
        noise = self._noise(self.noise_mode_train, b, draws.get("noise"),
                            self.generator, frames)
        mix = draws.get("mix")
        if mix is None and netG.style_mixing_prob > 0:
            mix = netG.draw_mix(self.generator, b)

        # ---- G (on a clip, every term of the last frame)
        fake, stg1, w = netG(real, mask, z.to(self.device), noise=noise,
                             mix=mix, mask_class=mask_class,
                             return_stg1=True, return_w=True)
        real, mask, fake, stg1 = (last_frame(t)
                                  for t in (real, mask, fake, stg1))
        lg, lg1 = netD(fake, mask, stg1)
        adv = torch.mean(F.softplus(-lg))
        adv1 = torch.mean(F.softplus(-lg1))
        pcp = self._pcp(fake, real) * self.pcp_ratio
        l1 = torch.mean(torch.abs(fake.detach() - real))
        gtot = adv + adv1 + pcp
        beta = self._ema_beta(sG.step, b)
        apply_updates(sG, param_grads(gtot, sG.params), beta)
        with torch.no_grad():
            self.w_avg = self.w_avg * 0.995 + torch.mean(w, dim=0) * 0.005
        losses = {"G_adv": adv.detach(), "G_adv_stg1": adv1.detach(),
                  "G_pcp": pcp.detach(), "G_l1": l1, "G_tot": gtot.detach()}

        # ---- D (+ lazy R1 on the reals' forward)
        fake_d, stg1_d = fake.detach(), stg1.detach()
        do_r1 = sD.step % self.r1_every == 0
        lf, lf1 = netD(fake_d, mask, stg1_d)
        real_d = real.detach().requires_grad_(do_r1)
        lr_, lr1 = netD(real_d, mask, real_d)
        main = (torch.mean(F.softplus(lf)) + torch.mean(F.softplus(-lr_))
                + torch.mean(F.softplus(lf1)) + torch.mean(F.softplus(-lr1)))
        if do_r1:
            reg = r1_penalty(lr_.sum() + lr1.sum(), real_d) * (
                self.r1_gamma / 2) * self.r1_every
        else:
            reg = torch.zeros((), device=self.device)
        dtot = main + reg
        apply_updates(sD, param_grads(dtot, sD.params))
        losses.update({"D_main": main.detach(), "D_r1": reg.detach(),
                       "D_tot": dtot.detach()})
        self.loss_log = losses
        self.ema_beta = beta
        return losses

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    # ------------------------------------------------------------------
    def inference(self, batch, use_ema=True, truncation_psi=None, seed=None,
                  draws=None, **kwargs):
        """Inpaint a host batch with the EMA weights (``use_ema``), the
        truncation ``truncation_psi`` (default the config's) toward
        ``w_avg``; ``seed`` fixes z and the noise. (B, H, W, C) float32
        numpy, or (B, F, H, W, C) for a clip (the last frame inpainted);
        known pixels are the input's."""
        dev = self.put_batch(self.set_input(batch))
        psi = self.truncation_psi if truncation_psi is None \
            else truncation_psi
        net = self.ema_nets["G_A"] if use_ema else self.nets["G_A"]
        draws = draws or {}
        gen = (torch.Generator(self.device).manual_seed(int(seed))
               if seed is not None else self.generator)
        b = dev["real"].shape[0]
        frames = dev["real"].shape[1] if dev["real"].ndim == 5 else 1
        z = draws.get("z")
        if z is None:
            z = torch.randn((b, self.z_dim), generator=gen,
                            device=self.device)
        noise = self._noise(self.noise_mode_eval, b, draws.get("noise"), gen,
                            frames)
        with torch.inference_mode():
            fake = net(dev["real"], dev["mask"], z.to(self.device),
                       noise=noise, mask_class=dev.get("mask_class"),
                       truncation_psi=psi, w_avg=self.w_avg)
        return fake.cpu().numpy()
