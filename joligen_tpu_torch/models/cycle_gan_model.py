"""CycleGAN (``joligen_tpu/models/cycle_gan_model.py``): G_A maps A to B,
G_B maps B to A, and each domain has its own set of discriminators
(``D_netDs``, named ``<D>_A`` for the Ds that judge domain A's images and
``<D>_B`` for domain B's), each with its own Adam.

One step (``optimize_prepared``), in the JAX step's order
(``cycle_gan_model.py:208-290``):

1. both Gs together: fake_B = G_A(A), fake_A = G_B(B); rec_A = G_B(fake_B
   + noise), rec_B = G_A(fake_A + noise) (``alg_cyclegan_rec_noise``
   times a normal draw, none at 0); the GAN terms of every D on its
   domain's fake (``gan_loss`` of the train mode with one-sided label
   smoothing; no DiffAugment on G's side), the cycle L1s scaled by
   ``lambda_A`` and ``lambda_B``, and with ``lambda_identity`` > 0 the
   identity L1s (G_A(B) against B scaled by lambda_B · lambda_idt, G_B(A)
   against A by lambda_A · lambda_idt); ``G_tot`` their sum; Adam on each G
   and its EMA (``train_G_ema``);
2. fake_A through pool A and fake_B through pool B (the fakes of before
   the update);
3. each D on its domain's real image (plus ``D_noise`` times a normal
   draw) and pooled fake, each DiffAugmented, 0.5 · (real term with label
   smoothing + fake term); PatchGAN Ds take live dropout with
   ``D_dropout``.

The Ds reuse G's fakes, so a step runs each G three times forward (fake,
rec, idt) and once backward through them.

ReCycleGAN (``re_cycle_gan``, over the ``nuplet`` dataset mode: frames
0..N-2 of each nuplet fold into the batch, ``set_input``) adds the frame
predictors P_A and P_B (``define_P``, flax's default init, each with its
own Adam at ``alg_re_P_lr``), updated first (``cycle_gan_model.py:
229-259``): P_A on the channel stack of A's frames 0..N-2 against frame
N-1, lambda_A · L1 (``P_proj_real_A``), and P_B on B's, lambda_B · L1
(``P_proj_real_B``); their mean at or below
``alg_re_projection_threshold`` opens a gate (a device tensor). G's loss
gains ``G_recycle_A`` = gate · lambda_A · L1(G_B(P_B(stack of fake_B)), A's
last frame) and its mirror ``G_recycle_B`` (P's parameters take no
gradient), and with ``alg_re_adversarial_loss_p`` ``G_proj_adversarial``,
gate times each D's GAN term (no smoothing, no dropout) on its domain's
prediction (``:188-215``).

Images are NHWC at the networks' boundaries, as in the JAX package. The
random draws come from the model's generator on the device where they are
used; ``draws`` feeds any of them instead (tests feed the JAX step's
draws): ``rec_noise`` ((noise on fake_B, noise on fake_A)), ``g_dropout``
({D state name: masks}), ``pool_A``, ``pool_B``, and per D state name
``d_noise``, ``d_real_aug``, ``d_fake_aug``, ``d_dropout`` ((real masks,
fake masks)).

In phase ``test`` only G_A and G_B (and their EMAs) are built and loaded.
``re_cycle_gan_semantic_mask`` raises as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.diff_aug import apply_diff_augment, draw_diff_augment
from .base import BaseModel, dequantize, quantize_batch
from .cut_model import (channel_stack, fold_frames, fold_nuplets,
                        init_discriminator, init_generator, init_predictor)
from .gan_networks import define_D
from .modules.cut_networks import gan_loss
from .modules.image_pool import ImagePool
from .train_state import apply_updates, param_grads


def check_model_type(opt):
    if opt.model_type == "re_cycle_gan_semantic_mask":
        raise NotImplementedError(
            "re_cycle_gan_semantic_mask: the CycleGAN path has no semantic "
            "heads, in the JAX package either; use re_cut_semantic_mask or "
            "re_cycle_gan")


class CycleGANModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        check_model_type(opt)
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        g = lambda name, default: getattr(opt, name, default)  # noqa: E731
        self.gan_mode = g("train_gan_mode", "lsgan")
        self.lambda_A = float(g("alg_cyclegan_lambda_A", 10.0))
        self.lambda_B = float(g("alg_cyclegan_lambda_B", 10.0))
        self.lambda_idt = float(g("alg_cyclegan_lambda_identity", 0.5))
        self.rec_noise = float(g("alg_cyclegan_rec_noise", 0.0))
        self.use_ema = bool(g("train_G_ema", False))
        self.ema_beta = float(g("train_G_ema_beta", 0.999))
        self.diff_policy = g("dataaug_diff_aug_policy", "") or ""
        self.diff_prob = float(g("dataaug_diff_aug_proba", 0.5))
        self.d_noise = float(g("dataaug_D_noise", 0.0) or 0.0)
        self.d_label_smooth = 0.1 if g("dataaug_D_label_smooth", False) else 0.0
        self.d_dropout = bool(g("D_dropout", False))
        self.recycle = opt.model_type == "re_cycle_gan"
        self.nuplet = int(g("alg_re_nuplet_size", 3) or 3)
        self.p_threshold = float(g("alg_re_projection_threshold", 1.0) or 1.0)
        self.p_adversarial = bool(g("alg_re_adversarial_loss_p", False))

        init_gen = torch.Generator().manual_seed(self.seed)
        for name in ("G_A", "G_B"):
            self.add_net(name, init_generator(opt, init_gen),
                         use_ema=self.use_ema, lr=g("train_G_lr", 2e-4))
        # (state name, domain, D name), domain A's Ds first
        self.d_names = []
        if not self.is_train:
            return
        for dom in ("A", "B"):
            for name, netD in define_D(opt).items():
                sname = f"{name}_{dom}"
                self.add_net(sname, init_discriminator(name, netD, init_gen,
                                                       opt),
                             lr=g("train_D_lr", 2e-4))
                self.d_names.append((sname, dom, name))
        if self.recycle:
            for name in ("P_A", "P_B"):
                self.add_net(name, init_predictor(opt, init_gen, scheme=False),
                             lr=float(g("alg_re_P_lr", 2e-4) or 2e-4))
        size = opt.data_crop_size
        shape = (size, size, opt.model_output_nc)
        pool_size = int(g("train_pool_size", 50))
        self.pool_A = ImagePool(pool_size, shape, self.device)
        self.pool_B = ImagePool(pool_size, shape, self.device)

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """The images; ReCycleGAN's nuplets (B, N, H, W, C) fold frames
        0..N-2 into the batch and keep each domain's last frames and
        sequences (``fold_nuplets``)."""
        if self.recycle and np.ndim(batch["A"]) == 5:
            return fold_nuplets(batch, (("A", "real_A"), ("B", "real_B")))
        return {"real_A": batch["A"], "real_B": batch["B"]}

    def prepare_batch(self, batch):
        """set_input, uint8 wire compression (the last frames and sequences
        stay float32, as in the JAX step), device upload."""
        return self.put_batch(quantize_batch(
            self.set_input(batch), float_keys=("real_A", "real_B")))

    def _augment(self, img, draws):
        """DiffAugment of an NHWC batch (``draws`` None: drawn here)."""
        if not self.diff_policy:
            return img
        x = img.permute(0, 3, 1, 2)
        if draws is None:
            draws = draw_diff_augment(self.generator, x.shape,
                                      self.diff_policy, self.diff_prob,
                                      x.device)
        return apply_diff_augment(x, draws, self.diff_policy).permute(
            0, 2, 3, 1)

    def _d(self, sname, name, x, dropout=None):
        """Apply D ``sname``; PatchGAN Ds take live dropout with
        ``D_dropout`` (fed masks, or the model's generator)."""
        if self.d_dropout and any(t in name for t in ("basic", "n_layers")):
            return self.nets[sname](
                x, dropout=self.generator if dropout is None else dropout)
        return self.nets[sname](x)

    def _noise(self, x, fed):
        return fed if fed is not None else torch.randn(
            x.shape, generator=self.generator, device=x.device)

    def _g_loss(self, real_A, real_B, draws, recycle=None):
        """Both Gs' losses on NHWC fp32 images; ReCycleGAN's terms where
        ``recycle`` is given ({"A_last", "B_last", "gate"}). Returns (total,
        losses, fake_A, fake_B)."""
        gA, gB = self.nets["G_A"], self.nets["G_B"]
        fake_B, fake_A = gA(real_A), gB(real_B)
        rec_in_B, rec_in_A = fake_B, fake_A
        if self.rec_noise > 0:
            noise_B, noise_A = draws.get("rec_noise", (None, None))
            rec_in_B = fake_B + self.rec_noise * self._noise(fake_B, noise_B)
            rec_in_A = fake_A + self.rec_noise * self._noise(fake_A, noise_A)
        rec_A, rec_B = gB(rec_in_B), gA(rec_in_A)
        g_gan = 0.0
        for sname, dom, name in self.d_names:
            pred = self._d(sname, name, fake_B if dom == "B" else fake_A,
                           draws.get("g_dropout", {}).get(sname))
            g_gan = g_gan + gan_loss(pred, True, self.gan_mode,
                                     smooth=self.d_label_smooth)
        losses = {"G_GAN": g_gan,
                  "G_cycle_A": self.lambda_A * torch.mean(
                      torch.abs(rec_A - real_A)),
                  "G_cycle_B": self.lambda_B * torch.mean(
                      torch.abs(rec_B - real_B))}
        if self.lambda_idt > 0:
            idt_A, idt_B = gA(real_B), gB(real_A)
            losses["G_idt_A"] = self.lambda_B * self.lambda_idt * torch.mean(
                torch.abs(idt_A - real_B))
            losses["G_idt_B"] = self.lambda_A * self.lambda_idt * torch.mean(
                torch.abs(idt_B - real_A))
        if recycle is not None:
            losses.update(self._recycle_terms(fake_A, fake_B, recycle))
        return sum(losses.values()), losses, fake_A, fake_B

    def _recycle_terms(self, fake_A, fake_B, recycle):
        """ReCycleGAN's G terms (see the module doc); G's update asks for no
        gradient of P's parameters."""
        n1 = self.nuplet - 1

        def stack(x):
            return channel_stack(x.reshape((-1, n1) + tuple(x.shape[1:])))
        proj_B = self.nets["P_B"](stack(fake_B))
        proj_A = self.nets["P_A"](stack(fake_A))
        rec_A = self.nets["G_B"](proj_B)
        rec_B = self.nets["G_A"](proj_A)
        gate = recycle["gate"]
        terms = {"G_recycle_A": gate * self.lambda_A * torch.mean(
                     torch.abs(rec_A - recycle["A_last"])),
                 "G_recycle_B": gate * self.lambda_B * torch.mean(
                     torch.abs(rec_B - recycle["B_last"]))}
        if self.p_adversarial:
            adv = 0.0
            for sname, dom, _ in self.d_names:
                adv = adv + gan_loss(
                    self.nets[sname](proj_B if dom == "B" else proj_A), True,
                    self.gan_mode)
            terms["G_proj_adversarial"] = gate * adv
        return terms

    def _p_update(self, dev):
        """P_A and P_B on the real sequences, each from the parameters of
        before either update (``cycle_gan_model.py:229-259``). Returns
        (losses, gate)."""
        out = {}
        for dom, lam in (("A", self.lambda_A), ("B", self.lambda_B)):
            state = self.states[f"P_{dom}"]
            loss = lam * torch.mean(torch.abs(
                self.nets[f"P_{dom}"](channel_stack(dev[f"real_{dom}_seq"]))
                - dev[f"real_{dom}_last"]))
            apply_updates(state, param_grads(loss, state.params))
            out[f"P_proj_real_{dom}"] = loss.detach()
        gate = ((out["P_proj_real_A"] + out["P_proj_real_B"]) / 2.0
                <= self.p_threshold).float()
        return out, gate

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        draws = draws or {}
        real_A = dequantize(dev["real_A"], "image")
        real_B = dequantize(dev["real_B"], "image")
        losses_p, recycle = {}, None
        if self.recycle and "real_A_seq" in dev:
            losses_p, gate = self._p_update(dev)
            recycle = {"A_last": dev["real_A_last"],
                       "B_last": dev["real_B_last"], "gate": gate}
        sA, sB = self.states["G_A"], self.states["G_B"]
        total, losses, fake_A, fake_B = self._g_loss(real_A, real_B, draws,
                                                     recycle)
        grads = param_grads(total, sA.params + sB.params)
        apply_updates(sA, grads[:len(sA.params)], self.ema_beta)
        apply_updates(sB, grads[len(sA.params):], self.ema_beta)
        losses["G_tot"] = total
        losses = {k: v.detach() for k, v in losses.items()}
        losses.update(losses_p)

        pooled = {}
        for dom, pool, fake in (("A", self.pool_A, fake_A),
                                ("B", self.pool_B, fake_B)):
            fake = fake.detach()
            pooled[dom] = pool.query(fake, draws.get(f"pool_{dom}") or
                                     pool.draw_query(self.generator,
                                                     fake.shape[0]))
        for sname, dom, name in self.d_names:
            real = real_B if dom == "B" else real_A
            if self.d_noise > 0:
                real = real + self.d_noise * self._noise(
                    real, draws.get("d_noise", {}).get(sname))
            real = self._augment(real, draws.get("d_real_aug", {}).get(sname))
            fake = self._augment(pooled[dom],
                                 draws.get("d_fake_aug", {}).get(sname))
            keep_r, keep_f = draws.get("d_dropout", {}).get(sname,
                                                            (None, None))
            loss = 0.5 * (gan_loss(self._d(sname, name, real, keep_r), True,
                                   self.gan_mode, smooth=self.d_label_smooth)
                          + gan_loss(self._d(sname, name, fake, keep_f),
                                     False, self.gan_mode))
            state = self.states[sname]
            apply_updates(state, param_grads(loss, state.params))
            losses[f"D_{sname}"] = loss.detach()
        self.loss_log = losses
        return losses

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    # ------------------------------------------------------------------
    def inference(self, batch, use_ema=None, direction="AtoB"):
        """NHWC float32 fakes in [-1, 1]: G_A on ``batch["A"]`` (AtoB) or
        G_B on ``batch["B"]`` (nuplets folded), from the G's EMA when
        ``use_ema`` (default: ``train_G_ema``) and it exists."""
        name, key = ("G_A", "A") if direction == "AtoB" else ("G_B", "B")
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get(name) if use_ema else None
        net = net if net is not None else self.nets[name]
        batch = fold_frames(batch)
        dev = self.put_batch({"x": np.asarray(batch[key], np.float32)})
        with torch.inference_mode():
            return net(dev["x"]).cpu().numpy()

