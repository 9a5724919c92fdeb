"""Palette DDPM: inpainting, pix2pix and super-resolution training and
DDPM/DDIM sampling (``joligen_tpu/models/palette_model.py:33-366``).

``optimize_parameters`` = ``prepare_batch`` (set_input, uint8 wire step,
device put) then ``optimize_prepared``: decode on the device, q_sample, the
denoiser, the masked loss, its gradients (through K1 forward and K2/K3
backward on the card), AdamW and the EMA. ``inference`` = ``prepare_batch``
then ``sample`` (the DDPM or DDIM chain with the EMA weights); ``sample``'s
first random draw is ``y_t`` from the model's generator.

``set_input`` builds the conditioning image as the JAX package does: ``y_t``
(dataset A), the canny sketch of ``computed_sketch`` / ``canny`` (the port's
numpy ``canny``, drawing its thresholds from ``random`` in the JAX order), or
``low_res`` (INTER_AREA down, INTER_CUBIC up, in numpy; no mask). With
``ref`` conditioning or the ``unet_mha_ref_attn`` G (``use_ref``) the
batch's ``ref_A`` becomes ``ref``, which reaches the denoiser in the loss,
both samplers and the per-class path.

Video (``palette_model.py:52-60,106-112,167-187,203-243``): a ``unet_vid``
G (``is_video``) takes (B, F, H, W, C) clips of ``data_temporal_number_
frames`` frames; an image G folds the frames of a 5-D batch into its batch.
Canny sketches are drawn per frame, each dropped with probability
``alg_diffusion_vid_canny_dropout[0][0]``. ``previous_frame`` conditions
frame k on frame k - 1 of the A stream (frame 0 on itself), blanked to -1
with probability 1 - ``alg_diffusion_cond_prob_use_previous_frame`` per
frame while training (numpy's global generator, as the JAX package draws
it). ``alg_palette_autoregressive`` with the ``y_t`` creation replaces the
first F // 2 conditioning frames of 9 batches in 10 by noisy ground truth
(one of 10 noise levels up to 0.7 a clip, noise inside the mask only). The
loss folds the frames, one min-SNR weight a clip repeated over its frames.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..ops.cv_resize import resize_area, resize_cubic
from ..ops.schedules import NoiseSchedule
from ..utils.mask_generation import random_edge_mask
from .base import BaseModel, dequantize, quantize_batch
from .diffusion_networks import VIDEO_NETGS, define_G, init_weights
from .modules.palette_diffusion import (ddim_sample, ddpm_sample,
                                        masked_elementwise_loss,
                                        palette_training_outputs)
from .train_state import apply_updates, param_grads

EDGE_MODES = ("computed_sketch", "sketch", "canny", "depth", "hed", "hough",
              "sam")
# creations that still raise: the sketch fillers that run frozen nets
UNPORTED_COND_CREATION = {
    m: "ROADMAP Queue 1 item 14, metrics and frozen nets"
    for m in ("sketch", "depth", "hed", "hough", "sam")}
# the autoregressive context: noise levels k / 9 * 0.7 for k in 0..9, the
# share of batches that take it, and its frames (the first F // 2)
AR_LEVELS, AR_SIGMA_MAX, AR_P = 10, 0.7, 0.9


def check_cond_creation(opt, creation):
    """Raise for a conditioning creation, or a computed_sketch list entry,
    that the port does not build."""
    kinds = [creation]
    if creation == "computed_sketch":
        kinds = (getattr(opt, "alg_diffusion_cond_computed_sketch_list",
                         None) or ["canny"])
    for kind in kinds:
        if kind in UNPORTED_COND_CREATION:
            raise NotImplementedError(
                f"conditioning image creation {kind!r} "
                f"({UNPORTED_COND_CREATION[kind]})")


class PaletteModel(BaseModel):
    def __init__(self, opt, phase="test", device=None, cpu=False):
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        self.task = getattr(opt, "alg_diffusion_task", "inpainting")
        self.sampling_method = getattr(opt, "alg_palette_sampling_method",
                                       "ddpm")
        self.loss_kind = getattr(opt, "alg_palette_loss", "MSE")
        self.minsnr = bool(getattr(opt, "alg_palette_minsnr", False))
        self.dropout_prob = float(getattr(opt, "alg_diffusion_dropout_prob",
                                          0.0) or 0.0)
        self.lambda_G = float(getattr(opt, "alg_diffusion_lambda_G", 1.0))
        self.ema_beta = float(getattr(opt, "train_G_ema_beta", 0.999))
        self.use_ema = bool(getattr(opt, "train_G_ema", False))
        self.conditioning = getattr(opt, "alg_diffusion_cond_embed", "") or ""
        self.autoregressive = bool(getattr(opt, "alg_palette_autoregressive",
                                           False))
        self.is_video = opt.G_netG in VIDEO_NETGS
        self.num_frames = int(getattr(opt, "data_temporal_number_frames", 1)
                              or 1)
        # palette_model.py:64-65
        self.use_ref = ("ref" in self.conditioning
                        or opt.G_netG == "unet_mha_ref_attn")
        check_cond_creation(opt, getattr(
            opt, "alg_diffusion_cond_image_creation", "y_t") or "y_t")
        # "the highest class is the unconditioned one" (palette_model.py:
        # 565-584)
        self.null_class = max(getattr(opt, "f_s_semantic_nclasses", 2),
                              getattr(opt, "cls_semantic_nclasses", 2)) - 1
        self.sched_train = NoiseSchedule.for_phase(opt, "train")
        self.sched_test = NoiseSchedule.for_phase(opt, "test")
        netG = define_G(opt)
        init_weights(netG, torch.Generator().manual_seed(self.seed))
        self.add_net("G_A", netG, use_ema=self.use_ema,
                     lr=getattr(opt, "train_G_lr", 2e-4))

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """Collated numpy batch -> (y_cond, gt, mask, cls), image path
        (reference palette_model.py:287-556)."""
        gt = batch["B"]
        cond = batch["A"]
        mask = batch.get("B_label_mask")
        cls = batch.get("B_label_cls")
        if self.task != "inpainting":
            mask = None
        if "class" not in self.conditioning:
            cls = None
        if gt.ndim == 5 and not self.is_video:
            # an image G takes a clip's frames as its batch
            b, f = gt.shape[:2]
            gt = gt.reshape((b * f,) + gt.shape[2:])
            cond = cond.reshape((b * f,) + cond.shape[2:])
            if mask is not None:
                mask = mask.reshape((b * f,) + mask.shape[2:])
            if cls is not None:
                cls = np.repeat(np.asarray(cls), f)
        creation = getattr(self.opt, "alg_diffusion_cond_image_creation",
                           "y_t") or "y_t"
        if creation in EDGE_MODES and mask is not None:
            # the masked region of gt filled with an edge map, one draw of
            # the list and the thresholds per image (palette_model.py:
            # 117-150)
            fns = ((getattr(self.opt,
                            "alg_diffusion_cond_computed_sketch_list", None)
                    or ["canny"]) if creation == "computed_sketch"
                   else [creation])
            rng_canny = getattr(self.opt,
                                "alg_diffusion_cond_sketch_canny_range",
                                [0, 765]) or [0, 765]
            canny_drop = getattr(self.opt, "alg_diffusion_vid_canny_dropout",
                                 [[]]) or [[]]
            drop_lo = (float(canny_drop[0][0])
                       if canny_drop and canny_drop[0] else 0.0)
            sketches = []
            for g_i, m_i in zip(gt.reshape((-1,) + gt.shape[-3:]),
                                mask.reshape((-1,) + mask.shape[-3:])):
                if drop_lo > 0.0 and random.random() < drop_lo:
                    sketches.append(np.zeros_like(g_i))
                    continue
                sketches.append(random_edge_mask(
                    fns, g_i, m_i, opt=self.opt,
                    low_threshold_random=int(min(rng_canny)),
                    high_threshold_random=int(max(rng_canny))))
            cond = np.stack(sketches).reshape(cond.shape)
        elif creation == "low_res":
            # super-resolution: gt down by the scale (INTER_AREA) and back up
            # (INTER_CUBIC), palette_model.py:152-166
            factor = max(2, int(getattr(
                self.opt, "alg_diffusion_super_resolution_scale", 2) or 2))
            lows = [resize_cubic(resize_area(g_i, factor),
                                 (g_i.shape[1], g_i.shape[0]))
                    for g_i in gt.reshape((-1,) + gt.shape[-3:])]
            cond = np.stack(lows).reshape(gt.shape).astype(np.float32)
            mask = None
        elif creation == "previous_frame" and batch["B"].ndim == 5:
            # frame k on frame k - 1 of the A stream, frame 0 on itself
            # (palette_model.py:167-187)
            src = np.asarray(batch["A"])
            prev = np.concatenate([src[:, :1], src[:, :-1]], axis=1)
            p_use = float(getattr(
                self.opt, "alg_diffusion_cond_prob_use_previous_frame", 0.5)
                or 0.0)
            if self.phase == "train" and p_use < 1.0:
                drop = np.random.rand(prev.shape[0], prev.shape[1]) >= p_use
                prev = np.where(drop[:, :, None, None, None],
                                -np.ones_like(prev), prev)
            cond = prev if self.is_video else prev.reshape(cond.shape)
        out = {"y_cond": cond, "gt": gt}
        if mask is not None:
            out["mask"] = mask
        if cls is not None:
            out["cls"] = cls.astype(np.int32)
        if self.use_ref and "ref_A" in batch:
            out["ref"] = batch["ref_A"]
        return out

    def prepare_batch(self, batch):
        """set_input, uint8 wire compression, device upload."""
        inp = quantize_batch(self.set_input(batch),
                             float_keys=("y_cond", "gt", "ref"),
                             int_keys=("mask",))
        return self.put_batch(inp)

    def _autoregressive_context(self, y_cond, gt, mask, draws=None):
        """The conditioning with its first F // 2 frames replaced by noisy
        ground truth in AR_P of the batches (palette_model.py:203-226):
        ``draws`` (tests) gives ``bucket`` (B,) in 0..9, ``eps`` (B, 1, H,
        W, C) and ``use_u`` (a scalar in [0, 1)), else the generator draws
        them in that order."""
        b, f = y_cond.shape[:2]
        k = f // 2
        if k == 0:
            return y_cond
        if draws is None:
            dev = y_cond.device
            draws = {"bucket": torch.randint(0, AR_LEVELS, (b,),
                                             generator=self.generator,
                                             device=dev),
                     "eps": torch.randn((b, 1) + y_cond.shape[2:],
                                        generator=self.generator,
                                        dtype=y_cond.dtype, device=dev),
                     "use_u": torch.rand((), generator=self.generator,
                                         device=dev)}
        sigma = (draws["bucket"].to(torch.float32) / (AR_LEVELS - 1)
                 * AR_SIGMA_MAX).reshape(b, 1, 1, 1, 1)
        m_ctx = ((mask[:, :k] > 0.5).to(y_cond.dtype) if mask is not None
                 else 1.0)
        mixed = torch.cat([gt[:, :k] + sigma * draws["eps"] * m_ctx,
                           y_cond[:, k:]], dim=1)
        # a device-side choice: no host sync
        return torch.where(draws["use_u"] < AR_P, mixed, y_cond)

    def _loss_fn(self, dev, draws=None):
        """lambda_G * masked loss of one training forward on a prepared
        batch; the wire-compressed inputs decode on the device. ``draws``
        (tests) holds the training draws and, with the autoregressive
        context, its own under ``"autoregressive"``."""
        y_cond = dequantize(dev["y_cond"], "image")
        gt = dequantize(dev["gt"], "image")
        mask = dequantize(dev.get("mask"), "label")
        ref = dequantize(dev.get("ref"), "image")
        net = self.nets["G_A"]
        creation = getattr(self.opt, "alg_diffusion_cond_image_creation",
                           "y_t") or "y_t"
        if (self.autoregressive and self.is_video and y_cond.ndim == 5
                and creation == "y_t"):
            y_cond = self._autoregressive_context(
                y_cond, gt, mask, None if draws is None
                else draws["autoregressive"])

        def apply_fn(x, gammas, cls=None, mask=None):
            return net(x, gammas, cls=cls, mask=mask, ref=ref)

        noise, noise_hat, weight = palette_training_outputs(
            apply_fn, self.generator, self.sched_train, gt, y_cond, mask=mask,
            cls=dev.get("cls"), dropout_prob=self.dropout_prob,
            minsnr=self.minsnr, null_class=self.null_class, draws=draws)
        if noise.ndim == 5:
            # the frames fold into the batch for the loss; one min-SNR
            # weight a clip, repeated over its frames
            f = noise.shape[1]
            noise, noise_hat = (t.flatten(0, 1) for t in (noise, noise_hat))
            if mask is not None:
                mask = mask.flatten(0, 1)
            if torch.is_tensor(weight):
                weight = weight[:, 0].repeat_interleave(f, dim=0)
        loss = masked_elementwise_loss(noise, noise_hat, mask=mask,
                                       weight=weight, kind=self.loss_kind)
        return self.lambda_G * loss

    def optimize_prepared(self, dev, draws=None):
        """One training step on a prepared batch: loss, gradients, AdamW and
        the EMA. ``draws`` (tests) replaces the generator's draws. The loss
        stays on the device: the host reads it only when it prints."""
        state = self.states["G_A"]
        loss = self._loss_fn(dev, draws)
        apply_updates(state, param_grads(loss, state.params), self.ema_beta)
        self.loss_log = {"G_tot": loss.detach()}
        return self.loss_log

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    def _sampling_args(self, sampling_method, num_steps, eta):
        # test-time overrides (reference palette_model.py:628-646)
        method = (sampling_method
                  or getattr(self.opt, "alg_palette_sampling_method_test", "")
                  or self.sampling_method)
        steps_test = int(getattr(self.opt, "alg_palette_sampling_steps_test",
                                 0) or 0)
        steps = num_steps or (steps_test if steps_test > 0 else 0) or \
            getattr(self.opt, "alg_palette_ddim_num_steps", 10)
        eta = eta if eta is not None else getattr(self.opt,
                                                  "alg_palette_ddim_eta", 0.5)
        return method, steps, eta

    def sample(self, dev, y_t=None, use_ema=None, sampling_method=None,
               num_steps=None, eta=None, guidance_scale=0.0):
        """Decode a prepared batch on the device and run the sampler.
        Returns (B, H, W, C) fp32 in [-1, 1] on the device."""
        method, steps, eta = self._sampling_args(sampling_method, num_steps,
                                                 eta)
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get("G_A") if use_ema else None
        net = net if net is not None else self.nets["G_A"]
        ref = dequantize(dev.get("ref"), "image")

        def apply_fn(x, gammas, cls=None, mask=None, zero_gamma=False):
            # the reference image reaches CFG's unconditional branch too
            return net(x, gammas, cls=cls, mask=mask, ref=ref,
                       zero_gamma=zero_gamma)

        y_cond = dequantize(dev["y_cond"], "image")
        y_0 = dequantize(dev["gt"], "image")
        mask = dequantize(dev.get("mask"), "label")
        kw = dict(y_t=y_t, y_0=y_0, mask=mask, cls=dev.get("cls"),
                  guidance_scale=guidance_scale,
                  out_channel=self.opt.model_output_nc)
        with torch.inference_mode():
            if method == "ddpm":
                return ddpm_sample(apply_fn, self.generator, self.sched_test,
                                   y_cond, **kw)
            return ddim_sample(apply_fn, self.generator, self.sched_test,
                               y_cond, num_steps=steps, eta=eta, **kw)

    def inference(self, batch, use_ema=None, sampling_method=None,
                  num_steps=None, eta=None, guidance_scale=0.0,
                  output_uint8=False):
        """Sample fakes for a batch. Returns NHWC float32 in [-1,1], or
        uint8 when ``output_uint8`` (encoded on the device)."""
        out = self.sample(self.prepare_batch(batch), use_ema=use_ema,
                          sampling_method=sampling_method,
                          num_steps=num_steps, eta=eta,
                          guidance_scale=guidance_scale)
        if output_uint8:
            out = torch.round((out + 1.0) * 127.5).clamp(0, 255).to(
                torch.uint8)
        return out.cpu().numpy()

    def inference_per_class(self, batch, nb_classes=None, **kwargs):
        """One sampled output per semantic class: the class and mask labels
        are set to each class id in turn (reference palette_model.py:650-690,
        alg_diffusion_generate_per_class). Returns {class_id: (B,H,W,C)}."""
        nb_classes = nb_classes or self.null_class
        outs = {}
        for i in range(1, nb_classes + 1):
            b2 = dict(batch)
            if "class" in self.conditioning and "B_label_cls" in batch:
                b2["B_label_cls"] = np.full_like(
                    np.asarray(batch["B_label_cls"]), i)
            if "mask" in self.conditioning and "B_label_mask" in batch:
                m = np.clip(np.asarray(batch["B_label_mask"]), 0, 1) * i
                b2["B_label_mask"] = m.astype(np.int32)
            outs[i] = self.inference(b2, **kwargs)
        return outs
