"""Palette DDPM/DDIM inpainting, phase ``test``
(``joligen_tpu/models/palette_model.py:95-192,288-346``).

``inference`` = ``prepare_batch`` (set_input, uint8 wire step, device put)
then ``sample`` (decode on the device, run the DDPM or DDIM chain with the
EMA weights). ``sample``'s first random draw is ``y_t`` from the model's
generator. Training is not ported yet (ROADMAP Queue 1 items 4-6).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.schedules import NoiseSchedule
from .base import BaseModel, dequantize, quantize_batch
from .diffusion_networks import define_G, init_weights
from .modules.palette_diffusion import ddim_sample, ddpm_sample

UNPORTED_COND_CREATION = ("computed_sketch", "sketch", "canny", "depth",
                          "hed", "hough", "sam", "low_res", "previous_frame")


class PaletteModel(BaseModel):
    def __init__(self, opt, phase="test", device=None, cpu=False):
        if phase != "test":
            raise NotImplementedError(
                "palette training (ROADMAP Queue 1 items 4-6)")
        super().__init__(opt, device=device, cpu=cpu)
        self.task = getattr(opt, "alg_diffusion_task", "inpainting")
        self.sampling_method = getattr(opt, "alg_palette_sampling_method",
                                       "ddpm")
        self.use_ema = bool(getattr(opt, "train_G_ema", False))
        self.conditioning = getattr(opt, "alg_diffusion_cond_embed", "") or ""
        self.sched_test = NoiseSchedule.for_phase(opt, "test")
        netG = define_G(opt)
        init_weights(netG, torch.Generator().manual_seed(self.seed))
        self.add_net("G_A", netG, use_ema=self.use_ema)

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """Collated numpy batch -> (y_cond, gt, mask, cls), image path with
        ``y_t`` conditioning (reference palette_model.py:287-556)."""
        gt = batch["B"]
        cond = batch["A"]
        mask = batch.get("B_label_mask")
        cls = batch.get("B_label_cls")
        if self.task != "inpainting":
            mask = None
        if "class" not in self.conditioning:
            cls = None
        creation = getattr(self.opt, "alg_diffusion_cond_image_creation",
                           "y_t") or "y_t"
        if creation in UNPORTED_COND_CREATION:
            raise NotImplementedError(
                f"conditioning image creation {creation!r} "
                "(ROADMAP Queue 1 item 6)")
        out = {"y_cond": cond, "gt": gt}
        if mask is not None:
            out["mask"] = mask
        if cls is not None:
            out["cls"] = cls.astype(np.int32)
        return out

    def prepare_batch(self, batch):
        """set_input, uint8 wire compression, device upload."""
        inp = quantize_batch(self.set_input(batch),
                             float_keys=("y_cond", "gt"), int_keys=("mask",))
        return self.put_batch(inp)

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

        def apply_fn(x, gammas, cls=None, mask=None, zero_gamma=False):
            return net(x, gammas, cls=cls, mask=mask, zero_gamma=zero_gamma)

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
