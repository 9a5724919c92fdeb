"""Shortcut model training and few-step Euler sampling
(``joligen_tpu/models/sc_model.py``): the MSE between the predicted and the
target velocities (``modules/sc.py``), Adam(W) and the EMA; inference at
``denoise_timesteps`` steps (default: the first of
``alg_sc_denoise_timesteps``).

The batch goes to the device in float32, as in the JAX model. ``draws``
feeds the step's draws (``dt_base``, ``t_u``, ``noise``, ``mode_u``). The
conditioning is that of ``cm_model.py``: the example configs' trunks take
[A, x]. ``alg_sc_perceptual_loss`` (LPIPS, DISTS) adds ``G_perceptual``
to the loss: ``alg_sc_lambda_perceptual`` times the terms of the one-step
x-prediction x_t + (1 - t) v_pred against the ground truth.
"""

from __future__ import annotations

import torch

from .. import compute_dtype
from .base import BaseModel
from .cm_model import is_conditional, perceptual_options, trunk_in_channels
from .diffusion_networks import define_inner_G, init_weights
from .modules.sc import SCDenoiser, sc_sample, sc_training_outputs
from .train_state import apply_updates, param_grads


class SCModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        self.task = getattr(opt, "alg_diffusion_task", "inpainting")
        self.lambda_G = float(getattr(opt, "alg_diffusion_lambda_G", 1.0))
        (self.perceptual, self.lambda_perceptual, self._perc_mean,
         self._perc_std) = perceptual_options(opt, "sc")
        self.use_ema = bool(getattr(opt, "train_G_ema", False))
        self.ema_beta = float(getattr(opt, "train_G_ema_beta", 0.999))
        self.denoise_timesteps = [int(x) for x in (getattr(
            opt, "alg_sc_denoise_timesteps", [8]) or [8])]
        self.conditional = is_conditional(opt, self.task)
        inner = define_inner_G(opt, trunk_in_channels(opt, self.conditional))
        netG = SCDenoiser(inner, opt.alg_diffusion_cond_embed_dim,
                          dtype=compute_dtype(opt))
        init_weights(netG, torch.Generator().manual_seed(self.seed))
        self.add_net("G_A", netG, use_ema=self.use_ema,
                     lr=getattr(opt, "train_G_lr", 2e-4))

    def set_input(self, batch):
        out = {"gt": batch["B"]}
        mask = batch.get("B_label_mask")
        if self.task == "inpainting" and mask is not None:
            out["mask"] = mask
        if self.conditional:
            out["y_cond"] = batch["A"]
        return out

    def prepare_batch(self, batch):
        return self.put_batch(self.set_input(batch))

    def _apply_fn(self, net):
        def apply_fn(x, t, dt_base, x_cond):
            return net(x, t, dt_base, x_cond=x_cond)
        return apply_fn

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch; the loss stays on the device."""
        state = self.states["G_A"]
        out = sc_training_outputs(
            self._apply_fn(self.nets["G_A"]), self.generator, dev["gt"],
            y_cond=dev.get("y_cond"), mask=dev.get("mask"), draws=draws,
            return_x=bool(self.perceptual))
        v_pred, v_target = out[:2]
        loss = self.lambda_G * torch.mean((v_pred - v_target) ** 2)
        aux = {}
        if self.perceptual:
            terms = self.perceptual_terms(out[2], dev["gt"], self.perceptual,
                                          self._perc_mean, self._perc_std)
            aux["G_perceptual"] = self.lambda_perceptual * sum(
                terms.values())
            loss = loss + aux["G_perceptual"]
        apply_updates(state, param_grads(loss, state.params), self.ema_beta)
        self.loss_log = {"G_tot": loss.detach(),
                         **{k: v.detach() for k, v in aux.items()}}
        return self.loss_log

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    def inference(self, batch, use_ema=None, denoise_timesteps=None):
        """The Euler sampler at ``denoise_timesteps`` steps; NHWC float32
        in [-1, 1]."""
        dev = self.prepare_batch(batch)
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get("G_A") if use_ema else None
        net = net if net is not None else self.nets["G_A"]
        with torch.inference_mode():
            out = sc_sample(self._apply_fn(net), self.generator, dev["gt"],
                            y_cond=dev.get("y_cond"), mask=dev.get("mask"),
                            denoise_timesteps=(denoise_timesteps
                                               or self.denoise_timesteps[0]))
        return out.cpu().numpy()
