"""B2B flow matching (``joligen_tpu/models/b2b_model.py``), model type
``b2b``: on video with the ``vit_vid`` denoiser (``modules/vit_vid.py``),
on images with the image JiT (``modules/jit.py``; any other ``G_netG``, as
in the JAX package). An image model folds the frames of a 5-D batch into
its batch (``set_input``).

One step (``optimize_prepared``):

1. decode the uint8 wire batch on the device (``gt`` and ``y_cond``
   images or clips, the ``mask``), the mask's bbox descriptor
   (``mask_size_condition``) with ``alg_b2b_mask_size_conditioning``;
2. the flow-matching forward (``modules/b2b.py``): logistic-normal t, the
   masked noisy clip, with ``alg_b2b_autoregressive`` one clean ground-truth
   frame at t = 1 in ``use_gt_prob`` of the clips (left out of the loss);
   the denoiser on [y_cond, z] with the clip's frame step;
3. the loss on the velocities (``_loss``: MSE, L1, pseudo-Huber, or the
   3-level multiscale MSE/L1; ``alg_b2b_loss_masked_region_only``), plus
   ``lambda_ref_copy`` times the L1 of the raw x-prediction against the
   ground truth on the clean frame (``G_ref_copy``);
4. the gradients (K1 forward, K2/K3 backward on the card), Adam(W), the
   EMA.

LoRA finetuning (``alg_b2b_lora``, phase train; ``models/lora.py``): the
net ``G_lora`` holds the adapters (rank ``alg_b2b_lora_rank``, α
``alg_b2b_lora_alpha``, ``alg_b2b_lora_target_modules``). A step merges
them into G's weights with ``alg_b2b_lora_dropout`` on A's rows, runs the
forward and the backward with the merged weights, and updates the
adapters alone with their own Adam(W) and no EMA; G's parameters, EMA and
optimizer state stay as they were. ``inference`` samples with the
adapters merged into the weights it uses (EMA or base);
``merge_lora_checkpoint`` folds them into G's base weights. The adapters
are saved as ``{prefix}_net_G_lora.pth``.

``draws`` (tests) feeds the step's random draws (``b2b_training_outputs``;
``lora_keep``, the dropout's keep masks) and ``inference``'s
(``b2b_sample``: ``noise``). ``inference`` runs the Heun sampler with
``denoise_timesteps`` steps (default: the first of
``alg_b2b_denoise_timesteps``) and ``cfg_scale`` on the EMA weights.

``alg_b2b_perceptual_loss`` (LPIPS, DISTS) adds ``G_perceptual``:
``alg_b2b_lambda_perceptual`` times the terms of the masked x-prediction
against the masked ground truth.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import compute_dtype
from .base import BaseModel, dequantize, quantize_batch
from .cm_model import is_conditional, perceptual_options
from .diffusion_networks import define_inner_G, init_weights
from .lora import (DEFAULT_TARGETS, LoRAAdapters, merge_deltas, merge_into,
                   merged_weights)
from .modules.b2b import b2b_sample, b2b_training_outputs, mask_size_condition
from .modules.cm import pseudo_huber_loss
from .modules.jit import JiT
from .train_state import apply_updates, param_grads


class B2BModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        g = lambda name, default: getattr(opt, name, default)  # noqa: E731
        self.task = g("alg_diffusion_task", "inpainting")
        self.lambda_G = float(g("alg_diffusion_lambda_G", 1.0))
        self.use_ema = bool(g("train_G_ema", False))
        self.ema_beta = float(g("train_G_ema_beta", 0.999))
        self.loss_kind = g("alg_b2b_loss", "MSE")
        self.masked_only = bool(g("alg_b2b_loss_masked_region_only", False))
        self.num_classes = max(1, int(g("G_vit_num_classes", 1)))
        self.label_drop_prob = float(g("alg_diffusion_dropout_prob", 0.0)
                                     or 0.0)
        self.mask_as_channel = bool(g("alg_b2b_mask_as_channel", False))
        self.is_video = opt.G_netG == "vit_vid"  # (B, F, H, W, C) clips
        self.num_frames = int(g("data_temporal_number_frames", 1) or 1)
        req_noise = float(g("alg_b2b_noise_scale", -1.0) or -1.0)
        self.noise_scale = req_noise if req_noise > 0 else (
            1.0 if opt.data_crop_size <= 256 else 2.0)
        self.t_eps = float(g("alg_b2b_t_eps", 5e-2))
        self.P_mean = float(g("alg_b2b_P_mean", -0.8))
        self.P_std = float(g("alg_b2b_P_std", 0.8))
        self.uniform_mix = float(g("alg_b2b_timestep_uniform_mix_prob", 0.1))
        steps = g("alg_b2b_denoise_timesteps", [50])
        if isinstance(steps, (int, float)):
            steps = [int(steps)]
        if not steps or any(int(s) <= 0 for s in steps):
            raise ValueError("--alg_b2b_denoise_timesteps must be one or "
                             "more positive integers")
        self.denoise_timesteps = int(steps[0])
        self.cfg_scale = float(g("alg_b2b_cfg_scale", 1.0))
        self.clip_denoised = bool(g("alg_b2b_clip_denoised", False))
        self.mask_size_cond = bool(g("alg_b2b_mask_size_conditioning",
                                     False))
        self.frame_step_cond = bool(g(
            "alg_b2b_temporal_frame_step_conditioning", False))
        self.autoregressive = bool(g("alg_b2b_autoregressive", False))
        self.use_gt_prob = (float(g("alg_b2b_use_gt_prob", 0.1))
                            if self.autoregressive and self.is_video
                            else 0.0)
        self.minsnr = bool(g("alg_b2b_minsnr", False))
        (self.perceptual, self.lambda_perceptual, self._perc_mean,
         self._perc_std) = perceptual_options(opt, "b2b")
        self.degrade_prob = float(g("alg_b2b_ref_frame_degradation_prob",
                                    0.0) or 0.0)
        self.degrade_std = float(g("alg_b2b_ref_frame_degradation_std", 0.0)
                                 or 0.0)
        self.lambda_ref_copy = float(g("alg_b2b_lambda_ref_copy", 0.0)
                                     or 0.0)
        self.conditional = is_conditional(opt, self.task)

        cin = opt.model_output_nc + (1 if self.mask_as_channel else 0)
        if self.conditional:
            cin += opt.model_input_nc
        netG = (define_inner_G(opt, cin) if self.is_video
                else JiT.from_opt(opt, cin, dtype=compute_dtype(opt)))
        init_weights(netG, torch.Generator().manual_seed(self.seed))
        self.add_net("G_A", netG, use_ema=self.use_ema,
                     lr=g("train_G_lr", 2e-4))

        self.use_lora = bool(g("alg_b2b_lora", False)) and self.is_train
        if self.use_lora:
            self.lora_rank = int(g("alg_b2b_lora_rank", 8) or 8)
            self.lora_dropout = float(g("alg_b2b_lora_dropout", 0.05) or 0.0)
            self.lora_alpha = float(g("alg_b2b_lora_alpha", 16) or 16)
            targets = tuple(g("alg_b2b_lora_target_modules", None)
                            or DEFAULT_TARGETS)
            # the base is frozen: no gradient reaches it
            netG.requires_grad_(False)
            adapters = LoRAAdapters(
                netG, self.lora_rank, targets,
                torch.Generator().manual_seed(self.seed + 1))
            self.add_net("G_lora", adapters, lr=g("train_G_lr", 2e-4))

    # ------------------------------------------------------------------
    def set_input(self, batch):
        """Collated numpy batch -> {gt, mask, y_cond, labels, frame_step};
        an image model takes a clip's frames as its batch."""
        gt = batch["B"]
        mask = batch.get("B_label_mask")
        cond = batch["A"] if self.conditional else None
        if gt.ndim == 5 and not self.is_video:
            b, f = gt.shape[:2]
            gt = gt.reshape((b * f,) + gt.shape[2:])
            if mask is not None:
                mask = mask.reshape((b * f,) + mask.shape[2:])
            if cond is not None:
                cond = cond.reshape((b * f,) + cond.shape[2:])
        out = {"gt": gt}
        if self.task == "inpainting" and mask is not None:
            out["mask"] = mask
        if cond is not None:
            out["y_cond"] = cond
        if self.num_classes > 1 and "B_label_cls" in batch:
            out["labels"] = np.asarray(batch["B_label_cls"], np.int32)
        if self.frame_step_cond and "temporal_frame_step" in batch:
            out["frame_step"] = np.asarray(batch["temporal_frame_step"],
                                           np.float32)
        return out

    def prepare_batch(self, batch):
        """set_input, the uint8 wire step of gt, y_cond and the mask, the
        device put."""
        return self.put_batch(quantize_batch(
            self.set_input(batch), float_keys=("gt", "y_cond"),
            int_keys=("mask",)))

    def _apply_fn(self, net, mask, frame_step):
        """apply_fn(z_in, t, labels, mask_size) of ``b2b.py``."""
        mch = (None if not (self.mask_as_channel and mask is not None)
               else torch.clamp(mask.float(), 0.0, 1.0))

        def apply_fn(z_in, t, labels, mask_size):
            if self.mask_as_channel:
                pad = mch if mch is not None else z_in.new_zeros(
                    z_in.shape[:-1] + (1,))
                z_in = torch.cat([z_in, pad], dim=-1)
            if not self.is_video:
                return net(z_in, t, y=labels, mask_size=mask_size)
            return net(z_in, t, y=labels, mask_size=mask_size,
                       temporal_frame_step=(frame_step if self.frame_step_cond
                                            else None))
        return apply_fn

    def _mask_size(self, mask, y):
        if self.mask_size_cond and mask is not None:
            return mask_size_condition(mask, y.shape[-3], y.shape[-2])
        return None

    def _loss(self, v_pred, v_target, mask):
        """The flow loss; frames fold into the batch first."""
        if v_pred.ndim == 5:
            if mask is not None:
                # a per-frame keep indicator (B, F, 1, 1, 1) becomes a full
                # mask, so that the masked mean counts pixels
                mask = torch.clamp(mask.to(v_pred.dtype), 0.0, 1.0).expand(
                    v_pred.shape[:-1] + (mask.shape[-1],))
                mask = mask.flatten(0, 1)
            v_pred, v_target = v_pred.flatten(0, 1), v_target.flatten(0, 1)
        if self.loss_kind.startswith("multiscale"):
            def base(d):
                return d.abs() if "L1" in self.loss_kind else d ** 2

            def pool(x):    # NHWC 2x2 average, floor
                return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1)
            total, e, m = 0.0, v_pred - v_target, mask
            for _ in range(3):
                if m is not None and self.masked_only:
                    mm = torch.clamp(m.to(e.dtype), 0.0, 1.0)
                    total = total + torch.sum(base(e) * mm) / torch.clamp(
                        torch.sum(mm) * e.shape[-1], min=1.0)
                    m = pool(m.to(e.dtype))
                else:
                    total = total + torch.mean(base(e))
                e = pool(e)
            return total / 3.0
        if self.loss_kind == "L1":
            err = (v_pred - v_target).abs()
        elif self.loss_kind == "pseudo_huber":
            err = pseudo_huber_loss(v_pred, v_target)
        else:
            err = (v_pred - v_target) ** 2
        if mask is not None:
            m = torch.clamp(mask.to(err.dtype), 0.0, 1.0)
            if self.masked_only:
                return torch.sum(err * m) / torch.clamp(
                    torch.sum(m) * err.shape[-1], min=1.0)
            err = err * m
        return torch.mean(err)

    def _loss_fn(self, dev, draws=None):
        """(G_tot, {G_perceptual, G_ref_copy}) of one training forward on a
        prepared batch."""
        gt = dequantize(dev["gt"], "image")
        y_cond = dequantize(dev.get("y_cond"), "image")
        mask = dequantize(dev.get("mask"), "label")
        apply_fn = self._apply_fn(self.nets["G_A"], mask,
                                  dev.get("frame_step"))
        v_pred, v_target, loss_mask, raw_x_pred, is_ref = \
            b2b_training_outputs(
                apply_fn, self.generator, gt, y_cond=y_cond,
                mask=None if self.mask_as_channel else mask,
                labels=dev.get("labels"), num_classes=self.num_classes,
                noise_scale=self.noise_scale, P_mean=self.P_mean,
                P_std=self.P_std, uniform_mix_prob=self.uniform_mix,
                t_eps=self.t_eps, label_drop_prob=self.label_drop_prob,
                mask_size=self._mask_size(mask, gt),
                use_gt_prob=self.use_gt_prob, degrade_prob=self.degrade_prob,
                degrade_std=self.degrade_std, minsnr=self.minsnr,
                draws=draws)
        if self.mask_as_channel and mask is not None:
            lm = torch.clamp(mask.to(v_pred.dtype), 0.0, 1.0)
            loss_mask = lm if loss_mask is None else loss_mask * lm
        loss = self.lambda_G * self._loss(v_pred, v_target, loss_mask)
        aux = {}
        if self.perceptual:
            mb = (torch.clamp(mask.to(gt.dtype), 0.0, 1.0)
                  if mask is not None else None)
            pp = raw_x_pred * mb if mb is not None else raw_x_pred
            tt = gt * mb if mb is not None else gt
            terms = self.perceptual_terms(pp, tt, self.perceptual,
                                          self._perc_mean, self._perc_std)
            aux["G_perceptual"] = self.lambda_perceptual * sum(
                terms.values())
            loss = loss + aux["G_perceptual"]
        if self.lambda_ref_copy > 0.0 and is_ref is not None:
            num = torch.sum((raw_x_pred - gt).abs() * is_ref)
            den = torch.clamp(torch.sum(is_ref.expand(gt.shape)), min=1.0)
            aux["G_ref_copy"] = num / den
            loss = loss + self.lambda_ref_copy * aux["G_ref_copy"]
        return loss, aux

    def _merged(self, net, **dropout):
        """G's weights with the adapters merged (``merge_deltas``)."""
        return merge_deltas(net, self.nets["G_lora"], self.lora_alpha,
                            self.lora_rank, **dropout)

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        if self.use_lora:
            state = self.states["G_lora"]
            net = self.nets["G_A"]
            merged = self._merged(
                net, dropout=self.lora_dropout,
                keep=(draws or {}).get("lora_keep"),
                generator=self.generator)
            with merged_weights(net, merged):
                loss, aux = self._loss_fn(dev, draws)
                grads = param_grads(loss, state.params)
            apply_updates(state, grads)
        else:
            state = self.states["G_A"]
            loss, aux = self._loss_fn(dev, draws)
            apply_updates(state, param_grads(loss, state.params),
                          self.ema_beta)
        self.loss_log = {"G_tot": loss.detach(),
                         **{k: v.detach() for k, v in aux.items()}}
        return self.loss_log

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    def merge_lora_checkpoint(self):
        """Fold the trained adapters into G's base weights
        (``b2b_model.py:379-387``); the EMA stays as it is."""
        if not self.use_lora:
            raise ValueError("merge_lora_checkpoint needs alg_b2b_lora in "
                             "phase train")
        merge_into(self.nets["G_A"], self.nets["G_lora"], self.lora_alpha,
                   self.lora_rank)

    # ------------------------------------------------------------------
    def inference(self, batch, use_ema=None, denoise_timesteps=None,
                  cfg_scale=None, draws=None):
        """The Heun sampler on a batch (float32, no wire step, as the JAX
        model puts it), with the adapters merged in when training LoRA;
        (B, [F,] H, W, C) float32 numpy in [-1, 1]."""
        dev = self.put_batch(self.set_input(batch))
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get("G_A") if use_ema else None
        net = net if net is not None else self.nets["G_A"]
        mask = dev.get("mask")
        y = dev["gt"]
        with torch.inference_mode(), merged_weights(
                net, self._merged(net) if self.use_lora else {}):
            out = b2b_sample(
                self._apply_fn(net, mask, dev.get("frame_step")),
                self.generator, y, y_cond=dev.get("y_cond"),
                mask=None if self.mask_as_channel else mask,
                labels=dev.get("labels"), num_classes=self.num_classes,
                denoise_timesteps=denoise_timesteps or self.denoise_timesteps,
                noise_scale=self.noise_scale, t_eps=self.t_eps,
                cfg_scale=self.cfg_scale if cfg_scale is None else cfg_scale,
                clip_denoised=self.clip_denoised,
                mask_size=self._mask_size(mask, y), draws=draws)
        return out.cpu().numpy()
