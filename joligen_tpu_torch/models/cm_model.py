"""Consistency model training (iCT), ECT finetuning and the CM-GAN hybrid
(``joligen_tpu/models/cm_model.py``), for model types ``cm`` and ``cm_gan``.

One step (``optimize_prepared``):

1. the consistency forward (``modules/cm.py``): the student at the next
   sigma with a graph, the teacher at the current one without (iCT; the
   number of sigmas is ``improved_timesteps_schedule`` of the samples seen,
   ``step_count``), or ECT's t and r;
2. the masked pseudo-Huber loss with the improved loss weights, plus for
   ``cm_gan`` the G_GAN term of every D on the student's output (the Ds as
   they were before this step);
3. G's gradients with respect to G's parameters only, Adam(W) and the EMA;
4. ``cm_gan``: the student's output (detached) through the pool, then each
   D on the real and pooled images, loss 0.5 * (real + fake), its own Adam.

The batch goes to the device in float32, as the JAX model puts it (no uint8
wire step). ``draws`` feeds the step's random draws (tests feed the JAX
keys'): ``timesteps`` and ``noise`` (iCT), ``t_normal`` and ``noise`` (ECT),
``pool``. Images are NHWC.

The conditioning: ``self.conditional`` compares the option
``alg_diffusion_cond_image_creation`` with ``"y_t"`` as the JAX model does,
so an unset option (None) makes the model conditional on ``A``: the example
configs' trunks take 6 input channels.

``alg_cm_perceptual_loss`` (LPIPS, DISTS) adds ``G_perceptual``,
``alg_cm_lambda_perceptual`` times the terms' sum, of the masked output
against the masked ground truth (``BaseModel.perceptual_terms``; the
ImageNet normalisation of a weights file overridden by ``alg_cm_dists_mean``
/ ``_std``). On clips, ``alg_diffusion_cond_image_creation previous_frame``
conditions each frame on the ground truth's previous one
(``previous_frame_condition``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compute_dtype
from .base import BaseModel
from .diffusion_networks import define_inner_G, init_weights
from .gan_networks import define_D, flax_default_init
from .modules.cm import (CMDenoiser, cm_sample, cm_training_outputs,
                         ect_training_outputs, pseudo_huber_loss)
from .modules.cut_networks import gan_loss
from .modules.image_pool import ImagePool
from .train_state import apply_updates, param_grads

SAMPLING_SIGMAS = (80.0, 24.4, 5.84, 0.9, 0.661)


def perceptual_options(opt, algo):
    """(kinds, lambda, mean, std) of ``alg_<algo>_perceptual_loss``,
    ``_lambda_perceptual``, ``_dists_mean`` and ``_dists_std``, read as
    the JAX models read them."""
    kinds = [x for x in (getattr(opt, f"alg_{algo}_perceptual_loss", [""])
                         or [""]) if x]
    lam = float(getattr(opt, f"alg_{algo}_lambda_perceptual", 1.0) or 1.0)
    return (kinds, lam, getattr(opt, f"alg_{algo}_dists_mean", None),
            getattr(opt, f"alg_{algo}_dists_std", None))


def is_conditional(opt, task):
    """The JAX models' test: the option against ``"y_t"``, without the
    default that ``set_input`` applies, so None counts as conditional."""
    return (getattr(opt, "alg_diffusion_cond_image_creation", "y_t") != "y_t"
            or task == "pix2pix")


def trunk_in_channels(opt, conditional):
    """The denoiser's input: x, or [x_cond, x]."""
    return opt.model_output_nc + (opt.model_input_nc if conditional else 0)


def previous_frame_condition(gt, shape, p_use, train):
    """cm's ``previous_frame`` condition of clips (``cm_model.py:102-117``):
    frame k's condition is ground-truth frame k - 1, frame 0's itself; in
    training each (clip, frame) is blanked to -1 with probability 1 -
    ``p_use``, drawn from numpy's global generator as in the JAX model.
    Reshaped to ``shape`` (A's)."""
    gt = np.asarray(gt)
    prev = np.concatenate([gt[:, :1], gt[:, :-1]], axis=1)
    if train and p_use < 1.0:
        drop = np.random.rand(prev.shape[0], prev.shape[1]) >= p_use
        prev = np.where(drop[:, :, None, None, None], -np.ones_like(prev),
                        prev)
    return prev.reshape(shape)


class CMModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        g = lambda name, default: getattr(opt, name, default)  # noqa: E731
        self.task = g("alg_diffusion_task", "inpainting")
        self.is_ect = (g("alg_ddpm_ft_mode", "cm") == "ect"
                       and g("alg_diffusion_ddpm_cm_ft", False))
        self.lambda_G = float(g("alg_diffusion_lambda_G", 1.0))
        (self.perceptual, self.lambda_perceptual, self._perc_mean,
         self._perc_std) = perceptual_options(opt, "cm")
        self.use_ema = bool(g("train_G_ema", False))
        self.ema_beta = float(g("train_G_ema_beta", 0.999))
        self.total_steps = int(g("alg_cm_num_steps", 1000000))
        self.with_gan = opt.model_type == "cm_gan"
        self.gan_mode = g("train_gan_mode", "lsgan")
        self.conditional = is_conditional(opt, self.task)

        inner = define_inner_G(opt, trunk_in_channels(opt, self.conditional))
        netG = CMDenoiser(inner, opt.alg_diffusion_cond_embed_dim,
                          ft_proj=g("alg_diffusion_ddpm_cm_ft", False),
                          dtype=compute_dtype(opt))
        init_gen = torch.Generator().manual_seed(self.seed)
        init_weights(netG, init_gen)
        self.add_net("G_A", netG, use_ema=self.use_ema,
                     lr=g("train_G_lr", 2e-4))
        self.d_names = []
        if self.with_gan and self.is_train:
            # flax's default init for every D (the projected D's trunk
            # included: the JAX model loads no trunk weights)
            for name, netD in define_D(opt).items():
                self.add_net(name, flax_default_init(netD, init_gen),
                             lr=g("train_D_lr", 2e-4))
                self.d_names.append(name)
            size = opt.data_crop_size
            self.pool = ImagePool(int(g("train_pool_size", 50)),
                                  (size, size, opt.model_output_nc),
                                  self.device)
        self.step_count = 0          # samples seen: the iCT stage
        self.ect_stage = 0

    # ------------------------------------------------------------------
    def set_input(self, batch):
        out = {"gt": batch["B"]}
        mask = batch.get("B_label_mask")
        if self.task == "inpainting" and mask is not None:
            out["mask"] = mask
        if self.conditional:
            creation = getattr(self.opt, "alg_diffusion_cond_image_creation",
                               "y_t") or "y_t"
            cond = batch["A"]
            if creation == "previous_frame" and np.asarray(
                    batch["B"]).ndim == 5:
                cond = previous_frame_condition(
                    batch["B"], np.shape(batch["A"]),
                    float(getattr(self.opt,
                                  "alg_diffusion_cond_prob_use_previous_frame",
                                  0.5) or 0.0), self.phase == "train")
            out["y_cond"] = cond
        return out

    def prepare_batch(self, batch):
        return self.put_batch(self.set_input(batch))

    def _apply_fn(self, net):
        def apply_fn(x, sigma, x_cond, train):
            return net(x, sigma, x_cond=x_cond, train=train)
        return apply_fn

    def _g_losses(self, gt, y_cond, mask, draws):
        """G's losses (``G_tot`` the consistency term) and the student's
        output."""
        apply_fn = self._apply_fn(self.nets["G_A"])
        if self.is_ect:
            pred, target, _, _ = ect_training_outputs(
                apply_fn, self.generator, self.ect_stage, gt, y_cond=y_cond,
                mask=mask, draws=draws)
            w = 1.0
        else:
            pred, target, w = cm_training_outputs(
                apply_fn, self.generator, self.step_count, self.total_steps,
                gt, y_cond=y_cond, mask=mask, draws=draws)
        if mask is not None:
            m = torch.clamp(mask.to(pred.dtype), 0.0, 1.0)
            pred_m, target_m = pred * m, target * m
        else:
            pred_m, target_m = pred, target
        losses = {"G_tot": torch.mean(pseudo_huber_loss(pred_m, target_m)
                                      * w) * self.lambda_G}
        if self.perceptual:
            gt_m = gt * m if mask is not None else gt
            terms = self.perceptual_terms(pred_m, gt_m, self.perceptual,
                                          self._perc_mean, self._perc_std)
            losses["G_perceptual"] = self.lambda_perceptual * sum(
                terms.values())
        if self.with_gan:
            losses["G_GAN"] = sum(gan_loss(self.nets[n](pred), True,
                                           self.gan_mode)
                                  for n in self.d_names)
        return losses, pred

    def optimize_prepared(self, dev, draws=None):
        """One step on a prepared batch (see the module doc). Losses stay
        on the device."""
        draws = draws or {}
        gt, y_cond, mask = dev["gt"], dev.get("y_cond"), dev.get("mask")
        state = self.states["G_A"]
        losses, pred = self._g_losses(gt, y_cond, mask, draws)
        total = sum(losses.values())
        apply_updates(state, param_grads(total, state.params),
                      self.ema_beta)
        losses["G_tot"] = total
        losses = {k: v.detach() for k, v in losses.items()}
        if self.with_gan:
            fake = pred.detach()
            pooled = self.pool.query(fake, draws.get("pool") or
                                     self.pool.draw_query(self.generator,
                                                          fake.shape[0]))
            for name in self.d_names:
                netD = self.nets[name]
                loss = 0.5 * (gan_loss(netD(gt), True, self.gan_mode)
                              + gan_loss(netD(pooled), False, self.gan_mode))
                dstate = self.states[name]
                apply_updates(dstate, param_grads(loss, dstate.params))
                losses[f"D_{name}"] = loss.detach()
        self.step_count += gt.shape[0]
        if self.is_ect:
            self.ect_stage = self.step_count // (1000 * 50)
        self.loss_log = losses
        return losses

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    # ------------------------------------------------------------------
    def inference(self, batch, use_ema=None, sigmas=SAMPLING_SIGMAS):
        """The consistency sampler over ``sigmas`` from the model's
        generator; NHWC float32 in [-1, 1], the EMA weights when
        ``use_ema`` (default: ``train_G_ema``) and they exist."""
        dev = self.prepare_batch(batch)
        use_ema = self.use_ema if use_ema is None else use_ema
        net = self.ema_nets.get("G_A") if use_ema else None
        net = net if net is not None else self.nets["G_A"]
        with torch.inference_mode():
            out = cm_sample(self._apply_fn(net), self.generator,
                            list(sigmas), dev["gt"], y_cond=dev.get("y_cond"),
                            mask=dev.get("mask"))
        return out.cpu().numpy()
