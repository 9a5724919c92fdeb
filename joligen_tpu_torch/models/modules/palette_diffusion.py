"""Palette conditioning wrapper, the training forward and loss, and the
DDPM/DDIM samplers (``joligen_tpu/models/modules/palette_diffusion.py``).

The JAX package runs each sampling chain as one ``lax.scan``; here they are
Python loops, one denoiser call per step. Images are NHWC, sampler and loss
arithmetic is fp32. Random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.schedules import NoiseSchedule, extract, gamma_embedding
from .unet_mha import Conv, Dense
from .unet_ref_attn import UNetRefAttn


class LabelEmbedder(nn.Module):
    """Class/mask-label embedding table (palette_denoise_fn.py:14-32)."""

    def __init__(self, num_classes, hidden_size):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_classes, hidden_size))

    def forward(self, labels):
        # F.embedding, not weight[labels]: the indexing op's backward
        # serialises on repeated rows (a mask label per pixel, 2 rows)
        return F.embedding(labels.long(), self.weight)


class PaletteDenoiser(nn.Module):
    """Wraps an inner denoiser with gamma/class/mask/ref conditioning.

    inner: module mapping ((B,H,W,Cin) NHWC, (B, emb_dim)) -> (B,H,W,Cout);
    a ``UNetRefAttn`` also takes the reference image.
    conditioning: "" | "mask" | "class" | "mask_and_class" | with "ref".

    ``ref`` conditioning without ``class`` (``palette_diffusion.py:99-139``)
    concatenates an embedding of the reference image (``ref_channels``
    channels) to the gamma embedding, whose share halves: a conv encoder
    (``ref_enc0..2``, stride 2, SiLU, the mean over the pixels) or, with
    ``ref_embed_net="clip"``, the frozen fp32 CLIP ViT-B/16 tower
    ``freezenet_clip`` (its output detached, then SiLU), then ``ref_proj``.
    """

    def __init__(self, inner, cond_embed_dim, conditioning="", nclasses=2,
                 ref_embed_net="", ref_channels=3, dtype=torch.float32):
        super().__init__()
        self.inner = inner
        self.cond_embed_dim = cond_embed_dim
        self.conditioning = conditioning
        self.nclasses = nclasses
        self.ref_embed_net = ref_embed_net
        self.dtype = dtype
        g = self.gamma_dim
        self.cond_embed_0 = Dense(g, g, dtype=dtype)
        self.cond_embed_1 = Dense(g, g, dtype=dtype)
        if "class" in conditioning:
            self.embedder_class = LabelEmbedder(nclasses, cond_embed_dim // 2)
        self.ref_embed = "ref" in conditioning and "class" not in conditioning
        if self.ref_embed:
            if ref_embed_net == "imagebind":
                raise NotImplementedError(
                    "alg_diffusion_ref_embed_net imagebind: the ImageBind "
                    "tower (ROADMAP Queue 1 item 14, metrics and frozen "
                    "nets)")
            if ref_embed_net == "clip":
                from ...utils.clip_vit import CLIPVisualViT
                self.freezenet_clip = CLIPVisualViT()
                cin = self.freezenet_clip.out_dim
            else:
                cin = ref_channels
                for i, chn in enumerate((64, 128, 256)):
                    self.add_module(f"ref_enc{i}", Conv(
                        cin, chn, 3, stride=2, padding=1, dtype=dtype))
                    cin = chn
            self.ref_proj = Dense(cin, cond_embed_dim - g, dtype=dtype)
        if "mask" in conditioning:
            self.embedder_mask = LabelEmbedder(nclasses, cond_embed_dim)

    @property
    def gamma_dim(self):
        # class and ref conditioning halve the gamma share of the embedding
        # (diffusion_generator.py:66-75)
        if "class" in self.conditioning or "ref" in self.conditioning:
            return self.cond_embed_dim // 2
        return self.cond_embed_dim

    def _ref_embedding(self, ref, batch, like):
        """The reference image's embedding (zeros without one)."""
        width = self.cond_embed_dim - self.gamma_dim
        if ref is None:
            return torch.zeros(batch, width, dtype=like.dtype,
                               device=like.device)
        if self.ref_embed_net == "clip":
            from ...utils.clip_vit import preprocess
            feats = self.freezenet_clip(preprocess(ref.float())).detach()
            return self.ref_proj(F.silu(feats).to(self.dtype))
        h = ref.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(3):
            h = F.silu(getattr(self, f"ref_enc{i}")(h))
        return self.ref_proj(h.mean(dim=(2, 3)))

    def forward(self, x, gammas, cls=None, mask=None, ref=None,
                zero_gamma=False):
        """x: (B,H,W,C) concatenated [y_cond, y_noisy]; gammas: (B,);
        cls: (B,) int or None; mask: (B,H,W,1) labels or None; ref:
        (B,H,W,C) reference image in [-1, 1] or None."""
        emb = gamma_embedding(gammas, self.gamma_dim)
        emb = self.cond_embed_1(F.silu(self.cond_embed_0(emb)))
        if zero_gamma:
            # CFG unconditional branch: literal zero embedding
            emb = torch.zeros_like(emb)
        if "class" in self.conditioning:
            cls_embed = (
                self.embedder_class(cls) if cls is not None else
                # cls=None (CFG uncond): zero class vector, NOT class 0
                torch.zeros(x.shape[0], self.cond_embed_dim // 2,
                            dtype=emb.dtype, device=emb.device))
            emb = torch.cat([emb, cls_embed.to(emb.dtype)], dim=1)
        if self.ref_embed:
            emb = torch.cat([emb, self._ref_embedding(
                ref, x.shape[0], emb).to(emb.dtype)], dim=1)
        if "mask" in self.conditioning:
            if mask is None:
                mask = torch.zeros(x.shape[:-1] + (1,), dtype=torch.int32,
                                   device=x.device)
            m = torch.clamp(mask[..., 0].long(), 0, self.nclasses - 1)
            x = torch.cat([x, self.embedder_mask(m).to(x.dtype)], dim=-1)
        if isinstance(self.inner, UNetRefAttn):
            return self.inner(x, emb, ref=ref)
        return self.inner(x, emb)


def q_sample(y0, sample_gammas, noise):
    """y_noisy = sqrt(g)*y0 + sqrt(1-g)*eps (diffusion_generator.py:410-412)."""
    return torch.sqrt(sample_gammas) * y0 + torch.sqrt(1.0 - sample_gammas) * noise


def continuous_gammas(schedule: NoiseSchedule, t, u):
    """gamma = gamma_{t-1} + u * (gamma_t - gamma_{t-1}) for t in 1..T-1 and
    u in [0, 1) (diffusion_generator.py:464-478)."""
    g_lo = extract(schedule.gammas, t - 1, 1)
    g_hi = extract(schedule.gammas, t, 1)
    return (g_hi - g_lo) * u + g_lo


def sample_continuous_gammas(generator, schedule: NoiseSchedule, batch,
                             device):
    """t ~ U{1..T-1}, gamma ~ U[gamma_{t-1}, gamma_t]; returns (t, gammas)."""
    t = torch.randint(1, schedule.num_timesteps, (batch,), generator=generator,
                      device=device)
    u = torch.rand(batch, generator=generator, device=device)
    return t, continuous_gammas(schedule, t, u)


def min_snr_weight(schedule: NoiseSchedule, t, ksnr=5.0):
    """min(SNR, k)/SNR per-sample weight (diffusion_generator.py:498-519)."""
    snr1 = extract(schedule.sqrt_recip_gammas, t, 1)
    snr2 = extract(schedule.sqrt_recipm1_gammas, t, 1)
    snr = (snr1 / snr2) ** 2
    return torch.clamp(snr, max=ksnr) / snr


def draw_training_noise(generator, schedule: NoiseSchedule, y0,
                        dropout_prob=0.0):
    """The random draws of one training forward, from ``generator`` in this
    order: timesteps and noise levels (``sample_continuous_gammas``), the
    noise, and (only with label dropout) the per-sample keep draws."""
    b = y0.shape[0]
    t, gammas = sample_continuous_gammas(generator, schedule, b, y0.device)
    noise = torch.randn(y0.shape, generator=generator, dtype=y0.dtype,
                        device=y0.device)
    keep_u = (torch.rand(b, generator=generator, device=y0.device)
              if dropout_prob > 0.0 else None)
    return {"t": t, "gammas": gammas, "noise": noise, "keep_u": keep_u}


def palette_training_outputs(apply_fn, generator, schedule: NoiseSchedule,
                             y0, y_cond, mask=None, cls=None,
                             dropout_prob=0.0, minsnr=True, null_class=0,
                             draws=None):
    """One training forward: returns (noise, noise_hat, weight) as the
    reference DiffusionGenerator.forward (diffusion_generator.py:457-521).

    y0/y_cond: (B,H,W,C) NHWC in [-1,1]. mask: (B,H,W,1) int labels or None.
    The draws come from ``generator`` (``draw_training_noise``) unless
    ``draws`` gives them (tests share host draws with the JAX package)."""
    b = y0.shape[0]
    bshape = (b,) + (1,) * (y0.ndim - 1)
    if draws is None:
        draws = draw_training_noise(generator, schedule, y0, dropout_prob)
    t, gammas, noise = draws["t"], draws["gammas"], draws["noise"]

    y_noisy = q_sample(y0, gammas.reshape(bshape), noise)
    if mask is not None:
        m = torch.clamp(mask.to(y0.dtype), 0.0, 1.0)
        y_noisy = y_noisy * m + (1.0 - m) * y0

    # classifier-free dropout of conditioning labels (palette_model.py:
    # 565-584): dropped samples get the reserved null class, not class 0
    if dropout_prob > 0.0:
        keep = draws["keep_u"] >= dropout_prob
        if cls is not None:
            cls = torch.where(keep, cls, torch.full_like(cls, null_class))
        if mask is not None:
            mask = torch.where(keep.reshape(bshape), mask,
                               torch.full_like(mask, null_class))

    x_in = torch.cat([y_cond, y_noisy], dim=-1)
    noise_hat = apply_fn(x_in, gammas, cls=cls, mask=mask)
    weight = min_snr_weight(schedule, t).reshape(bshape) if minsnr else 1.0
    return noise, noise_hat, weight


def _avg_pool2(e):
    """NHWC 2x2 stride-2 average pool (flax ``nn.avg_pool``, VALID)."""
    return F.avg_pool2d(e.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def masked_elementwise_loss(noise, noise_hat, mask=None, weight=1.0,
                            kind="MSE"):
    """Masked MSE/L1 (+ the 3-scale ``multiscale*`` pyramid) over the noised
    region with reference semantics (palette_model.py:586-609): the min-SNR
    weight and the mask multiply the inputs, and the reduction is a plain
    mean over all elements."""
    m = (torch.clamp(mask.to(noise.dtype), 0.0, 1.0)
         if mask is not None else 1.0)
    d = (noise_hat - noise) * weight * m

    def base(e):
        return torch.abs(e) if "L1" in kind else e ** 2

    if kind.startswith("multiscale"):
        total = 0.0
        e = d
        for _ in range(3):
            total = total + torch.mean(base(e))
            e = _avg_pool2(e)
        return total / 3.0
    return torch.mean(base(d))


def predict_start_from_noise(schedule: NoiseSchedule, y_t, t, noise):
    """(diffusion_utils.py:122-127)."""
    return (extract(schedule.sqrt_recip_gammas, t, y_t.ndim) * y_t
            - extract(schedule.sqrt_recipm1_gammas, t, y_t.ndim) * noise)


def q_posterior(schedule: NoiseSchedule, y0_hat, y_t, t):
    """(diffusion_utils.py:130-139)."""
    mean = (extract(schedule.posterior_mean_coef1, t, y_t.ndim) * y0_hat
            + extract(schedule.posterior_mean_coef2, t, y_t.ndim) * y_t)
    logvar = extract(schedule.posterior_log_variance_clipped, t, y_t.ndim)
    return mean, logvar


def _gammas(schedule, t):
    return torch.as_tensor(schedule.gammas, device=t.device)[t.long()]


def _denoise(apply_fn, schedule, y_t, y_cond, t, cls, mask, guidance_scale):
    gammas = _gammas(schedule, t)
    x_in = torch.cat([y_cond, y_t], dim=-1)
    noise_hat = apply_fn(x_in, gammas, cls=cls, mask=mask)
    y0_hat = predict_start_from_noise(schedule, y_t, t, noise_hat)
    if guidance_scale > 0.0:
        noise_uncond = apply_fn(x_in, gammas, cls=None, mask=None,
                                zero_gamma=True)
        y0_uncond = predict_start_from_noise(schedule, y_t, t, noise_uncond)
        y0_hat = (1 + guidance_scale) * y0_hat - guidance_scale * y0_uncond
    return torch.clamp(y0_hat, -1.0, 1.0)


def _initial(y_cond, y_t, out_channel, generator):
    if y_t is not None:
        return y_t
    c = out_channel or y_cond.shape[-1]
    return torch.randn(y_cond.shape[:-1] + (c,), generator=generator,
                       dtype=y_cond.dtype, device=y_cond.device)


def ddpm_sample(apply_fn, generator, schedule: NoiseSchedule, y_cond,
                y_t=None, y_0=None, mask=None, cls=None, guidance_scale=0.0,
                out_channel=None, noise_seq=None):
    """Full ancestral DDPM chain (reference restoration_ddpm,
    diffusion_generator.py:119-177). ``apply_fn(x, gammas, cls=, mask=,
    zero_gamma=)`` is the denoiser.

    ``noise_seq``: optional (T, B, H, W, C) per-step transition noises (step
    k is the noise added at t = T-1-k), so that a test drives this chain and
    the JAX one with the same noise. Otherwise ``y_t`` (when not given) is
    the generator's first draw and each step draws its noise after it."""
    b = y_cond.shape[0]
    y = _initial(y_cond, y_t, out_channel, generator)
    tmask = (None if mask is None
             else torch.clamp(mask.to(y_cond.dtype), 0.0, 1.0))
    for k, i in enumerate(range(schedule.num_timesteps - 1, -1, -1)):
        t = torch.full((b,), i, dtype=torch.int64, device=y.device)
        y0_hat = _denoise(apply_fn, schedule, y, y_cond, t, cls, mask,
                          guidance_scale)
        mean, logvar = q_posterior(schedule, y0_hat, y, t)
        noise = (torch.as_tensor(noise_seq[k], device=y.device)
                 if noise_seq is not None else
                 torch.randn(y.shape, generator=generator, dtype=y.dtype,
                             device=y.device))
        y = mean + (1.0 if i > 0 else 0.0) * noise * torch.exp(0.5 * logvar)
        if tmask is not None and y_0 is not None:
            y = y_0 * (1.0 - tmask) + tmask * y
    return y


def ddim_timesteps(num_timesteps, num_steps):
    """(current t, previous t) per DDIM step; the last previous t is -1."""
    tseq = np.linspace(0, num_timesteps - 1, num_steps).astype(np.int32)
    t_list = tseq[::-1].copy()
    prev_list = np.concatenate([tseq[::-1][1:], [-1]]).astype(np.int32)
    return t_list, prev_list


def ddim_sample(apply_fn, generator, schedule: NoiseSchedule, y_cond,
                y_t=None, y_0=None, mask=None, cls=None, guidance_scale=0.0,
                num_steps=10, eta=0.5, out_channel=None):
    """DDIM sampling (reference restoration_ddim, diffusion_generator.py:
    286-455). As in the reference the net output is used as y0 directly,
    and no noise is added: the only random draw is ``y_t`` when not given."""
    b = y_cond.shape[0]
    y = _initial(y_cond, y_t, out_channel, generator)
    tmask = (None if mask is None
             else torch.clamp(mask.to(y_cond.dtype), 0.0, 1.0))
    t_list, prev_list = ddim_timesteps(schedule.num_timesteps, num_steps)
    for ti, prevti in zip(t_list.tolist(), prev_list.tolist()):
        t = torch.full((b,), ti, dtype=torch.int64, device=y.device)
        gammas = _gammas(schedule, t)
        x_in = torch.cat([y_cond, y], dim=-1)
        y0_hat = apply_fn(x_in, gammas, cls=cls, mask=mask)
        if guidance_scale > 0.0:
            y0_unc = apply_fn(x_in, gammas, cls=None, mask=None,
                              zero_gamma=True)
            y0_hat = (1 + guidance_scale) * y0_hat - guidance_scale * y0_unc
        y0_hat = torch.clamp(y0_hat, -1.0, 1.0)

        gamma_t = extract(schedule.gammas, t, y.ndim)
        # gammas_prev[prevti + 1] (palette_diffusion.py:351)
        gamma_prevt = extract(schedule.gammas_prev,
                              torch.full_like(t, prevti + 1), y.ndim)
        sigma = eta * torch.sqrt(
            (1 - gamma_prevt) / (1 - gamma_t) * (1 - gamma_t / gamma_prevt))
        coef_eps = torch.sqrt(torch.clamp(1 - gamma_prevt - sigma ** 2,
                                          min=0.0))
        mean = (torch.sqrt(gamma_prevt) * (y - torch.sqrt(1.0 - gamma_t) * y0_hat)
                / torch.sqrt(gamma_t) + coef_eps * y0_hat)
        y = torch.clamp(mean, -1.0, 1.0)
        if tmask is not None and y_0 is not None:
            y = y_0 * (1.0 - tmask) + tmask * y
    return y
