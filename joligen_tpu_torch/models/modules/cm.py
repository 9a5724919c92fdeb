"""Consistency model core (iCT) and ECT (easy consistency tuning)
(``joligen_tpu/models/modules/cm.py``).

- Host-side tables, numpy float64 cast to float32 as in the JAX package: the
  Karras sigmas, the improved discretisation schedule, the lognormal
  timestep distribution (``math.erf``, vectorised) and the improved loss
  weights. ``stage_tables`` keeps them on the device, one copy a stage.
- The skip and output scalings (train and test variants), ECT's sigmoid
  t -> r map and the pseudo-Huber loss.
- ``NoiseLevelEmbedding`` and ``CMDenoiser`` with the flax names
  (``sigma_embed/W``, ``proj0``, ``proj1``, ``inner``). ``W`` is a
  parameter that the forward detaches, as the JAX module takes it behind
  ``stop_gradient``: its gradient is 0, and the optimizer still holds and
  decays it.
- The training forwards (``cm_training_outputs``, ``ect_training_outputs``:
  the student with a graph, the teacher under ``torch.no_grad`` on the same
  noise) and the multi-step sampler ``cm_sample``.

Each random draw is a tensor: drawn from the caller's ``torch.Generator``
unless ``draws`` feeds it (tests feed the JAX keys' draws).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .unet_mha import Dense

SIGMA_MIN = 0.002
SIGMA_MAX = 80.0
SIGMA_DATA = 0.5
RHO = 7.0

_erf = np.vectorize(math.erf, otypes=[np.float64])


def improved_timesteps_schedule(current_step, total_steps,
                                initial_timesteps=10, final_timesteps=1280):
    """The number of discretisation points at ``current_step`` (samples
    seen): doubles every ``total_steps / (log2(final / initial) + 1)``."""
    total_prime = math.floor(
        total_steps / (math.log2(math.floor(final_timesteps
                                            / initial_timesteps)) + 1))
    num = initial_timesteps * 2 ** math.floor(current_step
                                              / max(1, total_prime))
    return int(min(num, final_timesteps) + 1)


def karras_schedule(num_timesteps, sigma_min=SIGMA_MIN, sigma_max=SIGMA_MAX,
                    rho=RHO):
    """Ascending Karras sigmas, float32."""
    rho_inv = 1.0 / rho
    steps = np.arange(num_timesteps) / max(num_timesteps - 1, 1)
    sigmas = sigma_min ** rho_inv + steps * (
        sigma_max ** rho_inv - sigma_min ** rho_inv)
    return np.asarray(sigmas ** rho, dtype=np.float32)


def lognormal_timestep_probs(sigmas, mean=-1.1, std=2.0):
    """The lognormal law's mass on each interval [sigma_i, sigma_i+1),
    normalised, float32."""
    s = np.asarray(sigmas, dtype=np.float64)
    pdf = _erf((np.log(s[1:]) - mean) / (std * math.sqrt(2))) - _erf(
        (np.log(s[:-1]) - mean) / (std * math.sqrt(2)))
    return np.asarray(pdf / pdf.sum(), dtype=np.float32)


def improved_loss_weighting(sigmas):
    """1 / (sigma_i+1 - sigma_i), float32."""
    s = np.asarray(sigmas)
    return np.asarray(1.0 / (s[1:] - s[:-1]), dtype=np.float32)


@functools.lru_cache(maxsize=16)
def stage_tables(num_timesteps, device):
    """(sigmas, probs, weights) of a stage as float32 tensors on
    ``device``, copied there once a stage (a copy from host memory would
    wait for the device on every step)."""
    sigmas = karras_schedule(num_timesteps)
    return tuple(torch.from_numpy(a).to(device) for a in (
        sigmas, lognormal_timestep_probs(sigmas),
        improved_loss_weighting(sigmas)))


def skip_scaling(sigma, train=False):
    if train:
        return SIGMA_DATA ** 2 / (sigma ** 2 + SIGMA_DATA ** 2)
    return SIGMA_DATA ** 2 / ((sigma - SIGMA_MIN) ** 2 + SIGMA_DATA ** 2)


def output_scaling(sigma, train=False):
    if train:
        return (SIGMA_DATA * sigma) / (SIGMA_DATA ** 2 + sigma ** 2) ** 0.5
    return (SIGMA_DATA * (sigma - SIGMA_MIN)) / (
        SIGMA_DATA ** 2 + sigma ** 2) ** 0.5


def ect_t_to_r_sigmoid(t, stage, k=8.0, b=1.0, q=2.0):
    adj = 1 + k * torch.sigmoid(-b * t)
    decay = 1 / q ** (stage + 1)
    ratio = 1 - decay * adj
    return torch.clamp(t * ratio, min=0.0)


def pseudo_huber_loss(pred, target):
    """Elementwise; c = 0.00054 * sqrt(elements of one sample)."""
    c = 0.00054 * math.sqrt(math.prod(pred.shape[1:]))
    return torch.sqrt((pred - target) ** 2 + c ** 2) - c


class NoiseLevelEmbedding(nn.Module):
    """Fixed random Fourier features of sigma and an MLP: ``W`` (C/2,)
    N(0, ``scale``), then ``proj0`` (4C, or C with ``ft_proj``), SiLU,
    ``proj1`` (C)."""

    def __init__(self, channels, scale=0.02, ft_proj=False,
                 dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.zeros(channels // 2))
        hidden = channels if ft_proj else 4 * channels
        self.proj0 = Dense(2 * (channels // 2), hidden, dtype=dtype)
        self.proj1 = Dense(hidden, channels, dtype=dtype)

    def forward(self, sigmas):
        h = sigmas[:, None] * self.W.detach()[None, :] * 2 * math.pi
        h = torch.cat([torch.sin(h), torch.cos(h)], dim=-1)
        return self.proj1(F.silu(self.proj0(h)))


class CMDenoiser(nn.Module):
    """c_skip(sigma) * x + c_out(sigma) * inner([x_cond,] x, emb(sigma)),
    in fp32 whatever the trunk's compute dtype."""

    def __init__(self, inner, cond_embed_dim, ft_proj=False,
                 dtype=torch.float32):
        super().__init__()
        self.inner = inner
        self.sigma_embed = NoiseLevelEmbedding(cond_embed_dim,
                                               ft_proj=ft_proj, dtype=dtype)

    def forward(self, x, sigma, x_cond=None, train=True):
        c_skip = skip_scaling(sigma, train).reshape(-1, 1, 1, 1)
        c_out = output_scaling(sigma, train).reshape(-1, 1, 1, 1)
        emb = self.sigma_embed(sigma)
        xin = x if x_cond is None else torch.cat([x_cond, x], dim=-1)
        f = self.inner(xin, emb)
        return c_skip * x + c_out * f.float()


def _noiser(y0, noise, mask):
    m = None if mask is None else torch.clamp(mask.to(y0.dtype), 0.0, 1.0)

    def noisy(sig):
        x = y0 + sig.reshape(-1, 1, 1, 1) * noise
        if m is not None:
            x = x * m + (1 - m) * y0
        return x
    return noisy


def cm_training_outputs(apply_fn, generator, step_count, total_steps, y0,
                        y_cond=None, mask=None, draws=None):
    """One iCT training forward. ``apply_fn(x, sigma, x_cond, train)``.
    The stage (number of sigmas) comes from ``step_count`` on the host.
    ``draws``: ``timesteps`` (B,) ints in [0, N - 1) and ``noise`` like
    ``y0``. Returns (pred_x, target_x, loss weights (B, 1, 1, 1))."""
    draws = draws or {}
    num_t = improved_timesteps_schedule(step_count, total_steps)
    sigmas, probs, weights = stage_tables(num_t, y0.device)
    timesteps = draws.get("timesteps")
    if timesteps is None:
        timesteps = torch.multinomial(probs, y0.shape[0], replacement=True,
                                      generator=generator)
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(y0.shape, generator=generator, device=y0.device,
                            dtype=y0.dtype)
    timesteps = timesteps.to(y0.device).long()
    cur_sig, next_sig = sigmas[timesteps], sigmas[timesteps + 1]
    noisy = _noiser(y0, noise.to(y0.device), mask)
    pred_x = apply_fn(noisy(next_sig), next_sig, y_cond, True)
    with torch.no_grad():
        target_x = apply_fn(noisy(cur_sig), cur_sig, y_cond, True)
    return pred_x, target_x, weights[timesteps].reshape(-1, 1, 1, 1)


def ect_training_outputs(apply_fn, generator, stage, y0, y_cond=None,
                         mask=None, P_mean=-1.1, P_std=2.0, draws=None):
    """ECT forward: t ~ lognormal, r = the sigmoid-shrunk t; D(x_t, t) with
    a graph and D(x_r, r) without. ``draws``: ``t_normal`` (B,) and
    ``noise``. Returns (D_yt, D_yr, t, r)."""
    draws = draws or {}
    b, dev = y0.shape[0], y0.device
    normal = draws.get("t_normal")
    if normal is None:
        normal = torch.randn((b,), generator=generator, device=dev)
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(y0.shape, generator=generator, device=dev,
                            dtype=y0.dtype)
    t = torch.exp(normal.to(dev) * P_std + P_mean)
    r = ect_t_to_r_sigmoid(t, stage)
    noisy = _noiser(y0, noise.to(dev), mask)
    D_yt = apply_fn(noisy(t), t, y_cond, True)
    with torch.no_grad():
        D_yr = apply_fn(noisy(r), r, y_cond, True)
    return D_yt, D_yr, t, r


def cm_sample(apply_fn, generator, sigmas, y, y_cond=None, mask=None,
              clip_denoised=True, noise_seq=None):
    """Multi-step consistency sampler over ``sigmas`` (descending): one
    denoiser call a sigma, noise re-injected at each after the first.
    ``noise_seq``: (len(sigmas), B, H, W, C) injected noises (index 0 the
    first sigma's) in place of the generator's draws."""
    m = None if mask is None else torch.clamp(mask.to(y.dtype), 0.0, 1.0)
    y_base = y * (1 - m) if m is not None else torch.zeros_like(y)

    def project(x):
        if clip_denoised:
            x = torch.clamp(x, -1.0, 1.0)
        if m is not None:
            x = x * m + (1 - m) * y
        return x

    def noise(i):
        if noise_seq is not None:
            return noise_seq[i].to(y.device, y.dtype)
        return torch.randn(y.shape, generator=generator, device=y.device,
                           dtype=y.dtype)

    b = y.shape[0]
    x = (y_base if m is not None else y) + sigmas[0] * noise(0)
    if m is not None:
        x = x * m + (1 - m) * y
    sig0 = torch.full((b,), sigmas[0], dtype=y.dtype, device=y.device)
    x = project(apply_fn(x, sig0, y_cond, False))
    for i, sig in enumerate(sigmas[1:], 1):
        sig32 = np.float32(sig)
        scale = float(np.sqrt(np.maximum(
            sig32 ** 2 - np.float32(SIGMA_MIN ** 2), np.float32(0.0))))
        xi = x + scale * noise(i)
        if m is not None:
            xi = xi * m + (1 - m) * y
        sigb = torch.full((b,), float(sig32), dtype=y.dtype,
                          device=y.device)
        x = project(apply_fn(xi, sigb, y_cond, False))
    return x
