"""Shortcut model: the denoiser with t and dt embeddings, the training
forward (flow-matching targets mixed with bootstrap self-consistency
targets) and the Euler few-step sampler (``joligen_tpu/models/modules/
sc.py``).

The JAX forward computes both targets and picks one with ``jnp.where`` on
one Bernoulli draw a batch; so does this one: every step runs the two
bootstrap forwards (without a graph) and the student. Each random draw is a
tensor from the caller's ``torch.Generator`` unless ``draws`` feeds it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.schedules import timestep_embedding
from .unet_mha import Dense


class SCDenoiser(nn.Module):
    """inner([x_cond,] x_t, MLP(emb(t)) + MLP(emb(dt_base))); the MLPs are
    ``t_0``/``t_1`` and ``dt_0``/``dt_1``."""

    def __init__(self, inner, cond_embed_dim, freq_dim=256,
                 dtype=torch.float32):
        super().__init__()
        self.inner = inner
        self.freq_dim = freq_dim
        self.t_0 = Dense(freq_dim, cond_embed_dim, dtype=dtype)
        self.t_1 = Dense(cond_embed_dim, cond_embed_dim, dtype=dtype)
        self.dt_0 = Dense(freq_dim, cond_embed_dim, dtype=dtype)
        self.dt_1 = Dense(cond_embed_dim, cond_embed_dim, dtype=dtype)

    def forward(self, x_t, t, dt_base, x_cond=None):
        t_emb = self.t_1(F.silu(self.t_0(timestep_embedding(
            t, self.freq_dim))))
        dt_emb = self.dt_1(F.silu(self.dt_0(timestep_embedding(
            dt_base, self.freq_dim))))
        xin = x_t if x_cond is None else torch.cat([x_cond, x_t], dim=-1)
        return self.inner(xin, t_emb + dt_emb)


def sc_training_outputs(apply_fn, generator, y0, y_cond=None, mask=None,
                        num_timesteps=128, bootstrap_ratio=0.125,
                        draws=None, return_x=False):
    """Returns (v_pred, v_target), plus the one-step x-prediction
    x_t + (1 - t) v_pred when ``return_x`` (for the perceptual terms).
    ``apply_fn(x, t, dt_base, x_cond)``.
    ``draws`` (the JAX keys r_dt, r_t, r_n, r_mode): ``dt_base`` (B,) ints
    in [0, log2(num_timesteps)), ``t_u`` (B,) uniforms, ``noise`` like
    ``y0`` and ``mode_u`` (a 0-d uniform: bootstrap targets where it is
    below ``bootstrap_ratio``)."""
    draws = draws or {}
    b, dev = y0.shape[0], y0.device
    log2_sections = int(math.log2(num_timesteps))

    def draw(name, fn):
        v = draws.get(name)
        return fn() if v is None else v.to(dev)

    dt_base = draw("dt_base", lambda: torch.randint(
        0, log2_sections, (b,), generator=generator, device=dev)).float()
    u = draw("t_u", lambda: torch.rand((b,), generator=generator,
                                       device=dev))
    x0 = draw("noise", lambda: torch.randn(y0.shape, generator=generator,
                                           device=dev, dtype=y0.dtype))
    mode_u = draw("mode_u", lambda: torch.rand((), generator=generator,
                                               device=dev))
    dt = 1.0 / (2.0 ** dt_base)
    dt_base_bootstrap = dt_base + 1
    dt_bootstrap = dt / 2
    dt_sections = 2.0 ** dt_base
    t = torch.floor(u * dt_sections) / dt_sections

    t_full = t.reshape(-1, 1, 1, 1)
    x1 = y0
    x_t = (1 - (1 - 1e-5) * t_full) * x0 + t_full * x1
    if mask is not None:
        m = torch.clamp(mask.to(y0.dtype), 0.0, 1.0)
        x_t = x_t * m + (1 - m) * x1

    with torch.no_grad():
        v_b1 = apply_fn(x_t, t, dt_base_bootstrap, y_cond)
        t2 = t + dt_bootstrap
        x_t2 = torch.clamp(x_t + dt_bootstrap.reshape(-1, 1, 1, 1) * v_b1,
                           -1.5, 1.5)
        v_b2 = apply_fn(x_t2, t2, dt_base_bootstrap, y_cond)
        v_boot = torch.clamp((v_b1 + v_b2) / 2, -1.5, 1.5)
        v_flow = x1 - (1 - 1e-5) * x0
        v_target = torch.where(mode_u < bootstrap_ratio, v_boot, v_flow)
    v_pred = apply_fn(x_t, t, dt_base, y_cond)
    if return_x:
        return v_pred, v_target, x_t + (1.0 - t_full) * v_pred
    return v_pred, v_target


def sc_sample(apply_fn, generator, y, y_cond=None, mask=None,
              denoise_timesteps=8, clip_denoised=True, noise=None):
    """Euler sampler at ``denoise_timesteps`` steps; ``noise`` replaces the
    initial draw. The kept region is recombined with the zeroed base
    y * (1 - m), as the JAX sampler does."""
    b = y.shape[0]
    m = None if mask is None else torch.clamp(mask.to(y.dtype), 0.0, 1.0)
    base = y * (1 - m) if m is not None else y
    if noise is None:
        noise = torch.randn(y.shape, generator=generator, device=y.device,
                            dtype=y.dtype)
    x = base + noise.to(y.device, y.dtype)
    if m is not None:
        x = x * m + (1 - m) * base
    delta = 1.0 / denoise_timesteps
    dt_base = torch.full((b,), math.log2(denoise_timesteps), dtype=y.dtype,
                         device=y.device)
    for ti in range(denoise_timesteps):
        t_vec = torch.full((b,), ti / denoise_timesteps, dtype=y.dtype,
                           device=y.device)
        v = apply_fn(x, t_vec, dt_base, y_cond)
        x = x + v * delta
        if clip_denoised:
            x = torch.clamp(x, -1.0, 1.0)
        if m is not None:
            x = x * m + (1 - m) * base
    return x
