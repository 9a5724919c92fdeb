"""Diffusion noise schedules and sinusoidal embeddings.

The numpy tables are a copy of ``joligen_tpu/ops/schedules.py`` (reference
models/modules/diffusion_utils.py:45-119); ``extract`` and the gamma
embeddings work on torch tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def _warmup_beta(linear_start, linear_end, n_timestep, warmup_frac):
    betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * warmup_frac)
    betas[:warmup_time] = np.linspace(
        linear_start, linear_end, warmup_time, dtype=np.float64
    )
    return betas


def make_beta_schedule(
    schedule, n_timestep, linear_start=1e-6, linear_end=1e-2, cosine_s=8e-3
):
    """Beta schedule table (float64 numpy). Parity: diffusion_utils.py:45-76."""
    if schedule == "quad":
        betas = (
            np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                        dtype=np.float64) ** 2
        )
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    elif schedule == "jsd":
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    elif schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, None, 0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclass(frozen=True)
class NoiseSchedule:
    """All DDPM coefficient tables for one phase (train or test), float32
    numpy (reference diffusion_utils.py:79-119 set_new_noise_schedule)."""

    betas: np.ndarray
    gammas: np.ndarray
    gammas_prev: np.ndarray
    sqrt_recip_gammas: np.ndarray
    sqrt_recipm1_gammas: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, schedule="linear", n_timestep=2000, linear_start=1e-6,
               linear_end=1e-2, cosine_s=8e-3):
        betas = make_beta_schedule(schedule, n_timestep, linear_start,
                                   linear_end, cosine_s)
        alphas = 1.0 - betas
        gammas = np.cumprod(alphas, axis=0)
        gammas_prev = np.append(1.0, gammas[:-1])
        posterior_variance = betas * (1.0 - gammas_prev) / (1.0 - gammas)
        f32 = lambda x: np.asarray(x, dtype=np.float32)
        return cls(
            betas=f32(betas),
            gammas=f32(gammas),
            gammas_prev=f32(gammas_prev),
            sqrt_recip_gammas=f32(np.sqrt(1.0 / gammas)),
            sqrt_recipm1_gammas=f32(np.sqrt(1.0 / gammas - 1)),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(gammas_prev) / (1.0 - gammas)),
            posterior_mean_coef2=f32(
                (1.0 - gammas_prev) * np.sqrt(alphas) / (1.0 - gammas)),
        )

    @classmethod
    def for_phase(cls, opt_or_timesteps, phase="train"):
        """Linear 1e-6..0.01 for train, linear 1e-4..0.09 for test
        (reference unet_generator_attn.py:646-659 beta_schedule)."""
        if hasattr(opt_or_timesteps, "G_diff_n_timestep_train"):
            n = (opt_or_timesteps.G_diff_n_timestep_train if phase == "train"
                 else opt_or_timesteps.G_diff_n_timestep_test)
        else:
            n = int(opt_or_timesteps)
        if phase == "train":
            return cls.create(schedule="linear", n_timestep=n,
                              linear_start=1e-6, linear_end=0.01)
        return cls.create(schedule="linear", n_timestep=n,
                          linear_start=1e-4, linear_end=0.09)


def extract(table, t, ndim):
    """``table[t]`` broadcast to an ndim-dimensional per-sample coefficient.
    ``t`` is an integer tensor; the table goes to its device as float32."""
    table = torch.as_tensor(table, dtype=torch.float32, device=t.device)
    out = table[t.long()]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def gamma_embedding_1d(gammas, dim, max_period=10000.0):
    """Sinusoidal embedding of (possibly fractional) noise levels.
    Parity: diffusion_utils.py:8-28 — cos first, then sin."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=gammas.device) / half)
    args = gammas.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def gamma_embedding(gammas, dim, max_period=10000.0):
    """Multi-column gamma embedding (diffusion_utils.py:31-42): each column of
    ``gammas`` (B, K) gets dim//K dims, concatenated."""
    if gammas.ndim == 1:
        gammas = gammas[:, None]
    k = gammas.shape[1]
    reduced = dim // k
    return torch.cat([gamma_embedding_1d(gammas[:, i], reduced, max_period)
                      for i in range(k)], dim=1)


def timestep_embedding(timesteps, dim, max_period=10000.0):
    """The sinusoidal embedding of (integer or fractional) timesteps
    (``joligen_tpu/ops/schedules.py:151-153``)."""
    return gamma_embedding_1d(timesteps.float(), dim, max_period)
