"""The JiT blocks (``joligen_tpu/models/modules/jit.py``): the 2-D sin-cos
position table, axial RoPE, RMSNorm, the SwiGLU feed-forward, AdaLN
modulation and ``JiTBlock``, the transformer block of the video denoiser
``vit_vid`` (``models/modules/vit_vid.py``).

Modules carry the flax names (``adaLN``, ``norm1``, ``qkv``, ``q_norm``,
``k_norm``, ``proj``, ``norm2``, ``mlp/w1``, ``mlp/w3``, ``mlp/w2``). Dense
layers keep fp32 parameters and compute in ``dtype`` (bf16 under
``tpu_bf16``); RMSNorm takes fp32 statistics and returns its input's dtype.
Attention is the port's ``flash_attention`` (K1, and K2/K3 in the
backward), at (B, N, heads, head dim).

The image model ``JiT`` (``G_netG: vit``) is not ported: no example config
uses it (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_attention
from .unet_mha import Dense

JiT_VARIANT_CONFIGS = {
    f"JiT-{size}/{patch}": dict(
        depth={"B": 12, "L": 24, "H": 32}[size],
        hidden_size={"B": 768, "L": 1024, "H": 1280}[size],
        num_heads={"B": 12, "L": 16, "H": 16}[size],
        bottleneck_dim={"B": 128, "L": 128, "H": 256}[size],
        patch_size=patch, in_context_len=32,
        in_context_start={"B": 4, "L": 8, "H": 10}[size])
    for size, patches in (("B", (16, 8, 4, 2, 32)), ("L", (16, 32)),
                          ("H", (16, 32)))
    for patch in patches
}


def sincos_2d_pos_embed(dim, grid_h, grid_w):
    """The fixed 2-D sin-cos table, (grid_h * grid_w, dim) float32 numpy,
    built in float64: the first dim // 2 channels encode the column (w),
    the second half the row (h), as the JAX package's half order."""
    def _1d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64)
                                / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw, gh = np.meshgrid(np.arange(grid_w, dtype=np.float64),
                         np.arange(grid_h, dtype=np.float64))
    return np.concatenate([_1d(dim // 2, gw), _1d(dim // 2, gh)],
                          axis=1).astype(np.float32)


def axial_rope_tables(grid_h, grid_w, head_dim, prefix=0):
    """Axial interleaved RoPE cos/sin tables, (prefix + gh * gw, head_dim)
    float32 numpy: frequencies 10000^(-2i / (hd / 2)), each repeated for a
    pair; the first hd / 2 lanes rotate by the row, the second by the
    column; ``prefix`` identity rows (cos 1, sin 0) for the prefix tokens."""
    dim = head_dim // 2
    if dim % 2:
        raise ValueError("head_dim must be a multiple of 4 for axial RoPE")
    freqs = 1.0 / (10000 ** (np.arange(0, dim, 2)[: dim // 2]
                             .astype(np.float64) / dim))
    fh = np.repeat(np.arange(grid_h)[:, None] * freqs[None], 2, axis=-1)
    fw = np.repeat(np.arange(grid_w)[:, None] * freqs[None], 2, axis=-1)
    full = np.concatenate(
        [np.broadcast_to(fh[:, None, :], (grid_h, grid_w, dim)),
         np.broadcast_to(fw[None, :, :], (grid_h, grid_w, dim))],
        axis=-1).reshape(grid_h * grid_w, head_dim)
    cos, sin = np.cos(full), np.sin(full)
    if prefix:
        cos = np.concatenate([np.ones((prefix, head_dim)), cos], axis=0)
        sin = np.concatenate([np.zeros((prefix, head_dim)), sin], axis=0)
    return cos.astype(np.float32), sin.astype(np.float32)


def rope_rotate(t, cos, sin):
    """t * cos + rotate_half(t) * sin with interleaved pairs: t (B, N,
    heads, hd), tables (N, hd) cast to t's dtype."""
    x = t.reshape(*t.shape[:-1], t.shape[-1] // 2, 2)
    rot = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(t.shape)
    c = cos[None, :, None, :].to(t.dtype)
    s = sin[None, :, None, :].to(t.dtype)
    return t * c + rot * s


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x²) + eps) in fp32, times the fp32 scale, cast back to
    x's dtype."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                              + self.eps)
        return (n * self.weight).to(x.dtype)


class SwiGLUFFN(nn.Module):
    """w2(silu(w1 x) * w3 x), biased, hidden int(2/3 * ``hidden``)."""

    def __init__(self, dim, hidden, dtype=torch.float32):
        super().__init__()
        h = int(hidden * 2 / 3)
        self.w1 = Dense(dim, h, dtype=dtype)
        self.w3 = Dense(dim, h, dtype=dtype)
        self.w2 = Dense(h, dim, dtype=dtype)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class JiTBlock(nn.Module):
    """AdaLN-modulated pre-norm block: RMSNorm, qkv, q/k RMSNorm, RoPE,
    attention, projection, gated residual; then RMSNorm, SwiGLU, gated
    residual. ``adaLN`` (6 modulations from c) is zero-initialised, so a
    new block is the identity. ``forward(x (B, N, d), c (B, d), cos,
    sin)``, the tables (N, head dim)."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.adaLN = Dense(dim, 6 * dim, dtype=dtype, zero_init=True)
        self.norm1 = RMSNorm(dim)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.q_norm = RMSNorm(hd)
        self.k_norm = RMSNorm(hd)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = RMSNorm(dim)
        self.mlp = SwiGLUFFN(dim, 4 * dim, dtype=dtype)

    def forward(self, x, c, rope_cos, rope_sin):
        b, n, d = x.shape
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = torch.chunk(
            self.adaLN(F.silu(c)), 6, dim=-1)
        h = modulate(self.norm1(x), s_msa, sc_msa)
        q, k, v = torch.chunk(self.qkv(h), 3, dim=-1)
        shape = (b, n, self.num_heads, d // self.num_heads)
        q = rope_rotate(self.q_norm(q.reshape(shape)), rope_cos, rope_sin)
        k = rope_rotate(self.k_norm(k.reshape(shape)), rope_cos, rope_sin)
        a = flash_attention(q, k, v.reshape(shape)).reshape(b, n, d)
        x = x + g_msa[:, None, :] * self.proj(a)
        h = modulate(self.norm2(x), s_mlp, sc_mlp)
        return x + g_mlp[:, None, :] * self.mlp(h)
