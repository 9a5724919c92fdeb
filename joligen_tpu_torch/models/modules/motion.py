"""Temporal motion modules of the video denoiser
(``joligen_tpu/models/modules/motion.py``): per-pixel self-attention over
the frame axis with a sinusoidal position table, a GEGLU feed-forward, and a
zero-initialised output projection, so that a new motion module is the
identity.

Modules carry the flax names (``norm``, ``proj_in``, ``block{i}``,
``attn{i}``, ``to_q``/``to_k``/``to_v``/``to_out``, ``norm{i}``,
``norm_ff``, ``ff_geglu/proj``, ``ff_out``, ``proj_out``). ``MotionModule``
takes the port's NCHW interior with the frames folded into the batch,
(B*F, C, H, W), and attends over (B*H*W, F, C) sequences: 8 heads of C/8,
which is head dim 8 at the first level of ``unet_vid`` at ngf 64, through
the flash-attention kernels (K1, and K2/K3 in the backward; their packed
tiling, since F <= 25).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_attention
from ...utils.vit_layers import LayerNorm
from .unet_mha import Dense, GroupNorm


def temporal_pos_encoding(max_len, d):
    """The sinusoidal table (``motion.py:26-34``): built in float64, odd
    columns ``cos(...)[:, :d // 2]``, returned as float32 numpy."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((max_len, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : d // 2]
    return pe.astype(np.float32)


class GEGLU(nn.Module):
    """Dense to 2 * dim_out, then a * gelu(gate) with the exact (erf) GELU."""

    def __init__(self, cin, dim_out, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(cin, 2 * dim_out, dtype=dtype)

    def forward(self, x):
        a, gate = torch.chunk(self.proj(x), 2, dim=-1)
        return a * F.gelu(gate)


class TemporalSelfAttention(nn.Module):
    """Self-attention over the frame axis of (S, F, C) sequences, the
    position table added first; bias-free q, k, v projections."""

    def __init__(self, channels, num_heads, max_len=25, dtype=torch.float32):
        super().__init__()
        self.heads = num_heads
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(name, Dense(channels, channels, dtype=dtype,
                                        use_bias=False))
        self.to_out = Dense(channels, channels, dtype=dtype)
        self.register_buffer("pe", torch.from_numpy(
            temporal_pos_encoding(max_len, channels)), persistent=False)

    def forward(self, x):
        s, f, c = x.shape
        h = x + self.pe[:f].to(x.dtype)[None]
        q, k, v = (getattr(self, n)(h).reshape(s, f, self.heads, -1)
                   for n in ("to_q", "to_k", "to_v"))
        return self.to_out(flash_attention(q, k, v).reshape(s, f, c))


class TemporalTransformerBlock(nn.Module):
    """LayerNorm then temporal attention, twice, then LayerNorm and the GEGLU
    feed-forward, each residual; flax's LayerNorm (eps 1e-6)."""

    def __init__(self, channels, num_heads, num_attention_blocks=2,
                 max_len=25, dtype=torch.float32):
        super().__init__()
        self.n_attn = num_attention_blocks
        for i in range(num_attention_blocks):
            self.add_module(f"norm{i}", LayerNorm(channels, 1e-6))
            self.add_module(f"attn{i}", TemporalSelfAttention(
                channels, num_heads, max_len=max_len, dtype=dtype))
        self.norm_ff = LayerNorm(channels, 1e-6)
        self.ff_geglu = GEGLU(channels, 4 * channels, dtype=dtype)
        self.ff_out = Dense(4 * channels, channels, dtype=dtype)

    def forward(self, x):
        for i in range(self.n_attn):
            x = x + getattr(self, f"attn{i}")(getattr(self, f"norm{i}")(x))
        return x + self.ff_out(self.ff_geglu(self.norm_ff(x)))


class MotionModule(nn.Module):
    """GroupNorm (32 groups, lowered until they divide C; eps 1e-6), proj_in,
    ``num_transformer_blocks`` temporal blocks, the zero-initialised
    proj_out, residual. ``forward(x, frames)``: x (B*F, C, H, W) NCHW with
    the frames folded into the batch, returned in the same layout."""

    def __init__(self, channels, num_heads=8, num_transformer_blocks=2,
                 max_len=25, dtype=torch.float32):
        super().__init__()
        groups = 32
        while channels % groups:
            groups -= 1
        self.dtype = dtype
        self.n_blocks = num_transformer_blocks
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Dense(channels, channels, dtype=dtype)
        for i in range(num_transformer_blocks):
            self.add_module(f"block{i}", TemporalTransformerBlock(
                channels, num_heads, max_len=max_len, dtype=dtype))
        self.proj_out = Dense(channels, channels, dtype=dtype, zero_init=True)

    def forward(self, x, frames):
        bf, c, hh, ww = x.shape
        b = bf // frames
        y = self.norm(x.to(self.dtype))
        # (B*F, C, H, W) -> (B*H*W, F, C) temporal sequences
        y = y.reshape(b, frames, c, hh * ww).permute(0, 3, 1, 2)
        y = self.proj_in(y.reshape(b * hh * ww, frames, c))
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}")(y)
        y = self.proj_out(y)
        y = y.reshape(b, hh * ww, frames, c).permute(0, 2, 3, 1)
        return x + y.reshape(bf, c, hh, ww)
