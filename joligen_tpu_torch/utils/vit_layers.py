"""Layers of the frozen ViT towers (``utils/clip_vit.py``,
``utils/dinov2.py``) under flax's names and semantics:

- ``LayerNorm``: flax ``nn.LayerNorm`` over the last axis, fp32 statistics
  with the variance E[x²] − E[x]² clipped at 0;
- ``MultiHeadDotProductAttention``: flax's self-attention, its ``query``,
  ``key`` and ``value`` ``DenseGeneral`` kernels (D, H, hd) with biases
  (H, hd) and its ``out`` kernel (H, hd, D), kept in flax's layout (the
  converter carries them as they are). The query is scaled by 1/√hd before
  QKᵀ and the softmax runs in fp32, as ``flax.linen.dot_product_attention``
  does. Plain torch ops: the JAX package runs no kernel here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` kernel and bias in flax's layout; ``fan_in``
    is the size its default init (lecun normal) divides by."""

    def __init__(self, kernel_shape, bias_shape, fan_in):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))
        self.fan_in = fan_in


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention over (B, L, D) in fp32 (the towers have no dtype)."""

    def __init__(self, dim, heads):
        super().__init__()
        hd = dim // heads
        self.heads, self.head_dim = heads, hd
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((dim, heads, hd), (heads, hd),
                                               dim))
        self.out = DenseGeneral((heads, hd, dim), (dim,), dim)

    def _project(self, x, dense):
        b, n, d = x.shape
        y = torch.addmm(dense.bias.reshape(-1), x.reshape(b * n, d),
                        dense.kernel.reshape(d, -1))
        # (B, H, L, hd)
        return y.reshape(b, n, self.heads, self.head_dim).transpose(1, 2)

    def forward(self, x):
        b, n, d = x.shape
        q = self._project(x, self.query) / math.sqrt(self.head_dim)
        k = self._project(x, self.key)
        v = self._project(x, self.value)
        w = F.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1)
        o = torch.matmul(w.to(v.dtype), v).transpose(1, 2).reshape(b * n, -1)
        y = torch.addmm(self.out.bias, o, self.out.kernel.reshape(-1, d))
        return y.reshape(b, n, d)
