"""Spectral normalisation for ``G_spectral`` / ``D_spectral``
(``joligen_tpu/models/modules/spectral.py``): each forward divides the
kernel by its largest singular value, estimated by three power iterations
from a fixed start over the (fan_in, fan_out) matricisation. No state is
kept between calls (the JAX package's rule, not torch's persistent ``u``),
and the gradient flows through the estimate, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def spectral_normalize(w, iters=3, eps=1e-12):
    """w (OIHW) / sigma_max, sigma taken over the HWIO kernel reshaped to
    (kh·kw·in, out), as the JAX package takes it."""
    mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).float()
    n = mat.shape[0]
    u = torch.full((n,), 1.0 / float(torch.sqrt(torch.tensor(float(n)))),
                   device=w.device)
    v = None
    for _ in range(iters):
        v = mat.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u @ (mat @ v)
    return (w / torch.clamp(sigma, min=eps)).to(w.dtype)


class SNConv(nn.Module):
    """A conv (symmetric int padding) with a spectrally normalised kernel;
    parameters ``weight`` (OIHW) and ``bias``, as the flax ``SNConv``'s
    ``kernel`` and ``bias``."""

    def __init__(self, cin, cout, kernel=4, stride=1, padding=1,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        k = spectral_normalize(self.weight)
        return F.conv2d(x.to(self.dtype), k.to(self.dtype),
                        self.bias.to(self.dtype), self.stride, self.padding)
