"""Resizes with the JAX package's semantics (``joligen_tpu/ops/resize.py``,
``jax.image.resize`` and ``jax.image.scale_and_translate``).

- ``nearest_up2``: integer-factor nearest upsampling, NHWC.
- ``resize_nearest``: ``jax.image.resize(..., "nearest")``, half-pixel
  centres (torch's ``"nearest-exact"``), NCHW.
- ``scale_and_translate`` / ``resize_bilinear``: the triangle kernel of
  ``jax.image`` as one weight matrix per axis, so a downsample antialiases
  (the kernel widens by the factor) as JAX's default does. NCHW.
"""

from __future__ import annotations

import torch


def nearest_up2(x):
    """(B, H, W, C) -> (B, 2H, 2W, C) nearest-neighbour upsample."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def resize_nearest(x, size):
    """(N, C, H, W) -> (N, C, size[0], size[1]): source index
    floor((i + 0.5) * in / out), computed in fp32 as JAX does."""
    for dim, out in ((2, size[0]), (3, size[1])):
        n_in = x.shape[dim]
        if n_in == out:
            continue
        src = torch.floor((torch.arange(out, dtype=torch.float32) + 0.5)
                          * n_in / out).to(torch.int64)
        x = x.index_select(dim, src.to(x.device))
    return x


def _weight_mat(n_in, n_out, scale, translation, antialias=True):
    """``jax._src.image.scale.compute_weight_mat`` for the triangle kernel.
    ``scale`` and ``translation`` are fp32 tensors of shape (B,); returns
    (B, n_in, n_out)."""
    inv_scale = 1.0 / scale
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones_like(inv_scale))
    ar_out = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    ar_in = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    sample_f = ((ar_out[None] + 0.5) * inv_scale[:, None]
                - translation[:, None] * inv_scale[:, None] - 0.5)
    x = (torch.abs(sample_f[:, None, :] - ar_in[None, :, None])
         / kernel_scale[:, None, None])
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def scale_and_translate(x, scale, translation, antialias=True):
    """Per-image ``jax.image.scale_and_translate(img, img.shape, (H, W),
    (s, s), (ty, tx), "linear")`` over (N, C, H, W): ``scale`` (N,) and
    ``translation`` (N, 2) fp32. Output has the input's size."""
    n, c, h, w = x.shape
    wy = _weight_mat(h, h, scale, translation[:, 0], antialias).to(x.dtype)
    wx = _weight_mat(w, w, scale, translation[:, 1], antialias).to(x.dtype)
    return torch.einsum("nchw,nhy,nwx->ncyx", x, wy, wx)


def resize_bilinear(x, size, antialias=True):
    """``jax.image.resize(..., "bilinear")`` (antialiased when it shrinks)
    over (N, C, H, W). An axis whose size does not change is left alone,
    as JAX skips it."""
    n = x.shape[0]
    for dim, out in ((2, size[0]), (3, size[1])):
        n_in = x.shape[dim]
        if n_in == out:
            continue
        scale = torch.full((n,), out / n_in, dtype=torch.float32,
                           device=x.device)
        wm = _weight_mat(n_in, out, scale, torch.zeros_like(scale),
                         antialias)[0].to(x.dtype)
        x = (torch.einsum("nchw,hy->ncyw", x, wm) if dim == 2
             else torch.einsum("nchw,wx->nchx", x, wm))
    return x
