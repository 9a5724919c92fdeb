"""upfirdn2d (upsample, FIR filter, downsample) and the Haar transform
(``joligen_tpu/ops/upfirdn2d.py``), on NCHW tensors.

``upfirdn2d`` is a zero-stuff to ``h * up`` (trailing zeros after the last
sample, as the reference op and the JAX package's extra pad at
``upfirdn2d.py:54-58`` give), a pad (negative values crop), the flipped
filter as one single-channel ``conv2d`` over the N·C planes, and a stride.
Autograd gives its gradient. Not a depthwise ``conv2d(groups=C)``: PyTorch
runs that one's double backward group by group, C convolutions each, which
made MAT's R1 step (a double backward through its D's blurs) 13.8 s
against 0.85 s this way on an NVIDIA H100 (``PERF.md`` §6). The
``basic`` discriminator reaches it through ``blur_pool``
(``models/modules/discriminators.py``); ``freq_space`` options through the
Haar pair.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def setup_filter(f, normalize=True, gain=1.0):
    """2D FIR table (fp32) from a 1D or 2D spec, e.g. ``[1, 3, 3, 1]``."""
    if f is None:
        f = 1.0
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = np.outer(f, f)
    assert f.ndim == 2
    if normalize:
        f = f / f.sum()
    return torch.from_numpy(np.ascontiguousarray(f * gain, np.float32))


def upfirdn2d(x, f, up=1, down=1, padding=(0, 0, 0, 0), gain=1.0):
    """x: (N, C, H, W); f: (fh, fw) filter. ``padding`` is (left, right,
    top, bottom) on the zero-stuffed image."""
    up = (up, up) if isinstance(up, int) else tuple(up)
    down = (down, down) if isinstance(down, int) else tuple(down)
    padx0, padx1, pady0, pady1 = padding
    n, c, h, w = x.shape
    x = x.reshape(n * c, 1, h, w)
    if up != (1, 1):
        z = x.new_zeros(n * c, 1, h * up[0], w * up[1])
        z[:, :, ::up[0], ::up[1]] = x
        x = z
    x = F.pad(x, (padx0, padx1, pady0, pady1))
    kernel = torch.flip(f, (0, 1)).to(device=x.device, dtype=x.dtype)
    kernel = kernel * (gain * up[0] * up[1])
    y = F.conv2d(x, kernel[None, None], stride=down)
    return y.reshape(n, c, y.shape[-2], y.shape[-1])


def upsample2d(x, f, up=2, gain=1.0):
    """Antialiased ``up``x upsampling."""
    p = f.shape[0] - up
    return upfirdn2d(x, f, up=up,
                     padding=((p + 1) // 2 + up - 1, p // 2,
                              (p + 1) // 2 + up - 1, p // 2), gain=gain)


def downsample2d(x, f, down=2, gain=1.0):
    """Antialiased downsampling."""
    p = f.shape[0] - down
    return upfirdn2d(x, f, down=down,
                     padding=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2),
                     gain=gain)


def _haar_filters():
    ll = np.array([[0.5, 0.5], [0.5, 0.5]], dtype=np.float32)
    lh = np.array([[-0.5, -0.5], [0.5, 0.5]], dtype=np.float32)
    hl = np.array([[-0.5, 0.5], [-0.5, 0.5]], dtype=np.float32)
    hh = np.array([[0.5, -0.5], [-0.5, 0.5]], dtype=np.float32)
    return [torch.from_numpy(f) for f in (ll, lh, hl, hh)]


def haar_transform(x):
    """(N, C, H, W) -> (N, 4C, H/2, W/2): the LL, LH, HL, HH bands."""
    return torch.cat([upfirdn2d(x, f, down=2, padding=(0, 1, 0, 1))
                      for f in _haar_filters()], dim=1)


def inverse_haar_transform(x):
    """Inverse of ``haar_transform`` (an exact round trip)."""
    c = x.shape[1] // 4
    ll_f, lh_f, hl_f, hh_f = _haar_filters()
    out = 0.0
    for i, f in enumerate((ll_f, -lh_f, -hl_f, hh_f)):
        out = out + upfirdn2d(x[:, i * c:(i + 1) * c], f, up=2,
                              padding=(1, 0, 1, 0))
    return out * 0.25

