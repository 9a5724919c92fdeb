"""Integer-factor nearest upsampling (``joligen_tpu/ops/resize.py``)."""

from __future__ import annotations


def nearest_up2(x):
    """(B, H, W, C) -> (B, 2H, 2W, C) nearest-neighbour upsample."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)
