"""Host-side image helpers copied from ``joligen_tpu/data/transforms.py``."""

from __future__ import annotations

import numpy as np


def fill_mask_with_random(img, mask, cls=-1):
    """Replace pixels of class ``cls`` (-1 = any nonzero) with U[-1,1] noise
    (reference data/online_creation.py:1366-1385)."""
    sel = (mask[..., 0] > 0) if cls == -1 else (mask[..., 0] == cls)
    noise = np.random.uniform(-1.0, 1.0, img.shape).astype(img.dtype)
    out = img.copy()
    out[sel] = noise[sel]
    return out
