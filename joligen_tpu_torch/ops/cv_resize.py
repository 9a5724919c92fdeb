"""The two ``cv2.resize`` calls of the ``low_res`` conditioning
(``joligen_tpu/models/palette_model.py:152-166``) in numpy, on float32
(H, W, C) images: ``resize_area`` for INTER_AREA at an integer factor, then
``resize_cubic`` for INTER_CUBIC. ``tests/test_torch_cv_resize.py`` holds
both against cv2 to 1e-5."""

from __future__ import annotations

import numpy as np

CUBIC_A = np.float32(-0.75)


def resize_area(x, factor):
    """INTER_AREA downscale by an integer ``factor`` dividing H and W: the
    block mean of cv2's fast area path (the block's sum times 1/factor²)."""
    x = np.asarray(x, np.float32)
    h, w = x.shape[:2]
    if factor < 1 or h % factor or w % factor:
        raise ValueError(f"resize_area: factor {factor} does not divide the "
                         f"image shape {x.shape[:2]}")
    blocks = x.reshape(h // factor, factor, w // factor, factor, -1)
    out = blocks.sum(axis=(1, 3), dtype=np.float32) * np.float32(
        1.0 / (factor * factor))
    return out.reshape((h // factor, w // factor) + x.shape[2:])


def _cubic_taps(n_in, n_out):
    """Source indices (n_out, 4), clamped to the image, and their float32
    weights for INTER_CUBIC: source coordinate (x + 0.5)·scale − 0.5, its
    floor's four neighbours weighted by cv2's cubic with A = −0.75."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    base = np.floor(f).astype(np.int64)
    t = (f - base).astype(np.float32)
    a, one = CUBIC_A, np.float32(1.0)
    t1, u = t + one, one - t
    w0 = ((a * t1 - 5 * a) * t1 + 8 * a) * t1 - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + one
    w2 = ((a + 2) * u - (a + 3)) * u * u + one
    w3 = one - w0 - w1 - w2
    idx = np.clip(base[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, np.stack([w0, w1, w2, w3], axis=1).astype(np.float32)


def resize_cubic(x, size):
    """INTER_CUBIC resize of a float32 (H, W, C) image to ``size`` = (width,
    height), cv2's argument order: the horizontal pass, then the vertical
    one, each a float32 sum of four weighted taps."""
    x = np.asarray(x, np.float32)
    out_w, out_h = size
    xi, xw = _cubic_taps(x.shape[1], out_w)
    yi, yw = _cubic_taps(x.shape[0], out_h)
    rows = np.zeros((x.shape[0], out_w) + x.shape[2:], np.float32)
    for j in range(4):
        rows += x[:, xi[:, j]] * xw[:, j].reshape((1, -1) + (1,) * (
            x.ndim - 2))
    out = np.zeros((out_h, out_w) + x.shape[2:], np.float32)
    for j in range(4):
        out += rows[yi[:, j]] * yw[:, j].reshape((-1,) + (1,) * (x.ndim - 1))
    return out
