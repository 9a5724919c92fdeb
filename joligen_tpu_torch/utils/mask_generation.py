"""Conditioning sketch fillers: the canny path of
``joligen_tpu/utils/mask_generation.py`` (``_to_uint8``, ``_from_uint8``,
``_compose``, ``fill_img_with_canny`` and ``random_edge_mask``), copied.

The JAX package calls ``cv2.Canny``; the port has its own ``canny`` in numpy,
which equals it bit for bit (``tests/test_torch_mask_generation.py`` holds
the two together). The other sketch fillers (``sketch``, ``hed``, ``depth``,
``hough``, ``sam``) run frozen nets whose weights are not in the repository
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import random

import numpy as np

# tan(22.5°) in Q15, cv2's fixed point for the direction of the gradient
TG22 = 13573


def _to_uint8(img):
    """[-1,1] float (H,W,C) -> uint8 (H,W,C)."""
    return ((np.asarray(img) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def _from_uint8(img):
    return img.astype(np.float32) / 127.5 - 1.0


def _compose(img, cond, mask, select_mask):
    img = np.asarray(img, np.float32)
    if not select_mask or mask is None:
        return cond.astype(np.float32)
    m = (np.asarray(mask).astype(np.float32) > 0).astype(np.float32)
    if m.ndim == 2:
        m = m[:, :, None]
    return (img * (1.0 - m) + cond * m).astype(np.float32)


def _sobel3(u8):
    """cv2's 3×3 Sobel dx and dy with replicated borders, int32 (H,W,C)."""
    p = np.pad(u8.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    smooth_v = p[:-2] + 2 * p[1:-1] + p[2:]            # (H, W+2, C)
    smooth_h = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]   # (H+2, W, C)
    return smooth_v[:, 2:] - smooth_v[:, :-2], smooth_h[2:] - smooth_h[:-2]


def _hysteresis(cand, strong):
    """The candidates 8-connected (through candidates) to a strong pixel:
    labels over the candidate graph by hooking and pointer jumping, a few
    whole-array passes however long an edge runs."""
    h, w = cand.shape
    label = np.arange(h * w)
    c = np.pad(cand, 1)
    pairs = []
    for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
        both = c[1:-1, 1:-1] & c[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
        ys, xs = np.nonzero(both)
        pairs.append((ys * w + xs, (ys + dy) * w + xs + dx))
    a = np.concatenate([p[0] for p in pairs])
    b = np.concatenate([p[1] for p in pairs])
    while a.size:
        la, lb = label[a], label[b]
        if np.array_equal(la, lb):
            break
        low = np.minimum(la, lb)
        np.minimum.at(label, la, low)
        np.minimum.at(label, lb, low)
        while True:                      # every label onto its root
            jumped = label[label]
            if np.array_equal(jumped, label):
                break
            label = jumped
    reached = np.zeros(h * w, bool)
    reached[label[strong.ravel()]] = True
    return cand & reached[label].reshape(h, w)


def canny(u8, low_threshold, high_threshold):
    """``cv2.Canny(u8, low_threshold, high_threshold)`` (aperture 3, L1
    gradient) on a uint8 (H,W) or (H,W,C) image: 255 on edges, 0 elsewhere,
    uint8 (H,W).

    - a 3×3 Sobel with replicated borders; with several channels each pixel
      takes the dx, dy of the channel whose |dx|+|dy| is largest (the first
      one on a tie);
    - thresholds swapped when low > high, then floored;
    - non-maximum suppression in cv2's fixed point over the L1 magnitude
      (0 outside the image): horizontal where |dy|·2¹⁵ < |dx|·TG22, vertical
      where it exceeds |dx|·TG22 + |dx|·2¹⁶, else diagonal on the side of the
      sign of dx·dy; ``>`` against the previous neighbour and ``>=`` against
      the next on the horizontal and vertical axes, ``>`` on both diagonals;
    - hysteresis: a surviving pixel above ``low`` is an edge when it is
      8-connected through such pixels to one above ``high``.
    """
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise ValueError(f"canny takes uint8, got {u8.dtype}")
    if u8.ndim == 2:
        u8 = u8[:, :, None]
    if low_threshold > high_threshold:
        low_threshold, high_threshold = high_threshold, low_threshold
    low, high = int(np.floor(low_threshold)), int(np.floor(high_threshold))
    dx, dy = _sobel3(u8)
    mag = np.abs(dx) + np.abs(dy)
    best = np.argmax(mag, axis=-1)[..., None]           # first max wins
    dx = np.take_along_axis(dx, best, -1)[..., 0]
    dy = np.take_along_axis(dy, best, -1)[..., 0]
    mag = np.take_along_axis(mag, best, -1)[..., 0]
    h, w = mag.shape

    m = np.pad(mag, 1)

    def at(oy, ox):
        return m[1 + oy:h + 1 + oy, 1 + ox:w + 1 + ox]

    ax = np.abs(dx).astype(np.int64)
    ay = np.abs(dy).astype(np.int64) << 15
    tg22x = ax * TG22
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << 16))
    diagonal = ~horizontal & ~vertical
    s = np.where((dx ^ dy) < 0, -1, 1)
    peak = np.where(horizontal, (mag > at(0, -1)) & (mag >= at(0, 1)), False)
    peak |= vertical & (mag > at(-1, 0)) & (mag >= at(1, 0))
    # diagonal: the previous row at j - s, the next at j + s
    diag = np.where(s > 0, (mag > at(-1, -1)) & (mag > at(1, 1)),
                    (mag > at(-1, 1)) & (mag > at(1, -1)))
    peak |= diagonal & diag
    cand = peak & (mag > low)
    edges = _hysteresis(cand, cand & (mag > high))
    return edges.astype(np.uint8) * 255


def fill_img_with_canny(img, mask, low_threshold=None, high_threshold=None,
                        low_threshold_random=-1, high_threshold_random=-1,
                        select_mask=True, rng=None):
    """Replace masked pixels with the canny edge map (white edges on black);
    random thresholds drawn per call when the *_random bounds are given
    (reference util/mask_generation.py fill_img_with_canny)."""
    rng = rng or random
    max_value = 255 * 3
    if high_threshold is None and low_threshold is None:
        if high_threshold_random != -1 and low_threshold_random != -1:
            high_threshold = rng.randint(low_threshold_random,
                                         high_threshold_random)
            low_threshold = rng.randint(low_threshold_random, high_threshold)
        else:
            high_threshold = max_value
            low_threshold = rng.randint(0, max_value)
    elif high_threshold is None:
        high_threshold = max_value
    elif low_threshold is None:
        low_threshold = 0

    u8 = _to_uint8(img)
    edges = canny(u8, low_threshold, high_threshold)
    edges3 = np.repeat(edges[:, :, None], u8.shape[-1], axis=2)
    sketch = _from_uint8(edges3)
    return _compose(img, sketch, mask, select_mask)


def _needs_weights(kind):
    def fill(img, mask, **kw):
        raise NotImplementedError(
            f"{kind} sketch conditioning needs frozen-net weights that are "
            "not in the repository (ROADMAP Queue 1 item 14, metrics and "
            "frozen nets)")
    fill.__name__ = f"fill_img_with_{kind}"
    return fill


EDGE_FILLERS = {
    "canny": fill_img_with_canny,
    **{kind: _needs_weights(kind)
       for kind in ("sketch", "hed", "depth", "hough", "sam")},
}


def random_edge_mask(fn_list, img, mask, rng=None, opt=None, **kw):
    """Pick one conditioning filler at random (reference random_edge_mask);
    the draw comes first, as in the JAX package, whichever filler it
    picks."""
    rng = rng or random
    fn = EDGE_FILLERS[rng.choice([f for f in fn_list if f in EDGE_FILLERS])]
    if fn is fill_img_with_canny:
        return fn(img, mask, rng=rng, **kw)
    return fn(img, mask, **kw)
