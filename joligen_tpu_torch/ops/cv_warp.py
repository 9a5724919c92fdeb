"""The perspective warp of ``--cond_in``'s exemplar augmentation
(``scripts/gen_single_image_diffusion.py:74-107``) in numpy:
``get_perspective_transform`` is ``cv2.getPerspectiveTransform`` (the 8×8
linear system of the four point pairs, solved in float64) and
``warp_perspective`` is ``cv2.warpPerspective`` on uint8 images with
``INTER_LINEAR`` and a constant 0 border as OpenCV 5 computes it by
default (``ALGO_HINT_ACCURATE``): the matrix inverted in float64 and cast
to float32, each output pixel's source position in float32, its 2×2
neighbourhood (a neighbour outside the image reads 0) interpolated in
float32 by the position's fractions, the result rounded to 8 bits.
``tests/test_torch_cond_in.py`` holds it against cv2 (OpenCV's older fixed
point path, 1/32 px positions and weights of 2^15, differs from both by up
to 6 levels)."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def get_perspective_transform(src, dst):
    """The 3×3 homography mapping the four points ``src`` to ``dst`` (each
    (4, 2)), its last entry 1."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def warp_perspective(img, m, size):
    """``img`` (H, W[, C]) uint8 warped by the homography ``m`` (source ->
    destination) into ``size`` = (width, height)."""
    img = np.asarray(img, np.uint8)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w = img.shape[:2]
    ow, oh = size
    inv = np.linalg.inv(np.asarray(m, np.float64)).astype(F32).ravel()
    ys, xs = np.mgrid[0:oh, 0:ow].astype(F32)
    wgt = inv[6] * xs + inv[7] * ys + inv[8]
    sx = (inv[0] * xs + inv[1] * ys + inv[2]) / wgt
    sy = (inv[3] * xs + inv[4] * ys + inv[5]) / wgt
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def tap(dy, dx):
        px, py = ix + dx, iy + dy
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        v = img[np.clip(py, 0, h - 1), np.clip(px, 0, w - 1)].astype(F32)
        return np.where(inside[..., None], v, F32(0))
    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = p00 + ax * (p01 - p00)
    bottom = p10 + ax * (p11 - p10)
    out = np.clip(np.rint(top + ay * (bottom - top)), 0, 255).astype(np.uint8)
    return out[:, :, 0] if squeeze else out
