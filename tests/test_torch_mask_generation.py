"""The port's canny sketch (joligen_tpu_torch/utils/mask_generation) against
cv2 and the JAX package: ``canny`` equals ``cv2.Canny`` bit for bit on
random, flat and structured uint8 images of 1 and 3 channels and on
threshold pairs that include low > high, fractional and equal ones;
``fill_img_with_canny`` and ``random_edge_mask`` equal the JAX ones under the
same seed exactly. The fillers that need frozen-net weights raise."""

import random

import cv2
import numpy as np
import pytest

from joligen_tpu.utils import mask_generation as jmg
from joligen_tpu_torch.utils import mask_generation as tmg

THRESHOLDS = [(100, 400), (50, 150), (400, 100), (0, 765), (10.7, 30.2),
              (200, 200), (0, 0)]


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    h, w, c = shape
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "flat":
        img = np.full(shape, 77, np.uint8)
        img[h // 4:h // 2, w // 3:] = 200         # one step edge
        return img
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(xx / 3.0 + k) * 100 + yy * 2 + 40 * k
                    for k in range(c)], -1)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("kind", ["random", "flat", "structured"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", [(5, 7), (37, 64), (128, 128)])
def test_canny_equals_cv2_bit_for_bit(kind, channels, shape):
    img = _image(kind, shape + (channels,), seed=sum(shape) + channels)
    if channels == 1:
        img = np.ascontiguousarray(img[..., 0])
    for lo, hi in THRESHOLDS:
        want = cv2.Canny(img, lo, hi)
        got = tmg.canny(img, lo, hi)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (kind, channels, shape, lo, hi)


def test_canny_finds_long_connected_edges():
    """Hysteresis carries a weak edge along its whole length from one
    strong pixel: a faint spiral with one bright end."""
    img = np.zeros((96, 96), np.uint8)
    yy, xx = np.mgrid[0:96, 0:96]
    r = np.hypot(yy - 48, xx - 48)
    img[(np.sin(r / 3.0 + np.arctan2(yy - 48, xx - 48)) > 0)] = 40
    img[40:56, 2:10] = 255
    want = cv2.Canny(img, 60, 700)
    assert want.sum() > 0
    assert np.array_equal(tmg.canny(img, 60, 700), want)


def _gt_and_mask(seed, size=32):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (size, size, 3)).astype(np.float32)
    gt[8:20, 4:28] = 0.6
    mask = np.zeros((size, size, 1), np.int32)
    mask[6:26, 2:30] = 1
    return gt, mask


@pytest.mark.parametrize("kw", [
    dict(low_threshold_random=100, high_threshold_random=400),
    dict(low_threshold=20, high_threshold=120),
    dict(high_threshold=300), dict(low_threshold=50), {},
    dict(select_mask=False, low_threshold_random=0,
         high_threshold_random=765)])
def test_fill_img_with_canny_matches_jax(kw):
    gt, mask = _gt_and_mask(1)
    outs = [mod.fill_img_with_canny(gt, mask, rng=random.Random(5), **kw)
            for mod in (jmg, tmg)]
    assert outs[1].dtype == np.float32
    np.testing.assert_array_equal(outs[1], outs[0])
    keep = mask[..., 0] == 0
    if kw.get("select_mask", True):
        np.testing.assert_array_equal(outs[1][keep], gt[keep])
    assert set(np.unique(outs[1][~keep])) <= {-1.0, 1.0}


def test_random_edge_mask_matches_jax_draw_for_draw():
    for seed in range(4):
        gt, mask = _gt_and_mask(seed)
        outs, after = [], []
        for mod in (jmg, tmg):
            random.seed(seed)
            outs.append(mod.random_edge_mask(
                ["canny", "not_a_filler"], gt, mask,
                low_threshold_random=100, high_threshold_random=400))
            after.append(random.random())
        np.testing.assert_array_equal(outs[1], outs[0])
        assert after[0] == after[1]


@pytest.mark.parametrize("kind", ["sketch", "hed", "depth", "hough", "sam"])
def test_fillers_needing_weights_raise(kind):
    gt, mask = _gt_and_mask(0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tmg.random_edge_mask([kind], gt, mask)
