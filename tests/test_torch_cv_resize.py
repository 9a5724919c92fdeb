"""The port's numpy resizes of the ``low_res`` conditioning
(joligen_tpu_torch/ops/cv_resize) against ``cv2.resize``: INTER_AREA at an
integer factor and INTER_CUBIC up and down, on float32 (H, W, C) images, to
1e-5 (abs)."""

import cv2
import numpy as np
import pytest

from joligen_tpu_torch.ops.cv_resize import resize_area, resize_cubic

TOL = 1e-5


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _cv(x, size, interpolation):
    out = cv2.resize(x, size, interpolation=interpolation)
    return out[..., None] if out.ndim == 2 else out


@pytest.mark.parametrize("shape,factor", [((128, 128, 3), 4),
                                          ((64, 32, 3), 2),
                                          ((48, 96, 1), 4),
                                          ((30, 45, 3), 3),
                                          ((16, 16, 3), 1)])
def test_resize_area_matches_cv2(shape, factor):
    x = _img(shape, sum(shape))
    h, w = shape[:2]
    got = resize_area(x, factor)
    want = _cv(x, (w // factor, h // factor), cv2.INTER_AREA)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_resize_area_refuses_a_factor_that_does_not_divide():
    with pytest.raises(ValueError, match=r"\(30, 45\)"):
        resize_area(_img((30, 45, 3), 0), 4)


@pytest.mark.parametrize("shape,size", [((32, 32, 3), (128, 128)),
                                        ((17, 23, 3), (50, 64)),
                                        ((40, 40, 3), (20, 30)),
                                        ((8, 12, 1), (12, 8)),
                                        ((7, 9, 3), (9, 7))])
def test_resize_cubic_matches_cv2(shape, size):
    x = _img(shape, sum(shape) + 1)
    got = resize_cubic(x, size)
    want = _cv(x, size, cv2.INTER_CUBIC)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_low_res_chain_matches_cv2():
    """The conditioning of a super-resolution config at scale 4."""
    x = _img((128, 128, 3), 9)
    want = _cv(_cv(x, (32, 32), cv2.INTER_AREA), (128, 128),
               cv2.INTER_CUBIC)
    np.testing.assert_allclose(resize_cubic(resize_area(x, 4), (128, 128)),
                               want, atol=TOL, rtol=0)
