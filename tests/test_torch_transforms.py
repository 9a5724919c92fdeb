"""The port's image transforms without cv2 or tifffile
(``joligen_tpu_torch/data/transforms.py``): the numpy 3×3 Gaussian blur
against ``cv2.GaussianBlur(f, (3, 3), 0)``, which the JAX package calls, on
its own and through ``PairedTransform.image`` beside the JAX package's
transform; and the >8-bit read that PIL cannot do raising
``NotImplementedError``.

Tolerance: 1e-4 on the 0-255 float scale for the blur (the two sum the same
three terms in float32, in another order). The transformed images: the
same uint8 levels exactly (the blur's float32 error is far below one level
on these inputs), and 1e-6 after the uint8 -> [-1, 1] step, which the JAX
package may take with its g++ helper, one float32 ulp from numpy's
division (as in tests/test_torch_data.py).
"""

import types

import numpy as np
import pytest
from PIL import Image

from joligen_tpu.data import transforms as jax_transforms
from joligen_tpu_torch.data import transforms

BLUR_SHAPES = [(37, 53, 3), (16, 16), (5, 7, 1), (1, 9, 3), (2, 2, 3),
               (9, 1)]


@pytest.fixture
def cv2():
    return pytest.importorskip(
        "cv2", reason="cv2 is the reference of the numpy blur")


@pytest.mark.parametrize("shape", BLUR_SHAPES)
def test_numpy_blur_matches_cv2(cv2, shape):
    rng = np.random.default_rng(sum(shape))
    f = (rng.random(shape) * 255).astype(np.float32)
    want = cv2.GaussianBlur(f, (3, 3), 0).reshape(shape)
    got = transforms.gaussian_blur3(f)
    assert got.dtype == np.float32 and got.shape == f.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_photometric_blur_matches_the_jax_transform(cv2):
    # the JAX package's PairedTransform.image blurs through cv2; same
    # image, same params, same noise draws on both sides
    rng = np.random.default_rng(11)
    img = Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
    opt = types.SimpleNamespace(data_load_size=40, data_crop_size=32,
                                data_preprocess="resize_and_crop")
    params = {"hflip": False, "vflip": False, "rot90": False, "off_x": 3,
              "off_y": 5, "photo": {"brightness": 0.05, "contrast": 1.1,
                                    "blur": True, "noise": 0.02}}
    outs = []
    for mod in (jax_transforms, transforms):
        np.random.seed(5)
        outs.append(mod.PairedTransform(opt, phase="train").image(img,
                                                                  params))
    want, got = outs
    assert got.dtype == np.float32 and got.shape == (32, 32, 3)
    levels = [np.rint((a + 1.0) * 127.5).astype(np.int32) for a in outs]
    np.testing.assert_array_equal(levels[1], levels[0])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_deep_image_that_pil_cannot_open_raises(monkeypatch, tmp_path):
    path = tmp_path / "rgb16.tif"
    path.write_bytes(b"not an image PIL opens")

    def refuse(*a, **kw):
        raise OSError("cannot identify image file")
    monkeypatch.setattr(transforms.Image, "open", refuse)
    with pytest.raises(NotImplementedError, match="rgb16.tif"):
        transforms.load_image(str(path), img_bits=16)


def test_deep_image_that_pil_opens_keeps_its_mode(tmp_path):
    path = tmp_path / "gray16.png"
    arr = (np.arange(64, dtype=np.uint16) * 1000).reshape(8, 8)
    Image.fromarray(arr).save(path)
    img = transforms.load_image(str(path), img_bits=16)
    assert img.mode.startswith("I")
    np.testing.assert_array_equal(np.asarray(img), arr)
