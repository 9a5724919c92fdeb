"""``--cond_in`` (exemplar insertion) of the port's
gen_single_image_diffusion against the JAX script, and the numpy
perspective warp (ops/cv_warp.py) against cv2.

- ``get_perspective_transform`` equals cv2's to 1e-6 (relative);
  ``warp_perspective`` is cv2 5's default float32 INTER_LINEAR path: on
  the random images and corner draws here 99.98 % of the channels are
  exact and none is more than 1 level of 255 off (held: >= 99.9 % exact,
  at most 1 level).
- ``cond_augment`` against the JAX ``_cond_augment`` from one ``random``
  seed (the same draws in the same order; the rotation is PIL in both):
  within 1 level, >= 99 % exact.
- A whole ``--cond_in`` request (y_t, rotation, both warps, keep-ratio)
  through both scripts on a stub model: the conditioning image each hands
  the model agrees to 2 levels of 255 in [-1, 1] (2 / 127.5: a 1-level
  warp difference through the BICUBIC resize), >= 99 % of it exactly.
"""

import importlib.util
import os
import random
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu_torch.ops.cv_warp import (get_perspective_transform,
                                           warp_perspective)
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    path = os.path.join(ROOT, "scripts", "gen_single_image_diffusion.py")
    spec = importlib.util.spec_from_file_location("jax_gen_cond_in", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corners(rng, w, h):
    start = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    end = start.copy()
    d = h * 0.3 * rng.random()
    if rng.random() < 0.5:
        end[1][1] += d
        end[2][1] -= d
    else:
        end[0][1] += d
        end[3][1] -= d
    d = h * 0.3 * rng.random()
    if rng.random() < 0.5:
        end[3][0] += d
        end[2][0] -= d
    else:
        end[0][0] += d
        end[1][0] -= d
    return start, end


def test_warp_matches_cv2():
    rng = np.random.default_rng(0)
    exact = total = 0
    for _ in range(16):
        h, w = (int(v) for v in rng.integers(17, 80, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        start, end = _corners(rng, w, h)
        want_m = cv2.getPerspectiveTransform(start, end)
        m = get_perspective_transform(start, end)
        np.testing.assert_allclose(m, want_m, rtol=1e-6, atol=1e-9)
        want = cv2.warpPerspective(img, want_m, (w, h)).astype(int)
        got = warp_perspective(img, m, (w, h)).astype(int)
        assert np.abs(got - want).max() <= 1
        exact += int((got == want).sum())
        total += got.size
    assert exact / total >= 0.999, exact / total


def test_cond_augment_matches_jax():
    jgen = _jax_script()
    rng = np.random.default_rng(1)
    exact = total = 0
    for seed in range(6):
        sprite = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
        random.seed(seed)
        want = jgen._cond_augment(sprite, 25.0, 0.2, 0.15).astype(int)
        after_jax = random.random()
        random.seed(seed)
        got = gen.cond_augment(sprite, 25.0, 0.2, 0.15).astype(int)
        assert random.random() == after_jax     # the same draws
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1
        exact += int((got == want).sum())
        total += got.size
    assert exact / total >= 0.99, exact / total


class _Stub:
    """A model that records the batch it is asked to serve."""

    def __init__(self, size):
        self.seen = []
        self.generator = torch.Generator()
        self.opt = SimpleNamespace(
            data_crop_size=size, model_type="palette", G_netG="unet_mha",
            alg_diffusion_cond_image_creation="y_t",
            alg_palette_cond_image_creation="y_t")

    def inference(self, batch, **kw):
        self.seen.append(np.array(batch["A"]))
        return np.zeros_like(batch["B"])


@pytest.mark.parametrize("keep_ratio", [False, True])
def test_cond_in_request_matches_jax_script(tmp_path, keep_ratio):
    jgen = _jax_script()
    rng = np.random.default_rng(2)
    size = 32
    Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
        tmp_path / "img.png")
    Image.fromarray(rng.integers(0, 256, (21, 13, 3), dtype=np.uint8)).save(
        tmp_path / "sprite.png")
    m = np.zeros((40, 48), np.uint8)
    m[6:30, 10:20] = 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    argv = ["--model_in_file", "unused", "--img_in", str(tmp_path / "img.png"),
            "--mask_in", str(tmp_path / "mask.png"), "--cond_in",
            str(tmp_path / "sprite.png"), "--cond_rotation", "30",
            "--cond_persp_horizontal", "0.2", "--cond_persp_vertical",
            "0.25", "--seed", "3", "--cpu"] + (
                ["--cond_keep_ratio"] if keep_ratio else [])
    outs = []
    for mod, name in ((jgen, "jax"), (gen, "port")):
        stub = _Stub(size)
        args = mod.build_parser().parse_args(
            argv + ["--dir_out", str(tmp_path / name)])
        mod.inference(args, lmodel=stub, lopt=stub.opt)
        outs.append(stub.seen[0][0])
    want, got = outs
    mask = np.asarray(Image.open(tmp_path / "port" / "img_mask.png")) > 0
    assert mask.any() and not np.array_equal(got[mask], -np.ones_like(
        got[mask]))
    assert np.abs(got - want).max() <= 2 / 127.5 + 1e-6
    assert (np.abs(got - want) < 1e-6).mean() >= 0.99
