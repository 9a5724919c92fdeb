"""The port's online bbox-crop engine (joligen_tpu_torch/data/online_creation)
against the JAX package's (joligen_tpu/data/online_creation): ``crop_image``
of both on the same files with ``random.Random(seed)`` over a grid of its
options, and the helpers around it. Tolerance: none; every output is equal
exactly (crop pixels, mask, ref bbox, category, meta)."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from joligen_tpu.data import online_creation as joc
from joligen_tpu_torch.data import online_creation as toc

W, H = 96, 80
BOXES = ["1 10 12 30 28", "2 50 40 70 70", "1 60 5 90 25"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("online")
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
        d / "img.png")
    (d / "img.txt").write_text("\n".join(BOXES) + "\n")
    (d / "one.txt").write_text(BOXES[1] + "\n")
    return str(d / "img.png"), str(d / "img.txt"), str(d / "one.txt")


BASE = dict(crop_dim=40, output_dim=32, crop_delta=6)
CASES = {
    "plain": {},
    "mask_delta": dict(mask_delta=[[3], [2, 4]]),
    "mask_delta_ratio": dict(mask_delta_ratio=[[0.2], [0.1, 0.3]]),
    "random_offset": dict(mask_random_offset=[0.3, 0.1]),
    "square": dict(mask_square=True),
    "no_crop_delta": dict(crop_delta=0),
    "context": dict(context_pixels=4),
    "load_size": dict(load_size=[120, 100]),
    "load_size_keep_ratio": dict(load_size=[128], load_size_keep_ratio=True,
                                 mask_delta=[[2]], fixed_mask_size=10),
    "rotation": dict(rotation_state={"angle": 12.0,
                                     "rebox_mask_after_rotation": False}),
    "rotation_rebox": dict(rotation_state={"angle": -20.0,
                                           "rebox_mask_after_rotation": True},
                           crop_dim=24),
    "broaden": dict(broaden_rect_aug=True),
    "single_bbox": dict(single_bbox=True),
    "bbox_ref_id": dict(bbox_ref_id=1),
    "select_cat": dict(select_cat=2),
    "fixed_mask_size": dict(fixed_mask_size=12),
    "fixed_mask_size_model": dict(fixed_mask_size_model=10,
                                  fixed_mask_min_unmasked_border_model=3),
    "border_only": dict(fixed_mask_min_unmasked_border_model=6),
    "min_crop_bbox_ratio": dict(min_crop_bbox_ratio=2.5),
    "crop_center": dict(crop_center=True),
    "inverted": dict(inverted_mask=True, override_class=3),
    "return_meta": dict(return_meta=True, rotation_state={"angle": 5.0}),
    "crop_coordinates": dict(crop_coordinates=(20, 10, 36)),
    "get_crop_coordinates": dict(get_crop_coordinates=True),
}


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


class Refused(str):
    """The message of a ValueError that ``crop_image`` raised."""


def _outcome(mod, *args, **kw):
    """The result of ``mod.crop_image``, or the error it raised: a rotated
    window that only holds fill pixels is refused by both packages."""
    try:
        return mod.crop_image(*args, **kw)
    except ValueError as e:
        return Refused(e)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_image_matches_jax(files, case, seed):
    img, bbox, _ = files
    kw = dict(BASE, **CASES[case])
    outs = [_outcome(mod, img, bbox, rng=random.Random(seed), **kw)
            for mod in (joc, toc)]
    _equal(*outs)
    if isinstance(outs[1], Refused):
        assert "rotation_state" in kw      # only a rotated frame may refuse
    elif not kw.get("get_crop_coordinates"):
        crop, mask = outs[1][:2]
        assert crop.shape[:2] == mask.shape[:2] == (32 + 2 * kw.get(
            "context_pixels", 0),) * 2
        assert mask.max() > 0


@pytest.mark.parametrize("case", ["rotation", "rotation_rebox"])
def test_rotated_crops_are_cut(files, case):
    """Some seeds of each rotation case give a crop, not a refusal."""
    img, bbox, _ = files
    kw = dict(BASE, **CASES[case])
    cut = [out for out in (_outcome(toc, img, bbox, rng=random.Random(seed),
                                    **kw) for seed in range(6))
           if not isinstance(out, Refused)]
    assert cut


def test_crop_image_draws_from_the_random_module(files):
    """Without ``rng`` both draw from ``random``, in the same order, and
    leave it in the same state."""
    img, bbox, _ = files
    outs, states = [], []
    for mod in (joc, toc):
        random.seed(3)
        outs.append(mod.crop_image(img, bbox, mask_random_offset=[0.2],
                                   broaden_rect_aug=True, **BASE))
        states.append(random.random())
    _equal(*outs)
    assert states[0] == states[1]


def test_random_bbox_without_a_file(files):
    img, _, _ = files
    outs = [mod.crop_image(img, None, random_bbox=True,
                           rng=random.Random(4), **BASE)
            for mod in (joc, toc)]
    _equal(*outs)


def test_helpers_match_jax(files, tmp_path):
    img, bbox, one = files
    _equal(joc.read_bbox_file(bbox), toc.read_bbox_file(bbox))
    boxes = np.asarray([[10, 12, 30, 28], [50, 40, 70, 70]], np.float64)
    for angle in (7.5, -33.0, 90.0):
        _equal(joc._rotate_bboxes_expand(boxes, W, H, angle),
               toc._rotate_bboxes_expand(boxes, W, H, angle))
    for seed in range(8):
        _equal(joc._broaden_rect(10, 12, 30, 28, W, H, random.Random(seed)),
               toc._broaden_rect(10, 12, 30, 28, W, H, random.Random(seed)))
    for cat in (1, 2, 5):
        assert joc._delta_for_cat([[3], [2, 4]], cat) == \
            toc._delta_for_cat([[3], [2, 4]], cat)

    class Opt:
        dataaug_no_rotate = False
        data_online_creation_rotate_before_crop = True
        data_online_creation_rotate_max_angle = 15.0
        data_online_creation_rotate_rebox_mask_after_rotation = True
        data_dataset_mode = "self_supervised_labeled_mask_online"
    assert toc.rotation_enabled(Opt) and joc.rotation_enabled(Opt)
    _equal(joc.sample_rotation_state(Opt, random.Random(2)),
           toc.sample_rotation_state(Opt, random.Random(2)))
    Opt.data_dataset_mode = "self_supervised_labeled_mask"
    assert toc.sample_rotation_state(Opt) is None
    (tmp_path / "bad.txt").write_text("not a box\n")
    paths = ([img, img, os.path.join(str(tmp_path), "missing.png")],
             [bbox, str(tmp_path / "bad.txt"), one])
    _equal(joc.sanitize_paths(*paths), toc.sanitize_paths(*paths))
    assert toc.sanitize_paths(*paths) == ([img], [bbox])
