"""The port's data pipeline (joligen_tpu_torch/data) against the JAX
package's (joligen_tpu/data) on a tools/make_fake_dataset.py dataset (the
labeled-mask, aligned and single modes) and on an online bbox-crop dataset
written here (1-3 boxes of two classes an image): item by item, with Python's
``random`` and numpy seeded identically before each side draws its crop,
flips and fills; then the port's threaded loader's batches.

Tolerance: images 1e-6 (the JAX package may normalise uint8 -> [-1, 1] with
its g++ helper, a multiply by the reciprocal, one float32 ulp from the
port's division); masks, classes and paths exactly.
"""

import os
import random
import sys

import numpy as np
import pytest

from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.data import (PORTED_MODES, create_dataloader,
                                    create_dataset,
                                    find_dataset_class)
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.tools.synthetic_datasets import WRITERS, write_online

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.make_fake_dataset import make  # noqa: E402


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("fakeds")
    make(str(root), n=8, size=40, nclasses=2, seed=3)
    return str(root)


@pytest.fixture(scope="module")
def online_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("onlineds")
    write_online(str(root), 8, 48, seed=5, domains=("A", "B"))
    return str(root)


def _cfg(root, mode, rand_fill):
    oc = {"rand_mask_A": rand_fill}
    if "online" in mode:
        for d in "AB":
            oc.update({f"crop_size_{d}": 32, f"crop_delta_{d}": 4,
                       f"mask_delta_{d}": [[2], [1]],
                       f"mask_random_offset_{d}": [0.1]})
    return {"model_type": "palette", "dataroot": root,
            "data": {"dataset_mode": mode, "load_size": 40, "crop_size": 32,
                     "relative_paths": True, "online_creation": oc},
            "train": {"batch_size": 3}}


@pytest.mark.parametrize("mode,rand_fill", [
    ("self_supervised_labeled_mask", False),
    ("self_supervised_labeled_mask", True),
    ("self_supervised_labeled_mask_cls", False),
    ("unaligned_labeled_mask", False),
    ("self_supervised_labeled_mask_online", True),
    ("self_supervised_labeled_mask_cls_online", False),
    ("unaligned_labeled_mask_online", False),
    ("unaligned_labeled_mask_cls_online", True),
    ("aligned", False),
    ("single", False)])
def test_items_match_jax_dataset(dataroot, online_root, mode, rand_fill):
    # the labeled-mask modes read make_fake_dataset's layout; the others
    # the one written here (whose image folders hold only the images)
    own = "online" in mode or mode in ("aligned", "single")
    cfg = _cfg(online_root if own else dataroot, mode, rand_fill)
    jds = jax_create_dataset(JaxTrainOptions().parse_json(cfg, verbose=False))
    tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False))
    assert len(tds) == len(jds) == 8
    for i in range(len(tds)):
        items = []
        for ds in (jds, tds):
            random.seed(100 + i)
            np.random.seed(100 + i)
            items.append(ds[i])
        want, got = items
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            if isinstance(w, np.ndarray) and w.dtype == np.float32:
                assert g.dtype == np.float32 and g.shape == w.shape
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                           err_msg=k)
            elif isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                assert g == w, k


def test_loader_yields_full_batches(dataroot):
    opt = TrainOptions().parse_json(
        _cfg(dataroot, "self_supervised_labeled_mask", False), verbose=False)
    loader = create_dataloader(opt, create_dataset(opt))
    assert len(loader) == 8 // 3
    batches = list(loader)
    assert len(batches) == 2
    for b in batches:
        assert {"A", "B", "B_label_mask", "B_label_cls",
                "A_label_mask"} <= set(b)
        assert b["A"].shape == b["B"].shape == (3, 32, 32, 3)
        assert b["A"].dtype == b["B"].dtype == np.float32
        assert b["B_label_mask"].shape == (3, 32, 32, 1)
        assert b["B_label_mask"].dtype == np.int32
        assert b["B_label_cls"].shape == (3,)
        assert b["B_label_cls"].dtype == np.int32
        assert len(b["B_img_paths"]) == 3
        assert np.abs(b["A"]).max() <= 1.0
        # the self-supervised A is B with the masked region filled
        keep = b["B_label_mask"][..., 0] == 0
        np.testing.assert_array_equal(b["A"][keep], b["B"][keep])


@pytest.mark.parametrize("mode,nclasses", [("unaligned_labeled_cls", 3),
                                           ("unaligned_labeled_mask_cls", 2)])
def test_cls_layouts_match_jax_dataset(tmp_path, mode, nclasses):
    """``synthetic_datasets``' class layouts ('img cls', 'img cls mask')
    through both packages' datasets, item for item: the class labels of
    both domains, no label mask in ``unaligned_labeled_cls``."""
    root = str(tmp_path / mode)
    WRITERS[mode](root, 6, 40, seed=4, nclasses=nclasses)
    cfg = _cfg(root, mode, False)
    jds = jax_create_dataset(JaxTrainOptions().parse_json(cfg, verbose=False))
    tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False))
    assert len(tds) == len(jds) == 6
    classes = set()
    for i in range(len(tds)):
        items = []
        for ds in (jds, tds):
            random.seed(200 + i)
            np.random.seed(200 + i)
            items.append(ds[i])
        want, got = items
        assert sorted(got) == sorted(want)
        assert ("A_label_mask" in got) == (mode != "unaligned_labeled_cls")
        for k, w in want.items():
            if isinstance(w, np.ndarray) and w.dtype == np.float32:
                np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0)
            elif isinstance(w, np.ndarray):
                assert got[k].dtype == w.dtype
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                assert got[k] == w, k
        classes |= {int(got["A_label_cls"]), int(got["B_label_cls"])}
    assert classes == set(range(nclasses))


def test_unported_modes_raise(dataroot):
    """Every mode of the JAX table is ported; a mode outside it raises."""
    from joligen_tpu.data import find_dataset_class as jax_find

    for mode in ("self_supervised_labeled_mask", "unaligned", "colorization",
                 "multi_dataset", "self_supervised_temporal",
                 "unaligned_labeled_mask_online_prompt"):
        assert mode in PORTED_MODES
    for mode in PORTED_MODES:
        assert jax_find(mode).__name__ == find_dataset_class(mode).__name__
    opt = TrainOptions().parse_json(_cfg(dataroot, "colorization",
                                         False), verbose=False)
    opt.data_dataset_mode = "no_such_mode"
    with pytest.raises(NotImplementedError, match="not ported"):
        create_dataset(opt)


def test_online_loader_batches(online_root):
    """The online mode's batches: crops of the output size, the label mask
    of both classes, and A equal to B outside the mask."""
    opt = TrainOptions().parse_json(
        _cfg(online_root, "self_supervised_labeled_mask_cls_online", True),
        verbose=False)
    random.seed(0)
    np.random.seed(0)
    batches = list(create_dataloader(opt, create_dataset(opt)))
    assert len(batches) == 2
    classes = set()
    for b in batches:
        assert b["A"].shape == b["B"].shape == (3, 32, 32, 3)
        assert b["B_label_mask"].shape == (3, 32, 32, 1)
        assert b["A_ref_bbox"].shape == (3, 4)
        keep = b["B_label_mask"][..., 0] == 0
        np.testing.assert_array_equal(b["A"][keep], b["B"][keep])
        classes |= set(np.unique(b["B_label_mask"]).tolist())
        assert set(b["B_label_cls"].tolist()) <= {1, 2}
    assert classes == {0, 1, 2}


def test_refined_mask_raises(online_root):
    opt = TrainOptions().parse_json(
        _cfg(online_root, "self_supervised_labeled_mask_online", True),
        verbose=False)
    opt.data_refined_mask = True
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        create_dataset(opt)
