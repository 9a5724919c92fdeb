"""The last four dataset modes of the port (joligen_tpu_torch/data/
datasets.py) against the JAX package's, sample by sample, from the same
``random`` and ``np.random`` seeds: ``self_supervised_temporal`` (next-frame
pairs over the online video layout), ``unaligned_labeled_mask_online_prompt``
(``real_B_prompt`` from trainB/prompts.txt), ``colorization`` (cv2's 8-bit
Lab: the port's integer path equals cv2 on every colour tried; the samples
to 2 levels, 2 / 127.5: the transform's float output, 1 ulp off in
places, truncates to uint8 a level apart; >= 90 % exact) and
``multi_dataset`` (both schemas, the test_sets lookup under both key
spellings, the crop-delta scale, weighted sampling, the refusal to
nest). Float images to 1e-6, the rest exactly.
"""

import json
import random

import cv2
import numpy as np
import pytest

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.data import create_dataset
from joligen_tpu_torch.data.datasets import rgb_to_lab_u8
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.tools.synthetic_datasets import (write_online,
                                                        write_single,
                                                        write_test_split,
                                                        write_video)


def _pair(cfg, phase="train", name=""):
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    return (jax_create_dataset(jopt, phase, name),
            create_dataset(TrainOptions().parse_json(cfg, verbose=False),
                           phase, name))


def _same_items(jds, tds, n, seed, atol=1e-6):
    assert len(tds) == len(jds)
    seen = 0
    for i in range(n):
        items = []
        for ds in (jds, tds):
            random.seed(seed + i)
            np.random.seed(seed + 50 + i)
            items.append(ds[i])
        want, got = items
        if want is None:
            assert got is None
            continue
        seen += 1
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            if isinstance(w, np.ndarray) and w.dtype == np.float32:
                assert g.dtype == np.float32 and g.shape == w.shape, k
                np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                           err_msg=k)
            elif isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                assert g == w, k
    return seen


def _online_cfg(root, mode, **extra):
    oc = {}
    for d in "AB":
        oc.update({f"crop_size_{d}": 32, f"crop_delta_{d}": 4})
    cfg = {"model_type": "palette", "dataroot": str(root),
           "data": {"dataset_mode": mode, "load_size": 32, "crop_size": 24,
                    "relative_paths": True, "online_creation": oc},
           "train": {"batch_size": 2}}
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("rand_fill", [True, False])
def test_self_supervised_temporal_matches_jax(tmp_path, rand_fill):
    write_video(str(tmp_path), 6, 40, seed=1, n_series=1, phases=("train",),
                domains=("A", "B"))
    cfg = {"model_type": "palette", "dataroot": str(tmp_path),
           "data": {"dataset_mode": "self_supervised_temporal",
                    "load_size": 16, "crop_size": 16,
                    "relative_paths": True,
                    "temporal": {"number_frames": 2, "frame_step": 1},
                    "online_creation": {"crop_size_A": 24,
                                        "crop_delta_A": 4,
                                        "rand_mask_A": rand_fill}}}
    jds, tds = _pair(cfg)
    assert _same_items(jds, tds, 4, 10) == 4
    random.seed(0)
    np.random.seed(0)
    item = tds[0]
    assert item["A"].shape == item["B"].shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(item["A"][0], item["B"][0])


def test_online_prompt_matches_jax(tmp_path):
    write_online(str(tmp_path), 6, 48, seed=2, domains=("A", "B"))
    with open(tmp_path / "trainB" / "paths.txt") as f:
        imgs = [line.split()[0] for line in f if line.strip()]
    with open(tmp_path / "trainB" / "prompts.txt", "w") as f:
        for i, p in enumerate(imgs[:4]):          # two without a prompt
            f.write(f"{p} a photo of object {i}, on a table\n")
    jds, tds = _pair(_online_cfg(
        tmp_path, "unaligned_labeled_mask_online_prompt"))
    assert _same_items(jds, tds, 6, 20) == 6
    prompts = set()
    for i in range(6):
        random.seed(i)
        np.random.seed(i)
        prompts.add(tds[i]["real_B_prompt"])
    assert "" in prompts and any(p.startswith("a photo") for p in prompts)


def test_colorization_matches_jax(tmp_path):
    write_single(str(tmp_path), 4, 40, seed=3)
    cfg = {"model_type": "palette", "dataroot": str(tmp_path),
           "data": {"dataset_mode": "colorization", "load_size": 40,
                    "crop_size": 32}}
    jds, tds = _pair(cfg)
    # the images before Lab: the transform's float output 1 ulp apart in
    # places, its uint8 truncation then one level apart, which moves a or
    # b by up to 2 levels (2 / 127.5)
    assert _same_items(jds, tds, 4, 30, atol=2 / 127.5 + 1e-6) == 4
    exact = []
    for i in range(4):
        items = []
        for ds in (jds, tds):
            random.seed(30 + i)
            np.random.seed(80 + i)
            items.append(ds[i])
        exact += [np.mean(items[0][k] == items[1][k]) for k in "AB"]
    assert np.mean(exact) >= 0.9, exact
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb_to_lab_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Two online roots of different image sizes; the second with a test
    split."""
    roots = []
    for i, size in enumerate((40, 56)):
        root = tmp_path_factory.mktemp(f"child{i}")
        write_online(str(root), 5 + i, size, seed=10 + i)
        roots.append(root)
    write_test_split("online", str(roots[1]), 3, 56, seed=20)
    return roots


def _multi_cfg(tmp_path, children, schema, test_keys="ours", scale=None):
    entries = [{"name": f"c{i}",
                "dataset_mode": "self_supervised_labeled_mask_online",
                "dataroot": str(root), "weight": w,
                "overrides": {"data_online_creation_crop_size_A": 24 + 8 * i,
                              "data_online_creation_crop_delta_A": 7}}
               for i, (root, w) in enumerate(zip(children, (1.0, 3.0)))]
    if schema == "list":
        test = ({"id": "c1_x", "dataset": "c1", "test_name": ""}
                if test_keys == "ours" else
                {"id": "c1_x", "dataset_name": "c1", "child_test_name": "",
                 "dataroot": str(children[1])})
        multi = {"datasets": entries, "test_sets": [test]}
    else:
        multi = {"datasets": {e["name"]: dict(
            e["overrides"], dataroot=e["dataroot"], weight=e["weight"],
            data_dataset_mode=e["dataset_mode"]) for e in entries}}
    path = tmp_path / f"multi_{schema}_{test_keys}.json"
    path.write_text(json.dumps(multi))
    cfg = _online_cfg(children[0], "multi_dataset")
    cfg["data"]["multi_dataset_config"] = str(path)
    if scale is not None:
        cfg["data"]["multi_dataset_crop_delta_scale"] = scale
    return cfg


@pytest.mark.parametrize("schema,scale", [("list", None), ("dict", 0.5)])
def test_multi_dataset_matches_jax(tmp_path, children, schema, scale):
    jds, tds = _pair(_multi_cfg(tmp_path, children, schema, scale=scale))
    assert len(tds) == 11 and tds.weights == jds.weights == [0.25, 0.75]
    assert [c.opt.data_online_creation_crop_delta_A for c in tds.children] \
        == [c.opt.data_online_creation_crop_delta_A for c in jds.children] \
        == [int(7 * (scale or 1.0))] * 2
    assert _same_items(jds, tds, 8, 40) == 8
    # the weighted draw: the second child three times as often
    tds.children = [_Tag(0, 5), _Tag(1, 6)]
    random.seed(5)
    share = np.mean([tds[0] for _ in range(400)])
    assert 0.68 < share < 0.82, share


class _Tag:
    """A child that answers its tag."""

    def __init__(self, tag, n):
        self.tag, self.n = tag, n

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        return self.tag


@pytest.mark.parametrize("test_keys", ["ours", "generator"])
def test_multi_dataset_test_sets_match_jax(tmp_path, children, test_keys):
    cfg = _multi_cfg(tmp_path, children, "list", test_keys)
    jds, tds = _pair(cfg, "test", "c1_x")
    assert len(tds.children) == 1 and len(tds) == 3
    assert _same_items(jds, tds, 3, 60) == 3
    with pytest.raises(ValueError, match="not in config test_sets"):
        create_dataset(TrainOptions().parse_json(cfg, verbose=False),
                       "test", "nope")


def test_multi_dataset_refuses_to_nest(tmp_path, children):
    path = tmp_path / "nested.json"
    path.write_text(json.dumps({"datasets": [
        {"name": "x", "dataset_mode": "multi_dataset",
         "dataroot": str(children[0])}]}))
    cfg = _online_cfg(children[0], "multi_dataset")
    cfg["data"]["multi_dataset_config"] = str(path)
    with pytest.raises(ValueError, match="cannot nest"):
        create_dataset(TrainOptions().parse_json(cfg, verbose=False))
    cfg["data"]["multi_dataset_config"] = ""
    with pytest.raises(ValueError, match="requires"):
        create_dataset(TrainOptions().parse_json(cfg, verbose=False))
