"""The glasses GAN configs through the port's entry points, on the CPU:

1. ``write_unaligned_labeled``'s layout against the JAX dataset
   (``unaligned_labeled_mask``), ``random`` seeded alike: the same files,
   the images to 1e-6, A's and B's masks exactly (B's masks are what
   ``train_mask_f_s_B`` trains on).
2. End to end on the port alone: ``example_gan_noglasses2glasses.json`` and
   ``example_gan_glasses2noglasses.json`` at a reduced width (ngf 8, 2
   blocks, ndf 8, f_s nf 16, 32 px, the towers shrunk to dim 64, depth 2)
   through ``joligen_tpu_torch/train.py`` (2 steps each, with every option
   of the config: projected, basic and vision-aided Ds, f_s; f_s's mIoU
   printed for glasses2noglasses), then one request each through
   ``scripts/gen_single_image.py --cpu`` from the checkpoint.
3. What stays off the ported path raises, naming its ROADMAP item: the
   sam segmenter, the ``sam`` and ``depth`` Ds (the vgg segmenter, the
   classifier and the ``mask`` D run since the semantic networks' slice,
   the ``temporal`` D since the video slice that ported it:
   ``tests/test_torch_cut_video.py``). ``train_sem_use_label_B`` is accepted and read by nothing,
   in either package (a reference property the port copies).
"""

import ast
import functools
import os
import random

import numpy as np
import pytest

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import ROOT, few_torch_threads, h2z_cfg
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.data import create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.utils import clip_vit as tclip
from joligen_tpu_torch.utils import dinov2 as tdino

SMALL = dict(dim=64, depth=2, heads=2)
NETS = {"G_A", "F", "D_B_projected_d", "D_B_basic", "D_B_vision_aided",
        "f_s"}


def test_unaligned_labeled_layout_matches_jax_dataset(tmp_path):
    root = str(tmp_path / "ul")
    synth.write_unaligned_labeled(root, 4, 40)
    cfg = {"model_type": "cut", "dataroot": root,
           "data": {"dataset_mode": "unaligned_labeled_mask",
                    "load_size": 36, "crop_size": 32,
                    "relative_paths": True}}
    jds = jax_create_dataset(JaxTrainOptions().parse_json(
        cfg, verbose=False), "train")
    tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False),
                         "train")
    assert len(jds) == len(tds) == 4
    for i in range(4):
        random.seed(i)
        np.random.seed(i)
        a = jds[i]
        random.seed(i)
        np.random.seed(i)
        b = tds[i]
        assert a["B_img_paths"] == b["B_img_paths"]
        for k in ("A_label_mask", "B_label_mask"):
            assert b[k].any() and set(np.unique(b[k])) <= {0, 1}
            np.testing.assert_array_equal(b[k], a[k])
        for k in ("A", "B"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("config", ["noglasses2glasses", "glasses2noglasses"])
def test_train_and_serve_end_to_end(tmp_path, monkeypatch, capsys, config):
    from joligen_tpu_torch import train
    for mod, cls in ((tclip, "CLIPVisualViT"), (tdino, "DINOv2ViT")):
        monkeypatch.setattr(mod, cls, functools.partial(getattr(mod, cls),
                                                        **SMALL))
    root = str(tmp_path / "data")
    synth.write_unaligned_labeled(root, 4, 32)
    example = os.path.join(ROOT, "examples", f"example_gan_{config}.json")
    extra = ["--train_mask_compute_miou", "--train_mask_miou_every", "2"] \
        if config == "glasses2noglasses" else []
    ckpt = str(tmp_path / "ckpt")
    train.main(["--cpu", "--config_json", example, "--dataroot", root,
                "--checkpoints_dir", ckpt, "--name", config,
                "--data_load_size", "32", "--data_crop_size", "32",
                "--G_ngf", "8", "--G_nblocks", "2", "--D_ndf", "8",
                "--D_proj_interp", "-1", "--f_s_nf", "16",
                "--alg_cut_num_patches", "16", "--train_n_epochs", "1",
                "--train_n_epochs_decay", "0", "--output_print_freq", "2",
                "--output_display_freq", "0", "--data_num_threads", "1",
                *extra])
    printed = capsys.readouterr().out
    assert ("mIoU: miou_real_A" in printed) == bool(extra)
    run = os.path.join(ckpt, config)
    ema = {"G_A_ema"} if config == "noglasses2glasses" else set()
    assert {f[len("latest_net_"):-4] for f in os.listdir(run)
            if f.startswith("latest_net_")} == NETS | ema
    out = gen.main(["--cpu", "--model_in_file",
                    os.path.join(run, "latest_net_G_A.pth"),
                    "--img_in", os.path.join(root, "trainA", "imgs",
                                             "0000.png"),
                    "--img_out", str(tmp_path / "out.png")])
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8
    assert os.path.exists(tmp_path / "out.png")


@pytest.mark.parametrize("option,value,item", [
    ("D_netDs", ["depth"], "item 13"), ("f_s_net", "sam", "item 14"),
    ("D_netDs", ["sam"], "item 13")])
def test_off_path_options_raise(tmp_path, option, value, item):
    opt = TrainOptions().parse_json(h2z_cfg(tmp_path, {
        "train": {"semantic_mask": True}, "f_s": {"net": "unet"}}),
        verbose=False)
    setattr(opt, option, value)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        create_model(opt, device="cpu")


def test_use_label_B_is_read_by_nothing():
    """``train_sem_use_label_B`` is read by no code of either package (no
    attribute of that name, no string naming it, outside the option
    schemas): setting it changes nothing."""
    name = "train_sem_use_label_B"
    readers = []
    for pkg in ("joligen_tpu", "joligen_tpu_torch"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                readers += [path for node in ast.walk(tree) if (
                    isinstance(node, ast.Attribute) and node.attr == name
                    or isinstance(node, ast.Constant) and node.value == name)]
    assert readers == []
    opt = TrainOptions().parse_json({"model_type": "cut", "train": {
        "sem": {"use_label_B": True}}}, verbose=False)
    assert opt.train_sem_use_label_B is True
