"""The GAN entry points and the unaligned dataset, on the CPU:

1. ``UnalignedDataset`` against the JAX dataset, ``random`` seeded alike:
   the same files, the images to 1e-6.
2. End to end on the port alone: horse2zebra and mnist2USPS at a reduced
   width through ``joligen_tpu_torch/train.py`` (2 steps each), then one
   request each through ``scripts/gen_single_image.py --cpu`` from the
   checkpoint, and ``model_type: test`` loading the same G.
3. Options off the ported path raise (the CUT options ported since build);
   without a card and without ``--cpu``
   the GAN entry points raise.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import ROOT, SIZE, few_torch_threads, h2z_cfg
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.data import create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.train import launch_training


def test_unaligned_dataset_matches_jax(tmp_path):
    root = str(tmp_path / "ua")
    synth.write_unaligned(root, 5, 40)
    cfg = h2z_cfg(tmp_path)
    cfg["dataroot"] = root
    cfg["data"].update(load_size=36)
    for serial in (False, True):
        cfg["data"]["serial_batches"] = serial
        jds = jax_create_dataset(JaxTrainOptions().parse_json(
            cfg, verbose=False), "train")
        tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False),
                             "train")
        assert len(jds) == len(tds) == 5
        for i in range(5):
            random.seed(i)
            np.random.seed(i)
            a = jds[i]
            random.seed(i)
            np.random.seed(i)
            b = tds[i]
            assert a["B_img_paths"] == b["B_img_paths"]
            for k in ("A", "B"):
                # the port normalises in another order: 1e-6, as
                # tests/test_torch_data.py holds the items
                assert b[k].dtype == np.float32
                assert b[k].shape == (SIZE, SIZE, 3)
                np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("config", ["horse2zebra", "mnist2USPS"])
def test_train_and_serve_end_to_end(tmp_path, config):
    """Two steps through the train CLI at a reduced width, then a request
    through the serving script and a ``model_type: test`` load."""
    from joligen_tpu_torch import train
    root = str(tmp_path / "data")
    example = os.path.join(ROOT, "examples", f"example_gan_{config}.json")
    if config == "horse2zebra":
        synth.write_unaligned(root, 4, 40)
        extra = ["--data_load_size", "36", "--data_crop_size", "32",
                 "--G_ngf", "8", "--G_nblocks", "2", "--D_ndf", "8",
                 "--D_proj_interp", "-1", "--train_batch_size", "2",
                 "--train_G_ema"]
    else:
        synth.write_unaligned(root, 8, 32)
        extra = ["--G_ngf", "8", "--D_ndf", "8", "--train_batch_size", "4"]
    ckpt = str(tmp_path / "ckpt")
    train.main(["--cpu", "--config_json", example, "--dataroot", root,
                "--checkpoints_dir", ckpt, "--name", config,
                "--train_n_epochs", "1", "--train_n_epochs_decay", "0",
                "--output_print_freq", "1", "--data_num_threads", "1",
                *extra])
    run = os.path.join(ckpt, config)
    names = ({"G_A", "G_A_ema", "F", "D_B_basic", "D_B_projected_d"}
             if config == "horse2zebra" else {"G_A", "F", "D_B_basic"})
    assert {f[len("latest_net_"):-4] for f in os.listdir(run)
            if f.startswith("latest_net_")} == names
    out = gen.main(["--cpu", "--model_in_file",
                    os.path.join(run, "latest_net_G_A.pth"),
                    "--img_in", os.path.join(root, "trainA", "0000.png"),
                    "--img_out", str(tmp_path / "out.png")])
    img = np.asarray(__import__("PIL.Image").Image.open(
        os.path.join(root, "trainA", "0000.png")))
    assert out.shape == img.shape and out.dtype == np.uint8
    assert os.path.exists(tmp_path / "out.png")
    # model_type test: the same G, no EMA, from the same files
    with open(os.path.join(run, "train_config.json")) as f:
        cfg = json.load(f)
    cfg["model_type"] = "test"
    opt = TrainOptions().parse_json(cfg, verbose=False)
    tm = create_model(opt, phase="test", device="cpu")
    tm.save_dir = run
    tm.load_networks("latest")
    cut = create_model(TrainOptions().parse_json(
        dict(cfg, model_type="cut"), verbose=False), phase="test",
        device="cpu")
    cut.save_dir = run
    cut.load_networks("latest")
    a = np.random.default_rng(0).uniform(
        -1, 1, (1, opt.data_crop_size, opt.data_crop_size,
                opt.model_input_nc)).astype(np.float32)
    np.testing.assert_array_equal(tm.inference({"A": a}),
                                  cut.inference({"A": a}, use_ema=False))
    with pytest.raises(RuntimeError, match="inference-only"):
        tm.optimize_parameters({"A": a})


@pytest.mark.parametrize("option,value", [
    ("train_semantic_mask", True), ("dataaug_APA", True),
    ("train_use_contrastive_loss_D", True),
    ("alg_cut_flip_equivariance", True),
    ("alg_cut_supervised_loss", ["L1"]), ("D_netDs", ["temporal"])])
def test_unported_cut_options_raise(tmp_path, option, value):
    """The CUT options that raised until their slices now build: APA, the
    contrastive D, the flips and the supervised loss since ReCUT's slice
    (held against the JAX step by ``tests/test_torch_cut_options.py`` and
    ``test_torch_recut.py``), the semantic-mask branch with horse2zebra's
    f_s, the option schema's ``vgg`` (VGG16-FCN8s), since the semantic
    networks' slice (held against the JAX net by
    ``tests/test_torch_vgg_fcn8s.py``), and the temporal D since the video
    slice (held against the JAX step by ``tests/test_torch_cut_video.py``);
    an option still off the port's path would raise naming it."""
    opt = TrainOptions().parse_json(h2z_cfg(tmp_path), verbose=False)
    setattr(opt, option, value)
    ported = {"dataaug_APA": "apa",
              "train_use_contrastive_loss_D": "contrastive_d",
              "alg_cut_flip_equivariance": "flip_equivariance",
              "alg_cut_supervised_loss": "supervised",
              "train_semantic_mask": "semantic_mask",
              "D_netDs": "temporal_d"}
    model = create_model(opt, device="cpu")
    want = True if option == "D_netDs" else value
    assert getattr(model, ported[option]) == want
    if option == "train_semantic_mask":
        assert type(model.nets["f_s"]).__name__ == "VGG16FCN8s"
    if option == "D_netDs":
        assert list(model.d_names) == ["D_B_temporal"]


def test_gan_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = TrainOptions().parse_json(h2z_cfg(tmp_path), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_training(opt)
    with open(tmp_path / "train_config.json", "w") as f:
        json.dump(h2z_cfg(tmp_path), f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.main(["--model_in_file", str(tmp_path / "latest_net_G_A.pth"),
                  "--img_in", "x.png", "--img_out", "y.png"])
