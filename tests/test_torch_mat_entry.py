"""MAT's entry points in the port, on the CPU:

1. ``python -m joligen_tpu_torch.train --cpu --model_type mat`` (in
   process: the CLI's option parser, then ``launch_training``) for 2 steps
   of 2 images over a synthetic labeled-mask set at 32 px (base 16, w and
   z 64, stage-1 dim 12, fp32): every loss logged and finite, the files of
   ``latest`` (G, its EMA, D, the optimizer state);
2. ``scripts/gen_single_image_mat.py`` (truncation 0.7, a seed) and
   ``scripts/gen_video_mat.py`` (3 frames, a mask directory) on that
   checkpoint: outputs of the inputs' size, the known pixels those of the
   input's uint8 round trip, the same seed giving the same output;
3. both scripts against the JAX scripts on a stub model (which records
   its batch and returns a fixed function of it): the same batch (bicubic
   resize of a 40 x 48 image to the crop, the mask resized nearest and
   thresholded above 0) bit for bit, and the same uint8 outputs at the
   input's size;
4. the raises: ``--video_out`` (ROADMAP Queue 1 item 16), a checkpoint of
   another model type, and no card without ``--cpu``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_mat_common import BASE, DIM, ROOT, WZ
from joligen_tpu_torch import train
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image_mat as gen_img
from joligen_tpu_torch.scripts import gen_video_mat as gen_vid
from joligen_tpu_torch.scripts.common import (load_image_rgb, to_m1p1,
                                              to_uint8)
from joligen_tpu_torch.tools.synthetic_datasets import write_labeled

FLAGS = ["--model_type", "mat",
         "--data_dataset_mode", "self_supervised_labeled_mask",
         "--data_load_size", "32", "--data_crop_size", "32",
         "--data_relative_paths", "--data_num_threads", "1",
         "--G_ngf", str(BASE), "--D_ndf", str(BASE),
         "--alg_mat_z_dim", str(WZ), "--alg_mat_w_dim", str(WZ),
         "--alg_mat_first_stage_dim", str(DIM),
         "--train_batch_size", "2", "--train_n_epochs", "1",
         "--train_n_epochs_decay", "0", "--output_print_freq", "2",
         "--output_display_freq", "0", "--tpu_bf16", "false",
         "--name", "mat", "--seed", "3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("mat_entry")
    data = str(base / "data")
    write_labeled(data, 4, 32, seed=1)
    ckpt = str(base / "ckpt")
    model = train.launch_training(
        TrainOptions().parse_cli(["--dataroot", data, "--checkpoints_dir",
                                  ckpt, *FLAGS]), cpu=True)
    return base, data, os.path.join(ckpt, "mat"), model


def test_train_cli_two_steps(run, tmp_path, monkeypatch):
    base, data, run_dir, model = run
    assert model.states["G_A"].step == 2 and model.states["D"].step == 2
    assert set(model.loss_log) == {"G_adv", "G_adv_stg1", "G_pcp", "G_l1",
                                   "G_tot", "D_main", "D_r1", "D_tot"}
    assert all(np.isfinite(float(v)) for v in model.loss_log.values())
    assert float(model.loss_log["D_r1"]) == 0.0     # step 1: no R1
    for f in ("latest_net_G_A.pth", "latest_net_G_A_ema.pth",
              "latest_net_D.pth", "latest_optim.pkl", "train_config.json"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    # the CLI itself (main), without --cpu and without a card, refuses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--dataroot", data, "--checkpoints_dir", str(tmp_path),
                    *FLAGS])


def _mask_file(path, size, values=(255,)):
    m = np.zeros(size, np.uint8)
    h, w = size
    m[h // 4:h // 2, w // 5:w // 2] = values[0]
    m[h // 2:, w // 2:] = values[-1]
    Image.fromarray(m).save(path)
    return path


def test_image_request_from_the_checkpoint(run, tmp_path):
    _, data, run_dir, _ = run
    img = os.path.join(data, "trainA", "imgs", "0000.png")
    mask = _mask_file(str(tmp_path / "m.png"), (32, 32))
    outs = []
    for i in range(2):
        args = gen_img.parser().parse_args([
            "--model_in_file", os.path.join(run_dir, "latest_net_G_A.pth"),
            "--img_in", img, "--mask_in", mask,
            "--img_out", str(tmp_path / f"out{i}.png"),
            "--truncation_psi", "0.7", "--seed", "4", "--cpu"])
        outs.append(gen_img.inference(args))
    src = load_image_rgb(img)
    assert outs[0].shape == src.shape and outs[0].dtype == np.uint8
    np.testing.assert_array_equal(outs[0], outs[1])       # the seed
    keep = np.asarray(Image.open(mask)) == 0
    roundtrip = to_uint8(to_m1p1(src))     # fp32, as the script computes
    np.testing.assert_array_equal(outs[0][keep], roundtrip[keep])
    assert os.path.exists(tmp_path / "out0.png")


def _frames(d, n, hw, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(
            os.path.join(d, f"f{i:03d}.png"))
    return d


def test_video_request_from_the_checkpoint(run, tmp_path):
    _, _, run_dir, _ = run
    frames = _frames(str(tmp_path / "frames"), 3, (32, 32), 5)
    masks = str(tmp_path / "masks")
    os.makedirs(masks)
    for i in range(3):
        _mask_file(os.path.join(masks, f"m{i:03d}.png"), (32, 32))
    out_dir = str(tmp_path / "out")
    args = gen_vid.build_parser().parse_args([
        "--model_in_file", os.path.join(run_dir, "latest_net_G_A.pth"),
        "--dir_in", frames, "--mask_dir_in", masks, "--dir_out", out_dir,
        "--seed", "0", "--cpu"])
    outs = gen_vid.inference(args)
    assert len(outs) == 3 and all(o.shape == (32, 32, 3) for o in outs)
    assert sorted(os.listdir(out_dir)) == [f"frame_{i:05d}_generated.png"
                                           for i in range(3)]


def _jax_script(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stub:
    """A model that records its batches and returns tanh(1.3 x + 0.1)."""

    def __init__(self):
        self.batches = []

    def inference(self, batch, truncation_psi=None, seed=None):
        self.batches.append((batch, truncation_psi, seed))
        return np.tanh(np.asarray(batch["B"]) * 1.3 + 0.1).astype(np.float32)


def _stub_opt(tmp_path):
    cfg = {"model_type": "mat", "data": {"crop_size": 32, "load_size": 32}}
    return TrainOptions().parse_json(cfg, verbose=False)


def _batches_equal(a, b):
    assert len(a) == len(b)
    for (ba, pa, sa), (bb, pb, sb) in zip(a, b):
        assert (pa, sa) == (pb, sb)
        assert set(ba) == set(bb) == {"B", "B_label_mask"}
        for k in ba:
            assert np.asarray(ba[k]).dtype == np.asarray(bb[k]).dtype
            np.testing.assert_array_equal(ba[k], bb[k])


def test_scripts_match_the_jax_scripts(tmp_path, monkeypatch):
    opt = _stub_opt(tmp_path)
    frames = _frames(str(tmp_path / "frames"), 3, (40, 48), 6)
    mask = _mask_file(str(tmp_path / "m.png"), (40, 48), (128, 1))
    jimg = _jax_script("gen_single_image_mat")
    jstub, tstub = _Stub(), _Stub()
    monkeypatch.setattr(jimg, "load_model_from_file",
                        lambda *a, **k: (jstub, opt))
    argv = ["--model_in_file", "unused_net_G_A.pth", "--img_in",
            os.path.join(frames, "f000.png"), "--mask_in", mask,
            "--truncation_psi", "0.7", "--seed", "2"]
    ns = gen_img.parser().parse_args(argv + ["--img_out",
                                             str(tmp_path / "j.png")])
    want = jimg.inference(ns)
    ns.img_out = str(tmp_path / "t.png")
    got = gen_img.inference(ns, model=tstub, opt=opt)
    assert got.shape == (40, 48, 3)
    np.testing.assert_array_equal(got, want)
    _batches_equal(tstub.batches, jstub.batches)
    assert set(np.unique(tstub.batches[0][0]["B_label_mask"])) == {0, 1}

    jvid = _jax_script("gen_video_mat")
    jstub, tstub = _Stub(), _Stub()
    monkeypatch.setattr(jvid, "load_model_from_file",
                        lambda *a, **k: (jstub, opt))
    vargv = ["--model_in_file", "unused_net_G_A.pth", "--dir_in", frames,
             "--mask_dir_in", mask, "--seed", "1", "--max_frames", "2"]
    monkeypatch.setattr(sys, "argv", ["gen_video_mat.py", *vargv,
                                      "--dir_out", str(tmp_path / "jv")])
    jvid.main()
    got = gen_vid.inference(gen_vid.build_parser().parse_args(
        vargv + ["--dir_out", str(tmp_path / "tv")]), model=tstub, opt=opt)
    assert len(got) == 2
    _batches_equal(tstub.batches, jstub.batches)
    for i in range(2):
        name = f"frame_{i:05d}_generated.png"
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "tv" / name)),
            np.asarray(Image.open(tmp_path / "jv" / name)))


def test_raises(run, tmp_path, monkeypatch):
    _, _, run_dir, _ = run
    ckpt = os.path.join(run_dir, "latest_net_G_A.pth")
    with pytest.raises(NotImplementedError, match="item 16"):
        gen_vid.inference(gen_vid.build_parser().parse_args([
            "--model_in_file", ckpt, "--dir_in", str(tmp_path),
            "--mask_dir_in", str(tmp_path), "--video_out", "x.mp4",
            "--cpu"]))
    opt = _stub_opt(tmp_path)
    opt.model_type = "cut"
    with pytest.raises(ValueError, match="not a MAT checkpoint"):
        gen_img.inference(gen_img.parser().parse_args([
            "--model_in_file", ckpt, "--img_in", "x", "--mask_in", "x",
            "--img_out", "x"]), model=_Stub(), opt=opt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_img.inference(gen_img.parser().parse_args([
            "--model_in_file", ckpt, "--img_in", "x", "--mask_in", "x",
            "--img_out", "x"]))
    with open(os.path.join(run_dir, "train_config.json")) as f:
        assert json.load(f)["model_type"] == "mat"
