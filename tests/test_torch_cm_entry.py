"""The consistency and shortcut models through the port's entry points, on
the CPU, at a reduced width (16 px, or 32 px with the projected D; ngf 8,
mults 1,2, head dim 16) over a synthetic ``self_supervised_labeled_mask``
dataset (``tools/synthetic_datasets.write_labeled``):

1. ``python -m joligen_tpu_torch.train`` for 2 steps on
   ``example_cm_noglasses2glasses.json``, on
   ``example_cm_gan_noglasses2glasses.json`` (both Ds, ``iter_size`` 2: one
   real update) and on the cm config with ``--model_type sc``; the
   checkpoint files of each;
2. one request through ``scripts/gen_single_image_diffusion.py --cpu`` from
   each checkpoint: the output of the input's size, the image
   outside the mask the input's (to one level of the 8-bit round trip);
   the sampler's arguments by model type;
3. without a card and without ``--cpu`` the entry points raise.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import ROOT, few_torch_threads
from joligen_tpu_torch import train
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth

SMALL = ["--G_ngf", "8", "--G_unet_mha_channel_mults", "1", "2",
         "--G_unet_mha_res_blocks", "1", "1", "--G_unet_mha_attn_res", "2",
         "--G_unet_mha_num_head_channels", "16",
         "--G_unet_mha_group_norm_size", "4",
         "--alg_diffusion_cond_embed_dim", "32", "--train_batch_size", "2",
         "--train_n_epochs", "1", "--train_n_epochs_decay", "0",
         "--output_print_freq", "2", "--data_num_threads", "1"]
RUNS = {
    "cm": ("cm", 16, []),
    "cm_gan": ("cm_gan", 32, ["--D_ndf", "8", "--D_proj_interp", "-1",
                              "--train_iter_size", "2"]),
    "sc": ("cm", 16, ["--model_type", "sc"]),
}


@pytest.fixture(scope="module", params=list(RUNS))
def run(request, tmp_path_factory):
    """Two training steps of one run through the train CLI: (name, data
    root, run dir)."""
    name = request.param
    example, size, extra = RUNS[name]
    root = str(tmp_path_factory.mktemp(f"data_{name}"))
    synth.write_labeled(root, 4, size, seed=3)
    ckpt = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
    train.main(["--cpu", "--config_json", os.path.join(
        ROOT, "examples", f"example_{example}_noglasses2glasses.json"),
        "--dataroot", root, "--checkpoints_dir", ckpt, "--name", name,
        "--data_load_size", str(size), "--data_crop_size", str(size),
        *SMALL, *extra])
    return name, root, os.path.join(ckpt, name)


def test_train_cli_writes_every_net(run):
    name, _, rundir = run
    nets = {f[len("latest_net_"):-4] for f in os.listdir(rundir)
            if f.startswith("latest_net_")}
    want = {"G_A", "G_A_ema"}
    if name == "cm_gan":
        want |= {"D_B_projected_d", "D_B_basic"}
    assert nets == want
    with open(os.path.join(rundir, "train_config.json")) as f:
        assert json.load(f)["model_type"] == name
    with open(os.path.join(rundir, "losses.json")) as f:
        logged = f.read()
    for key in ("G_tot", *(("G_GAN", "D_D_B_basic") if name == "cm_gan"
                           else ())):
        assert key in logged


def test_serving_script_from_the_checkpoint(run, tmp_path):
    name, root, rundir = run
    img_path = os.path.join(root, "trainA", "imgs", "0000.png")
    mask_path = os.path.join(root, "trainA", "masks", "0000.png")
    args = gen.build_parser().parse_args([
        "--cpu", "--model_in_file", os.path.join(rundir,
                                                 "latest_net_G_A.pth"),
        "--img_in", img_path, "--mask_in", mask_path,
        "--dir_out", str(tmp_path), "--name", "req", "--seed", "0",
        *(["--sampling_steps", "2"] if name == "sc" else [])])
    full, model, _ = gen.inference(args)
    src = np.asarray(Image.open(img_path).convert("RGB"))
    assert full.shape == src.shape and full.dtype == np.uint8
    keep = np.asarray(Image.open(mask_path)) == 0
    diff = np.abs(full[keep].astype(int) - src[keep].astype(int))
    assert diff.max() <= 1
    assert "req_generated.png" in os.listdir(tmp_path)
    assert type(model).__name__ == ("SCModel" if name == "sc" else "CMModel")


def test_sampler_arguments_by_model_type():
    parse = gen.build_parser().parse_args
    base = ["--model_in_file", "m.pth", "--img_in", "x.png"]

    def kw(model_type, *argv):
        opt = type("Opt", (), {"model_type": model_type})
        return gen._inference_kwargs(parse(base + list(argv)), opt)
    assert kw("cm", "--sampling_steps", "3") == {}
    assert kw("sc") == {}
    assert kw("sc", "--alg_sc_denoise_inferstep", "4") == {
        "denoise_timesteps": 4}
    assert kw("sc", "--sampling_steps", "2",
              "--alg_sc_denoise_inferstep", "4") == {"denoise_timesteps": 2}
    assert kw("palette", "--sampling_method", "ddim",
              "--sampling_steps", "5") == {"sampling_method": "ddim",
                                           "num_steps": 5}


@pytest.mark.parametrize("model_type", ["cm", "cm_gan", "sc"])
def test_entry_points_raise_without_a_card(monkeypatch, tmp_path,
                                           model_type):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(os.path.join(ROOT, "examples",
                           "example_cm_noglasses2glasses.json")) as f:
        cfg = dict(json.load(f), model_type=model_type,
                   checkpoints_dir=str(tmp_path))
    opt = TrainOptions().parse_json(cfg, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.launch_training(opt)
    with open(tmp_path / "train_config.json", "w") as f:
        json.dump(cfg, f)
    args = gen.build_parser().parse_args([
        "--model_in_file", str(tmp_path / "latest_net_G_A.pth"),
        "--img_in", "x.png", "--dir_out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.inference(args)
