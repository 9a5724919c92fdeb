"""``python -m joligen_tpu_torch.train --cpu`` end to end on a tiny palette
config and a tools/make_fake_dataset.py dataset: it trains 2 epochs, prints
loss lines and writes the net, EMA and optimizer files; ``--train_continue``
reloads them bit for bit; the JAX package's ``load_networks`` reads the
port's net files; the port reads the JAX package's optax ``_optim.pkl``
(its state classes read without optax), moments bit for bit."""

import hashlib
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.make_fake_dataset import make  # noqa: E402

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.models import create_model as jax_create_model  # noqa: E402
from joligen_tpu.options import TrainOptions as JaxTrainOptions  # noqa: E402
from joligen_tpu_torch.models import create_model  # noqa: E402
from joligen_tpu_torch.models.convert import flax_to_torch  # noqa: E402
from joligen_tpu_torch.options import TrainOptions  # noqa: E402

NAME = "entry"
FLAGS = ["--model_type", "palette",
         "--data_dataset_mode", "self_supervised_labeled_mask",
         "--data_load_size", "32", "--data_crop_size", "32",
         "--data_relative_paths", "--data_num_threads", "2",
         "--G_netG", "unet_mha", "--G_ngf", "16",
         "--G_unet_mha_channel_mults", "1", "2",
         "--G_unet_mha_res_blocks", "1", "1",
         "--G_unet_mha_num_head_channels", "16",
         "--G_diff_n_timestep_test", "4",
         "--alg_diffusion_cond_embed", "mask",
         "--alg_diffusion_cond_embed_dim", "32",
         "--train_batch_size", "2", "--train_G_ema", "--train_optim", "adamw",
         "--train_n_epochs", "2", "--train_n_epochs_decay", "0",
         "--output_print_freq", "2", "--output_display_freq", "8",
         "--name", NAME, "--seed", "3"]
FILES = ("latest_net_G_A.pth", "latest_net_G_A_ema.pth", "latest_optim.pkl")


def _train(dataroot, ckpt, *extra):
    # the train CLI's process takes this one's torch thread count (the
    # fixture's), as the in-process runs of the other files do
    env = dict(os.environ, PYTHONPATH=ROOT,
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    return subprocess.run(
        [sys.executable, "-m", "joligen_tpu_torch.train", "--cpu",
         "--dataroot", dataroot, "--checkpoints_dir", ckpt, *FLAGS, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def _digests(run_dir):
    out = {}
    for f in FILES:
        with open(os.path.join(run_dir, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("entry")
    dataroot = str(base / "data")
    make(dataroot, n=8, size=32, seed=1)
    ckpt = str(base / "ckpt")
    out = _train(dataroot, ckpt)
    assert out.returncode == 0, out.stderr[-3000:]
    return dataroot, ckpt, out.stdout


def _port_model(run_dir, save_dir=None):
    with open(os.path.join(run_dir, "train_config.json")) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.steps_per_epoch = 4
    model = create_model(opt, phase="train", device="cpu")
    model.save_dir = save_dir or run_dir
    return model


def test_trains_two_epochs_and_saves(run):
    _, ckpt, stdout = run
    losses = [line for line in stdout.splitlines() if "G_tot:" in line]
    assert len(losses) == 8                # 4 steps of 2 images per epoch
    assert all(np.isfinite(float(line.split("G_tot:")[1]))
               for line in losses)
    assert "end of epoch 2" in stdout
    run_dir = os.path.join(ckpt, NAME)
    names = set(os.listdir(run_dir))
    assert set(FILES) | {"1_net_G_A.pth", "2_optim.pkl", "loss_log.txt",
                         "losses.json", "train_config.json"} <= names
    # display inference every 8 images: 3 panels at the end of each epoch
    assert len(os.listdir(os.path.join(run_dir, "web", "images"))) == 6
    with open(os.path.join(run_dir, "latest_optim.pkl"), "rb") as f:
        state = pickle.load(f)["G_A"]
    assert state["count"] == 8 and set(state) == {"count", "mu", "nu"}


def test_train_continue_reloads_bit_for_bit(run):
    dataroot, ckpt, _ = run
    run_dir = os.path.join(ckpt, NAME)
    saved = _digests(run_dir)
    # in process: the reloaded params, EMA and optimizer state are the saved
    model = _port_model(run_dir)
    model.load_networks("latest")
    model.save_dir = os.path.join(run_dir, "resaved")
    model.save_networks("latest")
    assert _digests(model.save_dir) == saved
    assert model.states["G_A"].tx.count == 8
    # through the entry point: --train_continue with no epoch left to run
    # reloads and saves latest again, unchanged
    out = _train(dataroot, ckpt, "--train_continue",
                 "--train_epoch_count", "3")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resumed from checkpoint" in out.stdout
    assert _digests(run_dir) == saved


def test_jax_package_reads_the_port_net_files(run):
    _, ckpt, _ = run
    run_dir = os.path.join(ckpt, NAME)
    with open(os.path.join(run_dir, "train_config.json")) as f:
        jopt = JaxTrainOptions().parse_json(json.load(f), verbose=False)
    jm = jax_create_model(jopt, phase="test")
    jm.save_dir = run_dir
    jm.load_networks("latest", load_optim=False)
    model = _port_model(run_dir)
    model.load_networks("latest")
    for got, want in ((jm.states["G_A"].params, model.nets["G_A"]),
                      (jm.states["G_A"].ema_params, model.ema_nets["G_A"])):
        got = flax_to_torch(jax.device_get(got))
        for k, v in want.state_dict().items():
            assert torch.equal(got[k], v), k


def test_port_refuses_the_jax_optimizer_file(run, tmp_path):
    _, ckpt, _ = run
    run_dir = os.path.join(ckpt, NAME)
    with open(os.path.join(run_dir, "train_config.json")) as f:
        jopt = JaxTrainOptions().parse_json(json.load(f), verbose=False)
    jm = jax_create_model(jopt, phase="train")
    jm.save_dir = str(tmp_path)
    jm.save_networks("latest")
    model = _port_model(run_dir, save_dir=str(tmp_path))
    model.load_networks("latest")
    want = flax_to_torch(jax.device_get(jm.states["G_A"].params))
    for k, v in model.nets["G_A"].state_dict().items():
        assert torch.equal(want[k], v), k
    # the optax state (adamw: its chain's ScaleByAdamState) read bit for bit
    adam = jax.device_get(jm.states["G_A"].opt_state)[0]
    state = model.states["G_A"].tx.state_dict()
    assert state["count"] == int(adam.count)
    for moment in ("mu", "nu"):
        tree = flax_to_torch(getattr(adam, moment))
        assert set(state[moment]) == set(tree)
        for k, v in tree.items():
            np.testing.assert_array_equal(state[moment][k], v.numpy())
