"""The multi-dataset B2B path of the port on the CPU: the config generator
(``joligen_tpu_torch/scripts/gen_multi_dataset_b2b_config.py``) against the
JAX package's script, then the config it writes trained as written but cut
small (JiT depth 3, hidden 192, patch 4, clips of 2 frames at 16 px, batch
2; Muon at ``train_iter_size`` 4, EMA, LPIPS and DISTS):

1. on the same two synthetic video roots (different frame sizes, so
   different derived crops), both scripts write the same
   ``multi_dataset_config.json`` and ``train_config.json`` but for the
   output paths; with a generated holdout too, and the port's previews;
2. 3 Muon updates (12 micro-steps) of ``B2BModel.optimize_prepared`` on
   batches of the port's ``multi_dataset`` loader against the JAX model's
   step, its keys replayed and the perceptual trunk shared
   (``_torch_metrics_common.shared_nets``): losses to 1e-4 (relative),
   parameters and EMA with the Adam allowance of tests/test_torch_b2b.py
   (at most 1 % of a leaf's elements past 1e-4, by at most 2 × lr a
   step);
3. ``launch_training`` on that config with ``tpu_profile_dir`` (a trace
   of micro-steps 3 to 6 written), its checkpoint and Muon state reloaded
   bit for bit, and a clip served by ``gen_vid_diffusion``.
"""

import importlib.util
import json
import os
import random
import sys

import jax
import numpy as np
import pytest
import torch

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_gan_common import fast_init_net_state, load_flax
from _torch_metrics_common import shared_nets  # noqa: F401
from test_torch_b2b import FLIP_SHARE, jax_training_draws
from joligen_tpu.models import b2b_model as jb2b
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.utils import metrics as jmet
from joligen_tpu_torch.data import create_dataloader, create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_multi_dataset_b2b_config as tgen
from joligen_tpu_torch.scripts import gen_vid_diffusion as vgen
from joligen_tpu_torch.tools.synthetic_datasets import write_video
from joligen_tpu_torch.train import launch_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, B = 16, 2
SMALL = {"data_load_size": SIZE, "data_crop_size": SIZE, "G_vit_depth": 3,
         "G_vit_hidden_size": 192, "G_vit_num_heads": 3,
         "G_vit_patch_size": 4, "G_vit_in_context_start": 1,
         "G_vit_in_context_len": 8, "G_vit_bottleneck_dim": 32,
         "train_batch_size": B, "data_num_threads": 1, "tpu_bf16": False,
         "output_print_freq": B, "output_display_freq": 0,
         "train_n_epochs": 1, "train_G_ema_beta": 0.9}


def _jax_gen():
    path = os.path.join(ROOT, "scripts", "gen_multi_dataset_b2b_config.py")
    spec = importlib.util.spec_from_file_location("jax_gen_multi", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two video roots: 160 px and 320 px frames, boxes of 20-40 and
    40-80 px (crops 16 and 32)."""
    base = tmp_path_factory.mktemp("md_roots")
    for name, size, seed in (("vidA_online", 160, 1), ("vidB", 320, 2)):
        write_video(str(base / "roots" / name), 8, size, seed=seed,
                    n_series=1, phases=("train",))
    return base


def _generate(mod, base, out, extra, monkeypatch):
    argv = ["--datasets-root", str(base / "roots"), "--output-dir",
            str(out), "--checkpoints-dir", str(base / "ckpt")] + extra
    if mod is tgen:
        tgen.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["gen"] + argv)
        mod.main()
    with open(out / "multi_dataset_config.json") as f:
        multi = f.read().replace(str(out), "<out>")
    with open(out / "train_config.json") as f:
        train = f.read().replace(str(out), "<out>")
    return json.loads(multi), json.loads(train)


@pytest.mark.parametrize("extra", [
    [], ["--auto-test-min-images", "0", "--auto-test-samples", "2",
         "--preview-samples", "1", "--name", "held"]])
def test_generator_writes_the_jax_scripts_jsons(roots, tmp_path, extra,
                                                monkeypatch):
    want = _generate(_jax_gen(), roots, tmp_path / "jax", extra,
                     monkeypatch)
    got = _generate(tgen, roots, tmp_path / "port", extra, monkeypatch)
    assert got == want
    multi, train = got
    assert [d["overrides"]["data_online_creation_crop_size_A"]
            for d in multi["datasets"]] == [16, 32]
    assert train["train_optim"] == "muon" and train["G_netG"] == "vit_vid"
    if extra:
        assert [t["generated"] for t in multi["test_sets"]] == [True, True]
        assert sorted(os.listdir(tmp_path / "port" / "previews")) == [
            "vidA", "vidB"]


@pytest.fixture(scope="module")
def config(roots):
    """The port's train config over ``roots``, cut small."""
    out = roots / "gen"
    tgen.main(["--datasets-root", str(roots / "roots"), "--output-dir",
               str(out), "--checkpoints-dir", str(roots / "ckpt")])
    with open(out / "train_config.json") as f:
        cfg = json.load(f)
    cfg.update(SMALL)
    return cfg


def _batches(opt, n):
    random.seed(3)
    np.random.seed(3)
    loader = create_dataloader(opt, create_dataset(opt, "train"),
                               shuffle=False)
    out = []
    while len(out) < n:
        out.extend(iter(loader))
    return out[:n]


def test_muon_trajectory_matches_jax(config, shared_nets, monkeypatch):
    jopt = JaxTrainOptions().parse_json(config, verbose=False)
    opt = TrainOptions().parse_json(config, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    assert opt.train_optim == "muon" and opt.train_iter_size == 4
    monkeypatch.setattr(jb2b, "init_net_state", fast_init_net_state(90))
    jm = jax_create_model(jopt, phase="train")
    tm = create_model(opt, phase="train", device="cpu")
    params = jax.device_get(jm.states["G_A"].params)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        load_flax(net, params)
    # the JAX VGG trunk built outside the step's trace (the shared tree)
    jm._perc_feats = jmet.vgg_feature_fn((SIZE, SIZE, 3))
    lr = opt.train_G_lr
    updates = 0
    for i, batch in enumerate(_batches(opt, 12)):
        key = jax.random.PRNGKey(100 + i)
        monkeypatch.setattr(jm, "next_rng", lambda k=key: k)
        want = jm.optimize_prepared(jm.prepare_batch(batch))
        draws = jax_training_draws(key, batch["B"].shape,
                                   (B,) if tm.num_classes > 1 else None)
        got = tm.optimize_prepared(tm.prepare_batch(batch), draws=draws)
        assert set(got) == set(want) == {"G_tot", "G_perceptual"}
        for k, v in want.items():
            assert abs(float(got[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(got[k]), float(v))
        if (i + 1) % 4:
            continue
        updates += 1
        bad = []
        state = jax.device_get(jm.states["G_A"])
        for net, tree in ((tm.nets["G_A"], state.params),
                          (tm.ema_nets["G_A"], state.ema_params)):
            ref = flax_to_torch(tree)
            for name, p in net.named_parameters():
                diff = (p.detach() - ref[name]).abs()
                if (diff > 1e-4).float().mean() > FLIP_SHARE:
                    bad.append((i, name, "share"))
                if diff.max() > 2 * lr * updates + 1e-4:
                    bad.append((i, name, float(diff.max())))
        assert not bad, bad
    assert updates == 3 and tm.states["G_A"].tx.gradient_step == 3
    start = flax_to_torch(params)
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in tm.nets["G_A"].named_parameters())
    assert moved > 1e-5


def test_config_trains_profiles_and_serves(config, tmp_path):
    cfg = dict(config, checkpoints_dir=str(tmp_path / "ckpt"),
               tpu_profile_dir=str(tmp_path / "trace"),
               data_max_dataset_size=8)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    model = launch_training(opt, cpu=True)
    state = model.states["G_A"]
    assert state.step == 8 and state.tx.gradient_step == 2
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    run = tmp_path / "ckpt" / opt.name
    # the Muon (and its Adam's) state and the EMA reloaded bit for bit
    again = create_model(opt, phase="train", device="cpu")
    again.save_dir = str(run)
    again.load_networks("latest")
    want, got = state.tx.state_dict(), again.states["G_A"].tx.state_dict()
    assert want["inner"]["count"] == got["inner"]["count"] == 2
    jax.tree.map(np.testing.assert_array_equal, want, got)
    for a, b in zip(model.ema_nets["G_A"].parameters(),
                    again.ema_nets["G_A"].parameters()):
        assert torch.equal(a, b)
    frames = os.path.join(config["dataroot"], "trainA", "vid0")
    written = vgen.inference(vgen.build_parser().parse_args([
        "--model_in_file", str(run / "latest_net_G_A.pth"), "--dir_in",
        frames, "--dir_out", str(tmp_path / "out"), "--max_frames", "2",
        "--sampling_steps", "2", "--seed", "0", "--cpu"]))
    assert len(written) == 2 and written[0].shape == (160, 160, 3)


def test_full_width_denoiser_and_muon_split_match_jax(roots, config):
    """The generated config at full width: the JiTViD of 7 input channels
    (A, z and the mask channel), its 156,929,280 parameters and its 92
    flax leaves, 49 of them Muon's, against ``jax.eval_shape`` of the JAX
    tree and optax's partition of it."""
    from joligen_tpu.models import train_state as jts
    from joligen_tpu.models.modules import vit_vid as jvv
    from joligen_tpu_torch.models.diffusion_networks import define_inner_G
    from joligen_tpu_torch.models.train_state import muon_labels

    with open(roots / "gen" / "train_config.json") as f:
        cfg = json.load(f)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    shapes = jax.eval_shape(lambda r: jvv.JiTViD.from_opt(jopt).init(
        r, jax.numpy.zeros((1, 2, 256, 256, 7)), jax.numpy.zeros((1,))),
        jax.random.PRNGKey(0))
    state = jax.eval_shape(
        lambda t: jts.make_optimizer(jopt, 1e-4).init(t), shapes)
    muon = state.inner_opt_state.inner_states["muon"].inner_state[0].mu
    want = sum(type(v).__name__ != "MaskedNode" for v in jax.tree.leaves(
        muon, is_leaf=lambda x: type(x).__name__ == "MaskedNode"))
    with torch.device("meta"):
        net = define_inner_G(opt, 7)
    labels = muon_labels([(n, p.dim()) for n, p in net.named_parameters()])
    assert sum(p.numel() for p in net.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == \
        156_929_280
    assert len(labels) == len(jax.tree.leaves(shapes)) == 92
    assert sum(leaf[4] == "muon" for leaf in labels) == want == 49
