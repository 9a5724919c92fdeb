"""``example_gan_mario2sonic.json`` on the port (CUT with the segformer G
``segformer_attn_conv``, the semantic-mask branch, online bbox crops in
both domains) against the JAX package, on the CPU:

1. 3-step trajectories of ``CUTModel.optimize_prepared`` against the JAX
   step (``_make_step``) in fp32, on the config cut small (32 px, batch 2,
   16 patches; one MiT block a stage; the basic and vision-aided Ds, the
   towers shrunk to dim 64, depth 2 in both packages, as
   ``tests/test_torch_glasses_cut.py`` runs them; the semantic gate opened
   with ``f_s_semantic_threshold`` 10), with
   seeded weights, the same batches (label masks of A and B) and the JAX
   step's draws fed: with the config's unet f_s (nf 16), and with
   ``f_s_net: segformer``. The NCE taps are the MiT's four stages. After
   every step: every loss to 1e-4 (relative), every parameter of every net
   to 1e-4 with the Adam allowance of ``tests/test_torch_gan_cut.py`` (at
   most 1 % of a leaf's elements past 1e-4, by at most 2 × lr a step), the
   pool to 1e-3. Leaves whose exact gradient is 0 may move by 2 × lr a
   step, as Adam scales their rounding noise up: the basic D's conv biases
   before InstanceNorm, and the MiT's ``kv`` biases, whose key half adds
   a constant to every key (the softmax drops it). The frozen towers stay
   bit for bit.
2. Before the trajectory with the unet f_s: G's gradient of its whole
   loss, the semantic term through f_s included, against ``jax.grad`` of
   the JAX ``_g_loss``.
3. The port's train CLI and GAN serving script end to end on the config at
   a small width over the synthetic mario2sonic layout (online bbox files
   in trainA and trainB, classes 1 to 6): two steps, every net saved, one
   request.
4. ``example_tutorial_bdd100k.json`` raises in both packages' model
   factories (its projected D's ``dinov2_vitb14`` trunk).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, few_torch_threads, grads_close, merge,
                               to_np)
# small_towers and fast_jax_init: fixtures
from _torch_glasses_common import (BATCH, FLIP_SHARE, LR, SIZE, STEPS,
                                   batch_of, fast_jax_init, g_loss_inputs,
                                   small_towers, step_draws)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models.modules import segformer as jseg
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import segformer as tseg
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.utils import clip_vit as tclip
from joligen_tpu_torch.utils import dinov2 as tdino

EXAMPLE = os.path.join(ROOT, "examples", "example_gan_mario2sonic.json")


@pytest.fixture
def shallow_mit(monkeypatch):
    """Both packages' segformer G and segmenter at one MiT block a
    stage."""
    for mod in (jseg, tseg):
        for cls in ("SegformerGeneratorAttn", "SegformerSegmenter"):
            monkeypatch.setattr(mod, cls, functools.partial(
                getattr(mod, cls), depths=(1, 1, 1, 1)))


def mario_cfg(tmp, extra=None):
    with open(EXAMPLE) as f:
        cfg = json.load(f)
    merge(cfg, {
        "checkpoints_dir": str(tmp),
        "D": {"ndf": 8, "netDs": ["basic", "vision_aided"]},
        "data": {"crop_size": SIZE, "load_size": SIZE, "num_threads": 1},
        "alg": {"cut": {"num_patches": 16}},
        "f_s": {"nf": 16, "semantic_threshold": 10.0},
        "train": {"batch_size": BATCH, "pool_size": 3},
        "tpu": {"bf16": False}})
    return merge(cfg, extra or {})


def models(tmp, extra=None):
    cfg = mario_cfg(tmp, extra)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    tm = create_model(opt, device="cpu")
    assert set(tm.nets) == set(jm.states)
    for name, net in tm.nets.items():
        net.load_state_dict(flax_to_torch(jax.device_get(
            jm.states[name].params)))
    return jm, tm


def zero_grad_leaves(tm):
    """The leaves whose exact gradient is 0, or 0 in half of it."""
    names = {f"D_B_basic.Conv_{i}.bias"
             for i in range(1, tm.opt.D_n_layers + 1)}
    for net in ("G_A", "f_s"):
        names |= {f"{net}.{n}" for n, _ in tm.nets[net].named_parameters()
                  if n.endswith(".kv.bias")}
    return names


def check_g_gradient(jm, tm):
    key = jax.random.PRNGKey(7)
    inp, t = g_loss_inputs(jm)
    jinp = dict(inp, _fs_params=jm.states["f_s"].params,
                _fs_gate=jnp.asarray(1.0))
    d_params = {n: jm.states[n].params for n in jm.netDs}
    rng_g = jax.random.split(key, 8)[0]
    jgrad = jax.jit(jax.grad(lambda pG: jm._g_loss(
        pG, jm.states["F"].params, d_params, rng_g, jinp)[0]))(
            jm.states["G_A"].params)
    total, losses, _ = tm._g_loss(t["real_A"], t["real_B"],
                                  step_draws(key, jm, tm), t["mask_A"],
                                  t.get("mask_B"), torch.tensor(1.0))
    assert {"G_GAN", "G_NCE", "G_sem_mask"} <= set(losses)
    netG = tm.nets["G_A"]
    for p, g in zip(netG.parameters(), torch.autograd.grad(
            total, list(netG.parameters()))):
        p.grad = g
    grads_close(jgrad, netG, 1e-4, 1e-4)
    for p in netG.parameters():
        p.grad = None


def run_trajectory(jm, tm):
    towers = {n: p.detach().clone() for n, p in
              tm.nets["D_B_vision_aided"].named_parameters()
              if n.startswith("freezenet_")}
    step = jm._make_step()
    states, pool = jax.device_put((jm.states, jm.pool), jax.devices()[0])
    zero = zero_grad_leaves(tm)
    for i in range(STEPS):
        batch = batch_of(10 + i)
        key = jax.random.PRNGKey(1000 + i)
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"),
                             int_keys=("mask_A", "mask_B"))
        states, pool, _, _, jlosses = step(states, pool, jm.apa_p,
                                           jm.d_diff_p, key, dev)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch),
                                       step_draws(key, jm, tm))
        assert set(tlosses) == set(jlosses)
        assert {"f_s", "G_sem_mask", "G_NCE"} <= set(tlosses)
        for k, v in jlosses.items():
            assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(tlosses[k]), float(v))
        bad = []
        for name, net in tm.nets.items():
            want = flax_to_torch(jax.device_get(states[name].params))
            for pname, p in net.named_parameters():
                diff = np.abs(to_np(p) - want[pname].numpy())
                if f"{name}.{pname}" in zero:
                    off = diff > 2 * LR * (i + 1) + 1e-6
                elif pname.startswith("freezenet_"):
                    off = diff > 1e-6
                else:
                    off = diff > 1e-4
                    if off.mean() > FLIP_SHARE:
                        bad.append((i, name, pname, int(off.sum()), diff.size))
                    off = diff > 2 * LR * (i + 1) + 1e-4
                if off.any():
                    bad.append((i, name, pname, float(diff.max())))
        assert not bad, bad
        np.testing.assert_allclose(to_np(tm.pool.buffer),
                                   np.asarray(pool.buffer), atol=1e-3)
    assert all(torch.equal(p, towers[n]) for n, p in
               tm.nets["D_B_vision_aided"].named_parameters() if n in towers)


@pytest.mark.parametrize("f_s", ["unet", "segformer"])
def test_mario2sonic_trajectory_matches_jax_step(tmp_path, small_towers,
                                                 fast_jax_init, shallow_mit,
                                                 f_s):
    jm, tm = models(tmp_path, {"f_s": {"net": f_s}})
    assert type(tm.nets["G_A"]).__name__ == "SegformerGeneratorAttn"
    assert tm.nets["G_A"].backbone.depths == (1, 1, 1, 1)
    assert tm.nce_layers == jm.nce_layers == [0, 1, 2, 3]
    assert tm.nets["G_A"].layer_channels(tm.nce_layers) == [32, 64, 160,
                                                            256]
    assert type(tm.nets["f_s"]).__name__ == (
        "SegformerSegmenter" if f_s == "segformer" else "UNetSegmenter")
    if f_s == "unet":
        check_g_gradient(jm, tm)
    run_trajectory(jm, tm)


def test_train_and_serve_end_to_end(tmp_path, monkeypatch):
    from joligen_tpu_torch import train
    from joligen_tpu_torch.scripts import gen_single_image as gen
    for mod, cls in ((tclip, "CLIPVisualViT"), (tdino, "DINOv2ViT")):
        monkeypatch.setattr(mod, cls, functools.partial(
            getattr(mod, cls), dim=64, depth=2, heads=2))
    root = str(tmp_path / "data")
    synth.write_online_ab(root, 4, 64, seed=3)
    with open(EXAMPLE) as f:
        cfg = json.load(f)
    # the crops cut to the small images: 40 px windows, 4 px of jitter,
    # masks 3 px around their boxes
    merge(cfg, {"data": {"online_creation": {
        "crop_size_A": 40, "crop_delta_A": 4, "mask_delta_A": [[3]],
        "crop_size_B": 40, "crop_delta_B": 4, "mask_delta_B": [[3]]}}})
    config = tmp_path / "mario2sonic.json"
    config.write_text(json.dumps(cfg))
    ckpt = str(tmp_path / "ckpt")
    train.main(["--cpu", "--config_json", str(config), "--dataroot", root,
                "--checkpoints_dir", ckpt, "--name", "m2s",
                "--data_load_size", "32", "--data_crop_size", "32",
                "--D_ndf", "8", "--D_proj_interp", "-1", "--f_s_nf", "16",
                "--alg_cut_num_patches", "16", "--train_n_epochs", "1",
                "--train_n_epochs_decay", "0", "--output_print_freq", "2",
                "--output_display_freq", "0", "--data_num_threads", "1"])
    run = os.path.join(ckpt, "m2s")
    assert {f[len("latest_net_"):-4] for f in os.listdir(run)
            if f.startswith("latest_net_")} == {
        "G_A", "F", "D_B_projected_d", "D_B_basic", "D_B_vision_aided",
        "f_s"}
    out = gen.main(["--cpu", "--model_in_file",
                    os.path.join(run, "latest_net_G_A.pth"),
                    "--img_in", os.path.join(root, "trainA", "imgs",
                                             "0000.png"),
                    "--img_out", str(tmp_path / "out.png")])
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8


def test_bdd100k_raises_in_both_packages(tmp_path):
    with open(os.path.join(ROOT, "examples",
                           "example_tutorial_bdd100k.json")) as f:
        cfg = json.load(f)
    cfg.update(checkpoints_dir=str(tmp_path), dataroot=str(tmp_path))
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    assert opt.f_s_net == "segformer"
    with pytest.raises(NotImplementedError, match="dinov2_vitb14"):
        jax_create_model(jopt)
    with pytest.raises(NotImplementedError, match="dinov2_vitb14"):
        create_model(opt, device="cpu")
