"""B2B flow matching on images in the port (``B2BModel`` with the image JiT,
``G_netG: vit``) against the JAX package on the CPU, fp32, the JAX keys'
draws fed to the port, on ``examples/example_ddpm_noglasses2glasses.json``
with ``--model_type b2b --G_netG vit`` cut small (JiT depth 3, hidden 64, 2
heads of 32, patch 4, 4 in-context tokens from block 1, 16 px, batch 2):

1. ``set_input`` folds a clip batch into the image batch as the JAX model
   does, exactly;
2. ``B2BModel._loss`` on images (MSE, L1, pseudo-Huber, the multiscale MSE
   and L1, each with and without ``alg_b2b_loss_masked_region_only``) equal
   to the JAX model's to 1e-5;
3. one AdamW step against the JAX step for the loss kinds and
   ``mask_as_channel`` (with min-SNR, 3 classes with label dropout and the
   mask-size conditioning in one case): losses to 1e-4, parameters and EMA
   to 1e-4 with the Adam allowance (at most 1 % of a leaf's elements past
   1e-4, by at most 2 × lr);
4. a 3-step trajectory (3 classes, label dropout 0.2) against the JAX
   model's steps, its keys replayed, then a 3-step Heun request with CFG (3
   classes, scale 2, labels given: the null class's call beside the
   conditional one inside the interval) against the JAX sampler, to 1e-3;
5. the config trained two steps by ``train.py`` over a synthetic
   labeled-mask set and served by ``scripts/gen_single_image_diffusion``
   (``--sampling_steps`` and ``--alg_sc_denoise_inferstep``), with
   ``--cpu``: the crop pasted back into the image, the pixels outside the
   mask kept; a vit_vid model still refused there.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_gan_common import (fast_init_net_state, few_torch_threads,
                               load_flax)
from test_torch_b2b import jax_training_draws
from joligen_tpu.models import b2b_model as jb2b
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import b2b_model as tb2b
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules.jit import JiT
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
from joligen_tpu_torch.scripts.common import load_model_from_file
from joligen_tpu_torch.tools.synthetic_datasets import write_labeled
from joligen_tpu_torch.train import launch_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "example_ddpm_noglasses2glasses.json")
B, SIZE = 2, 16
LR, FLIP_SHARE = 2e-4, 1e-2
SMALL = ["--model_type", "b2b", "--G_netG", "vit", "--G_vit_depth", "3",
         "--G_vit_hidden_size", "64", "--G_vit_num_heads", "2",
         "--G_vit_patch_size", "4", "--G_vit_bottleneck_dim", "16",
         "--G_vit_in_context_start", "1", "--G_vit_in_context_len", "4",
         "--data_load_size", str(SIZE), "--data_crop_size", str(SIZE),
         "--train_batch_size", str(B), "--train_G_ema_beta", "0.9",
         "--tpu_bf16", "false", "--data_num_threads", "1"]


def _t(a):
    return torch.from_numpy(np.array(a))


def small_args(tmp, extra=()):
    return ["--config_json", EXAMPLE, *SMALL, "--dataroot",
            str(tmp / "data"), "--checkpoints_dir", str(tmp / "ckpt"),
            *extra]


def models(tmp, monkeypatch, extra=(), seed=90):
    """The JAX and the port's b2b image models on one seeded tree."""
    args = small_args(tmp, extra)
    jopt = JaxTrainOptions().parse_cli(args)
    opt = TrainOptions().parse_cli(args)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    monkeypatch.setattr(jb2b, "init_net_state", fast_init_net_state(seed))
    jm = jax_create_model(jopt, phase="train")
    tm = create_model(opt, phase="train", device="cpu")
    assert not jm.is_video and not tm.is_video
    assert isinstance(tm.nets["G_A"], JiT)
    params = jax.device_get(jm.states["G_A"].params)
    for net in [tm.nets["G_A"]] + list(tm.ema_nets.values()):
        load_flax(net, params)
    return jm, tm


def images(seed, batch=B):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((batch, SIZE, SIZE, 1), np.int32)
    for i in range(batch):
        y0, x0 = rng.integers(0, 8, 2)
        mask[i, y0:y0 + 6, x0:x0 + 7] = 1
    cond = np.where(mask > 0, -1.0, gt).astype(np.float32)
    return {"A": cond, "B": gt, "B_label_mask": mask,
            "B_label_cls": np.arange(batch, dtype=np.int32) % 3}


def weights_close(i, tm, jm):
    bad = []
    state = jax.device_get(jm.states["G_A"])
    pairs = [(tm.nets["G_A"], state.params)]
    if state.ema_params is not None:
        pairs.append((tm.ema_nets["G_A"], state.ema_params))
    for net, tree in pairs:
        want = flax_to_torch(tree)
        for name, p in net.named_parameters():
            diff = (p.detach() - want[name]).abs()
            if (diff > 1e-4).float().mean() > FLIP_SHARE:
                bad.append((i, name, "share", int((diff > 1e-4).sum())))
            if diff.max() > 2 * LR * (i + 1) + 1e-4:
                bad.append((i, name, float(diff.max())))
    assert not bad, bad


def losses_close(got, want, label):
    assert set(got) == set(want), label
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), (label, k, float(got[k]), float(v))


def test_set_input_folds_clips_as_jax(tmp_path, monkeypatch):
    jm, tm = models(tmp_path, monkeypatch)
    rng = np.random.default_rng(1)
    clip = {"A": rng.uniform(-1, 1, (2, 3, SIZE, SIZE, 3)).astype(np.float32),
            "B": rng.uniform(-1, 1, (2, 3, SIZE, SIZE, 3)).astype(np.float32),
            "B_label_mask": rng.integers(0, 2, (2, 3, SIZE, SIZE, 1))
            .astype(np.int32)}
    want, got = jm.set_input(clip), tm.set_input(clip)
    assert set(got) == set(want) == {"gt", "mask", "y_cond"}
    for k in want:
        assert got[k].shape == (6, SIZE, SIZE) + want[k].shape[-1:]
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["MSE", "L1", "pseudo_huber", "multiscale",
                                  "multiscale_L1"])
@pytest.mark.parametrize("masked_only", [False, True])
def test_image_losses_match_jax(kind, masked_only):
    import types
    rng = np.random.default_rng(7)
    shape = (3, 12, 10, 3)
    v_pred, v_target = (rng.standard_normal(shape).astype(np.float32)
                        for _ in range(2))
    stub = types.SimpleNamespace(loss_kind=kind, masked_only=masked_only)
    pixel = (rng.uniform(size=shape[:-1] + (1,)) > 0.4).astype(np.float32)
    for mask in (pixel, None):
        want = float(jb2b.B2BModel._loss(
            stub, jnp.asarray(v_pred), jnp.asarray(v_target),
            None if mask is None else jnp.asarray(mask)))
        got = float(tb2b.B2BModel._loss(
            stub, torch.from_numpy(v_pred), torch.from_numpy(v_target),
            None if mask is None else torch.from_numpy(mask)))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (
            kind, masked_only, mask is None, got, want)


@pytest.mark.parametrize("extra", [
    ["--alg_b2b_loss", "L1"],
    ["--alg_b2b_loss", "pseudo_huber", "--alg_b2b_mask_as_channel"],
    ["--alg_b2b_loss", "multiscale_L1", "--alg_b2b_loss_masked_region_only",
     "--alg_b2b_mask_as_channel", "--alg_b2b_minsnr",
     "--alg_diffusion_dropout_prob", "0.5", "--G_vit_num_classes", "3",
     "--alg_b2b_mask_size_conditioning"]])
def test_option_step_matches_jax(tmp_path, monkeypatch, extra):
    jm, tm = models(tmp_path, monkeypatch, extra)
    batch = images(50)
    key = jax.random.PRNGKey(51)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    want = jm.optimize_prepared(jm.prepare_batch(batch))
    labels = (B,) if tm.num_classes > 1 else None
    got = tm.optimize_prepared(tm.prepare_batch(batch), draws=(
        jax_training_draws(key, batch["B"].shape, labels)))
    losses_close(got, want, extra)
    weights_close(0, tm, jm)


def test_three_step_trajectory_and_cfg_request_match_jax(tmp_path,
                                                         monkeypatch):
    extra = ["--G_vit_num_classes", "3", "--alg_diffusion_dropout_prob",
             "0.2"]
    jm, tm = models(tmp_path, monkeypatch, extra)
    start = flax_to_torch(jax.device_get(jm.states["G_A"].params))
    for i in range(3):
        batch, key = images(20 + i), jax.random.PRNGKey(30 + i)
        monkeypatch.setattr(jm, "next_rng", lambda k=key: k)
        want = jm.optimize_prepared(jm.prepare_batch(batch))
        got = tm.optimize_prepared(tm.prepare_batch(batch), draws=(
            jax_training_draws(key, batch["B"].shape, (B,))))
        losses_close(got, want, i)
        weights_close(i, tm, jm)
    assert max((p.detach() - start[n]).abs().max().item()
               for n, p in tm.nets["G_A"].named_parameters()) > 1e-4
    # a 3-step request with CFG on the EMA weights, the JAX noise fed
    batch, key = images(40), jax.random.PRNGKey(41)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    calls = []
    net = tm.ema_nets["G_A"]
    hook = net.register_forward_hook(lambda *a: calls.append(1))
    want = jm.inference(batch, denoise_timesteps=3, cfg_scale=2.0)
    got = tm.inference(batch, denoise_timesteps=3, cfg_scale=2.0, draws={
        "noise": _t(jax.random.normal(key, batch["B"].shape))})
    hook.remove()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    # 5 conditional calls (t = 0, 1/3, 1/3, 2/3, 2/3), the null class's
    # beside the 4 inside (0.1, 1)
    assert len(calls) == 9
    keep = np.broadcast_to(batch["B_label_mask"] == 0, got.shape)
    np.testing.assert_allclose(got[keep], batch["B"][keep], atol=1e-6)


def test_config_trains_and_serves_end_to_end(tmp_path):
    write_labeled(str(tmp_path / "data"), 4, 24, seed=3)
    opt = TrainOptions().parse_cli(small_args(tmp_path, [
        "--name", "b2b_img", "--train_n_epochs", "1",
        "--train_n_epochs_decay", "0", "--output_print_freq", str(B),
        "--output_display_freq", "0", "--alg_b2b_denoise_timesteps", "3"]))
    model = launch_training(opt, cpu=True)
    assert model.states["G_A"].step == 2 and set(model.loss_log) == {"G_tot"}
    ckpt = str(tmp_path / "ckpt" / "b2b_img" / "latest_net_G_A.pth")
    img = str(tmp_path / "data" / "trainA" / "imgs" / "0000.png")
    mask = str(tmp_path / "data" / "trainA" / "masks" / "0000.png")
    served, sopt = load_model_from_file(ckpt, cpu=True)
    assert served.denoise_timesteps == 3
    seen, infer = [], served.inference

    def recording_inference(batch, **kw):
        seen.append((batch, kw, infer(batch, **kw)))
        return seen[-1][2]
    served.inference = recording_inference
    for i, steps in enumerate((["--sampling_steps", "2"],
                               ["--alg_sc_denoise_inferstep", "4"])):
        out = str(tmp_path / f"out{i}")
        full, _, _ = gen.inference(gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--img_in", img, "--mask_in", mask,
            "--dir_out", out, "--seed", "0", "--cpu", *steps]),
            served, sopt)
        assert full.shape == (24, 24, 3)
        assert os.path.exists(os.path.join(out, "0000_generated.png"))
    assert [kw for _, kw, _ in seen] == [{"denoise_timesteps": 2},
                                         {"denoise_timesteps": 4}]
    for batch, _, fake in seen:
        assert fake.shape == (1, SIZE, SIZE, 3) and np.isfinite(fake).all()
        keep = np.broadcast_to(batch["B_label_mask"] == 0, fake.shape)
        assert keep.any() and not keep.all()
        np.testing.assert_allclose(fake[keep], batch["B"][keep], atol=1e-6)
    vid = TrainOptions().parse_cli(small_args(tmp_path, ["--G_netG",
                                                         "vit_vid"]))
    with pytest.raises(NotImplementedError, match="gen_vid_diffusion"):
        gen._check_supported(gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--img_in", img]), vid)
