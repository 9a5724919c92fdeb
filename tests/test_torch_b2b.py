"""B2B flow matching on video in the port (``joligen_tpu_torch/models/
modules/b2b.py``, ``models/b2b_model.py``) against the JAX package, on the
CPU, fp32, with the JAX keys' draws fed to the port:

1. ``mask_size_condition`` equal to the JAX function, empty and full masks
   among the inputs;
2. ``b2b_training_outputs`` (video with the autoregressive ground-truth
   frame and its degradation, min-SNR, label dropout; images) to 1e-4, and
   ``b2b_sample`` (Heun with the final Euler step, the mask projection, CFG
   in its interval, clipping) to 1e-3, on the same denoiser stand-in;
3. ``B2BModel._loss`` (MSE, L1, pseudo-Huber, the multiscale MSE and L1,
   each with and without ``alg_b2b_loss_masked_region_only``, on a pixel
   mask, a per-frame keep mask and none) equal to the JAX model's to 1e-5;
   one step with the options the config leaves off (the mask as a channel,
   the masked multiscale L1, min-SNR, two classes with label dropout; the
   pseudo-Huber loss) against the JAX step, as the trajectory below;
   a 3-step AdamW + EMA trajectory of ``B2BModel.optimize_prepared`` on
   ``example_b2b_vid_mario.json`` cut small (JiT depth 3, hidden 192, patch
   4, 2 clips of 4 frames at 16 px; the autoregressive frame in most clips)
   against the JAX model's step, its keys replayed: losses (``G_tot``,
   ``G_ref_copy``) to 1e-4 (relative), parameters and EMA to 1e-4 with the
   Adam allowance of the other trajectories (at most 1 % of a leaf's
   elements past 1e-4, by at most 2 × lr a step); then a 3-step request
   against the JAX sampler to 1e-3;
4. checkpoints both ways (the port's files into the JAX model, the JAX
   model's into the port), G and its EMA bit for bit;
5. the config trained by ``train.py`` on a synthetic video set and served
   by ``gen_vid_diffusion.py`` (``--autoregressive``), with ``--cpu``;
6. the raises: ``tpu_mesh_fsdp`` 2 on one device (the perceptual option
   read);
   LoRA and the image backbone build (``test_torch_lora.py`` and
   ``test_torch_b2b_image.py`` hold them).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (fast_init_net_state, few_torch_threads,
                               load_flax)
from joligen_tpu.models import b2b_model as jb2b
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models.modules import b2b as jb
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import b2b_model as tb2b
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.base import check_mesh
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import b2b as tb
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_vid_diffusion as gen
from joligen_tpu_torch.tools.synthetic_datasets import write_video
from joligen_tpu_torch.train import launch_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, SIZE = 2, 4, 16
LR, FLIP_SHARE = 1e-4, 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks(seed, lead):
    rng = np.random.default_rng(seed)
    m = np.zeros(lead + (SIZE, SIZE, 1), np.int32)
    flat = m.reshape((-1, SIZE, SIZE, 1))
    for i in range(len(flat)):
        y0, x0 = rng.integers(0, SIZE - 4, 2)
        h, w = rng.integers(1, SIZE - max(y0, x0), 2)
        flat[i, y0:y0 + h, x0:x0 + w] = 1
    flat[0] = 0                    # an empty mask
    flat[-1] = 1                   # a full one
    return m


@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_mask_size_condition_matches_jax(lead):
    m = _masks(0, lead)
    want = np.asarray(jb.mask_size_condition(jnp.asarray(m), SIZE, SIZE))
    got = tb.mask_size_condition(torch.from_numpy(m), SIZE, SIZE)
    assert got.shape == lead + (6,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.reshape(-1, 6)[0].any() and want.reshape(-1, 6)[-1, 4] == 1


def _apply_pair(ncls):
    """A denoiser stand-in, the same function in both packages: it reads
    the noisy input, t, the labels (per clip) and the mask descriptor (per
    clip or frame)."""
    def fn(xp, z_in, t, labels, mask_size, to_float):
        z = z_in[..., -3:]
        out = z * (0.5 + t.reshape(t.shape + (1,) * (z.ndim - t.ndim)))
        out = out + 0.3 * z_in[..., :1]
        if labels is not None:
            lab = to_float(labels) / ncls
            out = out + lab.reshape(lab.shape + (1,) * (z.ndim - 1))
        if mask_size is not None:
            ms = mask_size.mean(-1)
            out = out + ms.reshape(ms.shape + (1,) * (z.ndim - ms.ndim))
        return xp.tanh(out)

    def jfn(params, *a):
        return fn(jnp, *a, lambda x: x.astype(jnp.float32))

    def tfn(*a):
        return fn(torch, *a, lambda x: x.float())
    return jfn, tfn


def jax_training_draws(key, shape, labels_shape=None):
    """``b2b_training_outputs``' draws from ``key``, in the JAX split order,
    as the port takes them."""
    r_t, r_n, r_d, r_g, r_gi, r_dg, r_dn = jax.random.split(key, 7)
    r1, r2, r3 = jax.random.split(r_t, 3)
    b = shape[0]
    d = {"t_normal": _t(jax.random.normal(r1, (b,))),
         "t_uniform": _t(jax.random.uniform(r2, (b,))),
         "t_mix": _t(jax.random.uniform(r3, (b,))),
         "noise": _t(jax.random.normal(r_n, shape)),
         "use_gt": _t(jax.random.uniform(r_g, (b,))),
         "degrade": _t(jax.random.uniform(r_dg, (b,))),
         "degrade_noise": _t(jax.random.normal(r_dn, shape))}
    if len(shape) == 5:
        d["ref_idx"] = _t(jax.random.randint(r_gi, (b,), 0, shape[1]))
    if labels_shape is not None:
        d["drop"] = _t(jax.random.uniform(r_d, labels_shape))
    return d


@pytest.mark.parametrize("video,kw", [
    (True, dict(use_gt_prob=0.7, degrade_prob=0.6, degrade_std=0.2,
                minsnr=True, label_drop_prob=0.5)),
    (True, dict(use_gt_prob=0.0, uniform_mix_prob=0.5)),
    (False, dict(minsnr=True, label_drop_prob=0.3, noise_scale=2.0))])
def test_training_outputs_match_jax(video, kw):
    lead = (4, F) if video else (4,)
    rng = np.random.default_rng(1)
    y0 = rng.uniform(-1, 1, lead + (SIZE, SIZE, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, y0.shape).astype(np.float32)
    mask = _masks(2, lead)
    labels = np.array([0, 1, 2, 1], np.int32)
    ms = np.array(jb.mask_size_condition(jnp.asarray(mask), SIZE, SIZE))
    jfn, tfn = _apply_pair(3)
    key = jax.random.PRNGKey(11)
    want = jb.b2b_training_outputs(
        jfn, None, key, jnp.asarray(y0), y_cond=jnp.asarray(cond),
        mask=jnp.asarray(mask), labels=jnp.asarray(labels), num_classes=3,
        mask_size=jnp.asarray(ms), **kw)
    got = tb.b2b_training_outputs(
        tfn, None, torch.from_numpy(y0), y_cond=torch.from_numpy(cond),
        mask=torch.from_numpy(mask), labels=torch.from_numpy(labels),
        num_classes=3, mask_size=torch.from_numpy(ms),
        draws=jax_training_draws(key, y0.shape, labels.shape), **kw)
    assert (got[4] is None) == (want[4] is None)
    if video and kw.get("use_gt_prob"):
        assert float(got[4].sum()) > 0      # clips with the clean frame
    for name, g, w in zip(("v_pred", "v_target", "loss_mask", "x_pred",
                           "is_ref"), got, want):
        if w is None:
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(denoise_timesteps=5),
    dict(denoise_timesteps=4, cfg_scale=2.0, cfg_interval=(0.3, 0.9),
         clip_denoised=True),
    dict(denoise_timesteps=1, noise_scale=2.0)])
def test_sampler_matches_jax(kw):
    rng = np.random.default_rng(3)
    y = rng.uniform(-1, 1, (2, F, SIZE, SIZE, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, y.shape).astype(np.float32)
    mask = _masks(4, (2, F))
    labels = np.array([1, 2], np.int32)
    ms = np.array(jb.mask_size_condition(jnp.asarray(mask), SIZE, SIZE))
    jfn, tfn = _apply_pair(3)
    calls = []

    def counted(*a):
        calls.append(1)
        return tfn(*a)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jb.b2b_sample(
        jfn, None, key, jnp.asarray(y), y_cond=jnp.asarray(cond),
        mask=jnp.asarray(mask), labels=jnp.asarray(labels), num_classes=3,
        mask_size=jnp.asarray(ms), **kw))
    got = tb.b2b_sample(
        counted, None, torch.from_numpy(y), y_cond=torch.from_numpy(cond),
        mask=torch.from_numpy(mask), labels=torch.from_numpy(labels),
        num_classes=3, mask_size=torch.from_numpy(ms),
        draws={"noise": _t(jax.random.normal(key, y.shape))}, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    # outside the mask the clip is kept
    np.testing.assert_allclose(got.numpy()[mask[..., 0] == 0],
                               y[mask[..., 0] == 0], atol=1e-6)
    n = kw["denoise_timesteps"]
    if "cfg_scale" not in kw:
        assert len(calls) == 2 * n - 1


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
    return dst


def small_cfg(tmp, extra=None):
    """example_b2b_vid_mario.json cut small: JiT depth 3 (the in-context
    tokens inserted at block 1), hidden 192, 3 heads, patch 4, 8 in-context
    tokens, clips of 4 frames at 16 px, batch 2, fp32, the mesh on one
    device."""
    with open(os.path.join(ROOT, "examples",
                           "example_b2b_vid_mario.json")) as f:
        cfg = json.load(f)
    _merge(cfg, {
        "dataroot": str(tmp / "data"), "checkpoints_dir": str(tmp / "ckpt"),
        "data": {"load_size": SIZE, "crop_size": SIZE, "num_threads": 1,
                 "temporal_number_frames": F,
                 "online_creation": {"crop_size_A": 24, "crop_delta_A": 4}},
        "G": {"vit_depth": 3, "vit_hidden_size": 192, "vit_num_heads": 3,
              "vit_patch_size": 4, "vit_in_context_start": 1,
              "vit_in_context_len": 8, "vit_bottleneck_dim": 32},
        "alg": {"b2b": {"use_gt_prob": 0.9}},
        "train": {"batch_size": B, "n_epochs": 1, "n_epochs_decay": 0,
                  "G_ema_beta": 0.9},
        "output": {"print_freq": B, "display_freq": 0},
        "tpu": {"bf16": False, "mesh_fsdp": 1}})
    return _merge(cfg, extra or {})


def _models(tmp_path, monkeypatch, extra=None):
    cfg = small_cfg(tmp_path, extra)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    monkeypatch.setattr(jb2b, "init_net_state", fast_init_net_state(70))
    jm = jax_create_model(jopt, phase="train")
    tm = create_model(opt, phase="train", device="cpu")
    params = jax.device_get(jm.states["G_A"].params)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        load_flax(net, params)
    return jm, tm


def clips(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (B, F, SIZE, SIZE, 3)).astype(np.float32)
    mask = _masks(seed, (B, F))
    mask[:, :, 4:10, 3:11] = 1                 # no empty mask here
    cond = np.where(mask > 0, -1.0, gt).astype(np.float32)
    return {"A": cond, "B": gt, "B_label_mask": mask,
            "temporal_frame_step": np.array([1, 3], np.int32)}


def _weights_close(i, tm, jm):
    bad = []
    state = jax.device_get(jm.states["G_A"])
    for net, tree in ((tm.nets["G_A"], state.params),
                      (tm.ema_nets["G_A"], state.ema_params)):
        want = flax_to_torch(tree)
        for name, p in net.named_parameters():
            diff = (p.detach() - want[name]).abs()
            if (diff > 1e-4).float().mean() > FLIP_SHARE:
                bad.append((i, name, "share", int((diff > 1e-4).sum())))
            if diff.max() > 2 * LR * (i + 1) + 1e-4:
                bad.append((i, name, float(diff.max())))
    assert not bad, bad


@pytest.mark.parametrize("kind", ["MSE", "L1", "pseudo_huber", "multiscale",
                                  "multiscale_L1"])
@pytest.mark.parametrize("masked_only", [False, True])
def test_losses_match_jax(kind, masked_only):
    import types
    rng = np.random.default_rng(7)
    shape = (2, 3, 12, 10, 3)
    v_pred, v_target = (rng.standard_normal(shape).astype(np.float32)
                        for _ in range(2))
    stub = types.SimpleNamespace(loss_kind=kind, masked_only=masked_only)
    pixel = (rng.uniform(size=shape[:-1] + (1,)) > 0.4).astype(np.float32)
    keep = np.ones(shape[:2] + (1, 1, 1), np.float32)
    keep[0, 1] = 0
    for mask in (pixel, keep, None):
        want = float(jb2b.B2BModel._loss(
            stub, jnp.asarray(v_pred), jnp.asarray(v_target),
            None if mask is None else jnp.asarray(mask)))
        got = float(tb2b.B2BModel._loss(
            stub, torch.from_numpy(v_pred), torch.from_numpy(v_target),
            None if mask is None else torch.from_numpy(mask)))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (
            kind, masked_only, None if mask is None else mask.shape, got,
            want)


@pytest.mark.parametrize("extra", [
    {"alg": {"b2b": {"mask_as_channel": True, "loss": "multiscale_L1",
                     "loss_masked_region_only": True, "minsnr": True},
             "diffusion": {"dropout_prob": 0.5}},
     "G": {"vit_num_classes": 2}},
    {"alg": {"b2b": {"loss": "pseudo_huber", "autoregressive": False}}}])
def test_option_step_matches_jax(tmp_path, monkeypatch, extra):
    jm, tm = _models(tmp_path, monkeypatch, extra)
    batch = clips(50)
    batch["B_label_cls"] = np.array([1, 0], np.int32)
    key = jax.random.PRNGKey(51)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    want = jm.optimize_prepared(jm.prepare_batch(batch))
    labels = (B,) if tm.num_classes > 1 else None
    got = tm.optimize_prepared(tm.prepare_batch(batch), draws=(
        jax_training_draws(key, batch["B"].shape, labels)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), (k, float(got[k]), float(v))
    _weights_close(0, tm, jm)


def test_three_step_trajectory_and_request_match_jax(tmp_path, monkeypatch):
    jm, tm = _models(tmp_path, monkeypatch)
    assert tm.use_gt_prob == jm.use_gt_prob == 0.9
    start = flax_to_torch(jax.device_get(jm.states["G_A"].params))
    refs = 0
    for i in range(3):
        batch, key = clips(20 + i), jax.random.PRNGKey(30 + i)
        monkeypatch.setattr(jm, "next_rng", lambda k=key: k)
        want = jm.optimize_prepared(jm.prepare_batch(batch))
        draws = jax_training_draws(key, batch["B"].shape)
        refs += int((draws["use_gt"] < 0.9).sum())
        got = tm.optimize_prepared(tm.prepare_batch(batch), draws=draws)
        assert set(got) == set(want) == {"G_tot", "G_ref_copy"}
        for k, v in want.items():
            assert abs(float(got[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(got[k]), float(v))
        _weights_close(i, tm, jm)
    assert refs > 0
    assert max((p.detach() - start[n]).abs().max().item()
               for n, p in tm.nets["G_A"].named_parameters()) > 1e-4
    # a 3-step request on the EMA weights, the JAX noise fed
    batch, key = clips(40), jax.random.PRNGKey(41)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    want = jm.inference(batch, denoise_timesteps=3)
    got = tm.inference(batch, denoise_timesteps=3, draws={
        "noise": _t(jax.random.normal(key, batch["B"].shape))})
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def _nets_equal(pairs):
    for net, tree in pairs:
        want = flax_to_torch(jax.device_get(tree))
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    jm, tm = _models(tmp_path, monkeypatch)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.01)
    tm.save_networks("port")
    jm.load_networks("port", load_optim=False)
    _nets_equal(((tm.nets["G_A"], jm.states["G_A"].params),
                 (tm.ema_nets["G_A"], jm.states["G_A"].ema_params)))
    jm.states["G_A"] = jm.states["G_A"].replace(params=jax.tree.map(
        lambda x: x * 0.5, jm.states["G_A"].params))
    jm.save_networks("jax")
    served = create_model(tm.opt, phase="test", device="cpu")
    served.load_networks("jax")
    _nets_equal(((served.nets["G_A"], jm.states["G_A"].params),
                 (served.ema_nets["G_A"], jm.states["G_A"].ema_params)))


def test_config_trains_and_serves_end_to_end(tmp_path):
    write_video(str(tmp_path / "data"), 6, 32, seed=3)
    cfg = small_cfg(tmp_path, {"name": "b2b"})
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.data_max_dataset_size = 4          # two steps of 2 clips
    model = launch_training(opt, cpu=True)
    assert model.states["G_A"].step == 2
    assert set(model.loss_log) == {"G_tot", "G_ref_copy"}
    ckpt = str(tmp_path / "ckpt" / "b2b" / "latest_net_G_A.pth")
    assert os.path.exists(ckpt)
    frames = str(tmp_path / "data" / "trainA" / "vid0")
    out = str(tmp_path / "out")
    written = gen.inference(gen.build_parser().parse_args([
        "--model_in_file", ckpt, "--dir_in", frames, "--dir_out", out,
        "--sampling_steps", "2", "--autoregressive", "--seed", "0",
        "--cpu"]))
    assert len(written) == 6 and written[0].shape == (32, 32, 3)
    assert sorted(os.listdir(out)) == [f"frame_{i:05d}_generated.png"
                                       for i in range(6)]


def test_raises(tmp_path):
    opt = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
    check_mesh(opt)
    for key, value in (("tpu_mesh_fsdp", 2), ("tpu_mesh_data", 2),
                       ("tpu_mesh_tensor", 2)):
        bad = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
        setattr(bad, key, value)
        with pytest.raises(NotImplementedError, match="item 15"):
            create_model(bad, device="cpu")
    ok = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
    ok.alg_b2b_perceptual_loss = ["DISTS"]     # read, as the JAX model
    assert create_model(ok, device="cpu").perceptual == ["DISTS"]
    for key, value in (("alg_b2b_lora", True), ("G_netG", "vit")):
        ok = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
        setattr(ok, key, value)
        model = create_model(ok, device="cpu")
        assert model.is_video == (ok.G_netG == "vit_vid")
        assert ("G_lora" in model.nets) == ok.alg_b2b_lora
