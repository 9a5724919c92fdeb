"""Video palette on the port (the temporal datasets, ``set_input`` on clips,
the training loss and step, ``train.py`` and ``scripts/gen_vid_diffusion.py``;
the samplers are in ``test_torch_vid_samplers.py``) against the JAX
package, on the CPU, fp32:

1. the three online video modes' items, with ``random`` and numpy seeded
   alike, equal to the JAX package's;
2. ``set_input`` with ``previous_frame`` (training, with numpy's draws;
   serving; an image G on clips) and with canny sketches under the
   per-frame dropout, equal to the JAX package's;
3. a 3-step AdamW+EMA trajectory of ``optimize_prepared`` on
   ``example_ddpm_vid_mario.json`` cut small (2 clips of 4 frames at 16 px,
   min-SNR, the autoregressive context), against the JAX ``_loss_fn`` and
   ``apply_updates`` with its draws computed on the host from the same
   keys: losses 1e-4 (relative), parameters and EMA 2e-5 but for the
   elements whose gradient is 0 in exact arithmetic (Adam's allowance, 2 ×
   lr a step);
4. the video config trained for two steps by ``train.py`` and served by
   ``gen_vid_diffusion.py`` (``--autoregressive``, ``--direction
   backward``, ``--cond_canny``, ``--cls_progress``); the script's batches
   and written frames equal to the JAX script's on the same stub model; the
   raises;
5. the b2b global context of each frame from the three modes, equal to
   the JAX package's.
"""

import importlib.util
import json
import os
import random
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import fast_init_net_state, few_torch_threads, \
    load_flax
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import palette_model as jpm
from joligen_tpu.models import train_state as jts
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch.data import PORTED_MODES, create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models import palette_model as tpm
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules.palette_diffusion import \
    continuous_gammas
from joligen_tpu_torch.models.modules.unet_vid import UNetVid
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_vid_diffusion as gen
from joligen_tpu_torch.tools.synthetic_datasets import write_video
from joligen_tpu_torch.train import launch_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, SIZE = 2, 4, 16
VID_MODES = ("temporal_labeled_mask_online",
             "self_supervised_vid_mask_online",
             "self_supervised_vid_labeled_mask_cls_online")


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
    return dst


def _vid_cfg(tmp, extra=None):
    """example_ddpm_vid_mario.json cut small: ngf 16, two levels, 4 frames
    at 16 px crops of 32 px frames, fp32."""
    with open(os.path.join(ROOT, "examples",
                           "example_ddpm_vid_mario.json")) as f:
        cfg = json.load(f)
    _merge(cfg, {
        "dataroot": str(tmp / "data"), "checkpoints_dir": str(tmp / "ckpt"),
        "data": {"load_size": SIZE, "crop_size": SIZE, "num_threads": 1,
                 "temporal": {"number_frames": F},
                 "online_creation": {"crop_size_A": 24, "crop_delta_A": 6}},
        "G": {"ngf": 16, "unet_mha": {"channel_mults": [1, 2],
                                      "res_blocks": [1, 1],
                                      "num_head_channels": 16,
                                      "group_norm_size": 8},
              "diff_n_timestep_train": 200, "diff_n_timestep_test": 50},
        "train": {"batch_size": B, "iter_size": 1, "n_epochs": 1,
                  "n_epochs_decay": 0, "G_ema_beta": 0.9,
                  "save_epoch_freq": 100},
        "output": {"print_freq": B, "display_freq": 0},
        "tpu": {"bf16": False},
    })
    return _merge(cfg, extra or {})


@pytest.mark.parametrize("mode", VID_MODES)
def test_video_dataset_items_match_jax(tmp_path, mode):
    assert mode in PORTED_MODES
    write_video(str(tmp_path / "data"), 6, 32, seed=1, domains=("A", "B"))
    cfg = _vid_cfg(tmp_path, {"data": {
        "dataset_mode": mode,
        "online_creation": {"crop_size_B": 24, "crop_delta_B": 6}}})
    jds = jax_create_dataset(JaxTrainOptions().parse_json(cfg, verbose=False))
    tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False))
    assert len(tds) == len(jds) == 12
    for i in range(4):
        items = []
        for ds in (jds, tds):
            random.seed(10 + i)
            np.random.seed(20 + i)
            items.append(ds[i])
        want, got = items
        assert sorted(got) == sorted(want)
        assert got["A"].shape == (F, SIZE, SIZE, 3)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k


def test_b2b_global_context_raises(tmp_path):
    """The b2b global context, refused until it was ported, now comes with
    every clip of the three video modes: each frame's whole image with
    frame 0's crop window blacked out, PIL bicubic to
    ``alg_b2b_global_context_size``, in [-1, 1] (``A_global_context``, and
    ``B_global_context`` from B's clip or, self-supervised, the same),
    equal to the JAX package's items with ``random`` and numpy seeded
    alike."""
    write_video(str(tmp_path / "data"), 6, 32, seed=2, domains=("A", "B"))
    for mode in VID_MODES:
        cfg = _vid_cfg(tmp_path, {
            "data": {"dataset_mode": mode,
                     "online_creation": {"crop_size_B": 24,
                                         "crop_delta_B": 6}},
            "alg": {"b2b": {"global_context_mode": "tokens",
                            "global_context_size": 12}}})
        jds = jax_create_dataset(JaxTrainOptions().parse_json(
            cfg, verbose=False))
        tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False))
        for i in range(3):
            items = []
            for ds in (jds, tds):
                random.seed(30 + i)
                np.random.seed(40 + i)
                items.append(ds[i])
            want, got = items
            assert sorted(got) == sorted(want)
            for k in ("A_global_context", "B_global_context"):
                assert got[k].shape == (F, 12, 12, 3)
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            # the blacked-out window: black pixels, -1 after scaling
            assert (got["A_global_context"] == -1.0).any()
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)


def _clips(seed, batch=B, frames=F):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (batch, frames, SIZE, SIZE, 3)).astype(
        np.float32)
    mask = np.zeros((batch, frames, SIZE, SIZE, 1), np.int32)
    for b in range(batch):
        x0, y0 = rng.integers(1, SIZE // 2, 2)
        mask[b, :, y0:y0 + 6, x0:x0 + 7] = 1
    cond = np.where(mask > 0, rng.uniform(-1, 1, gt.shape), gt).astype(
        np.float32)
    return {"A": cond, "B": gt, "B_label_mask": mask}


def _stub(opt, phase, is_video=True):
    return types.SimpleNamespace(
        opt=opt, phase=phase, task="inpainting", conditioning="",
        is_video=is_video, use_ref=False)


@pytest.mark.parametrize("creation,phase,is_video", [
    ("previous_frame", "train", True), ("previous_frame", "test", True),
    ("previous_frame", "train", False), ("computed_sketch", "train", True)])
def test_set_input_on_clips_matches_jax(tmp_path, creation, phase, is_video):
    cfg = _vid_cfg(tmp_path, {"alg": {"diffusion": {
        "cond_image_creation": creation,
        "cond_computed_sketch_list": ["canny"],
        "cond_sketch_canny_range": [100, 650],
        "cond_prob_use_previous_frame": 0.5,
        "vid_canny_dropout": [[0.3], [0.6]]}}})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    topt = TrainOptions().parse_json(cfg, verbose=False)
    batch = _clips(3, batch=3)
    outs = []
    for cls, opt in ((jpm.PaletteModel, jopt), (tpm.PaletteModel, topt)):
        random.seed(5)
        np.random.seed(6)
        outs.append(cls.set_input(_stub(opt, phase, is_video), batch))
    want, got = outs
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    lead = (3, F) if is_video else (3 * F,)
    assert got["y_cond"].shape == lead + (SIZE, SIZE, 3)
    if creation == "previous_frame":
        y = got["y_cond"].reshape(3, F, SIZE, SIZE, 3)
        np.random.seed(6)
        drop = (np.random.rand(3, F) >= 0.5 if phase == "train"
                else np.zeros((3, F), bool))
        prev = np.concatenate([batch["A"][:, :1], batch["A"][:, :-1]], 1)
        for b in range(3):
            for f in range(F):
                want_f = -1.0 if drop[b, f] else prev[b, f]
                np.testing.assert_array_equal(y[b, f], np.broadcast_to(
                    want_f, y[b, f].shape))
        assert drop.any() or phase == "test"


def _loss_models(tmp_path):
    cfg = _vid_cfg(tmp_path, {"alg": {"palette": {"minsnr": True,
                                                  "autoregressive": True}},
                              "train": {"optim": "adamw"}})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    return jopt, opt


def _host_draws(key, sched, shape):
    """JAX ``_loss_fn``'s draws from ``key`` (its split order), computed on
    the host: the autoregressive context's, then the training forward's."""
    b = shape[0]
    rng, rng_ar = jax.random.split(key)
    r1, r2, r3 = jax.random.split(rng_ar, 3)
    rng_g, rng_n, _ = jax.random.split(rng, 3)
    rng_t, rng_u = jax.random.split(rng_g)
    t = np.asarray(jax.random.randint(rng_t, (b,), 1, sched.num_timesteps))
    u = np.asarray(jax.random.uniform(rng_u, (b,)))
    return {"t": torch.from_numpy(t).long(),
            "u": torch.from_numpy(u),
            "noise": torch.from_numpy(np.asarray(
                jax.random.normal(rng_n, shape, jnp.float32))),
            "autoregressive": {
                "bucket": torch.from_numpy(np.asarray(
                    jax.random.randint(r1, (b,), 0, 10))),
                "eps": torch.from_numpy(np.asarray(jax.random.normal(
                    r2, (b, 1) + shape[2:], jnp.float32))),
                "use_u": torch.tensor(float(jax.random.uniform(r3, ())))}}


def test_three_step_trajectory_matches_jax(tmp_path, monkeypatch):
    jopt, opt = _loss_models(tmp_path)
    monkeypatch.setattr(jpm, "init_net_state", fast_init_net_state(60))
    jm = jax_create_model(jopt, phase="test")
    tm = create_model(opt, phase="train", device="cpu")
    assert jm.is_video and tm.is_video and isinstance(tm.nets["G_A"].inner,
                                                      UNetVid)
    params = jax.device_get(jm.states["G_A"].params)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        load_flax(net, params)
    tx = jm.txs["G_A"]

    @jax.jit
    def jstep(state, key, y_cond, gt, mask):
        loss, grads = jax.value_and_grad(jm._loss_fn)(
            state.params, key, y_cond, gt, mask, None)
        return jts.apply_updates(state, grads, tx, jm.ema_beta), loss, grads

    p = jax.tree.map(jnp.asarray, params)
    js = jts.NetState(params=p, opt_state=tx.init(p),
                      ema_params=jax.tree.map(jnp.copy, p),
                      step=jnp.zeros((), jnp.int32))
    used = []
    for i in range(3):
        batch, key = _clips(30 + i), jax.random.PRNGKey(40 + i)
        inp = quantize_batch(jm.set_input(batch), float_keys=("y_cond", "gt"),
                             int_keys=("mask",))
        js, want, grads = jstep(js, key, *(jnp.asarray(inp[k]) for k in (
            "y_cond", "gt", "mask")))
        if i == 0:
            g0 = flax_to_torch(jax.device_get(grads))
        d = _host_draws(key, jm.sched_train, batch["B"].shape)
        used.append(float(d["autoregressive"]["use_u"]) < 0.9)
        d["gammas"] = continuous_gammas(tm.sched_train, d["t"], d.pop("u"))
        losses = tm.optimize_prepared(tm.prepare_batch(batch), draws=d)
        np.testing.assert_allclose(losses["G_tot"].item(), float(want),
                                   rtol=1e-4)
    assert any(used)          # the context replaced frames in some step
    top = max(g.abs().max().item() for g in g0.values())
    lr = float(opt.train_G_lr)
    host = jax.device_get(js)
    for module, tree in ((tm.nets["G_A"], host.params),
                         (tm.ema_nets["G_A"], host.ema_params)):
        want = flax_to_torch(tree)
        for k, v in module.state_dict().items():
            noise = g0[k].abs() <= 1e-7 * top
            diff = (v - want[k]).abs()
            assert (~noise).sum() == 0 or diff[~noise].max() <= 2e-5, k
            assert not noise.any() or diff[noise].max() <= 2 * lr * 3, k
    start = flax_to_torch(params)
    assert max((v - start[k]).abs().max().item()
               for k, v in tm.nets["G_A"].state_dict().items()) > 1e-4


def _jax_script():
    path = os.path.join(ROOT, "scripts", "gen_vid_diffusion.py")
    spec = importlib.util.spec_from_file_location("jax_gen_vid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _StubModel:
    """A model whose output is a fixed function of its batch, so that two
    scripts given the same batches write the same frames."""

    def __init__(self):
        self.batches = []
        self.generator = torch.Generator()

    def inference(self, batch, **kw):
        self.batches.append((batch, kw))
        return np.tanh(batch["B"] + 0.5 * batch["A"]).astype(np.float32)


def test_gen_vid_script_matches_jax_script(tmp_path, monkeypatch):
    write_video(str(tmp_path / "data"), 7, 32, seed=2)
    cfg = _vid_cfg(tmp_path, {"data": {"online_creation": {
        "crop_delta_A": 0}}})
    opts = (JaxTrainOptions().parse_json(cfg, verbose=False),
            TrainOptions().parse_json(cfg, verbose=False))
    jgen = _jax_script()
    frames_dir = str(tmp_path / "data" / "trainA" / "vid1")
    runs = {}
    for name, script, opt in (("jax", jgen, opts[0]), ("port", gen, opts[1])):
        stub = _StubModel()
        monkeypatch.setattr(script, "load_model_from_file",
                            lambda f, cpu=False, s=stub, o=opt: (s, o))
        out = str(tmp_path / name)
        args = script.build_parser().parse_args([
            "--model_in_file", "ckpt.pth", "--dir_in", frames_dir,
            "--dir_out", out, "--autoregressive", "--context_frames", "2",
            "--context_noise_sigma", "0.3", "--direction", "backward",
            "--cls_progress", "1", "2", "--sampling_steps", "10",
            "--seed", "4", "--cpu"])
        script.inference(args)
        runs[name] = (stub.batches, out)
    (jb, jout), (tb, tout) = runs["jax"], runs["port"]
    # 7 frames: two clips of 4, the tail padded; the second clip carries
    # two context frames
    assert len(jb) == len(tb) == 2
    for (bj, kj), (bt, kt) in zip(jb, tb):
        assert kj == kt == {"sampling_method": "ddim", "num_steps": 10}
        assert sorted(bj) == sorted(bt)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    assert not tb[1][0]["B_label_mask"][0, :2].any()
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 7
    from PIL import Image
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(
            os.path.join(tout, n))), np.asarray(Image.open(
                os.path.join(jout, n))))


def test_video_config_trains_and_serves_end_to_end(tmp_path):
    write_video(str(tmp_path / "data"), 6, 32, seed=3)
    cfg = _vid_cfg(tmp_path, {"name": "vid", "train": {"iter_size": 2}})
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.data_max_dataset_size = 4          # two steps of 2 clips
    model = launch_training(opt, cpu=True)
    assert model.states["G_A"].tx.gradient_step == 1
    ckpt = str(tmp_path / "ckpt" / "vid" / "latest_net_G_A.pth")
    assert os.path.exists(ckpt)
    frames = str(tmp_path / "data" / "trainA" / "vid0")
    for extra in (["--autoregressive", "--context_noise_sigma", "0.2"],
                  ["--direction", "backward", "--cond_canny"]):
        out = str(tmp_path / f"out{len(extra)}")
        written = gen.inference(gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--dir_in", frames, "--dir_out", out,
            "--sampling_steps", "2", "--seed", "0", "--cpu", *extra]))
        assert len(written) == 6 and written[0].shape == (32, 32, 3)
        assert sorted(os.listdir(out)) == [f"frame_{i:05d}_generated.png"
                                           for i in range(6)]
    with pytest.raises(NotImplementedError, match="item 16"):
        gen.inference(gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--dir_in", frames, "--cpu",
            "--video_out", str(tmp_path / "v.mp4")]))
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as single
    with pytest.raises(NotImplementedError, match="gen_vid_diffusion"):
        single.inference(single.build_parser().parse_args([
            "--model_in_file", ckpt, "--img_in",
            os.path.join(frames, "frame_000.png"), "--cpu"]))
