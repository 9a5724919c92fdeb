"""b2b on video with the global context and object references, and palette
with the video JiT, in the port against the JAX package, on the CPU, fp32,
``example_b2b_vid_mario.json`` cut small as ``tests/test_torch_b2b.py``
cuts it (JiT depth 3, hidden 192, patch 4, 2 clips of 4 frames at 16 px),
the context at 16 px and the references at 8 px:

1. the object references as both models load them (PIL RGB, bicubic,
   [-1, 1]), bit for bit;
2. one step of ``B2BModel.optimize_prepared`` with ``tokens`` and two
   references, and with ``adaln``, the batch's ``B_global_context`` fed,
   against the JAX model's step with its keys replayed: losses to 1e-4
   (relative), G and its EMA with the Adam allowance; then a 3-step Heun
   request with the context against the JAX sampler to 1e-3. The JAX
   ``JiTViD`` with references is the package's with its one defect fixed
   (``tests/_torch_vid_context_common.py``);
3. ``tokens`` with a reference trained by ``train.py`` over the
   ``self_supervised_vid_mask_online`` layout (two steps), served by
   ``gen_vid_diffusion.py`` (no context: the zero image, as the JAX script)
   and by ``model.inference`` on a dataset batch with its context;
4. palette with ``G_netG vit_vid`` (the raw-t denoiser on clips, one mask
   channel): a step against the JAX ``_loss_fn`` and ``apply_updates``
   with its draws computed on the host (loss to 1e-4 relative, weights
   within 2 × lr), and 2 DDIM steps on clips from one y_T against the JAX
   sampler to 1e-3.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (fast_init_net_state, few_torch_threads,  # noqa: F401
                               load_flax)
from _torch_vid_context_common import fixed_vit_vid
from test_torch_b2b import (B, F, SIZE, _models, _t, _weights_close, clips,
                            jax_training_draws, small_cfg)
from test_torch_vid_palette import _host_draws
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import palette_model as jpm
from joligen_tpu.models import train_state as jts
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.models.modules import vit_vid as jvv_package
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch.data import create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.b2b_model import load_object_refs
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import palette_diffusion as tpd
from joligen_tpu_torch.models.modules.palette_diffusion import \
    continuous_gammas
from joligen_tpu_torch.models.modules.vit_vid import JiTViD
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_vid_diffusion as gen
from joligen_tpu_torch.tools.synthetic_datasets import write_video
from joligen_tpu_torch.train import launch_training

GC, OREF = 16, 8


def _refs(tmp, n, size=20):
    """``n`` PNG references of odd sizes (the load resizes them)."""
    rng = np.random.default_rng(9)
    paths = []
    for i in range(n):
        p = str(tmp / f"ref{i}.png")
        Image.fromarray(rng.integers(0, 256, (size + 3 * i, size, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def _context(mode, refs):
    return {"alg": {"b2b": {"global_context_mode": mode,
                            "global_context_size": GC,
                            "object_ref_paths": refs,
                            "object_ref_size": OREF}}}


def _with_context(batch, seed):
    rng = np.random.default_rng(seed)
    batch["B_global_context"] = rng.uniform(
        -1, 1, (B, F, GC, GC, 3)).astype(np.float32)
    return batch


@pytest.fixture
def fixed_jax_jitvid(monkeypatch):
    """The JAX b2b model builds the fixed copy of ``JiTViD``."""
    monkeypatch.setattr(jvv_package, "JiTViD", fixed_vit_vid().JiTViD)


@pytest.mark.parametrize("mode,n_ref", [("tokens", 2), ("adaln", 0)])
def test_context_step_and_request_match_jax(tmp_path, monkeypatch,
                                            fixed_jax_jitvid, mode, n_ref):
    refs = _refs(tmp_path, n_ref)
    jm, tm = _models(tmp_path, monkeypatch, _context(mode, refs))
    assert tm.gc_mode == jm.gc_mode == mode
    if n_ref:
        assert tm.object_refs.shape == (1, n_ref, OREF, OREF, 3)
        np.testing.assert_array_equal(tm.object_refs.numpy(),
                                      jm.object_refs)
        np.testing.assert_array_equal(load_object_refs(refs, OREF),
                                      jm.object_refs)
    net = tm.nets["G_A"]
    assert hasattr(net, "gc_embed" if mode == "tokens" else "gc_enc")
    batch, key = _with_context(clips(60), 61), jax.random.PRNGKey(62)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    want = jm.optimize_prepared(jm.prepare_batch(batch))
    got = tm.optimize_prepared(tm.prepare_batch(batch), draws=(
        jax_training_draws(key, batch["B"].shape)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), (k, float(got[k]), float(v))
    _weights_close(0, tm, jm)
    # the context reaches the sampler: a 3-step request on the EMA
    batch, key = _with_context(clips(63), 64), jax.random.PRNGKey(65)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    want = jm.inference(batch, denoise_timesteps=3)
    noise = {"noise": _t(jax.random.normal(key, batch["B"].shape))}
    got = tm.inference(batch, denoise_timesteps=3, draws=noise)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    if mode == "tokens":
        # and changes it: the same request without the context differs
        batch.pop("B_global_context")
        other = tm.inference(batch, denoise_timesteps=3, draws=noise)
        assert np.abs(other - got).max() > 1e-4


def test_context_and_refs_train_and_serve_end_to_end(tmp_path):
    write_video(str(tmp_path / "data"), 6, 32, seed=3)
    refs = _refs(tmp_path, 1)
    cfg = small_cfg(tmp_path, dict(_context("tokens", refs), name="gc"))
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.data_max_dataset_size = 4          # two steps of 2 clips
    model = launch_training(opt, cpu=True)
    assert model.states["G_A"].step == 2
    assert isinstance(model.nets["G_A"], JiTViD)
    assert model.nets["G_A"].oref_posemb.shape == (1, 4, 192)
    # a dataset batch carries its context into the sampler
    ds = create_dataset(opt)
    item = None
    while item is None:
        item = ds[0]
    assert item["B_global_context"].shape == (F, GC, GC, 3)
    batch = {k: v[None] for k, v in item.items()
             if isinstance(v, np.ndarray)}
    out = model.inference(batch, denoise_timesteps=2)
    assert out.shape == (1, F, SIZE, SIZE, 3) and np.isfinite(out).all()
    ckpt = str(tmp_path / "ckpt" / "gc" / "latest_net_G_A.pth")
    frames = str(tmp_path / "data" / "trainA" / "vid0")
    written = gen.inference(gen.build_parser().parse_args([
        "--model_in_file", ckpt, "--dir_in", frames,
        "--dir_out", str(tmp_path / "out"), "--sampling_steps", "2",
        "--seed", "0", "--cpu"]))
    assert len(written) == 6 and written[0].shape == (32, 32, 3)


def test_palette_with_the_video_jit_matches_jax(tmp_path, monkeypatch):
    cfg = small_cfg(tmp_path, {
        "model_type": "palette",
        "G": {"diff_n_timestep_train": 200, "diff_n_timestep_test": 50},
        "alg": {"diffusion": {"cond_embed": "mask"}}})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    monkeypatch.setattr(jpm, "init_net_state", fast_init_net_state(80))
    jm = jax_create_model(jopt, phase="test")
    tm = create_model(opt, phase="train", device="cpu")
    assert tm.is_video and isinstance(tm.nets["G_A"].inner, JiTViD)
    # [y_cond, y_t] and the clipped mask channel
    assert tm.nets["G_A"].inner.x_embed.proj1.weight.shape[1] == 4 * 4 * 7
    params = jax.device_get(jm.states["G_A"].params)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        load_flax(net, params)
    tx = jm.txs["G_A"]

    @jax.jit
    def jstep(state, key, y_cond, gt, mask):
        loss, grads = jax.value_and_grad(jm._loss_fn)(
            state.params, key, y_cond, gt, mask, None)
        return jts.apply_updates(state, grads, tx, jm.ema_beta), loss

    p = jax.tree.map(jnp.asarray, params)
    js = jts.NetState(params=p, opt_state=tx.init(p),
                      ema_params=jax.tree.map(jnp.copy, p),
                      step=jnp.zeros((), jnp.int32))
    batch, key = clips(70), jax.random.PRNGKey(71)
    inp = quantize_batch(jm.set_input(batch), float_keys=("y_cond", "gt"),
                         int_keys=("mask",))
    js, want = jstep(js, key, *(jnp.asarray(inp[k]) for k in (
        "y_cond", "gt", "mask")))
    d = _host_draws(key, jm.sched_train, batch["B"].shape)
    d["gammas"] = continuous_gammas(tm.sched_train, d["t"], d.pop("u"))
    losses = tm.optimize_prepared(tm.prepare_batch(batch), draws=d)
    np.testing.assert_allclose(losses["G_tot"].item(), float(want),
                               rtol=1e-4)
    host = jax.device_get(js)
    lr = float(opt.train_G_lr)
    for module, tree in ((tm.nets["G_A"], host.params),
                         (tm.ema_nets["G_A"], host.ema_params)):
        ref = flax_to_torch(tree)
        for k, v in module.state_dict().items():
            assert (v - ref[k]).abs().max() <= 2 * lr + 1e-4, k
    # DDIM over 2 steps from the same y_T (its one draw) on the same
    # weights, the JAX sampler against the port's
    rng = np.random.default_rng(74)
    batch = clips(72)
    y_t = rng.standard_normal(batch["B"].shape).astype(np.float32)
    mask = np.clip(batch["B_label_mask"], 0, 1)

    def japply(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return jm.netG.apply(p, x, g, cls=cls, mask=mask,
                             zero_gamma=zero_gamma)
    want = jpd.ddim_sample(
        japply, jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0),
        jm.sched_test, jnp.asarray(batch["A"]), y_t=jnp.asarray(y_t),
        y_0=jnp.asarray(batch["B"]), mask=jnp.asarray(mask), num_steps=2)
    load_flax(tm.nets["G_A"], params)
    net = tm.nets["G_A"]
    with torch.inference_mode():
        got = tpd.ddim_sample(
            lambda x, g, cls=None, mask=None, zero_gamma=False: net(
                x, g, cls=cls, mask=mask, zero_gamma=zero_gamma), None,
            tm.sched_test, torch.from_numpy(batch["A"]),
            y_t=torch.from_numpy(y_t), y_0=torch.from_numpy(batch["B"]),
            mask=torch.from_numpy(mask), num_steps=2).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=0)
