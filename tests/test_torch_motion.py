"""The video denoiser's modules on the port (``models/modules/motion.py``,
``unet_vid.py``) against the JAX package, on the CPU, fp32, with seeded
weights in which every leaf, the zero-initialised ``proj_out`` and
``out_proj`` included, is non-zero:

1. the position table (exact), ``GEGLU``, ``TemporalSelfAttention`` and
   ``MotionModule`` (8 heads of 2 over 4 frames), forward and every
   gradient, to 1e-4 of the largest;
2. ``UNetVid`` with two levels (ngf 16, one res block a level, attention at
   ds 2) over B = 2 clips of 4 frames at 16 px with distinct embeddings
   (``repeat`` would give the wrong clip's embedding to a frame), forward
   and every gradient, the input's included, to 1e-4 of the largest;
3. the converter both ways on the ``UNetVid`` tree, bit for bit;
4. every name and shape of ``example_ddpm_vid_mario.json``'s trunk at full
   width against ``jax.eval_shape`` (132,643,651 parameters, 73,296,000 of
   them in the 20 motion modules), built on the meta device;
5. a fresh ``MotionModule`` is the identity (``proj_out`` is zero).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (err_and_scale, few_torch_threads, grads_close,
                               load_flax, seeded_tree, to_np)
from joligen_tpu.models import diffusion_networks as jdn
from joligen_tpu.models.modules import motion as jmotion
from joligen_tpu.models.modules import unet_vid as jvid
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import diffusion_networks as tdn
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import motion as tmotion
from joligen_tpu_torch.models.modules import unet_vid as tvid
from joligen_tpu_torch.options import TrainOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, H, W, C = 2, 4, 4, 4, 16
NET = dict(in_channel=6, out_channel=3, inner_channel=16, cond_embed_dim=32,
           res_blocks=(1, 1), attn_res=(2,), channel_mults=(1, 2),
           num_head_channels=16, group_size=4)
EXPECTED_PARAMS = 132_643_651
EXPECTED_MOTION_PARAMS = 73_296_000


def _rand(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _shapes(module, *args):
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)


def _check(got, want, tol=1e-4):
    err, scale = err_and_scale(got, want, norm=False)
    assert err <= tol * max(scale, 1e-6), (err, scale)


def _jax_vjp(apply, params, x, cot_seed):
    """(output, parameter gradients, input gradient) of ``apply(params, x)``
    for the cotangent ``_rand(cot_seed, output shape)``, in one jitted
    program."""
    shape = jax.eval_shape(apply, params, x).shape
    cot = _rand(cot_seed, shape)

    def run(p, a):
        out, vjp = jax.vjp(apply, p, a)
        return (out,) + vjp(jnp.asarray(cot))
    out, g_p, g_x = jax.jit(run)(params, x)
    return np.asarray(out), g_p, np.asarray(g_x), cot


def _parity(jmod, tmod, x_np, seed):
    """Forward and every gradient (parameters and input) of a seeded
    ``jmod`` on (..., C) and of ``tmod`` loaded with the same tree, for the
    loss sum(out * cotangent)."""
    params = seeded_tree(_shapes(jmod, jnp.asarray(x_np)), seed, lecun=True)
    load_flax(tmod, params)
    want, jg_p, jg_x, cot = _jax_vjp(jmod.apply, params, jnp.asarray(x_np),
                                     seed + 1)
    xt = torch.from_numpy(x_np).requires_grad_()
    out = tmod(xt)
    _check(to_np(out), want)
    (out * torch.from_numpy(cot)).sum().backward()
    _check(to_np(xt.grad), jg_x)
    grads_close(jg_p, tmod, rtol=1e-4, floor=1e-6)


def test_position_table_matches_jax():
    for max_len, d in ((25, 64), (25, 16), (8, 6)):
        np.testing.assert_array_equal(tmotion.temporal_pos_encoding(max_len, d),
                                      jmotion.temporal_pos_encoding(max_len, d))


def test_geglu_matches_jax():
    x = _rand(0, (3, 5, C))
    _parity(jmotion.GEGLU(4 * C), tmotion.GEGLU(C, 4 * C), x, seed=10)


def test_temporal_self_attention_matches_jax():
    x = _rand(1, (6, F, C))
    _parity(jmotion.TemporalSelfAttention(8), tmotion.TemporalSelfAttention(
        C, 8), x, seed=20)


def _nchw(t):       # (B, F, H, W, C) -> (B*F, C, H, W)
    return t.reshape((-1,) + tuple(t.shape[2:])).permute(0, 3, 1, 2)


def _clip(t):       # (B*F, C, H, W) -> (B, F, H, W, C)
    return t.permute(0, 2, 3, 1).reshape(B, F, H, W, -1)


def test_motion_module_matches_jax():
    x = _rand(2, (B, F, H, W, C))
    tmod = tmotion.MotionModule(C)
    params = seeded_tree(_shapes(jmotion.MotionModule(), jnp.asarray(x)), 30,
                         lecun=True)
    assert float(np.abs(params["params"]["proj_out"]["kernel"]).max()) > 0
    load_flax(tmod, params)
    want, jg_p, jg_x, cot = _jax_vjp(jmotion.MotionModule().apply, params,
                                     jnp.asarray(x), 31)
    xt = _nchw(torch.from_numpy(x)).detach().requires_grad_()
    out = _clip(tmod(xt, F))
    _check(to_np(out), want)
    (out * torch.from_numpy(cot)).sum().backward()
    _check(to_np(_clip(xt.grad)), jg_x)
    grads_close(jg_p, tmod, rtol=1e-4, floor=1e-6)


def test_motion_module_is_the_identity_at_init():
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    tmod = init_weights(tmotion.MotionModule(C),
                        torch.Generator().manual_seed(0))
    assert not tmod.proj_out.weight.detach().any()
    x = torch.from_numpy(_rand(3, (B * F, C, H, W)))
    assert torch.equal(tmod(x, F), x)


def _unet_vid_inputs():
    x = _rand(4, (B, F, 16, 16, 6))
    emb = _rand(5, (B, 32))
    return x, emb


def test_unet_vid_matches_jax():
    x, emb = _unet_vid_inputs()
    jmod = jvid.UNetVid(**NET)
    params = seeded_tree(_shapes(jmod, jnp.asarray(x), jnp.asarray(emb)), 40,
                         lecun=True)
    tmod = load_flax(tvid.UNetVid(**NET), params)
    want, jg_p, jg_x, cot = _jax_vjp(
        lambda p, a: jmod.apply(p, a, jnp.asarray(emb)), params,
        jnp.asarray(x), 41)

    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt, torch.from_numpy(emb))
    assert out.shape == (B, F, 16, 16, 3) and out.dtype == torch.float32
    _check(to_np(out), want)
    # a clip's embedding reaches its own frames: the other clip's changes
    # the output
    swapped = tmod(xt, torch.from_numpy(emb[::-1].copy()))
    assert float((swapped - out).abs().max()) > 1e-3
    (out * torch.from_numpy(cot)).sum().backward()
    _check(to_np(xt.grad), jg_x)
    grads_close(jg_p, tmod, rtol=1e-4, floor=1e-6)


def test_unet_vid_converter_round_trip_is_exact():
    x, emb = _unet_vid_inputs()
    shapes = _shapes(jvid.UNetVid(**NET), jnp.asarray(x), jnp.asarray(emb))
    params = jax.device_get(seeded_tree(shapes, 50))
    sd = flax_to_torch(params)
    tmod = tvid.UNetVid(**NET)
    tmod.load_state_dict(sd, strict=True)
    back = torch_to_flax(tmod.state_dict())
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
        assert got[path].dtype == leaf.dtype
    # and the motion leaves the other way: a Dense kernel is transposed, a
    # LayerNorm scale is a weight, the bias-free to_q has no bias
    m = sd
    assert m["motion_enc0.block0.attn0.to_q.weight"].shape == (16, 16)
    assert "motion_enc0.block0.attn0.to_q.bias" not in m
    np.testing.assert_array_equal(
        m["motion_dec1.block1.ff_geglu.proj.weight"].numpy(),
        params["params"]["motion_dec1"]["block1"]["ff_geglu"]["proj"][
            "kernel"].T)
    np.testing.assert_array_equal(
        m["motion_enc1.block0.norm_ff.weight"].numpy(),
        params["params"]["motion_enc1"]["block0"]["norm_ff"]["scale"])


def _example_opts():
    with open(os.path.join(ROOT, "examples",
                           "example_ddpm_vid_mario.json")) as f:
        cfg = json.load(f)
    return (TrainOptions().parse_json(cfg, verbose=False),
            JaxTrainOptions().parse_json(cfg, verbose=False))


def test_full_width_tree_matches_jax_names_and_shapes():
    topt, jopt = _example_opts()
    jinner = jdn.define_inner_G(jopt)
    f, size = jopt.data_temporal_number_frames, jopt.data_crop_size
    shapes = _shapes(jinner, jnp.zeros((1, f, size, size, 6)),
                     jnp.zeros((1, jopt.alg_diffusion_cond_embed_dim)))
    want = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        tinner = tdn.define_inner_G(topt)
    assert isinstance(tinner, tvid.UNetVid)
    got = torch_to_flax_shapes(tinner.state_dict())
    assert got == {k: tuple(v) for k, v in want.items()}
    n = sum(int(np.prod(s)) for s in got.values())
    n_motion = sum(int(np.prod(s)) for k, s in got.items()
                   if k.split(".")[1].startswith("motion_"))
    assert (n, n_motion) == (EXPECTED_PARAMS, EXPECTED_MOTION_PARAMS)
    # 10 motion modules each side, 2 blocks of 2 attentions, 8 heads of
    # C / 8: head dims 8 to 64
    heads = {m.heads for m in tinner.modules()
             if isinstance(m, tmotion.TemporalSelfAttention)}
    assert heads == {8}
    assert sum(isinstance(m, tmotion.MotionModule)
               for m in tinner.modules()) == 20


def torch_to_flax_shapes(state_dict):
    """The flax path and shape of every leaf of a (meta) state dict, as
    ``torch_to_flax`` names and lays them out."""
    out = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        name, shape = parts[-1], tuple(t.shape)
        if name == "weight":
            if len(shape) == 4:
                name, shape = "kernel", (shape[2], shape[3], shape[1],
                                         shape[0])
            elif len(shape) == 1:
                name = "scale"
            else:
                name, shape = "kernel", shape[::-1]
        out[".".join(["params"] + parts[:-1] + [name])] = shape
    return out


def test_cross_attention_dim_is_read_by_nothing():
    # G_unet_vid_cross_attention_dim (768 in the _ft config, 384 in
    # _ft_from_image) changes neither package's trunk
    topt, jopt = _example_opts()
    counts = []
    for dim in (768, 384):
        topt.G_unet_vid_cross_attention_dim = dim
        jopt.G_unet_vid_cross_attention_dim = dim
        with torch.device("meta"):
            tinner = tdn.define_inner_G(topt)
        counts.append(sum(p.numel() for p in tinner.parameters()))
    assert counts == [EXPECTED_PARAMS] * 2
    # and no module of either package, options aside, reads it
    for pkg in ("joligen_tpu", "joligen_tpu_torch"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
            if os.path.basename(dirpath) == "options":
                continue
            for fn in files:
                if fn.endswith(".py"):
                    with open(os.path.join(dirpath, fn)) as f:
                        src = f.read()
                    assert "cross_attention_dim\"" not in src and \
                        "cross_attention_dim'" not in src, fn
