"""The video JiT denoiser of the port (``joligen_tpu_torch/models/modules/
vit_vid.py``) against the JAX package's on the CPU, fp32, seeded inputs
from numpy and seeded weights through the converter (every zero-initialised
leaf, ``adaLN``, ``final_adaLN``, ``final_proj``, ``ms_1``, ``fs_1`` and
``proj_out``, filled from a seed first: zeros hide errors):

1. ``TokenMotionModule`` at head dim 96 (192 channels over 2 heads),
   forward and every gradient, to 1e-4;
2. a small ``JiTViD`` (depth 3, ``in_context_start`` 1, hidden 192, 3 heads
   of 64, 2 motion heads of 96, patch 4, 16 px, 4 frames, 2 register
   tokens, 2 classes, mask-size and frame-step conditioning), forward and
   the gradients of the input and every parameter, to 1e-4, per-frame and
   per-clip t; under ``tpu_remat`` the same values;
3. the converter on the scanned stacks: the flax tree to the per-block
   torch keys and back, bit for bit, and an optax adam state the same way;
4. the example config's denoiser at full width on the meta device: every
   name and shape against ``jax.eval_shape`` of the JAX module on its 6
   input channels, 156,640,512 parameters, its segments [(0, 4), (4, 12)
   with the motion module];
5. the global context and object references build from the options
   (their parity: ``tests/test_torch_vit_vid_context.py``).
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, seeded_tree
from joligen_tpu.models.modules import vit_vid as jvv
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_adam_state_to_torch,
                                              torch_adam_state_to_optax,
                                              torch_to_flax)
from joligen_tpu_torch.models.modules import vit_vid as tvv
from joligen_tpu_torch.options import TrainOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
# the example config's denoiser: 6 input channels, [y_cond, z], since the
# unset alg_diffusion_cond_image_creation makes b2b conditional on A in
# both packages (156,542,208 with 3)
EXPECTED_PARAMS = 156_640_512
SMALL = dict(patch_size=4, hidden_size=192, depth=3, num_heads=3,
             bottleneck_dim=32, in_context_start=1, num_classes=2,
             num_register_tokens=2, out_channels=3, motion_num_heads=2,
             mask_size_conditioning=True,
             temporal_frame_step_conditioning=True)
B, F, SIZE, CIN = 2, 4, 16, 6


def _np(t):
    return t.detach().float().numpy()


def _grads_close(jgrads, module, tol=TOL):
    want = flax_to_torch(jax.device_get(jgrads))
    assert set(want) == {n for n, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        scale = max(1.0, float(want[name].abs().max()))
        err = float((p.grad - want[name]).abs().max())
        assert err <= tol * scale, (name, err, scale)


def test_token_motion_module_head_dim_96_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 192)).astype(np.float32)
    jmod = jvv.TokenMotionModule(num_heads=2)
    shapes = jax.eval_shape(lambda r: jmod.init(r, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    tree = seeded_tree(shapes, 1, 0.05, lecun=True)
    params = jax.tree.map(jnp.asarray, tree)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(jmod.apply, params, jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))

    tmod = tvv.TokenMotionModule(192, num_heads=2)
    tmod.load_state_dict(flax_to_torch(tree), strict=True)
    assert tmod.block0.attn0.heads == 2          # head dim 96
    assert float(tmod.proj_out.weight.detach().abs().max()) > 0
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), atol=TOL,
                               rtol=TOL)
    _grads_close(jp, tmod)


def _inputs(seed, per_frame_t):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, F, SIZE, SIZE, CIN)).astype(np.float32)
    t = rng.uniform(0, 1, (B, F) if per_frame_t else (B,)).astype(
        np.float32)
    y = np.array([1, 0], np.int32)
    ms = rng.uniform(0, 1, (B, 6)).astype(np.float32)
    fs = np.array([1.0, 3.0], np.float32)
    return x, t, y, ms, fs


def _small_pair(seed=3):
    jnet = jvv.JiTViD(**SMALL)
    x, t, *_ = _inputs(0, True)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.asarray(x), jnp.asarray(t)), jax.random.PRNGKey(0))
    tree = seeded_tree(shapes, seed, 0.05, lecun=True)
    return jnet, tree


@pytest.mark.parametrize("per_frame_t,remat", [(True, False), (False, False),
                                               (True, True)])
def test_jitvid_matches_jax_forward_and_gradients(per_frame_t, remat):
    jnet, tree = _small_pair()
    params = jax.tree.map(jnp.asarray, tree)
    x, t, y, ms, fs = _inputs(1, per_frame_t)
    cot = np.random.default_rng(2).standard_normal(
        (B, F, SIZE, SIZE, 3)).astype(np.float32)

    def f(p, xx):
        return jnet.apply(p, xx, jnp.asarray(t), y=jnp.asarray(y),
                          mask_size=jnp.asarray(ms),
                          temporal_frame_step=jnp.asarray(fs))
    want, vjp = jax.vjp(f, params, jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))

    tnet = tvv.JiTViD(CIN, remat=remat, **SMALL)
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    assert [(a, b, m) for a, b, m in tnet._segments()] == \
        jnet._segments(1) == [(0, 1, False), (1, 3, True)]
    for leaf in (tnet.blocks0[0].adaLN, tnet.final_adaLN, tnet.final_proj,
                 tnet.ms_1, tnet.fs_1, tnet.motion.proj_out):
        assert float(leaf.weight.detach().abs().max()) > 0
    xt = torch.from_numpy(x).requires_grad_()
    got = tnet(xt, torch.from_numpy(t), y=torch.from_numpy(y).long(),
               mask_size=torch.from_numpy(ms),
               temporal_frame_step=torch.from_numpy(fs))
    assert got.shape == (B, F, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), atol=TOL,
                               rtol=TOL)
    _grads_close(jp, tnet)


def test_scan_stacks_and_adam_state_round_trip_exactly():
    _, tree = _small_pair(seed=5)
    sd = flax_to_torch(tree)
    # blocks1 (2 scanned blocks) -> blocks1.0, blocks1.1
    assert sd["blocks1.1.qkv.weight"].shape == (576, 192)
    np.testing.assert_array_equal(sd["blocks1.1.qkv.weight"].numpy(),
                                  tree["params"]["blocks1"]["block"]["qkv"]
                                  ["kernel"][1].T)
    back = torch_to_flax(sd)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf)
    # an adam state with seeded moments: to the port and back, exactly
    tx = optax.adamw(1e-4)
    state = tx.init(jax.tree.map(jnp.asarray, tree))
    rng = np.random.default_rng(6)
    state = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)) if a.ndim else a, state)
    mine = optax_adam_state_to_torch(jax.device_get(state))
    assert set(mine["mu"]) == set(sd)
    again = torch_adam_state_to_optax(mine, jax.device_get(state))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _example_opts():
    with open(os.path.join(ROOT, "examples",
                           "example_b2b_vid_mario.json")) as f:
        cfg = json.load(f)
    return (TrainOptions().parse_json(cfg, verbose=False),
            JaxTrainOptions().parse_json(cfg, verbose=False))


def _flax_shapes(state_dict):
    """The flax path and shape of every leaf of a (meta) state dict: the
    converter's names, the blocks of a segment stacked again."""
    out = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        name, shape = parts[-1], tuple(t.shape)
        if name == "weight":
            name, shape = (("scale", shape) if len(shape) == 1
                           else ("kernel", shape[::-1]))
        if parts[0].startswith("blocks"):
            path = ".".join([parts[0], "block"] + parts[2:-1] + [name])
            depth = out.get(path, (0,))[0]
            out[path] = (max(depth, int(parts[1]) + 1),) + shape
        else:
            out[".".join(parts[:-1] + [name])] = shape
    return out


def test_full_width_tree_matches_jax_names_and_shapes():
    topt, jopt = _example_opts()
    f, size = jopt.data_temporal_number_frames, jopt.data_crop_size
    jnet = jvv.JiTViD.from_opt(jopt)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, f, size, size, CIN)), jnp.zeros((1,))),
        jax.random.PRNGKey(0))["params"]
    want = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        tnet = tvv.JiTViD.from_opt(topt, CIN)
    assert _flax_shapes(tnet.state_dict()) == want
    n = sum(p.numel() for p in tnet.parameters())
    assert n == sum(int(np.prod(s)) for s in want.values()) == \
        EXPECTED_PARAMS
    assert tnet._segments() == [(0, 4, False), (4, 12, True)]
    assert len(tnet.blocks0) == 4 and len(tnet.blocks1) == 8
    assert tnet.motion.block0.attn0.heads == 8     # 768 / 8: head dim 96


@pytest.mark.parametrize("variant,count,blocks,heads,motion_hd", [
    ("JiT-L/16", 504_401_632, (8, 16), 16, 128),
    ("JiT-H/16", 1_023_910_976, (10, 22), 16, 160)])
def test_wide_variants_match_jax_count_and_head_dims(variant, count, blocks,
                                                     heads, motion_hd):
    """b2b_vid_mario with ``--G_vit_variant`` JiT-L/16 or JiT-H/16: the
    parameter count against ``jax.eval_shape`` of the JAX module, the
    blocks' head dim (1024 / 16 = 64, 1280 / 16 = 80) and the motion
    module's (1024 / 8 = 128, 1280 / 8 = 160), each in the kernels'
    list."""
    from joligen_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
    topt, jopt = _example_opts()
    topt.G_vit_variant = jopt.G_vit_variant = variant
    f, size = jopt.data_temporal_number_frames, jopt.data_crop_size
    jnet = jvv.JiTViD.from_opt(jopt)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, f, size, size, CIN)), jnp.zeros((1,))),
        jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        tnet = tvv.JiTViD.from_opt(topt, CIN)
    assert _flax_shapes(tnet.state_dict()) == {
        ".".join(str(k.key) for k in path): leaf.shape
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert sum(p.numel() for p in tnet.parameters()) == count
    assert (len(tnet.blocks0), len(tnet.blocks1)) == blocks
    hd = tnet.hidden_size // tnet.num_heads
    mhd = tnet.hidden_size // tnet.motion.block0.attn0.heads
    assert tnet.num_heads == heads and mhd == motion_hd
    assert hd in SUPPORTED_HEAD_DIMS and mhd in SUPPORTED_HEAD_DIMS


def test_global_context_and_object_refs_raise():
    """The global context and the object references, which raised until
    they were ported, now build from the options (parity:
    ``tests/test_torch_vit_vid_context.py``): their mode, context size,
    reference count and size; ``tokens`` or a reference inserts a prefix
    at ``in_context_start`` even without in-context tokens, ``adaln``
    alone does not."""
    topt, _ = _example_opts()
    topt.alg_b2b_global_context_mode = "tokens"
    topt.alg_b2b_global_context_size = 64
    topt.alg_b2b_object_ref_paths = ["a.png", "b.png"]
    topt.alg_b2b_object_ref_size = 32
    with torch.device("meta"):
        net = tvv.JiTViD.from_opt(topt, CIN)
    assert net.gc_posemb.shape == (1, 16, 768)
    assert net.oref_posemb.shape == (1, 2 * 4, 768)
    assert not hasattr(net, "gc_enc") and net.split_at == 4
    topt.G_vit_in_context_len = 0
    topt.alg_b2b_object_ref_paths = []
    for mode, inserts in (("tokens", True), ("adaln", False)):
        topt.alg_b2b_global_context_mode = mode
        with torch.device("meta"):
            net = tvv.JiTViD.from_opt(topt, CIN)
        assert net.would_insert == inserts
        assert net.split_at == (4 if inserts else net.depth)
        assert hasattr(net, "gc_enc") == (mode == "adaln")
