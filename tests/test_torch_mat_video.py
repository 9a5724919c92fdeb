"""Video MAT (``alg_mat_motion``) in the port against the JAX package, on
the CPU, cut small as ``tests/test_mat_model.py``'s motion test: base 16, w
and z 64, stage-1 dim 12, 32 px, clips of 3 frames (the bottleneck's 128
channels over the options' 8 heads, 2 motion blocks, at most 8 frames):

1. the 5-D generator with converted seeded weights (every leaf non-zero,
   the motion subtree too) and the JAX generator's draws fed: the clip
   and its stage-1 output to 1e-4 of the largest value in fp32, the
   history frames bit for bit; at 2 heads (head dim 64, the config's) its
   gradients in float64 on both sides, the parameters' and the clip's,
   to 1e-4 of the largest;
2. ``set_input`` on clips, with ``alg_mat_motion_prob_use_previous_frames``
   0.5 and the same ``np.random`` seed on both sides: exact, dropped and
   kept samples both present;
3. a 2-step trajectory (R1 at step 0, ``alg_mat_d_reg_every`` 2, drops at
   0.5 from the same seed) with the JAX step's draws fed: every loss, ``w_avg`` and the EMA beta to 1e-4,
   G, its EMA and D with the Adam allowance; then a clip request, the
   clip's shape, the history frames and the known pixels bit for bit, to
   1e-4 of the JAX model's;
4. the converter on the motion tree (the motion subtree's ``kernel``
   leaves beside MAT's ``weight`` and 0-D ``noise_strength`` leaves) and
   the checkpoint files both ways, bit for bit.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_mat_common import (BASE, DIM, WZ, close, grads64, grads_close,
                               init_tree, load_mat, mat_models, noise_draws,
                               step_draws, to_np, weights_close)
from joligen_tpu.models import mat_model as jmm
from joligen_tpu.models.modules import mat as jm
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models import mat_model as tmm
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import mat as tm

FRAMES, SIZE = 3, 32
MOTION = {"alg": {"mat": {"motion": True, "d_reg_every": 2}},
          "data": {"temporal_number_frames": FRAMES}}


def clip_batch(seed, n=2, frames=FRAMES, size=SIZE):
    """Clips and label masks: a box hole in every frame."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (n, frames, size, size, 3)).astype(np.float32)
    mask = np.zeros((n, frames, size, size, 1), np.int32)
    for i in range(n):
        for f in range(frames):
            y0, x0 = rng.integers(0, size // 2, 2)
            h, w = rng.integers(size // 4, size // 2, 2)
            mask[i, f, y0:y0 + h, x0:x0 + w] = 1
    return {"B": img, "B_label_mask": mask}


def _generators(heads, jdtype=jnp.float32):
    kw = dict(frames=FRAMES, motion_heads=heads, motion_blocks=2,
              motion_max_frames=8)
    jg = jm.MATGenerator(base=BASE, w_dim=WZ, z_dim=WZ, stage1_dim=DIM,
                         dtype=jdtype, **kw)
    tg = tm.MATGenerator(SIZE, 3, base=BASE, w_dim=WZ, z_dim=WZ,
                         stage1_dim=DIM, **kw)
    return jg, tg


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.ones((2, FRAMES, SIZE, SIZE, 1), np.float32)
    mask[:, -1, 6:22, 4:26] = 0.0
    mask[1, -1, 20:30, 10:14] = 0.5
    z = rng.standard_normal((2, WZ)).astype(np.float32)
    return img, mask, z


def test_video_generator_matches_jax():
    jg, tg = _generators(8)
    img, mask, z = _inputs(1)
    tree = init_tree(jg, (img, mask, z), {"rng": jax.random.PRNGKey(0)}, 7)
    assert tg.motion.block0.attn0.heads == 8
    load_mat(tg, tree)
    key = jax.random.PRNGKey(3)
    want, want_s1, want_w = jax.jit(lambda p: jg.apply(
        p, img, mask, z, rng=key, return_stg1=True, return_w=True))(tree)
    with torch.no_grad():
        got, got_s1, got_w = tg(
            *map(torch.from_numpy, (img, mask, z)),
            noise=noise_draws(key, tg, 2, frames=FRAMES), return_stg1=True,
            return_w=True)
    assert got.shape == (2, FRAMES, SIZE, SIZE, 3)
    close(to_np(got), want, 1e-4)
    close(to_np(got_s1), want_s1, 1e-4)
    close(to_np(got_w), want_w, 1e-4)
    np.testing.assert_array_equal(to_np(got)[:, :-1], img[:, :-1])
    np.testing.assert_array_equal(to_np(got_s1)[:, :-1], img[:, :-1])
    keep = np.broadcast_to(mask[:, -1] == 1, img[:, -1].shape)
    np.testing.assert_array_equal(to_np(got)[:, -1][keep], img[:, -1][keep])


def test_video_generator_gradients_match_jax_float64():
    jg, tg = _generators(2, jnp.float64)
    img, mask, z = _inputs(2)
    tree = init_tree(jg, (img, mask, z), {"rng": jax.random.PRNGKey(0)}, 8)
    assert tg.motion.block0.attn0.heads == 2            # head dim 64
    load_mat(tg, tree)
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        noise = noise_draws(key, tg, 2, jnp.float64, frames=FRAMES)

    def jfn(p, x):
        return jg.apply(p, x, jnp.asarray(mask, x.dtype),
                        jnp.asarray(z, x.dtype), rng=key)

    def tfn(x):
        return tg(x, torch.from_numpy(mask).double(),
                  torch.from_numpy(z).double(), noise=noise)
    (gx,), jgrads = grads64(jfn, tree, (img,), tg, tfn, seed=5)
    grads_close(jgrads[0], tg)
    close(to_np(gx), jgrads[1], 1e-4)
    assert float(gx[:, :-1].abs().max()) > 0     # through the motion module
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in tg.named_parameters() if n.startswith("motion"))


def test_set_input_on_clips_matches_jax():
    # both models' set_input on a stand-in for the model: what it reads
    model = types.SimpleNamespace(phase="train", motion_keep_prob=0.5,
                                  mask_class_cond=False)
    b = clip_batch(3, n=8)
    for seed in (0, 1):
        np.random.seed(seed)
        want = jmm.MATModel.set_input(model, b)
        np.random.seed(seed)
        got = tmm.MATModel.set_input(model, b)
        assert set(got) == set(want) == {"real", "mask"}
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    hist = (got["real"][:, :-1] == got["real"][:, -1:]).all(axis=(1, 2, 3, 4))
    assert hist.any() and not hist.all()            # dropped and kept
    assert (got["mask"][~hist, :-1] == 1).all()
    # the batch itself is left as it came
    assert not (b["B"][:, :-1] == b["B"][:, -1:]).all(axis=(1, 2, 3, 4)).any()


def _close_scalar(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (what, got, want)


def test_two_step_trajectory_and_clip_request_match_jax(tmp_path,
                                                        monkeypatch):
    jmodel, tmodel = mat_models(tmp_path, monkeypatch, dict(MOTION, alg={
        "mat": dict(MOTION["alg"]["mat"],
                    motion_prob_use_previous_frames=0.5)}))
    net = tmodel.nets["G_A"]
    assert (net.frames, tmodel.r1_every) == (FRAMES, 2)
    assert tmodel.motion_keep_prob == jmodel.motion_keep_prob == 0.5
    assert net.motion.n_blocks == 2 and net.motion.block0.attn0.heads == 8
    lr, r1 = 2e-3, []
    for i in range(2):
        b, key = clip_batch(10 + i), jax.random.PRNGKey(20 + i)
        step = int(jmodel.states["G_A"].step)
        monkeypatch.setattr(jmodel, "next_rng", lambda k=key: k)
        np.random.seed(i)           # the same drops on both sides
        want = jmodel.optimize_prepared(jmodel.prepare_batch(b))
        np.random.seed(i)
        got = tmodel.optimize_prepared(tmodel.prepare_batch(b), draws=(
            step_draws(key, net, 2, WZ, tmodel.noise_mode_train, FRAMES)))
        assert set(got) == set(want)
        for k, v in want.items():
            _close_scalar(got[k], v, (i, k))
        r1.append(float(got["D_r1"]))
        _close_scalar(tmodel.ema_beta, jmodel._ema_beta(jnp.asarray(step),
                                                        2), (i, "beta"))
        close(to_np(tmodel.w_avg), jmodel.w_avg, 1e-4)
        weights_close(i, tmodel, jmodel, lr)
    assert r1[0] > 0 and r1[1] == 0

    b, seed = clip_batch(40), 3
    want = jmodel.inference(b, seed=seed)
    got = tmodel.inference(b, seed=seed, draws={
        "z": torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (2, WZ)))),
        "noise": noise_draws(jax.random.PRNGKey(0), net, 2,
                             frames=FRAMES)})
    assert got.shape == want.shape == (2, FRAMES, SIZE, SIZE, 3)
    close(got, want, 1e-4)
    np.testing.assert_array_equal(got[:, :-1], b["B"][:, :-1])
    keep = np.broadcast_to(b["B_label_mask"][:, -1] == 0, got[:, -1].shape)
    np.testing.assert_array_equal(got[:, -1][keep], b["B"][:, -1][keep])


def test_motion_tree_converts_and_checkpoints_cross_both_ways(tmp_path,
                                                              monkeypatch):
    jg, tg = _generators(8)
    img, mask, z = _inputs(6)
    tree = jax.device_get(init_tree(jg, (img, mask, z),
                                    {"rng": jax.random.PRNGKey(0)}, 9))
    leaves = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    names = {str(p[-1].key) for p in leaves}
    assert {"kernel", "scale", "weight", "noise_strength"} <= names
    sd = flax_to_torch(tree, weight_leaves=True)
    tg.load_state_dict(sd, strict=True)
    assert tuple(sd["motion.proj_in.weight"].shape) == (128, 128)
    back = torch_to_flax(tg.state_dict(), True)
    back_leaves = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(back_leaves) == set(leaves)
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(back_leaves[path], np.asarray(leaf),
                                      str(path))

    jmodel, tmodel = mat_models(tmp_path, monkeypatch, MOTION)
    with torch.no_grad():
        for i, p in enumerate(tmodel.nets["G_A"].parameters()):
            p.add_(0.01 * (i + 1))
    tmodel.save_networks("port")
    jmodel.load_networks("port", load_optim=False)
    want = flax_to_torch(jax.device_get(jmodel.states["G_A"].params), True)
    got = tmodel.nets["G_A"].state_dict()
    assert any(k.startswith("motion.") for k in got)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    jmodel.states["G_A"] = jmodel.states["G_A"].replace(
        params=jax.tree.map(lambda x: x * 0.5, jmodel.states["G_A"].params))
    jmodel.save_networks("jax")
    served = create_model(tmodel.opt, phase="test", device="cpu")
    served.load_networks("jax")
    want = flax_to_torch(jax.device_get(jmodel.states["G_A"].params), True)
    for k, v in served.nets["G_A"].state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("heads", [8, 4])
def test_full_width_video_tree_matches_jax(heads):
    """example_mat_inpainting.json with --alg_mat_motion at the options'
    defaults (5 frames, 2 blocks, at most 8) and 8 or 4 heads: every name
    and shape of the generator against ``jax.eval_shape`` of the JAX
    module, 70,809,338 parameters (the image generator's 59,779,834 and
    the motion module's 11,029,504)."""
    size, frames = 256, 5
    img = jax.ShapeDtypeStruct((1, frames, size, size, 3), jnp.float32)
    mask = jax.ShapeDtypeStruct((1, frames, size, size, 1), jnp.float32)
    z = jax.ShapeDtypeStruct((1, 512), jnp.float32)
    key = jax.random.PRNGKey(0)
    kw = dict(frames=frames, motion_heads=heads, motion_blocks=2,
              motion_max_frames=8)
    jtree = jax.eval_shape(lambda a, b, c: jm.MATGenerator(
        stage1_dim=180, **kw).init(key, a, b, c, rng=key), img, mask, z)
    with torch.device("meta"):
        net = tm.MATGenerator(size, 3, 64, 512, 512, stage1_dim=180, **kw)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jtree["params"])[0]:
        s = tuple(leaf.shape)
        s = ((s[3], s[2], s[0], s[1]) if len(s) == 4 else s[::-1])
        keys = [p.key for p in path]
        if keys[0] == "motion" and keys[-1] in ("kernel", "scale"):
            keys[-1] = "weight"                  # the kernel rules' names
        want[".".join(keys)] = s
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert sum(v.numel() for v in net.parameters()) == 70_809_338 == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(jtree))
    assert sum(v.numel() for n, v in net.named_parameters()
               if n.startswith("motion.")) == 11_029_504
    # the motion module's attention: (B * 256, 5, heads, 512 / heads)
    assert net.motion.block0.attn0.heads == heads
