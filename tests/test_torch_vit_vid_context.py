"""The video JiT's global context and object references in the port
(``joligen_tpu_torch/models/modules/vit_vid.py``: ``GlobalContextEncoder``
under ``alg_b2b_global_context_mode adaln``, the ``gc_embed`` tokens under
``tokens``, the ``oref_embed`` tokens of ``alg_b2b_object_ref_paths``)
against the JAX package's ``JiTViD`` on the CPU, fp32, seeded inputs from
numpy and seeded weights through the converter, every zero-initialised
leaf (``gc_enc/proj1`` among them) filled from a seed first:

1. ``adaln`` with a context a frame, ``tokens`` with one context a clip
   (repeated over the frames), ``tokens`` with 2 object references (a
   ragged prefix of 2 + 16 + 2·4 + 8 tokens) and ``tokens`` without a
   context (the zero image): the forward and the gradients of the clip,
   the context, the references and every parameter, to 1e-4; the JAX
   module with references is the package's with one line fixed
   (``tests/_torch_vid_context_common.py``: the package's own raises
   ``UnboundLocalError``, checked here, and the copy builds the package's
   tree plus the references' leaves);
2. the converter on the new leaves (``gc_enc``, ``gc_embed``,
   ``gc_posemb``, ``gc_type``, ``oref_embed``, ``oref_posemb``,
   ``oref_type``): the flax tree to the torch keys and back, and an optax
   adam state the same way, bit for bit;
3. ``example_b2b_vid_mario.json`` with ``tokens`` and one reference, and
   with ``adaln``, at full width on the meta device: every name and shape
   against ``jax.eval_shape`` of the JAX module, 157,098,240 and
   158,390,784 parameters; in ``tokens`` mode the blocks after the prefix
   see 64 + 64 + 16 + 32 = 176 tokens;
4. ``alg_b2b_global_context_conditioning`` is read by neither package.
"""

import ast
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, seeded_tree  # noqa: F401
from _torch_vid_context_common import fixed_vit_vid
from test_torch_vit_vid import (CIN, SMALL, _example_opts, _flax_shapes,
                                _grads_close, _np)
from joligen_tpu.models.modules import vit_vid as jvv_package
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_state_to_torch,
                                              torch_adam_state_to_optax,
                                              torch_to_flax)
from joligen_tpu_torch.models.modules import vit_vid as tvv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, F, SIZE, GC, OREF = 2, 4, 16, 16, 8
EXPECTED = {"tokens": 157_098_240, "adaln": 158_390_784}
CASES = {
    "adaln_per_frame": dict(mode="adaln", n_ref=0, gc="frame"),
    "tokens_per_clip": dict(mode="tokens", n_ref=0, gc="clip"),
    "tokens_two_refs": dict(mode="tokens", n_ref=2, gc="frame"),
    "tokens_no_context": dict(mode="tokens", n_ref=1, gc=None),
}


def _kwargs(mode, n_ref):
    return dict(SMALL, global_context_mode=mode, global_context_size=GC,
                object_ref_num_images=n_ref, object_ref_size=OREF)


def _inputs(case, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, F, SIZE, SIZE, CIN)).astype(np.float32)
    t = rng.uniform(0, 1, (B, F)).astype(np.float32)
    extra = {}
    if case["gc"] == "frame":
        extra["global_context"] = rng.uniform(
            -1, 1, (B, F, GC, GC, 3)).astype(np.float32)
    elif case["gc"] == "clip":
        extra["global_context"] = rng.uniform(
            -1, 1, (B, GC, GC, 3)).astype(np.float32)
    if case["n_ref"] and case["gc"] is not None:
        extra["object_ref"] = rng.uniform(
            -1, 1, (B, case["n_ref"], OREF, OREF, 3)).astype(np.float32)
    return x, t, extra


def _pair(case, seed=3):
    """(JAX module, seeded flax tree) of ``case``; the tree's shapes from
    the context and references at their full count."""
    jnet = fixed_vit_vid().JiTViD(**_kwargs(case["mode"], case["n_ref"]))
    init = {"global_context": jnp.zeros((1, F, GC, GC, 3))}
    if case["n_ref"]:
        init["object_ref"] = jnp.zeros((1, case["n_ref"], OREF, OREF, 3))
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, F, SIZE, SIZE, CIN)), jnp.zeros((1,)), **init),
        jax.random.PRNGKey(0))
    return jnet, seeded_tree(shapes, seed, 0.05, lecun=True)


@pytest.mark.parametrize("name", list(CASES))
def test_context_and_refs_match_jax_forward_and_gradients(name):
    case = CASES[name]
    jnet, tree = _pair(case)
    params = jax.tree.map(jnp.asarray, tree)
    x, t, extra = _inputs(case)
    y = np.array([1, 0], np.int32)
    cot = np.random.default_rng(2).standard_normal(
        (B, F, SIZE, SIZE, 3)).astype(np.float32)
    keys = sorted(extra)

    def f(p, xx, *ex):
        return jnet.apply(p, xx, jnp.asarray(t), y=jnp.asarray(y),
                          **dict(zip(keys, ex)))
    want, vjp = jax.vjp(f, params, jnp.asarray(x),
                        *(jnp.asarray(extra[k]) for k in keys))
    jp, jx, *jex = vjp(jnp.asarray(cot))

    tnet = tvv.JiTViD(CIN, **_kwargs(case["mode"], case["n_ref"]))
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    if case["mode"] == "adaln":
        assert float(tnet.gc_enc.proj1.weight.detach().abs().max()) > 0
    xt = torch.from_numpy(x).requires_grad_()
    ext = {k: torch.from_numpy(v).requires_grad_() for k, v in extra.items()}
    got = tnet(xt, torch.from_numpy(t), y=torch.from_numpy(y).long(), **ext)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), atol=TOL,
                               rtol=TOL)
    for k, g in zip(keys, jex):
        assert float(np.abs(np.asarray(g)).max()) > 0, k
        np.testing.assert_allclose(_np(ext[k].grad), np.asarray(g),
                                   atol=TOL, rtol=TOL, err_msg=k)
    _grads_close(jp, tnet)


def test_package_jitvid_with_refs_raises_and_the_copy_runs():
    """The JAX package's module with references fails before any output;
    the tests' copy (``nonlocal object_ref`` added) builds the same tree
    as the package's without references, plus the references' leaves."""
    init = dict(object_ref=jnp.zeros((1, 1, OREF, OREF, 3)))

    def shapes(module, **kw):
        return jax.eval_shape(lambda r: module.init(
            r, jnp.zeros((1, F, SIZE, SIZE, CIN)), jnp.zeros((1,)), **kw),
            jax.random.PRNGKey(0))["params"]
    with pytest.raises(UnboundLocalError, match="object_ref"):
        shapes(jvv_package.JiTViD(**_kwargs("none", 1)), **init)
    fixed = shapes(fixed_vit_vid().JiTViD(**_kwargs("none", 1)), **init)
    plain = shapes(jvv_package.JiTViD(**_kwargs("none", 0)))
    assert set(fixed) - set(plain) == {"oref_embed", "oref_posemb",
                                       "oref_type"}
    assert jax.tree.map(lambda a: a.shape, {k: fixed[k] for k in plain}) \
        == jax.tree.map(lambda a: a.shape, plain)


def test_new_leaves_and_adam_state_round_trip_exactly():
    _, tree = _pair(CASES["tokens_two_refs"], seed=5)
    _, tree_a = _pair(CASES["adaln_per_frame"], seed=6)
    sd = flax_to_torch(tree)
    p = tree["params"]
    np.testing.assert_array_equal(sd["gc_posemb"].numpy(), p["gc_posemb"])
    np.testing.assert_array_equal(sd["oref_embed.proj1.weight"].numpy(),
                                  p["oref_embed"]["proj1"]["kernel"].T)
    assert sd["oref_posemb"].shape == (1, 2 * (OREF // 4) ** 2, 192)
    sd_a = flax_to_torch(tree_a)
    np.testing.assert_array_equal(
        sd_a["gc_enc.conv1.weight"].numpy(),
        tree_a["params"]["gc_enc"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    for t, s in ((tree, sd), (tree_a, sd_a)):
        back = torch_to_flax(s)
        want = jax.tree_util.tree_leaves_with_path(t)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf)
        tx = optax.adamw(1e-4)
        state = tx.init(jax.tree.map(jnp.asarray, t))
        rng = np.random.default_rng(6)
        state = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
            a.shape).astype(np.float32)) if a.ndim else a, state)
        mine = optax_state_to_torch(jax.device_get(state))
        assert set(mine["mu"]) == set(s)
        again = torch_adam_state_to_optax(mine, jax.device_get(state))
        for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode,n_ref", [("tokens", 1), ("adaln", 0)])
def test_full_width_tree_matches_jax(mode, n_ref):
    topt, jopt = _example_opts()
    for o in (topt, jopt):
        o.alg_b2b_global_context_mode = mode
        o.alg_b2b_object_ref_paths = ["ref.png"] * n_ref
    f, size = jopt.data_temporal_number_frames, jopt.data_crop_size
    jnet = fixed_vit_vid().JiTViD.from_opt(jopt)
    init = {"global_context": jnp.zeros((1, f, 128, 128, 3))}
    if n_ref:
        init["object_ref"] = jnp.zeros((1, n_ref, 64, 64, 3))
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, f, size, size, CIN)), jnp.zeros((1,)), **init),
        jax.random.PRNGKey(0))["params"]
    want = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        tnet = tvv.JiTViD.from_opt(topt, CIN)
    assert _flax_shapes(tnet.state_dict()) == want
    assert sum(p.numel() for p in tnet.parameters()) == sum(
        int(np.prod(s)) for s in want.values()) == EXPECTED[mode]
    if mode == "tokens":
        # 64 context tokens, 16 of the reference, 32 in-context
        assert want["gc_posemb"] == (1, 64, 768)
        assert want["oref_posemb"] == (1, 16, 768)
        assert 64 + 64 + 16 + tnet.in_context_len == 176
    else:
        assert "gc_enc.proj1.kernel" in want and tnet.would_insert


def test_global_context_conditioning_is_read_by_nothing():
    name = "alg_b2b_global_context_conditioning"
    readers = []
    for pkg in ("joligen_tpu", "joligen_tpu_torch"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
            for fname in files:
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                readers += [path for node in ast.walk(tree) if (
                    isinstance(node, ast.Attribute) and node.attr == name
                    or isinstance(node, ast.Constant) and node.value == name)]
    assert readers == []
