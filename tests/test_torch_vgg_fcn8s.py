"""VGG16-FCN8s, the ``vgg`` f_s of the port
(``joligen_tpu_torch/models/modules/semantic_networks.py``), against the
JAX package's, on the CPU. Its widths are fixed (134M parameters, 103M of
them in ``fc6``), so one seeded tree (flax's default law, every leaf
non-zero: the zero-initialised skips ``score_pool4`` and ``score_pool3``
too, or they would add nothing) is made once for the file and serves both
pads, which share one parameter tree:

1. the fp32 forward under ``fcn`` (99 px pad, VALID ``fc6``, crops at 5, 9
   and 31) and ``same`` (no pad, SAME ``fc6``, crops at 0) at 17 and 33 px,
   odd sizes whose ceil-mode pools pad with −inf, to 1e-4 of the largest
   logit; the upsampling's lax padding against ``jax.lax.conv_transpose``
   at odd sizes, VALID ((in + 1)·factor) and SAME (in·factor);
2. every gradient (parameters and input) at 17 px under ``same`` in fp32,
   to 1e-4 of each leaf's largest (under ``fcn``, at 7 px in float64:
   ``tests/test_torch_vgg_fcn8s_grad.py``);
3. ``define_f`` with ``f_s_net: vgg`` on noglasses2glasses: the ``same``
   pad by default and the JAX net's parameter count;
4. ``load_vgg_fcn8s_trunk`` on a seeded ``vgg16_lpips.npz`` under a
   temporary ``JOLIGEN_TPU_WEIGHTS_DIR`` (two trunk convs, ``fc7``, and an
   ``fc6`` of another shape, which both loaders skip): the same tree as the
   JAX loader's, bit for bit; without the file nothing changes.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, err_and_scale,  # noqa: F401
                               few_torch_threads, grads_close, load_flax,
                               seeded_tree, to_np)
from _torch_mat_common import cotangent, grads64, jax_fwd_bwd
from joligen_tpu.models.modules import semantic_networks as jsem
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models.convert import torch_to_flax
from joligen_tpu_torch.models.modules import semantic_networks as tsem
from joligen_tpu_torch.options import TrainOptions

NCLASSES = 3


def _x(seed, size):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32)


def vgg_tree():
    """The seeded tree (both pads' parameters)."""
    jmod = jsem.VGG16FCN8s(nclasses=NCLASSES)
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.zeros((1, 17, 17, 3))),
                            jax.random.PRNGKey(0))
    t = seeded_tree(shapes, 21, 0.05, lecun=True)
    assert all(np.abs(t["params"][n]["kernel"]).min() > 0
               for n in ("score_pool4", "score_pool3"))
    return t


@pytest.fixture(scope="module")
def tree():
    return vgg_tree()


@pytest.fixture(scope="module")
def nets(tree):
    """The port's net under each pad, on the seeded tree."""
    return {pad: load_flax(tsem.VGG16FCN8s(3, NCLASSES, pad=pad), tree)
            for pad in ("fcn", "same")}


@pytest.mark.parametrize("size", [17, 33])
@pytest.mark.parametrize("pad", ["fcn", "same"])
def test_vgg_fcn8s_matches_jax(tree, nets, pad, size):
    jmod = jsem.VGG16FCN8s(nclasses=NCLASSES, pad=pad)
    tmod = nets[pad]
    x = _x(size, size)
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == want.shape == (1, size, size, NCLASSES)
    err, scale = err_and_scale(to_np(got), want, norm=False)
    assert err <= 1e-4 * scale, (err, scale)
    if size == 17 and pad == "same":
        check_grads(jmod, tmod, tree, x, float64=False)


def check_grads(jmod, tmod, tree, x, float64):
    """The gradients of sum(logits x cotangent) for every parameter and the
    input to 1e-4 of each leaf's largest, in fp32 or (``float64``) in
    float64 on both sides (``_torch_mat_common.grads64``)."""
    if float64:
        (gx,), (jg, jgx) = grads64(jmod.clone(dtype=jnp.float64).apply,
                                   tree, [x], tmod, tmod, 22)
    else:
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tmod(xt)
        cot = cotangent(tuple(out.shape), 22)
        (out * torch.from_numpy(cot)).sum().backward()
        _, (jg, jgx) = jax_fwd_bwd(jmod.apply, jax.tree.map(jnp.asarray,
                                                            tree),
                                   [jnp.asarray(x)], cot)
        gx = xt.grad
    grads_close(jg, tmod, 1e-4, 1e-4)
    err, scale = err_and_scale(to_np(gx), jgx, norm=False)
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("size", [3, 6])
@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("factor", [2, 8])
def test_upscore_matches_conv_transpose(factor, padding, size):
    x = np.random.default_rng(size).normal(
        size=(2, size, size + 1, 3)).astype(np.float32)
    w = jsem.VGG16FCN8s._bilinear_kernel(factor, 3)
    want = jax.lax.conv_transpose(jnp.asarray(x), w, (factor, factor),
                                  padding,
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tsem.upscore(torch.from_numpy(x).permute(0, 3, 1, 2), factor,
                       padding).permute(0, 2, 3, 1)
    grow = 1 if padding == "VALID" else 0
    assert got.shape == want.shape == (2, (size + grow) * factor,
                                       (size + 1 + grow) * factor, 3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)


def test_define_f_vgg():
    with open(os.path.join(ROOT, "examples",
                           "example_gan_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    cfg["f_s"]["net"] = "vgg"
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jmod, tmod = jsem.define_f(jopt), tsem.define_f(opt)
    assert tmod.pad == jmod.pad == "same" and tmod.dtype == torch.bfloat16
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.zeros((1, 32, 32, 3))),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
    assert n == sum(p.numel() for p in tmod.parameters()) > 134_000_000


def test_load_vgg_fcn8s_trunk_matches_jax(tree, nets, tmp_path,
                                          monkeypatch):
    tmod = nets["fcn"]          # its last use
    monkeypatch.setenv("JOLIGEN_TPU_WEIGHTS_DIR", str(tmp_path))
    assert tsem.load_vgg_fcn8s_trunk(tmod) == []
    rng = np.random.default_rng(23)
    p = tree["params"]
    raw = {}
    for name in ("b0c0", "b3c1", "fc7"):
        for leaf in ("kernel", "bias"):
            raw[f"{name}/{leaf}"] = rng.normal(
                size=p[name][leaf].shape).astype(np.float32)
    raw["fc6/kernel"] = np.zeros((3, 3, 512, 4096), np.float32)
    raw["fc6/bias"] = np.zeros((4096,), np.float32)
    np.savez(tmp_path / "vgg16_lpips.npz", **raw)
    assert tsem.load_vgg_fcn8s_trunk(tmod) == ["b0c0", "b3c1", "fc7"]
    want = jsem.load_vgg_fcn8s_trunk(tree)
    got = torch_to_flax(tmod.state_dict())["params"]
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.array_equal(a, np.asarray(b)), got, want["params"]))
    assert np.array_equal(got["b3c1"]["kernel"], raw["b3c1/kernel"])
    assert np.array_equal(got["fc6"]["kernel"], p["fc6"]["kernel"])
