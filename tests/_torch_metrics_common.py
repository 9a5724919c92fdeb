"""Helpers shared by the ``tests/test_torch_metrics*.py`` files: seeded
flax trees for the metric networks (every leaf non-zero), and
``shared_nets``, which gives both packages' random-feature fallbacks (the
image extractor at seeds 0 and 1, the clip extractor, the VGG16 trunk) the
same seeded weights, so a metric computed by both packages compares."""

import functools

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_gan_common import seeded_tree
from joligen_tpu.utils import metrics as jmet
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.utils import metrics as tmet


def seeded(shapes, seed):
    """Seeded values for a tree of shapes (lecun-scaled kernels, biases
    N(0, 0.1)), as jax arrays."""
    return jax.tree.map(jnp.asarray, seeded_tree(shapes, seed, lecun=True))


@functools.lru_cache(maxsize=None)
def _shapes(kind):
    """The flax tree shapes of a fallback network of ``kind``."""
    key = jax.random.PRNGKey(0)
    if kind == "image":
        return jax.eval_shape(lambda r: jmet.RandomConvFeatures().init(
            r, jnp.zeros((1, 64, 64, 3))), key)
    if kind == "vgg":
        return jax.eval_shape(lambda r: jmet._VGGish().init(
            r, jnp.zeros((1, 32, 32, 3))), key)
    chans = (3, 32, 64, 128)      # the clip extractor's (local) RandomConv3D
    return {"params": {f"c{i}": {
        "kernel": jax.ShapeDtypeStruct((3, 3, 3, chans[i], chans[i + 1]),
                                       jnp.float32),
        "bias": jax.ShapeDtypeStruct((chans[i + 1],), jnp.float32)}
        for i in range(3)}}


SEEDS = {("image", 0): 40, ("image", 1): 41, ("clip", 0): 50, ("vgg", 0): 60}


@functools.lru_cache(maxsize=None)
def shared_tree(kind, seed):
    """The seeded tree both packages' fallback of ``kind`` at ``seed``
    runs under ``shared_nets``."""
    return seeded(_shapes(kind), SEEDS[(kind, seed)])


_BUILD_VIDEO = jmet.VideoFeatures._build


def clip_fallback(vf=None):
    """Build the JAX ``VideoFeatures`` ``vf`` (a new one if None) on its
    fallback, the init of its RandomConv3D (a class local to ``_build``)
    traced for shapes only; returns (that net, its tree of shapes)."""
    vf = vf or jmet.VideoFeatures()
    init = flax.linen.Module.init
    flax.linen.Module.init = lambda self, *a, **kw: jax.eval_shape(
        functools.partial(init, self, *a, **kw))
    try:
        _BUILD_VIDEO(vf)
    finally:
        flax.linen.Module.init = init
    assert vf.is_fallback
    fn = vf._fn.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells["net"], cells["params"]


@pytest.fixture
def shared_nets(monkeypatch):
    """Both packages' fallbacks on the same seeded trees
    (``shared_tree``): the JAX fallbacks' ``init`` (``RandomConvFeatures``
    at key 0 or 1, ``_VGGish``) gives the tree, the clip extractor (a class
    local to ``VideoFeatures._build``) has the params it closes over
    swapped, and the port's ``_seeded`` modules and fallback VGG trunk load
    the converted trees."""
    for kind in ("image", "vgg"):
        _shapes(kind)                   # before ``init`` is replaced
    monkeypatch.setattr(
        jmet.RandomConvFeatures, "init", lambda self, rng, *a, **kw:
        shared_tree("image", int(np.asarray(rng).ravel()[-1])))
    monkeypatch.setattr(jmet._VGGish, "init", lambda self, rng, *a, **kw:
                        shared_tree("vgg", 0))
    def build(self):
        net, _ = clip_fallback(self)
        fn = self._fn.__wrapped__
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        cells["params"].cell_contents = shared_tree("clip", 0)
    monkeypatch.setattr(jmet.VideoFeatures, "_build", build)

    def port_seeded(module, seed):
        kind = ("clip" if isinstance(module, tmet.RandomConv3D) else
                "vgg" if isinstance(module, tmet._VGGish) else "image")
        module.load_state_dict(flax_to_torch(jax.device_get(
            shared_tree(kind, seed))))
        return module.requires_grad_(False)
    monkeypatch.setattr(tmet, "_seeded", port_seeded)

    class SharedVGG(tmet._VGGish):
        def __init__(self, *a, generator=None, **kw):
            super().__init__(*a, **kw)
            if generator is not None:        # the fallback trunk
                port_seeded(self, 0)
    monkeypatch.setattr(tmet, "_VGGish", SharedVGG)


def imgs(seed, n, size, c=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, c)) \
        .astype(np.float32)


def close(got, want, rtol):
    """Largest |got - want| within ``rtol`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (float(err), float(scale))


def to_np(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)
