"""The metric functions and networks of the port
(``joligen_tpu_torch/utils/metrics.py``, ``inception.py``, ``i3d.py``)
against the JAX package, on the CPU:

1. PSNR (with and without its mask), SSIM, the Fréchet distance, FID, KID
   (its ``RandomState`` subsets) and MSID, to 1e-6 relative; the metric
   keys, the fallback marker, the statistics cache and its path;
2. the networks on one seeded tree (every leaf non-zero) converted to the
   port: ``RandomConvFeatures``, ``InceptionV3FID`` at its least input (75
   px, batch 2), ``I3D`` at 4 frames of 32 px, the clip fallback
   ``RandomConv3D`` (the JAX one taken from ``VideoFeatures``) and the VGG16
   trunk's stages with LPIPS and DISTS, to 1e-4 of the largest value; the
   converter both ways bit for bit;
3. the weights files (``inception_v3_fid.npz``, ``vgg16_lpips.npz``,
   ``i3d_fvd.npz``) written seeded in a temporary ``WEIGHTS_DIR``: both
   packages' loaders read the same trees, the extractors drop the fallback
   marker, LPIPS (ImageNet-normalised input) and DISTS under
   ``alg_*_dists_mean``/``_std`` agree with the JAX package to 1e-4, and
   the port's extractors run the real-size networks (299 px, 224 px).

``compute_metrics`` over the fallbacks: ``test_torch_metrics_models.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_metrics_common import clip_fallback, close, imgs, seeded, to_np
from joligen_tpu.utils import i3d as ji3d
from joligen_tpu.utils import inception as jinc
from joligen_tpu.utils import metrics as jmet
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.utils import i3d as ti3d
from joligen_tpu_torch.utils import inception as tinc
from joligen_tpu_torch.utils import metrics as tmet

RTOL = 1e-4
CPU = "cpu"


def _rel(got, want, rtol=1e-6):
    assert abs(got - want) <= rtol * max(abs(want), 1e-12), (got, want)


def _flat(tree):
    return {k: v for k, v in flax_to_torch(jax.device_get(tree)).items()}


def _bit_for_bit(tree, state):
    want = _flat(tree)
    assert sorted(state) == sorted(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k


# ---------------------------------------------------------------------------
# 1. pixel and distribution metrics
# ---------------------------------------------------------------------------

def test_pixel_and_distribution_metrics_match_jax(tmp_path):
    a = imgs(0, 4, 24)
    b = np.clip(a + 0.3 * np.random.default_rng(1).standard_normal(
        a.shape), -1, 1).astype(np.float32)
    mask = np.zeros((4, 24, 24, 1), np.int32)
    mask[:, 4:18, 6:20] = 1
    for kw in ({}, {"mask": mask}):
        _rel(tmet.psnr(a, b, device=CPU, **kw), jmet.psnr(a, b, **kw))
    # SSIM on 2 images of 16 px: fp32 sums of both packages' filters and
    # means, in their own orders, part by ~1e-6 of the mean at 4 x 24 px
    sa, sb = a[:2, :16, :16], b[:2, :16, :16]
    _rel(tmet.ssim(sa, sb, device=CPU), jmet.ssim(sa, sb))
    _rel(tmet.ssim(sa[..., :1], sb[..., :1], device=CPU),
         jmet.ssim(sa[..., :1], sb[..., :1]))
    rng = np.random.default_rng(2)
    acts1 = rng.standard_normal((40, 16))
    acts2 = rng.standard_normal((30, 16)) * 1.3 + 0.2
    for fn in ("fid_from_acts", "kid_from_acts", "msid_from_acts"):
        _rel(getattr(tmet, fn)(acts1, acts2), getattr(jmet, fn)(acts1, acts2))
    _rel(tmet.kid_from_acts(acts1, acts2, subset_size=10, seed=3),
         jmet.kid_from_acts(acts1, acts2, subset_size=10, seed=3))
    assert tmet.kid_from_acts(acts1[:1], acts2) == 0.0
    mu1, s1 = tmet._cov_mean(acts1)
    mu2, s2 = jmet._cov_mean(acts2)
    _rel(tmet.frechet_distance(mu1, s1, mu2, s2),
         jmet.frechet_distance(mu1, s1, mu2, s2))
    assert tmet.FALLBACK_MARKER == jmet.FALLBACK_MARKER
    for fb in (False, True):
        assert tmet.metric_key("FID", fb) == jmet.metric_key("FID", fb)
    assert tmet.cache_path_for(str(tmp_path), "B", 32, "test") == \
        jmet.cache_path_for(str(tmp_path), "B", 32, "test")
    # the statistics cache: the port writes it, both read it
    path = tmet.cache_path_for(str(tmp_path / "stats"), "B", 24)
    mu, sigma, acts = tmet.compute_statistics_of_images(
        lambda x: acts1, a, cache_path=path)
    for fn in (tmet.compute_statistics_of_images,
               jmet.compute_statistics_of_images):
        got = fn(lambda x: 1 / 0, a, cache_path=path)
        for g, w in zip(got, (mu, sigma, acts)):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# 2. the networks on converted seeded trees
# ---------------------------------------------------------------------------

def _case(name):
    """(JAX module, its tree, port module, input) of a network case."""
    key = jax.random.PRNGKey(0)
    if name == "random_conv":
        jnet, tnet, x = jmet.RandomConvFeatures(), tmet.RandomConvFeatures(), \
            imgs(3, 2, 40)
    elif name == "inception":
        jnet, tnet, x = jinc.InceptionV3FID(), tinc.InceptionV3FID(), \
            imgs(4, 2, 75)
    elif name == "i3d":
        jnet, tnet = ji3d.I3D(), ti3d.I3D()
        x = np.random.default_rng(5).uniform(-1, 1, (2, 4, 32, 32, 3)) \
            .astype(np.float32)
    elif name == "random_conv3d":
        jnet, params = clip_fallback()
        tnet = tmet.RandomConv3D()
        x = np.random.default_rng(6).uniform(-1, 1, (2, 4, 16, 16, 3)) \
            .astype(np.float32)
        return jnet, seeded(params, 16), tnet, x
    else:
        jnet, tnet, x = jmet._VGGish(), tmet._VGGish(), imgs(7, 2, 32)
    shapes = jax.eval_shape(lambda r: jnet.init(r, x), key)
    return jnet, seeded(shapes, 10 + len(name)), tnet, x


@pytest.mark.parametrize("name", ["random_conv", "inception", "i3d",
                                  "random_conv3d", "vgg"])
def test_networks_match_jax_on_converted_trees(name):
    jnet, tree, tnet, x = _case(name)
    tnet.load_state_dict(_flat(tree))
    back = tnet.flax_tree() if name == "i3d" else torch_to_flax(
        tnet.state_dict())
    for (pj, a), (pt, b) in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pj == pt
        np.testing.assert_array_equal(a, b)
    apply = jax.jit(jnet.apply)
    want = apply(tree, x)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    if name != "vgg":
        assert got.shape == want.shape and np.abs(want).max() > 0
        close(to_np(got), want, RTOL)
        return
    for g, w in zip(got, want):
        close(to_np(g), w, RTOL)
    y = imgs(8, 2, 32)
    fy = apply(tree, y)
    with torch.no_grad():
        gy = tnet(torch.from_numpy(y))
    for fn in ("lpips_from_feats", "dists_from_feats"):
        close(to_np(getattr(tmet, fn)(got, gy)),
              getattr(jmet, fn)(want, fy), RTOL)


# ---------------------------------------------------------------------------
# 3. the weights files
# ---------------------------------------------------------------------------

def _flat_npz(tree, sep):
    """A flat npz dict of a flax tree: ``a/b/kernel`` (``sep`` "/") or
    ``<unit>.kernel`` (I3D's one-level tree, ``sep`` ".")."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(tree["params"]))[0]:
        out[sep.join(p.key for p in path)] = np.asarray(leaf)
    return out


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    """Seeded full-size weights files in a temporary ``WEIGHTS_DIR`` of
    both packages; yields their trees."""
    key = jax.random.PRNGKey(0)
    trees = {
        "inception_v3_fid.npz": (jinc.InceptionV3FID(), (1, 75, 75, 3), "/"),
        "vgg16_lpips.npz": (jmet._VGGish(), (1, 32, 32, 3), "/"),
        "i3d_fvd.npz": (ji3d.I3D(), (1, 4, 32, 32, 3), "."),
    }
    out = {}
    for i, (fname, (net, shape, sep)) in enumerate(trees.items()):
        shapes = jax.eval_shape(lambda r: net.init(r, jnp.zeros(shape)), key)
        out[fname] = seeded(shapes, 30 + i)
        np.savez(tmp_path / fname, **_flat_npz(out[fname], sep))
    for mod in (jmet, tmet):
        monkeypatch.setattr(mod, "WEIGHTS_DIR", str(tmp_path))
    yield out


def test_weights_files_load_in_both_packages(weights_dir):
    d = tmet.WEIGHTS_DIR
    path = os.path.join(d, "inception_v3_fid.npz")
    _bit_for_bit(jinc.load_inception_params(path),
                 flax_to_torch(tinc.load_inception_params(path)))
    path = os.path.join(d, "i3d_fvd.npz")
    _bit_for_bit(ji3d.load_i3d_params(path),
                 flax_to_torch(ti3d.load_i3d_params(path)))
    _bit_for_bit(weights_dir["vgg16_lpips.npz"], flax_to_torch(
        tmet.load_vgg_params(os.path.join(d, "vgg16_lpips.npz"))))
    # LPIPS and DISTS through the normalised input of a weights file
    a, b = imgs(20, 3, 32), imgs(21, 3, 32)
    lp = tmet.LPIPS(device=CPU)
    assert not lp.is_fallback
    _rel(lp(a, b), jmet.LPIPS()(a, b), RTOL)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    jf = jmet.vgg_feature_fn((32, 32, 3), mean=mean, std=std)
    tf = tmet.vgg_feature_fn((32, 32, 3), mean=mean, std=std, device=CPU)
    with torch.no_grad():
        got = tmet.dists_from_feats(tf(torch.from_numpy(a)),
                                    tf(torch.from_numpy(b)))
    close(to_np(got), jmet.dists_from_feats(jf(a), jf(b)), RTOL)
    # the extractors load them and run at their real input sizes
    inc = tmet.InceptionV3Features(batch=1, device=CPU)
    feats = inc(imgs(22, 1, 40))
    assert not inc.is_fallback and feats.shape == (1, 2048)
    assert np.isfinite(feats).all()
    vf = tmet.VideoFeatures(device=CPU)
    clips = np.random.default_rng(23).uniform(-1, 1, (1, 2, 24, 24, 1)) \
        .astype(np.float32)
    out = vf(clips)
    assert not vf.is_fallback and out.shape == (1, 400)
    assert np.isfinite(out).all()
