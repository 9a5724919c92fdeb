"""The GAN slice's ops and losses against the JAX package, on the CPU, fp32:

- ``upfirdn2d`` (up, down, crops), ``upsample2d``/``downsample2d``,
  ``blur_pool`` and the Haar pair: forward and the gradient of a random
  cotangent, 1e-5;
- the resizes the projected D and DiffAugment use against
  ``jax.image.resize`` / ``scale_and_translate``, 1e-5;
- each DiffAugment policy with the JAX draws fed, 1e-6 (resize 1e-5);
- ``PatchSampleF`` with fed ids and PatchNCE, MoNCE and SRC + hDCE, the
  losses and their gradients, 1e-5;
- ``gan_loss`` in its four modes, the contrastive loss and the WGAN-GP
  penalty with a fed alpha;
- ``ImagePool`` with the JAX draws fed, bit for bit, through filling and
  swapping.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (aug_draws, few_torch_threads, load_flax, nchw,
                               patch_ids, pool_draws, to_np)
from joligen_tpu.models.modules import cut_networks as jcut
from joligen_tpu.models.modules.discriminators import blur_pool as jblur
from joligen_tpu.models.modules.image_pool import ImagePool as JPool
from joligen_tpu_torch.models.modules import cut_networks as tcut
from joligen_tpu_torch.models.modules.discriminators import blur_pool
from joligen_tpu_torch.models.modules.image_pool import ImagePool
from joligen_tpu_torch.ops import diff_aug as taug
from joligen_tpu_torch.ops import resize as tres
from joligen_tpu_torch.ops import upfirdn2d as tfir

jfir = importlib.import_module("joligen_tpu.ops.upfirdn2d")
jaug = importlib.import_module("joligen_tpu.ops.diff_aug")

F4 = [1, 3, 3, 1]
FIR_CASES = {
    "up2": (lambda f: dict(up=2, padding=(1, 2, 1, 2)), (2, 9, 11, 3)),
    "down2_crop": (lambda f: dict(up=2, down=2, padding=(-1, 2, 1, -2)),
                   (2, 9, 11, 3)),
    "gain": (lambda f: dict(down=2, padding=(1, 1, 1, 1), gain=2.0),
             (1, 8, 8, 2)),
}


def _vjp_pair(jf, tf, shape, seed):
    """Forward and input gradient of <f(x), cot> in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y, vjp = jax.vjp(jf, jnp.asarray(x))
    cot = rng.standard_normal(y.shape).astype(np.float32)
    gx, = vjp(jnp.asarray(cot))
    xt = nchw(x).requires_grad_(True)
    yt = tf(xt)
    (yt * nchw(cot)).sum().backward()
    return (np.asarray(y), to_np(yt).transpose(0, 2, 3, 1),
            np.asarray(gx), to_np(xt.grad).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("case", sorted(FIR_CASES))
def test_upfirdn2d_matches_jax(case):
    kw, shape = FIR_CASES[case]
    jf = jfir.setup_filter(F4)
    tf = tfir.setup_filter(F4)
    y, yt, g, gt = _vjp_pair(lambda x: jfir.upfirdn2d(x, jf, **kw(jf)),
                             lambda x: tfir.upfirdn2d(x, tf, **kw(tf)),
                             shape, 0)
    assert y.shape == yt.shape
    np.testing.assert_allclose(yt, y, atol=1e-5)
    np.testing.assert_allclose(gt, g, atol=1e-5)


@pytest.mark.parametrize("name", ["upsample2d", "downsample2d", "blur_pool",
                                  "haar", "haar_roundtrip"])
def test_resampling_and_haar_match_jax(name):
    jf, tf = jfir.setup_filter(F4), tfir.setup_filter(F4)
    fns = {
        "upsample2d": (lambda x: jfir.upsample2d(x, jf),
                       lambda x: tfir.upsample2d(x, tf)),
        "downsample2d": (lambda x: jfir.downsample2d(x, jf),
                         lambda x: tfir.downsample2d(x, tf)),
        "blur_pool": (jblur, blur_pool),
        "haar": (jfir.haar_transform, tfir.haar_transform),
        "haar_roundtrip": (
            lambda x: jfir.inverse_haar_transform(jfir.haar_transform(x)),
            lambda x: tfir.inverse_haar_transform(tfir.haar_transform(x))),
    }
    y, yt, g, gt = _vjp_pair(*fns[name], (2, 8, 10, 3), 1)
    np.testing.assert_allclose(yt, y, atol=1e-5)
    np.testing.assert_allclose(gt, g, atol=1e-5)
    if name == "haar_roundtrip":
        x = np.random.default_rng(1).standard_normal((2, 8, 10, 3))
        np.testing.assert_allclose(yt, x, atol=1e-5)


@pytest.mark.parametrize("size", [(5, 7), (16, 12), (3, 2)])
def test_resizes_match_jax_image(size):
    """Bilinear (antialiased where it shrinks, 16 -> 5) and nearest with
    half-pixel centres (2 -> 3 is where torch's plain ``nearest``
    differs)."""
    x = np.random.default_rng(2).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    for method, fn in (("bilinear", tres.resize_bilinear),
                       ("nearest", tres.resize_nearest)):
        want = np.asarray(jax.image.resize(
            jnp.asarray(x), (2,) + size + (3,), method))
        got = to_np(fn(nchw(x), size)).transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=method)


POLICIES = ["color", "translation", "cutout", "noise", "resize",
            "color,translation,cutout"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_diff_augment_with_fed_draws_matches_jax(policy, prob):
    shape = (3, 12, 10, 3)
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jaug.diff_augment(key, jnp.asarray(x), policy,
                                            prob))
        draws = aug_draws(key, shape, policy, prob)
        got = to_np(taug.apply_diff_augment(nchw(x), draws, policy))
        tol = 1e-5 if "resize" in policy else 1e-6
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want,
                                   atol=tol)


def test_diff_augment_draws_on_the_generator():
    """The port's own draws: shapes, ranges, and the gate's share."""
    g = torch.Generator().manual_seed(0)
    d = taug.draw_diff_augment(g, (4, 3, 16, 16), "color,translation,"
                               "cutout,noise,resize", 0.5)
    assert d["noise"].shape == (4, 3, 16, 16)
    assert int(d["ty"].abs().max()) <= 2 and int(d["cx"].max()) < 16
    assert all(0 <= float(d[k].min()) and float(d[k].max()) < 1
               for k in ("brightness", "zoom", "ox"))
    uses = [bool(taug.draw_diff_augment(g, (1, 3, 4, 4), "color", 0.5)["use"])
            for _ in range(400)]
    assert 0.4 < np.mean(uses) < 0.6
    assert taug.draw_diff_augment(g, (1, 3, 4, 4), "", 0.5) is None


def _nce_inputs(seed, b=2, p=16, c=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * p, c)).astype(np.float32)
    k = rng.standard_normal((b * p, c)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    return q, k


NCE = {
    "patchnce": (lambda q, k: jcut.patch_nce_loss(q, k, 0.07, 2),
                 lambda q, k: tcut.patch_nce_loss(q, k, 0.07, 2)),
    "patchnce_all_neg": (
        lambda q, k: jcut.patch_nce_loss(q, k, 0.07, 2, True),
        lambda q, k: tcut.patch_nce_loss(q, k, 0.07, 2, True)),
    "monce": (lambda q, k: jcut.monce_loss(q, k, 0.07, 2, 16),
              lambda q, k: tcut.monce_loss(q, k, 0.07, 2, 16)),
    "monce_256": (lambda q, k: jcut.monce_loss(q, k, 0.07, 2, 256),
                  lambda q, k: tcut.monce_loss(q, k, 0.07, 2, 256)),
    "hdce": (lambda q, k: jcut.src_hdce_loss(q, k, 0.07, 2, 16,
                                             gamma=10.0)[0],
             lambda q, k: tcut.src_hdce_loss(q, k, 0.07, 2, 16,
                                             gamma=10.0)[0]),
    "src": (lambda q, k: jcut.src_hdce_loss(q, k, 0.07, 2, 16)[1],
            lambda q, k: tcut.src_hdce_loss(q, k, 0.07, 2, 16)[1]),
}


@pytest.mark.parametrize("name", sorted(NCE))
def test_nce_losses_and_gradients_match_jax(name):
    """The losses per patch, and the gradient of their mean in feat_q (the
    gradient runs through MoNCE's 50 Sinkhorn iterations); feat_k gets
    none."""
    jf, tf = NCE[name]
    q, k = _nce_inputs(4)
    want, (gq, gk) = jax.value_and_grad(
        lambda a, b: jnp.mean(jf(a, b)), argnums=(0, 1))(jnp.asarray(q),
                                                         jnp.asarray(k))
    per = np.asarray(jf(jnp.asarray(q), jnp.asarray(k)))
    qt = torch.from_numpy(q).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    out = tf(qt, kt)
    np.testing.assert_allclose(to_np(out), per, atol=1e-5, rtol=1e-5)
    out.mean().backward()
    np.testing.assert_allclose(to_np(qt.grad), np.asarray(gq), atol=1e-5)
    assert kt.grad is None and not np.asarray(gk).any()


def test_patch_sample_f_with_fed_ids_matches_jax():
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((2, 8, 8, 3)).astype(np.float32),
             rng.standard_normal((2, 4, 4, 16)).astype(np.float32)]
    key = jax.random.PRNGKey(7)
    jids = jcut.sample_patch_ids(key, [jnp.asarray(f) for f in feats], 12)
    ids = patch_ids(key, [64, 16], 12)
    for a, b in zip(jids, ids):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jnet = jcut.PatchSampleF(nc=32)
    params = jnet.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
                       jids)
    want = jnet.apply(params, [jnp.asarray(f) for f in feats], jids)
    net = load_flax(tcut.PatchSampleF([3, 16], nc=32), params)
    got = net([torch.from_numpy(f) for f in feats], ids)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5)
    # the port's own ids: distinct, in range, min(num_patches, H·W) a map
    g = torch.Generator().manual_seed(0)
    own = tcut.sample_patch_ids(g, [torch.from_numpy(f) for f in feats], 40)
    assert [len(i) for i in own] == [40, 16]
    assert all(len(set(i.tolist())) == len(i) for i in own)
    assert int(own[0].max()) < 64


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp", "projected"])
def test_gan_loss_matches_jax(mode):
    pred = np.random.default_rng(6).standard_normal((3, 5, 5, 1)).astype(
        np.float32) * 2
    for real in (True, False):
        for smooth in (0.0, 0.1):
            want = float(jcut.gan_loss(jnp.asarray(pred), real, mode,
                                       smooth=smooth))
            got = float(tcut.gan_loss(torch.from_numpy(pred), real, mode,
                                      smooth=smooth))
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_contrastive_loss_and_gradient_penalty_match_jax():
    rng = np.random.default_rng(8)
    t, f = (rng.standard_normal((2, 6)).astype(np.float32) for _ in range(2))
    want = float(jcut.contrastive_gan_loss(jnp.asarray(t), jnp.asarray(f)))
    got = float(tcut.contrastive_gan_loss(torch.from_numpy(t),
                                          torch.from_numpy(f)))
    assert abs(got - want) <= 1e-6
    real, fake = (rng.uniform(-1, 1, (3, 6, 6, 2)).astype(np.float32)
                  for _ in range(2))
    w = rng.standard_normal((2,)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jd(p, x):
        return jnp.tanh(x * p).sum(axis=(1, 2))

    want = float(jcut.wgangp_gradient_penalty(jd, jnp.asarray(w),
                                              jnp.asarray(real),
                                              jnp.asarray(fake), key))
    alpha = torch.from_numpy(np.array(jax.random.uniform(
        key, (3, 1, 1, 1), jnp.float32)))
    wt = torch.from_numpy(w).requires_grad_(True)
    gp = tcut.wgangp_gradient_penalty(
        lambda x: torch.tanh(x * wt).sum(dim=(1, 2)),
        torch.from_numpy(real), torch.from_numpy(fake), alpha)
    assert abs(float(gp.detach()) - want) <= 1e-5 * max(1.0, abs(want))
    wgrad = jax.grad(lambda p: jcut.wgangp_gradient_penalty(
        jd, p, jnp.asarray(real), jnp.asarray(fake), key))(jnp.asarray(w))
    gp.backward()
    np.testing.assert_allclose(to_np(wt.grad), np.asarray(wgrad), atol=1e-5)


def test_image_pool_with_fed_draws_is_bit_exact():
    """Five queries of 3 into a pool of 7: filling, the query that fills it,
    then swaps; returned images and the buffer bit for bit."""
    shape = (4, 4, 3)
    jp = JPool.create(7, shape)
    tp = ImagePool(7, shape, "cpu")
    rng = np.random.default_rng(9)
    for i in range(5):
        fakes = rng.standard_normal((3,) + shape).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        jp, want = jp.query(key, jnp.asarray(fakes))
        got = tp.query(torch.from_numpy(fakes), pool_draws(key, 3, 7))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
        np.testing.assert_array_equal(to_np(tp.buffer), np.asarray(jp.buffer))
        assert tp.count == int(jp.count)
    key = jax.random.PRNGKey(5)
    want = jp.get_random(key, 4)
    idx = torch.from_numpy(np.array(jax.random.randint(
        key, (4,), 0, max(int(jp.count), 1)))).long()
    np.testing.assert_array_equal(to_np(tp.get_random(idx)),
                                  np.asarray(want))
    assert ImagePool(0, shape, "cpu").query(torch.ones(2, *shape),
                                            None).shape == (2,) + shape
