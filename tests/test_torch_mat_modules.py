"""MAT's layers in the port (``joligen_tpu_torch/models/modules/mat.py``,
``utils/metrics.py``'s ``_VGGish``) against the JAX package, on the CPU,
on seeded weights with every leaf non-zero (``_torch_mat_common``): each
forward in fp32, and the gradients of sum(output x a fixed cotangent) for
the inputs and every parameter in float64 on both sides (``grads64``: in
fp32 an lrelu input within rounding of its kink takes either of two valid
gradients), to 1e-4 of the largest value (gradients: of the largest
leaf's):

- the resampling convs at k = 1 and k = 3 (plain, 2x down through the
  full-resolution FIR, 2x up through the stuffed input), boundary pixels
  included;
- ``EqualDense`` (lr_mul 0.01, bias init 1), ``MappingNet``;
- ``ModulatedConv`` (up, down, plain, the 1x1 without demodulation),
  ``StyleConv`` with its noise, ``ToRGB`` accumulating an image;
- ``EqualConv`` (the D's 1x1 down skip, up, down), ``PartialConv`` (plain,
  down, up; a hole covering whole 3x3 windows; no mask);
- the window helpers and the shift bias exactly; ``WindowAttention`` with
  and without the shift bias, with an all-hole window (its gradient
  finite); ``SwinBlock`` shifted and not; ``BasicLayerMAT`` down with its
  mask and up without;
- ``minibatch_std`` at batch 8 and 6, ``DisBlock``, ``MATDiscriminator``;
- ``_VGGish``'s five stages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_mat_common import (close, grads64, grads_close,
                               init_tree, load_mat, to_np)
from joligen_tpu.models.modules import mat as jm
from joligen_tpu.utils import metrics as jmetrics
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import mat as tm
from joligen_tpu_torch.utils import metrics as tmetrics

RTOL = 1e-4


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def check(jmod, tmod, jfn, tfn, ins, seed, init_kw=None, init_args=None):
    """The fp32 forward of ``jfn(params, *ins)`` (JAX) against ``tfn(*ins)``
    (the port's module ``tmod`` loaded with the same seeded tree, built for
    ``init_args``, default ``ins``), both in the JAX layout, and their
    gradients in float64 on both sides (``grads64``); returns the port's
    fp32 output."""
    params = init_tree(jmod, ins if init_args is None else init_args,
                       init_kw or {}, seed)
    load_mat(tmod, params)
    got = tfn(*[torch.from_numpy(np.array(a)) for a in ins])
    close(to_np(got), jax.jit(jfn)(params, *ins), RTOL)
    xgrads, jg = grads64(jfn, params, ins, tmod, tfn, seed + 1)
    for g, want in zip(xgrads, jg[1:]):
        assert torch.isfinite(g).all()
        close(to_np(g), want, RTOL)
    grads_close(jg[0], tmod, RTOL)
    return got


def _x(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# resampling convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", ["plain", "down", "up"])
def test_resampling_convs_match_jax(k, mode):
    x = _x(1, (2, 8, 10, 5))
    w = np.random.default_rng(2).standard_normal((k, k, 5, 4)).astype(
        np.float32)
    jfn = {"plain": jm._conv_plain, "down": jm._conv_down2,
           "up": jm._conv_up2}[mode]
    tfn = {"plain": tm._conv_plain, "down": tm._conv_down2,
           "up": tm._conv_up2}[mode]
    want = jfn(jnp.asarray(x), jnp.asarray(w), k)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = _nhwc(tfn(_nchw(xt), wt.permute(3, 2, 0, 1), k))
    assert got.shape == want.shape
    close(to_np(got), want, RTOL)
    cot = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(jfn(a, b, k) * cot),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    (got * torch.from_numpy(cot)).sum().backward()
    close(to_np(xt.grad), gx, RTOL)
    close(to_np(wt.grad), gw, RTOL)


def test_blurs_keep_a_constant_image():
    x = torch.full((1, 2, 6, 6), 0.7)
    assert torch.allclose(tm.blur_up(x)[:, :, 2:-2, 2:-2], torch.tensor(0.7))
    assert tm.blur_down(x).shape == (1, 2, 3, 3)


# ---------------------------------------------------------------------------
# dense layers and the mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(lr_mul=0.01, act=True),
                                dict(bias_init=1.0)])
def test_equal_dense_matches_jax(kw):
    x = _x(4, (3, 7))
    jmod = jm.EqualDense(5, **kw)
    tmod = tm.EqualDense(7, 5, **kw)
    check(jmod, tmod, lambda p, a: jmod.apply(p, a), tmod, (x,), 5)


def test_mapping_net_matches_jax():
    z = np.random.default_rng(6).standard_normal((3, 16)).astype(np.float32)
    jmod = jm.MappingNet(w_dim=24)
    tmod = tm.MappingNet(16, 24)
    check(jmod, tmod, lambda p, a: jmod.apply(p, a), tmod, (z,), 7)


# ---------------------------------------------------------------------------
# modulated convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(up=True), dict(down=True), dict(),
                                dict(kernel=1, demodulate=False)])
def test_modulated_conv_matches_jax(kw):
    x, s = _x(8, (2, 8, 8, 6)), _x(9, (2, 10))
    jmod = jm.ModulatedConv(5, **kw)
    tmod = tm.ModulatedConv(6, 5, 10, **kw)
    check(jmod, tmod, lambda p, a, b: jmod.apply(p, a, b),
          lambda a, b: _nhwc(tmod(_nchw(a), b)), (x, s), 10)


def test_style_conv_with_noise_matches_jax():
    x, s = _x(11, (2, 8, 8, 6)), _x(12, (2, 10))
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, (2, 16, 16, 1), jnp.float32)
    with jax.enable_x64(True):   # the JAX layer's draw in float64 (``check``)
        noise64 = jax.random.normal(key, (2, 16, 16, 1), jnp.float64)
    jmod = jm.StyleConv(5, up=True)
    tmod = tm.StyleConv(6, 5, 10, up=True)
    tn = {t.dtype: _nchw(t) for t in (torch.from_numpy(np.array(noise)),
                                       torch.from_numpy(np.array(noise64)))}
    check(jmod, tmod, lambda p, a, b: jmod.apply(p, a, b, key),
          lambda a, b: _nhwc(tmod(_nchw(a), b, tn[a.dtype])), (x, s), 13,
          init_kw={"rng": key})
    assert tmod.noise.noise_strength.grad.abs() > 0


def test_to_rgb_accumulates_like_jax():
    x, s, img = _x(14, (2, 8, 8, 6)), _x(15, (2, 10)), _x(16, (2, 4, 4, 3))
    jmod = jm.ToRGB(3)
    tmod = tm.ToRGB(6, 3, 10)
    check(jmod, tmod, lambda p, a, b, c: jmod.apply(p, a, b, c),
          lambda a, b, c: _nhwc(tmod(_nchw(a), b, _nchw(c))), (x, s, img), 17)


# ---------------------------------------------------------------------------
# equalized and partial convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(kernel=1, down=True, act=False, use_bias=False, gain=0.5 ** 0.5),
    dict(up=True), dict(down=True, gain=0.5 ** 0.5), dict()])
def test_equal_conv_matches_jax(kw):
    x = _x(18, (2, 8, 8, 4))
    jmod = jm.EqualConv(6, **kw)
    tmod = tm.EqualConv(4, 6, **kw)
    check(jmod, tmod, lambda p, a: jmod.apply(p, a),
          lambda a: _nhwc(tmod(_nchw(a))), (x,), 19)


def _hole_mask():
    """A 12x12 mask (1 = known) with a 6x6 hole: the middle taps' 3x3
    windows lie wholly inside it."""
    m = np.ones((2, 12, 12, 1), np.float32)
    m[:, 3:9, 2:8] = 0.0
    m[1, :, 10:] = 0.0
    return m


@pytest.mark.parametrize("kw", [dict(), dict(down=True), dict(up=True)])
def test_partial_conv_matches_jax(kw):
    x = _x(20, (2, 12, 12, 4))
    m = _hole_mask()
    if kw.get("up"):
        x, m = x[:, :6, :6], m[:, ::2, ::2]
    jmod = jm.PartialConv(5, **kw)
    tmod = tm.PartialConv(4, 5, **kw)
    tmask = _nchw(torch.from_numpy(m))
    got = check(jmod, tmod, lambda p, a: jmod.apply(p, a, m)[0],
                lambda a: _nhwc(tmod(_nchw(a), tmask)[0]), (x,), 21,
                init_kw={"mask": m})
    want_m = jmod.apply(init_tree(jmod, (x,), {"mask": m}, 21), x, m)[1]
    got_m = _nhwc(tmod(_nchw(torch.from_numpy(x)), tmask)[1])
    np.testing.assert_array_equal(to_np(got_m), np.asarray(want_m))
    assert (to_np(got_m) == 0).any()     # whole windows in the hole
    assert (to_np(got) == 0).any()       # scaled to 0 there


def test_partial_conv_without_mask_is_the_conv():
    x = _x(22, (2, 8, 8, 4))
    jmod = jm.PartialConv(5, down=True)
    tmod = tm.PartialConv(4, 5, down=True)
    got = check(jmod, tmod, lambda p, a: jmod.apply(p, a)[0],
                lambda a: _nhwc(tmod(_nchw(a))[0]), (x,), 23)
    assert tmod(_nchw(torch.from_numpy(x)))[1] is None and got.shape == (
        2, 4, 4, 5)


# ---------------------------------------------------------------------------
# windows and attention
# ---------------------------------------------------------------------------

def test_window_helpers_and_shift_bias_are_exact():
    x = _x(24, (2, 8, 12, 3))
    want = np.asarray(jm.window_partition(jnp.asarray(x), 4))
    got = tm.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.window_reverse(got, 4, 8, 12).numpy(),
                                  x)
    for h, w, ws, shift in ((8, 8, 4, 2), (16, 8, 8, 4)):
        np.testing.assert_array_equal(
            tm.shift_attn_bias_np(h, w, ws, shift),
            np.asarray(jm._shift_attn_bias(h, w, ws, shift)))


def _window_mask(bw, n):
    m = np.ones((bw, n, 1), np.float32)
    m[0] = 0.0                      # an all-hole window
    m[1, ::3] = 0.0
    return m


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_matches_jax(shifted):
    n_win, n = 4, 16
    x = _x(25, (2 * n_win, n, 12))
    x[0, :4] = 0.0                  # exact-zero hole tokens
    bias = np.asarray(jm._shift_attn_bias(8, 8, 4, 2)) if shifted else None
    m = None if shifted else _window_mask(2 * n_win, n)
    jmod = jm.WindowAttention(12, 3)
    tmod = tm.WindowAttention(12, 3)
    tb = torch.from_numpy(np.array(bias)) if shifted else None
    tmask = torch.from_numpy(m) if m is not None else None

    def jfn(p, a):
        return jmod.apply(p, a, mask_windows=m, attn_bias=bias,
                          n_windows=n_win)[0]

    def tfn(a):
        return tmod(a, mask_windows=tmask, attn_bias=tb, n_windows=n_win)[0]
    check(jmod, tmod, jfn, tfn, (x,), 26,
          init_kw={"mask_windows": m, "attn_bias": bias, "n_windows": n_win})
    if m is not None:
        new = tmod(torch.from_numpy(x), mask_windows=tmask)[1]
        assert new[0].sum() == 0 and (new[1:] == 1).all()


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_matches_jax(shift):
    x = _x(27, (2, 64, 12))
    m = np.ones((2, 64, 1), np.float32)
    m[0, :20] = 0.0
    jmod = jm.SwinBlock(12, 3, 8, 8, 4, shift)
    tmod = tm.SwinBlock(12, 3, 8, 8, 4, shift)
    assert tmod.shift == shift
    check(jmod, tmod, lambda p, a: jmod.apply(p, a, m)[0],
          lambda a: tmod(a, torch.from_numpy(m))[0], (x,), 28,
          init_kw={"mask": m})


@pytest.mark.parametrize("resample", ["down", "up"])
def test_basic_layer_matches_jax(resample):
    h = 8 if resample == "down" else 4
    x = _x(29, (2, h * h, 12))
    m = None
    if resample == "down":
        m = np.ones((2, h * h, 1), np.float32)
        m[1, 10:30] = 0.0
    jmod = jm.BasicLayerMAT(12, 2, 3, h, h, 4, resample=resample)
    tmod = tm.BasicLayerMAT(12, 2, 3, h, h, 4, resample=resample)
    tmask = torch.from_numpy(m) if m is not None else None
    check(jmod, tmod, lambda p, a: jmod.apply(p, a, m)[0],
          lambda a: tmod(a, tmask)[0], (x,), 30, init_kw={"mask": m})
    p = init_tree(jmod, (x,), {"mask": m}, 30)
    _, hw, jmask = jmod.apply(p, x, m)
    _, thw, tmask2 = tmod(torch.from_numpy(x), tmask)
    assert thw == hw
    if m is not None:
        np.testing.assert_array_equal(to_np(tmask2), np.asarray(jmask))


# ---------------------------------------------------------------------------
# discriminator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 6])
def test_minibatch_std_matches_jax(n):
    x = _x(31, (n, 4, 4, 5))
    want = jm.minibatch_std(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _nhwc(tm.minibatch_std(_nchw(xt)))
    close(to_np(got), want, RTOL)
    cot = np.random.default_rng(32).standard_normal(want.shape).astype(
        np.float32)
    gx = jax.grad(lambda a: jnp.sum(jm.minibatch_std(a) * cot))(
        jnp.asarray(x))
    (got * torch.from_numpy(cot)).sum().backward()
    close(to_np(xt.grad), gx, RTOL)


def test_dis_block_matches_jax():
    x = _x(33, (2, 8, 8, 6))
    jmod = jm.DisBlock(10)
    tmod = tm.DisBlock(6, 10)
    check(jmod, tmod, lambda p, a: jmod.apply(p, a),
          lambda a: _nhwc(tmod(_nchw(a))), (x,), 34)


def test_discriminator_matches_jax():
    img, stg1 = _x(35, (4, 32, 32, 3)), _x(36, (4, 32, 32, 3))
    m = np.ones((4, 32, 32, 1), np.float32)
    m[:, 8:20, 4:24] = 0.0
    jmod = jm.MATDiscriminator(base=16)
    tmod = tm.MATDiscriminator(32, 3, base=16)
    tm_ = torch.from_numpy(m)
    check(jmod, tmod, lambda p, a, b: jnp.concatenate(
              jmod.apply(p, a, m, b), axis=-1),
          lambda a, b: torch.cat(tmod(a, tm_, b), dim=-1), (img, stg1), 37,
          init_args=(img, m, stg1))


# ---------------------------------------------------------------------------
# the perceptual trunk
# ---------------------------------------------------------------------------

def test_vggish_matches_jax():
    x = _x(38, (2, 32, 32, 3))
    jmod = jmetrics._VGGish()
    params = jmod.init(jax.random.PRNGKey(0), x)
    tmod = tmetrics._VGGish(generator=torch.Generator().manual_seed(0))
    tmod.load_state_dict(flax_to_torch(jax.device_get(params)))
    want = jmod.apply(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmod(xt)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(to_np(g), w, RTOL)
    gx = jax.grad(lambda a: sum(jnp.sum(f ** 2) for f in jmod.apply(
        params, a)))(x)
    sum((f ** 2).sum() for f in got).backward()
    close(to_np(xt.grad), gx, RTOL)
    # the seeded init: flax's law, the same draws each time
    again = tmetrics._VGGish(generator=torch.Generator().manual_seed(0))
    w0 = again.b0c0.weight
    assert torch.equal(w0, tmetrics._VGGish(
        generator=torch.Generator().manual_seed(0)).b0c0.weight)
    assert abs(w0.std().item() - (1 / 27) ** 0.5) < 0.05
