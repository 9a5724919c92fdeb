"""MAT's generator in the port (``joligen_tpu_torch/models/modules/mat.py``)
against the JAX package, on the CPU, on seeded weights with every leaf
non-zero (``_torch_mat_common``), the JAX draws fed to the port:

- ``FirstStage`` at 32 px (coarse = the input: one ToRGB) and at 128 px
  (one partial down conv, the ``dec0`` blocks), the fp32 forward and the
  gradients for the image, w and every parameter, to 1e-4 of the largest
  value; every gradient is taken in float64 on both sides (``grads64``:
  in fp32 an lrelu input within rounding of its kink takes either of two
  valid gradients, and which input lands there depends on the CPU, the
  thread count and the BLAS path);
- the second stage: ``Encoder`` at 128 px (its down convs), ``ToStyle``,
  ``DecBlockFirst``, ``DecBlockRef`` and ``Decoder`` with their noise, the
  same way;
- ``MATGenerator`` (base 16, w and z 64, stage-1 dim 12 or 36) under noise
  from a key, from key 0 (the model's ``const`` mode) and none (the
  mul_maps then 0.5), with truncation 0.7 toward a w average, with style
  mixing, with mask-class conditioning, and at 128 px: the output, the
  first stage's output and w to 1e-4, the known pixels equal to the input
  bit for bit; the gradients of one case for the image and every
  parameter;
- the generator and the discriminator in bf16 against the JAX bf16
  forwards, to 2e-2 of the L2 norm;
- the full-width trees (base 64, stage-1 dim 180, 256 px): 59,779,834
  parameters in G and 36,083,330 in D, key for key the shapes of
  ``jax.eval_shape`` of the JAX modules (built on the meta device, run by
  neither).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_mat_common import (BASE, DIM, WZ, close, grads64, grads_close,
                               init_tree, load_mat, mix_draws, nchw,
                               noise_draws, to_np)
from joligen_tpu.models.modules import mat as jm
from joligen_tpu_torch.models.modules import mat as tm

RTOL = 1e-4
B = 2


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _inputs(seed, size, classes=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    m = np.ones((B, size, size, 1), np.float32)
    m[0, size // 4:size // 2, size // 8:size // 2] = 0.0
    m[1, size // 2:, : size // 3] = 0.0
    z = rng.standard_normal((B, WZ)).astype(np.float32)
    mc = np.where(m > 0, 0.0, rng.integers(1, 4, m.shape)).astype(
        np.float32) if classes else None
    return img, m, z, mc


def _t(a, dtype=None):
    """A tensor of ``a`` (None stays None), cast to ``dtype``."""
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# the first stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 128])
def test_first_stage_matches_jax(size):
    img, m, _, _ = _inputs(3, size)
    w = np.random.default_rng(4).standard_normal((B, WZ)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmod = jm.FirstStage(base=BASE, w_dim=WZ, dim=DIM)
    tmod = tm.FirstStage(size, 4, 3, WZ, DIM)
    params = init_tree(jmod, (img, m, w), {"rng": key}, 6)
    load_mat(tmod, params)
    assert tmod.down_time == (0 if size == 32 else 1)
    shape = (B, tmod.mid_res ** 2, DIM)
    mul = jax.random.bernoulli(key, 0.5, shape)
    with jax.enable_x64(True):       # the JAX draw of the float64 run
        mul64 = jax.random.bernoulli(key, 0.5, shape)

    def jfn(p, a, b):
        return jmod.apply(p, a, m, b, key)

    def tfn(a, b):
        dt = a.dtype
        return _nhwc(tmod(a.permute(0, 3, 1, 2),
                          _t(m, dt).permute(0, 3, 1, 2), b,
                          mul_map=_t(mul64 if dt == torch.float64 else mul,
                                     dt)))
    got = tfn(_t(img), _t(w))
    want = jax.jit(jfn)(params, img, w)
    close(to_np(got), want, RTOL)
    assert (np.abs(np.asarray(want)) < 0.999).mean() > 0.9   # not clamped
    (gx, gw), jg = grads64(jfn, params, (img, w), tmod, tfn, 5)
    close(to_np(gx), jg[1], RTOL)
    close(to_np(gw), jg[2], RTOL)
    grads_close(jg[0], tmod, RTOL)


# ---------------------------------------------------------------------------
# the second stage
# ---------------------------------------------------------------------------

def test_encoder_and_to_style_match_jax():
    x = np.random.default_rng(6).uniform(-1, 1, (B, 128, 128, 7)).astype(
        np.float32)
    jenc = jm.Encoder(base=BASE)
    tenc = tm.Encoder(128, 7, BASE)
    params = init_tree(jenc, (x,), {}, 7)
    load_mat(tenc, params)
    want_h, want_f = jenc.apply(params, x)
    got_h, got_f = tenc(_t(x).permute(0, 3, 1, 2))
    assert sorted(got_f) == sorted(want_f) == [4, 5, 6, 7]
    for k in want_f:
        close(to_np(_nhwc(got_f[k])), want_f[k], RTOL)
    close(to_np(_nhwc(got_h)), want_h, RTOL)
    (gx,), jg = grads64(lambda p, a: jenc.apply(p, a)[0], params, (x,),
                        tenc, lambda a: _nhwc(tenc(a.permute(0, 3, 1, 2))[0]),
                        8)
    close(to_np(gx), jg[1], RTOL)
    grads_close(jg[0], tenc, RTOL)

    h = np.array(want_h)
    jsty = jm.ToStyle(40)
    tsty = tm.ToStyle(h.shape[-1], 40, h.shape[1])
    params = init_tree(jsty, (h,), {}, 9)
    load_mat(tsty, params)
    got = tsty(_t(h).permute(0, 3, 1, 2))
    close(to_np(got), jsty.apply(params, h), RTOL)
    (gh,), jg = grads64(lambda p, a: jsty.apply(p, a), params, (h,), tsty,
                        lambda a: tsty(a.permute(0, 3, 1, 2)), 10)
    close(to_np(gh), jg[1], RTOL)
    grads_close(jg[0], tsty, RTOL)


def test_decoder_blocks_match_jax():
    rng = np.random.default_rng(11)
    size, sd = 32, 20
    h = rng.uniform(-1, 1, (B, 16, 16, 128)).astype(np.float32)
    feats = {4: rng.uniform(-1, 1, (B, 16, 16, 128)).astype(np.float32),
             5: rng.uniform(-1, 1, (B, 32, 32, 128)).astype(np.float32)}
    styles = rng.standard_normal((4, B, sd)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    keys = jax.random.split(key, 3)
    noise = [jax.random.normal(k, (B, r, r, 1)) for k, r in
             zip(keys, (16, 32, 32))]
    tnoise = [nchw(n) for n in noise]
    with jax.enable_x64(True):       # the JAX draws of the float64 run
        tnoise64 = [nchw(jax.random.normal(k, (B, r, r, 1), jnp.float64),
                         np.float64) for k, r in zip(keys, (16, 32, 32))]

    # DecBlockFirst and DecBlockRef alone
    jfirst = jm.DecBlockFirst(128, 3)
    tfirst = tm.DecBlockFirst(128, 128, 3, sd)
    p1 = init_tree(jfirst, (h, feats[4], styles[0], styles[1], keys[0]), {},
                   13)
    load_mat(tfirst, p1)
    gh, gimg = tfirst(_t(h).permute(0, 3, 1, 2), nchw(feats[4]),
                      torch.from_numpy(styles[0]),
                      torch.from_numpy(styles[1]), tnoise[0])
    jh, jimg = jfirst.apply(p1, h, feats[4], styles[0], styles[1], keys[0])
    close(to_np(_nhwc(gh)), jh, RTOL)
    close(to_np(_nhwc(gimg)), jimg, RTOL)
    jref = jm.DecBlockRef(128, 3)
    tref = tm.DecBlockRef(128, 128, 3, sd)
    args = (np.asarray(jh), np.asarray(jimg), feats[5],
            tuple(styles[1:4]), tuple(keys[1:3]))
    p2 = init_tree(jref, args, {}, 14)
    load_mat(tref, p2)
    rh, rimg = tref(gh, gimg, nchw(feats[5]),
                    tuple(torch.from_numpy(s) for s in styles[1:4]),
                    tnoise[1:3])
    want = jref.apply(p2, *args)
    close(to_np(_nhwc(rh)), want[0], RTOL)
    close(to_np(_nhwc(rimg)), want[1], RTOL)

    # the Decoder with its shared style indices, and its gradients
    jdec = jm.Decoder(base=BASE, out_channels=3)
    tdec = tm.Decoder(size, BASE, 3, sd)
    stab = styles[:, :, : sd // 2]          # w_at(i); gs fills the rest
    gs = rng.standard_normal((B, sd - sd // 2)).astype(np.float32)

    def jfn(p, a, s, g):
        return jdec.apply(p, a, feats, lambda i: s[i], g, key)
    params = init_tree(jdec, (h, feats, lambda i: stab[i], gs, key), {}, 15)
    load_mat(tdec, params)

    def tfn(a, s, g):
        dt = a.dtype
        return _nhwc(tdec(a.permute(0, 3, 1, 2),
                          {k: _t(v, dt).permute(0, 3, 1, 2)
                           for k, v in feats.items()},
                          lambda i: torch.cat([s[i], g], dim=-1),
                          tnoise64 if dt == torch.float64 else tnoise))
    got = tfn(_t(h), _t(stab), _t(gs))
    close(to_np(got), jax.jit(jfn)(params, h, stab, gs), RTOL)
    xgrads, jg = grads64(jfn, params, (h, stab, gs), tdec, tfn, 16)
    for g, want in zip(xgrads, jg[1:]):
        close(to_np(g), want, RTOL)
    grads_close(jg[0], tdec, RTOL)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

CASES = {
    # name: (size, stage-1 dim, noise key (None: no noise; 0: the const
    # mode's key 0), mixing, truncation psi, mask classes)
    "noise": (32, DIM, 5, False, 1.0, False),
    "const": (32, DIM, 0, False, 1.0, False),
    "none": (32, DIM, None, False, 1.0, False),
    "truncation": (32, 36, 5, False, 0.7, False),
    "mixing": (32, DIM, 5, True, 1.0, False),
    "mask_class": (32, DIM, 5, False, 1.0, True),
    "128px": (128, DIM, 5, True, 0.7, False),
}


def _generators(size, dim, mixing, classes, seed, dtype=None):
    jmod = jm.MATGenerator(base=BASE, w_dim=WZ, z_dim=WZ, stage1_dim=dim,
                           style_mixing_prob=0.6 if mixing else 0.0,
                           mask_class=classes,
                           **({"dtype": dtype} if dtype else {}))
    tmod = tm.MATGenerator(size, 3, BASE, WZ, WZ, mask_class=classes,
                           style_mixing_prob=0.6 if mixing else 0.0,
                           stage1_dim=dim,
                           dtype=torch.bfloat16 if dtype else torch.float32)
    img, m, z, mc = _inputs(seed, size, classes)
    params = init_tree(jmod, (img, m, z), {"rng": jax.random.PRNGKey(0),
                                           "mask_class": mc}, seed + 1)
    load_mat(tmod, params)
    return jmod, tmod, params, (img, m, z, mc)


@pytest.mark.parametrize("case", list(CASES))
def test_generator_matches_jax(case):
    size, dim, nkey, mixing, psi, classes = CASES[case]
    jmod, tmod, params, (img, m, z, mc) = _generators(size, dim, mixing,
                                                      classes, 20)
    key = None if nkey is None else jax.random.PRNGKey(nkey)
    mkey = jax.random.PRNGKey(21) if mixing else None
    w_avg = (np.random.default_rng(22).standard_normal(WZ).astype(
        np.float32) * 0.1 if psi != 1.0 else None)
    kw = dict(mask_class=mc, truncation_psi=psi, w_avg=w_avg,
              return_stg1=True, return_w=True)
    noise = None if key is None else noise_draws(key, tmod, B)
    mix = mix_draws(mkey, B, WZ, tmod.n_style_layers) if mixing else None

    def jfn(p, a, mod=jmod):
        return mod.apply(p, a, m, z, rng=key, mix_rng=mkey, **kw)
    got = tmod(_t(img), _t(m), _t(z), noise=noise, mix=mix,
               mask_class=_t(mc), truncation_psi=psi, w_avg=_t(w_avg),
               return_stg1=True, return_w=True)
    if case == "mixing":           # the gradients of one case, in float64
        jmod64 = jm.MATGenerator(base=BASE, w_dim=WZ, z_dim=WZ,
                                 stage1_dim=dim, style_mixing_prob=0.6,
                                 mask_class=classes, dtype=jnp.float64)
        with jax.enable_x64(True):         # the JAX draws of the float64 run
            noise64 = noise_draws(key, tmod, B, jnp.float64)
            mix64 = mix_draws(mkey, B, WZ, tmod.n_style_layers)
        (gx,), jg = grads64(
            lambda p, a: jfn(p, a, jmod64)[0], params, (img,), tmod,
            lambda a: tmod(a, _t(m), _t(z), noise=noise64, mix=mix64,
                           mask_class=_t(mc), truncation_psi=psi,
                           w_avg=_t(w_avg)), 23)
        close(to_np(gx), jg[1], RTOL)
        grads_close(jg[0], tmod, RTOL)
    out, stg1, w = jax.jit(jfn)(params, img)
    for g, want in zip(got, (out, stg1, w)):
        close(to_np(g), want, RTOL)
    # known pixels are the input's, bit for bit; the hole is not clamped
    known = np.broadcast_to(m > 0, img.shape)
    np.testing.assert_array_equal(to_np(got[0])[known], img[known])
    assert (np.abs(np.asarray(out)[~known]) < 0.999).mean() > 0.9


def test_bf16_forwards_match_jax():
    jmod, tmod, params, (img, m, z, _) = _generators(
        32, DIM, True, False, 30, dtype=jnp.bfloat16)
    key, mkey = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    out, stg1 = jax.jit(lambda p: jmod.apply(
        p, img, m, z, rng=key, mix_rng=mkey, return_stg1=True))(params)
    got, gs1 = tmod(torch.from_numpy(img), torch.from_numpy(m),
                    torch.from_numpy(z),
                    noise=noise_draws(key, tmod, B, jnp.bfloat16),
                    mix=mix_draws(mkey, B, WZ, tmod.n_style_layers),
                    return_stg1=True)
    assert got.dtype == torch.float32
    close(to_np(got), out, 2e-2, norm=True)
    close(to_np(gs1), stg1, 2e-2, norm=True)
    known = np.broadcast_to(m > 0, img.shape)
    np.testing.assert_array_equal(to_np(got)[known], img[known])

    jd = jm.MATDiscriminator(base=BASE, dtype=jnp.bfloat16)
    td = tm.MATDiscriminator(32, 3, BASE, dtype=torch.bfloat16)
    fake = np.array(out)
    dparams = init_tree(jd, (fake, m, np.asarray(stg1)), {}, 33)
    load_mat(td, dparams)
    want = jax.jit(lambda p: jnp.concatenate(
        jd.apply(p, fake, m, np.asarray(stg1)), -1))(dparams)
    lg = td(torch.from_numpy(fake), torch.from_numpy(m),
            torch.from_numpy(np.array(stg1)))
    assert lg[0].dtype == torch.float32
    close(to_np(torch.cat(lg, dim=-1)), want, 2e-2, norm=True)


def test_full_width_trees_match_jax():
    size = 256
    img = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    mask = jax.ShapeDtypeStruct((1, size, size, 1), jnp.float32)
    z = jax.ShapeDtypeStruct((1, 512), jnp.float32)
    key = jax.random.PRNGKey(0)
    jg = jax.eval_shape(lambda a, b, c: jm.MATGenerator(
        stage1_dim=180).init(key, a, b, c, rng=key), img, mask, z)
    jd = jax.eval_shape(lambda a, b: jm.MATDiscriminator().init(key, a, b, a),
                        img, mask)
    with torch.device("meta"):
        tg = tm.MATGenerator(size, 3, 64, 512, 512, stage1_dim=180)
        td = tm.MATDiscriminator(size, 3, 64)
    for jtree, net, count in ((jg, tg, 59_779_834), (jd, td, 36_083_330)):
        # the converter's layouts on the shapes: HWIO -> OIHW, (in, out) ->
        # (out, in)
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jtree["params"])[0]:
            s = tuple(leaf.shape)
            s = ((s[3], s[2], s[0], s[1]) if len(s) == 4 else s[::-1])
            want[".".join(p.key for p in path)] = s
        got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert got == want
        assert sum(v.numel() for v in net.parameters()) == count
        assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jtree)) \
            == count
