"""MAT's generator in the port (``joligen_tpu_torch/models/modules/mat.py``)
against the JAX package, on the CPU, on seeded weights with every leaf
non-zero (``_torch_mat_common``), the JAX draws fed to the port:

- ``FirstStage`` at 32 px (coarse = the input: one ToRGB) and at 128 px
  (one partial down conv, the ``dec0`` blocks), forward and gradients for
  the image, w and every parameter, to 1e-4 of the largest value (fp32);
  each gradient test first holds its input to no lrelu output within fp32
  rounding of the kink (``kink_ties``), where the gradient is either of
  two valid ones;
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
from _torch_mat_common import (BASE, DIM, WZ, close, cotangent, grads_close,
                               init_tree, jax_fwd_bwd, kink_ties, load_mat,
                               mix_draws, nchw, noise_draws, to_np)
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


def _backward(jfn, ins, params, got, seed):
    """The JAX output and gradients of sum(jfn(params, *ins) x cotangent)
    (params and ``ins``), after the port's backward of the same sum over
    ``got``."""
    cot = cotangent(tuple(got.shape), seed)
    (got * torch.from_numpy(cot)).sum().backward()
    return jax_fwd_bwd(jfn, params, ins, cot)


# ---------------------------------------------------------------------------
# the first stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 128])
def test_first_stage_matches_jax(size):
    # an input whose lrelu outputs lie clear of the kink at 1 and 2 torch
    # threads (``kink_ties``; the input of seed 1 at 128 px has one within
    # fp32 rounding of 0, where the two gradients differ by 1.1e-3 of w's)
    img, m, _, _ = _inputs(3, size)
    w = np.random.default_rng(4).standard_normal((B, WZ)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmod = jm.FirstStage(base=BASE, w_dim=WZ, dim=DIM)
    tmod = tm.FirstStage(size, 4, 3, WZ, DIM)
    params = init_tree(jmod, (img, m, w), {"rng": key}, 6)
    load_mat(tmod, params)
    assert tmod.down_time == (0 if size == 32 else 1)
    mul = np.asarray(jax.random.bernoulli(
        key, 0.5, (B, tmod.mid_res ** 2, DIM)), np.float32)
    t = lambda a, dt: torch.from_numpy(a).to(dt)  # noqa: E731
    assert kink_ties(tmod, lambda dt: tmod(
        t(img, dt).permute(0, 3, 1, 2), t(m, dt).permute(0, 3, 1, 2),
        t(w, dt), mul_map=t(mul, dt))) == 0

    def jfn(p, a, b):
        return jmod.apply(p, a, m, b, key)
    x = torch.from_numpy(img).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = _nhwc(tmod(x.permute(0, 3, 1, 2),
                     torch.from_numpy(m).permute(0, 3, 1, 2), wt,
                     mul_map=torch.from_numpy(mul)))
    want, jg = _backward(jfn, (img, w), params, got, 5)
    close(to_np(got), want, RTOL)
    assert (np.abs(np.asarray(want)) < 0.999).mean() > 0.9   # not clamped
    close(to_np(x.grad), jg[1], RTOL)
    close(to_np(wt.grad), jg[2], RTOL)
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
    xt = torch.from_numpy(x).requires_grad_(True)
    got_h, got_f = tenc(xt.permute(0, 3, 1, 2))
    assert sorted(got_f) == sorted(want_f) == [4, 5, 6, 7]
    for k in want_f:
        close(to_np(_nhwc(got_f[k])), want_f[k], RTOL)
    _, jg = _backward(lambda p, a: jenc.apply(p, a)[0], (x,), params,
                      _nhwc(got_h), 8)
    close(to_np(xt.grad), jg[1], RTOL)
    grads_close(jg[0], tenc, RTOL)

    h = np.array(want_h)
    jsty = jm.ToStyle(40)
    tsty = tm.ToStyle(h.shape[-1], 40, h.shape[1])
    params = init_tree(jsty, (h,), {}, 9)
    load_mat(tsty, params)
    ht = torch.from_numpy(h).requires_grad_(True)
    got = tsty(ht.permute(0, 3, 1, 2))
    close(to_np(got), jsty.apply(params, h), RTOL)
    _, jg = _backward(lambda p, a: jsty.apply(p, a), (h,), params, got, 10)
    close(to_np(ht.grad), jg[1], RTOL)
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

    # DecBlockFirst and DecBlockRef alone
    jfirst = jm.DecBlockFirst(128, 3)
    tfirst = tm.DecBlockFirst(128, 128, 3, sd)
    p1 = init_tree(jfirst, (h, feats[4], styles[0], styles[1], keys[0]), {},
                   13)
    load_mat(tfirst, p1)
    ht = torch.from_numpy(h).requires_grad_(True)
    gh, gimg = tfirst(ht.permute(0, 3, 1, 2), nchw(feats[4]),
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
    t = lambda a, dt: torch.from_numpy(np.array(a)).to(dt)  # noqa: E731
    assert kink_ties(tdec, lambda dt: tdec(
        t(h, dt).permute(0, 3, 1, 2),
        {k: t(v, dt).permute(0, 3, 1, 2) for k, v in feats.items()},
        lambda i: torch.cat([t(stab[i], dt), t(gs, dt)], dim=-1),
        [n.to(dt) for n in tnoise])) == 0
    ht = torch.from_numpy(h).requires_grad_(True)
    st = torch.from_numpy(stab).requires_grad_(True)
    gt = torch.from_numpy(gs).requires_grad_(True)
    got = _nhwc(tdec(ht.permute(0, 3, 1, 2),
                     {k: nchw(v) for k, v in feats.items()},
                     lambda i: torch.cat([st[i], gt], dim=-1), tnoise))
    want, jg = _backward(jfn, (h, stab, gs), params, got, 16)
    close(to_np(got), want, RTOL)
    for t, g in zip((ht, st, gt), jg[1:]):
        close(to_np(t.grad), g, RTOL)
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
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    noise = None if key is None else noise_draws(key, tmod, B)
    mix = mix_draws(mkey, B, WZ, tmod.n_style_layers) if mixing else None

    def run(x):
        return tmod(x, t(m), t(z), noise=noise, mix=mix, mask_class=t(mc),
                    truncation_psi=psi, w_avg=t(w_avg), return_stg1=True,
                    return_w=True)

    def jfn(p, a):
        return jmod.apply(p, a, m, z, rng=key, mix_rng=mkey, **kw)
    grad = case == "mixing"        # the gradients of one case
    if grad:
        assert kink_ties(tmod, lambda dt: run(t(img).to(dt))) == 0
    x = torch.from_numpy(img).requires_grad_(grad)
    got = run(x)
    if grad:
        jout, jg = _backward(lambda p, a: jfn(p, a)[0], (img,), params,
                             got[0], 23)
        close(to_np(x.grad), jg[1], RTOL)
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
