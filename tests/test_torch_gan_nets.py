"""The GAN networks against the JAX package on the CPU, on the same seeded
weights (a flax tree of ``jax.eval_shape`` shapes, converted), at a small
width (ngf 8, 2 blocks, 32 px; ndf 8):

- ``ResnetGenerator[Attn]`` (plain and ``mobile``, ``reflect`` / ``zeros``
  / ``replicate`` padding, ``convtranspose`` up-mode, spectral convs,
  ``batch`` norm, ``freq_space``): the output, the NCE taps, and every
  parameter's and the input's gradient of a random cotangent;
- ``NLayerDiscriminator`` (blur-pool and strided, spectral, ``batch`` norm,
  ``D_dropout`` with the JAX masks fed, ``freq_space``),
  ``PixelDiscriminator`` and ``ProjectedDiscriminator`` (an ``interp`` that
  shrinks the input, so the antialiased bilinear resize and the
  non-integer nearest upsample both run): the same;

Tolerances. fp32: the largest difference is within 1e-4 of the largest
magnitude (of the output, the input gradient, each parameter's gradient),
on weights of N(0, 0.1). bf16, on weights drawn as the GANs' init scheme
draws them (N(0, 0.02) kernels): the JAX package's own bf16 results sit
far from its fp32 ones (1.4 % of the output's L2 norm, 7-21 % of the
input gradient's), so the port's bf16 result is held against the JAX fp32
one, in L2 norm, to twice the JAX bf16 result's distance from it plus 2e-2
of its norm. A leaf whose exact gradient is 0 (a conv bias before
InstanceNorm: only rounding noise is left, in both packages) is held to
1e-4 of the largest gradient of all in fp32, and in bf16 to twice the JAX
bf16 noise plus twice 1e-3 of that largest gradient. The projected D's trunk and
projections get a zero gradient, and so does its input.

Also: the converter carries every leaf of horse2zebra's full-width G, F,
``D_B_basic`` and ``D_B_projected_d`` both ways bit for bit; a checkpoint
the port writes reads back through flax's msgpack into the JAX tree, and
one JAX writes loads into the port; and ``apply_init_scheme``'s
statistics.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import serialization

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (err_and_scale, few_torch_threads, grads_close,
                               load_flax, nchw, seeded_tree, to_np)
from joligen_tpu.models import gan_networks as jgan
from joligen_tpu.models.modules import cut_networks as jcut
from joligen_tpu.models.modules import discriminators as jdisc
from joligen_tpu.models.modules import projected_d as jproj
from joligen_tpu.models.modules import resnet_generator as jres
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import gan_networks as tgan
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import discriminators as tdisc
from joligen_tpu_torch.models.modules import projected_d as tproj
from joligen_tpu_torch.models.modules import resnet_generator as tres
from joligen_tpu_torch.models.train_state import apply_init_scheme
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.utils import checkpoint_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# dtype: (jax, torch, tolerance, floor, L2 measure, weight scale)
DT = {"fp32": (jnp.float32, torch.float32, 1e-4, 1e-4, False, 0.1),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-3, True, 0.02)}

G_CASES = {
    "attn": (jres.ResnetGeneratorAttn, tres.ResnetGeneratorAttn,
             dict(nb_mask_attn=4, nb_mask_input=1)),
    "mobile_zeros_convtranspose": (
        jres.ResnetGenerator, tres.ResnetGenerator,
        dict(mobile=True, padding_type="zeros", up_mode="convtranspose")),
    "spectral_batch_replicate_freq": (
        jres.ResnetGenerator, tres.ResnetGenerator,
        dict(use_spectral=True, norm="batch", padding_type="replicate",
             freq_space=True)),
}


def _check(got, want, dt, ref32=None, what=""):
    """``got`` (the port) against ``want`` (JAX in the same dtype); in bf16
    against the JAX fp32 ``ref32`` (see the module doc)."""
    tol = DT[dt][2]
    if dt == "fp32":
        err, scale = err_and_scale(got, want, False)
        assert err <= tol * scale, (what, err, scale)
        return
    err, scale = err_and_scale(got, ref32, True)
    own, _ = err_and_scale(want, ref32, True)
    assert err <= 2 * own + tol * scale, (what, err, own, scale)


def _grads(jgp, tmod, dt, jgp32=None):
    if dt == "fp32":
        grads_close(jgp, tmod, DT[dt][2], DT[dt][3])
        return
    ref = flax_to_torch(jax.device_get(jgp32))
    own = flax_to_torch(jax.device_get(jgp))
    pairs = {n: (err_and_scale(to_np(p.grad) if p.grad is not None
                               else np.zeros(p.shape, np.float32),
                               ref[n].numpy(), True)[0],
                 err_and_scale(own[n].numpy(), ref[n].numpy(), True))
             for n, p in tmod.named_parameters()}
    scale_all = max(sc for _, (_, sc) in pairs.values())
    floor = DT[dt][3] * scale_all
    bad = [(n, e, o, sc) for n, (e, (o, sc)) in pairs.items()
           if e > 2 * o + (DT[dt][2] * sc if sc > floor else 2 * floor)]
    assert not bad, bad


def _run_pair(jmod, tmod, x, seed, dt, jkw=None, tkw=None):
    """Seeded weights into both; the output and the gradients of <out, cot>
    in the parameters and the input, from the port and from JAX in the
    same dtype, and in bf16 from JAX in fp32 too. Returns {"port": (out,
    dx), "jax": (out, dx, grads), "ref32": (...) or None, "params"} and
    leaves the port's gradients on ``tmod``."""
    jkw, tkw = jkw or {}, tkw or {}
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    params = seeded_tree(shapes, seed, DT[dt][5])
    load_flax(tmod, params)
    out = jax.eval_shape(lambda p: jmod.apply(p, jnp.asarray(x), **jkw),
                         params)
    cot = np.random.default_rng(seed + 1).standard_normal(out.shape).astype(
        np.float32)

    def jrun(mod):
        def f(p, xx):
            return jnp.sum(mod.apply(p, xx, **jkw).astype(jnp.float32) * cot)
        jout = jax.jit(lambda p, xx: mod.apply(p, xx, **jkw))(
            params, jnp.asarray(x))
        jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(params,
                                                        jnp.asarray(x))
        return (np.asarray(jout, np.float32), np.asarray(jgx, np.float32),
                jgp)

    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tmod(xt, **tkw)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    tgx = np.zeros(x.shape, np.float32) if xt.grad is None else to_np(
        xt.grad)
    return {"port": (to_np(tout), tgx), "jax": jrun(jmod),
            "ref32": (jrun(jmod.clone(dtype=jnp.float32)) if dt == "bf16"
                      else (None, None, None)),
            "params": params}


def _check_all(r, tmod, dt):
    (tout, tgx), (jout, jgx, jgp) = r["port"], r["jax"]
    rout, rgx, rgp = r["ref32"]
    _check(tout, jout, dt, rout, "out")
    _check(tgx, jgx, dt, rgx, "dx")
    _grads(jgp, tmod, dt, rgp)


def _image(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("case,dt", [
    ("attn", "fp32"), ("attn", "bf16"), ("mobile_zeros_convtranspose", "fp32"),
    ("mobile_zeros_convtranspose", "bf16"),
    ("spectral_batch_replicate_freq", "fp32")])
def test_generator_forward_and_gradients_match_jax(case, dt):
    jdt, tdt = DT[dt][:2]
    jcls, tcls, kw = G_CASES[case]
    jmod = jcls(ngf=8, n_blocks=2, dtype=jdt, **kw)
    tmod = tcls(ngf=8, n_blocks=2, dtype=tdt, **kw)
    x = _image(0, (2, 32, 32, 3))
    r = _run_pair(jmod, tmod, x, 10, dt)
    _check_all(r, tmod, dt)
    params = r["params"]
    # the NCE taps: input, stem, down0, down1, res0, res1 (16 clamps)
    ids = [0, 1, 3, 4, 16]
    jf = jmod.apply(params, jnp.asarray(x), extract_layer_ids=ids)
    rf = jmod.clone(dtype=jnp.float32).apply(params, jnp.asarray(x),
                                             extract_layer_ids=ids)
    tf = tmod(torch.from_numpy(x), extract_layer_ids=ids)
    assert [f.shape for f in tf] == [f.shape for f in jf]
    for a, b, c in zip(tf, jf, rf):
        _check(to_np(a), np.asarray(b, np.float32), dt,
               np.asarray(c, np.float32), "taps")
    out, feats = tmod(torch.from_numpy(x), with_features=ids)
    np.testing.assert_array_equal(to_np(out), r["port"][0])
    assert tmod.encoder.layer_channels(ids) == [f.shape[-1] for f in jf]


def _d_cases():
    return {
        "basic_antialias": (
            jdisc.NLayerDiscriminator(ndf=8, n_layers=3),
            lambda dt: tdisc.NLayerDiscriminator(ndf=8, n_layers=3, dtype=dt),
            (2, 32, 32, 3)),
        "strided_spectral_batch_dropout_freq": (
            jdisc.NLayerDiscriminator(ndf=8, n_layers=2, norm="batch",
                                      antialias=False, use_dropout=True,
                                      use_spectral=True, freq_space=True),
            lambda dt: tdisc.NLayerDiscriminator(
                ndf=8, n_layers=2, norm="batch", antialias=False,
                use_dropout=True, use_spectral=True, freq_space=True,
                dtype=dt), (2, 32, 32, 3)),
        "pixel": (jdisc.PixelDiscriminator(ndf=8),
                  lambda dt: tdisc.PixelDiscriminator(ndf=8, dtype=dt),
                  (2, 8, 8, 3)),
    }


@pytest.mark.parametrize("case,dt", [
    ("basic_antialias", "fp32"), ("basic_antialias", "bf16"),
    ("strided_spectral_batch_dropout_freq", "fp32"), ("pixel", "fp32")])
def test_patch_discriminators_match_jax(case, dt):
    jdt, tdt = DT[dt][:2]
    jmod, tmake, shape = _d_cases()[case]
    jmod = jmod.clone(dtype=jdt)
    tmod = tmake(tdt)
    x = _image(1, shape)
    jkw, tkw = {}, {}
    if "dropout" in case:
        # the masks of the JAX Dropout layers, read from their outputs
        key = jax.random.PRNGKey(4)
        jkw = {"deterministic": False, "rngs": {"dropout": key}}
        shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.asarray(x)),
                                jax.random.PRNGKey(0))
        params = seeded_tree(shapes, 20, DT[dt][5])
        _, inter = jax.jit(lambda p, xx: jmod.apply(
            p, xx, capture_intermediates=lambda m, n:
            isinstance(m, fnn.Dropout), mutable=["intermediates"],
            **jkw))(params, jnp.asarray(x))
        outs = [inter["intermediates"][f"Dropout_{i}"]["__call__"][0]
                for i in range(len(inter["intermediates"]))]
        tkw = {"dropout": [nchw(o) != 0 for o in outs]}
    _check_all(_run_pair(jmod, tmod, x, 20, dt, jkw, tkw), tmod, dt)


@pytest.mark.parametrize("dt", sorted(DT))
def test_projected_discriminator_matches_jax(dt):
    """48 px input resized to 40 (antialiased bilinear); taps 10, 5, 3, 2
    px, so the CSM upsamples 2 -> 3 with half-pixel centres."""
    jdt, tdt = DT[dt][:2]
    jmod = jproj.ProjectedDiscriminator(interp=40, dtype=jdt)
    tmod = tproj.ProjectedDiscriminator(size=48, interp=40, dtype=tdt)
    x = _image(2, (2, 48, 48, 3))
    r = _run_pair(jmod, tmod, x, 30, dt)
    _check_all(r, tmod, dt)
    assert not r["jax"][1].any() and not r["port"][1].any()
    jgp = r["jax"][2]
    for p in tmod.frozen_parameters():
        assert p.grad is None or not p.grad.any()
    jz = flax_to_torch(jax.device_get(jgp))
    assert all(not jz[k].any() for k in jz
               if k.startswith(("feature_network.", "proj.")))


def _h2z_opts():
    with open(os.path.join(ROOT, "examples",
                           "example_gan_horse2zebra.json")) as f:
        cfg = json.load(f)
    return (JaxTrainOptions().parse_json(cfg, verbose=False),
            TrainOptions().parse_json(cfg, verbose=False))


def _h2z_trees():
    """horse2zebra's full-width G, F and Ds as flax trees of seeded values
    (shapes from ``jax.eval_shape``; nothing is computed)."""
    jopt, _ = _h2z_opts()
    key = jax.random.PRNGKey(0)
    ex = jnp.zeros((1, 256, 256, 3), jnp.float32)
    netG = jgan.define_G(jopt)
    trees = {"G_A": jax.eval_shape(netG.init, key, ex)}
    layers = [int(i) for i in jopt.alg_cut_nce_layers.split(",")]
    feats = jax.eval_shape(
        lambda p: netG.apply(p, ex, extract_layer_ids=layers), trees["G_A"])
    ids = [jnp.zeros((min(256, f.shape[1] * f.shape[2]),), jnp.int32)
           for f in feats]
    feats = [jnp.zeros(f.shape, f.dtype) for f in feats]
    trees["F"] = jax.eval_shape(jgan.define_F(jopt).init, key, feats, ids)
    for name, netD in jgan.define_D(jopt).items():
        trees[name] = jax.eval_shape(netD.init, key, ex)
    return {k: seeded_tree(v, i) for i, (k, v) in enumerate(trees.items())}


def _port_nets(opt):
    netG = tgan.define_G(opt)
    layers = [int(i) for i in opt.alg_cut_nce_layers.split(",")]
    nets = {"G_A": netG,
            "F": tgan.define_F(opt, netG.encoder.layer_channels(layers))}
    nets.update(tgan.define_D(opt))
    return nets


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converter_carries_every_horse2zebra_leaf_both_ways(tmp_path):
    """Every leaf of the full-width G (resnet_attn, ngf 64, 9 blocks), F
    (5 taps) and both Ds: flax -> port modules (strict, every shape) ->
    flax, bit for bit; then through checkpoint files both ways."""
    trees = _h2z_trees()
    _, opt = _h2z_opts()
    nets = _port_nets(opt)
    assert set(nets) == set(trees) == {"G_A", "F", "D_B_basic",
                                       "D_B_projected_d"}
    counts = {}
    for name, tree in trees.items():
        nets[name].load_state_dict(flax_to_torch(tree), strict=True)
        back = torch_to_flax(nets[name].state_dict())
        a, b = dict(_leaves(tree)), dict(_leaves(back))
        assert set(a) == set(b), name
        for path, v in a.items():
            assert b[path].dtype == v.dtype and b[path].shape == v.shape
            np.testing.assert_array_equal(b[path], v, err_msg=str(path))
        counts[name] = len(a)
        # the port writes, flax's msgpack reads into the JAX tree ...
        path = str(tmp_path / f"latest_net_{name}.pth")
        checkpoint_io.save(path, back)
        with open(path, "rb") as f:
            restored = serialization.from_bytes(
                jax.tree.map(np.zeros_like, tree), f.read())
        for p, v in _leaves(restored):
            np.testing.assert_array_equal(v, a[p])
        # ... and a file flax writes loads into the port
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(tree))
        nets[name].load_state_dict(flax_to_torch(checkpoint_io.load(path)))
        for k, t in nets[name].state_dict().items():
            np.testing.assert_array_equal(
                t.numpy(), flax_to_torch(tree)[k].numpy())
    # G: 27 convs (stem, 2 downs, 18 block convs, 2 x (2 ups + head));
    # F: 5 taps x 2 dense layers; basic D: 5 convs
    assert counts == {"G_A": 54, "F": 20, "D_B_basic": 10,
                      "D_B_projected_d": 141}


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
def test_init_scheme_statistics(init_type):
    """Kernels drawn with the scheme's law, biases zero, norm scales kept;
    the values themselves differ from JAX's (other generator)."""
    net = tres.ResnetGenerator(ngf=16, n_blocks=2, norm="batch")
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.fill_(0.5)
    apply_init_scheme(net, torch.Generator().manual_seed(0), init_type, 0.02)
    w = net.encoder.res0.conv1.weight.detach()          # 64 x 64 x 3 x 3
    fan_in = fan_out = 64 * 9
    want = {"normal": 0.02, "xavier": 0.02 * np.sqrt(2 / (fan_in + fan_out)),
            "kaiming": np.sqrt(2 / fan_in)}
    if init_type == "orthogonal":
        m = w.reshape(64, -1)
        np.testing.assert_allclose(to_np(m @ m.T), 0.02 ** 2 * np.eye(64),
                                   atol=1e-6)
    else:
        assert abs(float(w.std()) / want[init_type] - 1) < 0.05
        assert abs(float(w.mean())) < 0.1 * want[init_type]
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        elif p.ndim == 1:
            assert (p == 0.5).all(), name


def test_unported_networks_raise():
    jopt, opt = _h2z_opts()
    # every generator of the JAX factory is ported: a name it refuses is
    # refused here too
    opt.G_netG = jopt.G_netG = "no_such_generator"
    for factory in (tgan.define_G, jgan.define_G):
        with pytest.raises(NotImplementedError, match="no_such_generator"):
            factory(opt if factory is tgan.define_G else jopt)
    # the temporal D, refused until it was ported, builds as in the JAX
    # factory (parity: tests/test_torch_temporal_d.py); depth and sam
    # still raise
    from joligen_tpu_torch.models.modules.projected_d import \
        TemporalProjectedDiscriminator
    assert list(jgan.define_D(jopt, ["temporal"])) == ["D_B_temporal"]
    assert isinstance(tgan.define_D(opt, ["temporal"])["D_B_temporal"],
                      TemporalProjectedDiscriminator)
    assert set(tgan.UNPORTED_D) == {"depth", "sam"}
    for name in tgan.UNPORTED_D:
        with pytest.raises(NotImplementedError, match="item 13"):
            tgan.define_D(opt, [name])
    # the JAX factory builds the same names for the ported Ds
    jopt, _ = _h2z_opts()
    assert list(jgan.define_D(jopt)) == list(tgan.define_D(opt))
    assert isinstance(jgan.define_F(jopt), jcut.PatchSampleF)
