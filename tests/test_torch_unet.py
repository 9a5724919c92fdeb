"""The port's unet_mha modules against the flax ones, in fp32 on converted
weights: GroupNorm32 (with group clipping), ResBlock (plain, up, down),
AttentionBlock (both norm kinds), a small UNetMHA that reaches attention,
and a small PaletteDenoiser with mask conditioning. Zero-initialised output
layers are perturbed so that every branch reaches the output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.models.modules import unet_mha as junet
from joligen_tpu.models.modules.palette_diffusion import \
    PaletteDenoiser as JDenoiser
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import unet_mha as tunet
from joligen_tpu_torch.models.modules.palette_diffusion import PaletteDenoiser

TOL = dict(atol=1e-4, rtol=1e-4)
ZERO_INIT = ("out_conv", "proj_out", "out_proj")
SMALL = dict(out_channel=3, inner_channel=16, cond_embed_dim=32,
             res_blocks=(1, 1), attn_res=(2,), channel_mults=(1, 2),
             num_heads=1, num_head_channels=16)


def perturb_zero_init(variables, seed=0, std=0.05):
    """Give the flax zero-initialised leaves small seeded values."""
    rng = np.random.default_rng(seed)

    def walk(tree, zero):
        return {k: (walk(v, zero or k in ZERO_INIT) if isinstance(v, dict)
                    else (rng.normal(0, std, v.shape).astype(np.float32)
                          if zero else np.asarray(v)))
                for k, v in tree.items()}
    return walk(jax.device_get(variables), False)


def load(module, variables):
    module.load_state_dict(flax_to_torch(variables), strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("channels,groups", [(64, 32), (48, 32), (20, 32)])
def test_groupnorm32(channels, groups):
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((2, 6, 5, channels)) * 3 + 1).astype(np.float32)
    jm = junet.GroupNorm32(num_groups=groups)
    var = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    var["params"]["GroupNorm_0"]["scale"] = rng.standard_normal(
        channels).astype(np.float32)
    var["params"]["GroupNorm_0"]["bias"] = rng.standard_normal(
        channels).astype(np.float32)
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = load(tunet.GroupNorm32(groups, channels), var)
    # 48 and 20 channels clip 32 groups to 24 and 20
    assert tm.GroupNorm_0.num_groups == {64: 32, 48: 24, 20: 20}[channels]
    np.testing.assert_allclose(nhwc(tm(nchw(x))), want, **TOL)


@pytest.mark.parametrize("cin,cout,up,down", [(16, 32, False, False),
                                              (32, 32, True, False),
                                              (32, 32, False, True)])
def test_resblock(cin, cout, up, down):
    rng = np.random.default_rng(cin + up + 2 * down)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    emb = rng.standard_normal((2, 24)).astype(np.float32)
    jm = junet.ResBlock(out_channel=cout, up=up, down=down)
    var = perturb_zero_init(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                    jnp.asarray(emb)))
    want = np.asarray(jm.apply(var, jnp.asarray(x), jnp.asarray(emb)))
    tm = load(tunet.ResBlock(cin, cout, 24, up=up, down=down), var)
    got = nhwc(tm(nchw(x), torch.from_numpy(emb)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("up", [True, False])
def test_conv_resample(up):
    rng = np.random.default_rng(13 + up)
    x = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
    jm = (junet.Upsample if up else junet.Downsample)(out_channel=24)
    var = jax.device_get(jm.init(jax.random.PRNGKey(6), jnp.asarray(x)))
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = load((tunet.Upsample if up else tunet.Downsample)(16, 24), var)
    got = nhwc(tm(nchw(x)))
    assert got.shape == ((2, 12, 12, 24) if up else (2, 3, 3, 24))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("norm_kind", ["group", "instance"])
def test_attention_block(norm_kind):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 6, 64)).astype(np.float32)
    jm = junet.AttentionBlock(num_head_channels=16, norm_kind=norm_kind)
    var = perturb_zero_init(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = load(tunet.AttentionBlock(64, num_head_channels=16,
                                   norm_kind=norm_kind), var)
    assert tm.heads == 4
    np.testing.assert_allclose(nhwc(tm(nchw(x))), want, **TOL)


def test_unet_mha_small():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    emb = rng.standard_normal((2, 32)).astype(np.float32)
    jm = junet.UNetMHA(in_channel=6, **SMALL)
    var = perturb_zero_init(jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                    jnp.asarray(emb)))
    assert "AttentionBlock_2" in var["params"]   # enc, mid, dec attention
    want = np.asarray(jm.apply(var, jnp.asarray(x), jnp.asarray(emb)))
    tm = load(tunet.UNetMHA(in_channel=6, **SMALL), var)
    got = tm(torch.from_numpy(x), torch.from_numpy(emb)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("conditioning", ["mask", "", "class",
                                          "mask_and_class"])
def test_palette_denoiser_conditioning(conditioning):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    gam = rng.uniform(0.1, 0.9, (2,)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16, 16, 1)) > 0.5).astype(np.int32)
    cls = np.array([1, 0], np.int32)
    extra = 32 if "mask" in conditioning else 0
    jm = JDenoiser(inner=junet.UNetMHA(in_channel=6, **SMALL),
                   cond_embed_dim=32, conditioning=conditioning)
    jargs = (jnp.asarray(x), jnp.asarray(gam))
    jkw = dict(mask=jnp.asarray(mask), cls=jnp.asarray(cls))
    var = perturb_zero_init(jm.init(jax.random.PRNGKey(4), *jargs, **jkw))
    tm = load(PaletteDenoiser(tunet.UNetMHA(in_channel=6 + extra, **SMALL),
                              cond_embed_dim=32, conditioning=conditioning),
              var)
    targs = (torch.from_numpy(x), torch.from_numpy(gam))
    tkw = dict(mask=torch.from_numpy(mask), cls=torch.from_numpy(cls))
    # conditioned, and the guidance branch's unconditioned call
    for kw in ({}, dict(zero_gamma=True, cls=None, mask=None)):
        want = np.asarray(jm.apply(var, *jargs, **{**jkw, **kw}))
        got = tm(*targs, **{**tkw, **kw}).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_unported_variants_raise():
    """UViT and ``freq_space`` are ported: each builds the JAX tree (their
    values are held in ``tests/test_torch_gan_zoo.py``); the ImageBind ref
    encoder still raises."""
    for kw in (dict(transformer_blocks=2), dict(freq_space=True)):
        jnet = junet.UNetMHA(in_channel=6, **SMALL, **kw)
        shapes = jax.eval_shape(lambda r: jnet.init(
            r, jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 32))),
            jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in flax_to_torch(jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items()}
        tnet = tunet.UNetMHA(in_channel=6, **SMALL, **kw)
        assert {k: tuple(v.shape) for k, v in
                tnet.state_dict().items()} == want
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PaletteDenoiser(torch.nn.Identity(), 32, conditioning="ref",
                        ref_embed_net="imagebind")
