"""The JiT blocks of the port (``joligen_tpu_torch/models/modules/jit.py``)
against the JAX package's (``joligen_tpu/models/modules/jit.py``) on the CPU,
fp32, seeded inputs from numpy and seeded weights through the converter (the
zero-initialised ``adaLN`` filled from a seed, since zeros hide errors):

1. the 2-D sin-cos table and the axial RoPE tables (with and without
   prefix rows), equal to the JAX package's;
2. RMSNorm, fp32 and bf16 in, against the JAX module;
3. RoPE: ``rope_rotate`` against the JAX function, and against a twin that
   rotates half-split pairs (the lanes de-interleaved, rotate_half, the
   lanes interleaved again), with identity rows for the prefix;
4. ``JiTBlock`` at (B, N, d) = (2, 20, 64) with 4 heads of 16 and 4 prefix
   rows, forward and the gradients of x, c and every parameter, to 1e-4;
5. the variant table equal to the JAX one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, seeded_tree
from joligen_tpu.models.modules import jit as jjit
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import jit as tjit

TOL = 1e-4


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("gh,gw,hd,prefix", [(4, 4, 16, 0), (3, 5, 64, 6),
                                             (8, 8, 64, 32)])
def test_tables_match_jax(gh, gw, hd, prefix):
    np.testing.assert_array_equal(tjit.sincos_2d_pos_embed(4 * hd, gh, gw),
                                  jjit.sincos_2d_pos_embed(4 * hd, gh, gw))
    for got, want in zip(tjit.axial_rope_tables(gh, gw, hd, prefix),
                         jjit.axial_rope_tables(gh, gw, hd, prefix)):
        assert got.shape == (prefix + gh * gw, hd)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    want = jjit.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}},
                                jnp.asarray(x, getattr(jnp, dt)))
    norm = tjit.RMSNorm(48)
    norm.weight.data = torch.from_numpy(scale)
    got = norm(torch.from_numpy(x).to(getattr(torch, dt)))
    assert got.dtype == getattr(torch, dt)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL if dt == "float32" else 2e-2,
                               rtol=TOL if dt == "float32" else 2e-2)


def _rope_half_split(t, cos, sin):
    """The same rotation on half-split pairs: lanes (2i, 2i + 1) moved to
    (i, i + hd / 2), rotate_half there, moved back."""
    hd = t.shape[-1]
    perm = torch.cat([torch.arange(0, hd, 2), torch.arange(1, hd, 2)])
    inv = torch.argsort(perm)
    tp = t[..., perm]
    c, s = cos[:, perm][None, :, None], sin[:, perm][None, :, None]
    rot = torch.cat([-tp[..., hd // 2:], tp[..., :hd // 2]], dim=-1)
    return (tp * c + rot * s)[..., inv]


@pytest.mark.parametrize("prefix", [0, 3])
def test_rope_matches_jax_and_half_split_twin(prefix):
    rng = np.random.default_rng(1)
    cos, sin = tjit.axial_rope_tables(3, 4, 16, prefix)
    t = rng.standard_normal((2, prefix + 12, 3, 16)).astype(np.float32)
    got = tjit.rope_rotate(torch.from_numpy(t), torch.from_numpy(cos),
                           torch.from_numpy(sin))
    want = jjit.rope_rotate(jnp.asarray(t), jnp.asarray(cos),
                            jnp.asarray(sin))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    twin = _rope_half_split(torch.from_numpy(t), torch.from_numpy(cos),
                            torch.from_numpy(sin))
    np.testing.assert_allclose(_np(got), _np(twin), atol=1e-6)
    # the prefix rows pass unrotated
    np.testing.assert_array_equal(_np(got)[:, :prefix], t[:, :prefix])
    assert not np.allclose(_np(got)[:, prefix + 1:], t[:, prefix + 1:])


def test_jit_block_matches_jax_forward_and_gradients():
    b, n, d, heads, prefix = 2, 20, 64, 4, 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, d)).astype(np.float32)
    cos, sin = jjit.axial_rope_tables(4, 4, d // heads, prefix)
    jblock = jjit.JiTBlock(num_heads=heads)
    shapes = jax.eval_shape(lambda r: jblock.init(
        r, jnp.asarray(x), jnp.asarray(c), jnp.asarray(cos),
        jnp.asarray(sin)), jax.random.PRNGKey(0))
    # every leaf seeded, adaLN's zeros among them
    tree = seeded_tree(shapes, 3, 0.05, lecun=True)
    params = jax.tree.map(jnp.asarray, tree)
    cot = rng.standard_normal((b, n, d)).astype(np.float32)

    def f(p, xx, cc):
        return jblock.apply(p, xx, cc, jnp.asarray(cos), jnp.asarray(sin))
    want, vjp = jax.vjp(f, params, jnp.asarray(x), jnp.asarray(c))
    jp, jx, jc = vjp(jnp.asarray(cot))

    tblock = tjit.JiTBlock(d, heads)
    tblock.load_state_dict(flax_to_torch(tree), strict=True)
    assert float(tblock.adaLN.weight.detach().abs().max()) > 0
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    got = tblock(xt, ct, torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(_np(ct.grad), np.asarray(jc), atol=TOL,
                               rtol=TOL)
    jg = flax_to_torch(jax.device_get(jp))
    for name, p in tblock.named_parameters():
        scale = max(1.0, float(jg[name].abs().max()))
        assert float((p.grad - jg[name]).abs().max()) <= TOL * scale, name


def test_variant_table_matches_jax():
    assert tjit.JiT_VARIANT_CONFIGS == jjit.JiT_VARIANT_CONFIGS
