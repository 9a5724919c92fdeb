"""The rest of the GAN generator zoo in the port against the JAX package,
on the CPU, fp32, seeded numpy inputs, seeded non-zero weights through the
converter (the zero-init layers, UViT's ``to_scale_shift``,
``proj_kernel`` and ``proj_bias``, ``resnet_attn``'s ``film``, filled from
the seed):

1. ``UNetMHA`` as a GAN generator (tanh head, no embedding), with
   ``freq_space`` (Haar trunk) and as UViT (2 transformer blocks over a
   6 × 6 bottleneck of 16 channels: C ≠ H·W, so a transpose in place of the
   CHW reshape shows), forward and every gradient to 1e-4 of the largest
   gradient; UViT's ``TransformerBlock`` on tokens one of which is near
   constant (its variance under the layer norm's 1e-5 clamp), to 1e-4;
   the encoder taps (``extract_layer_ids``) to 1e-5;
2. ``ResnetGeneratorAttnDiff`` (palette's ``resnet_attn``), forward and
   every gradient to 1e-4 of each leaf's largest, and with ``freq_space``;
3. ``hdit`` as a GAN generator (constant conditioning, no t layers),
   forward and taps to 1e-4.

HAT, ITTR and the factory's trees are in ``tests/test_torch_gan_zoo_trees.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (few_torch_threads, grads_close, load_flax,
                               seeded_tree, to_np)
from joligen_tpu.models.modules import hdit as jhdit
from joligen_tpu.models.modules import resnet_generator as jres
from joligen_tpu.models.modules import unet_mha as junet
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import hdit as thdit
from joligen_tpu_torch.models.modules import resnet_generator as tres
from joligen_tpu_torch.models.modules import unet_mha as tunet

TOL = 1e-4


def _tree(jnet, *args, seed=1, **kw):
    """Seeded flax tree of ``jnet`` for inputs ``args`` (kernels at flax's
    law; HDiT's attention scales kept positive)."""
    shapes = jax.eval_shape(lambda r: jnet.init(r, *args, **kw),
                            jax.random.PRNGKey(0))
    tree = seeded_tree(shapes, seed, 0.1, lecun=True)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.abs(v) + 1.0 if "attn_scale" in str(p) else v, tree)


def _jit_taps(jnet, ids):
    """The JAX net's taps ``ids`` as one jitted call."""
    return jax.jit(lambda p, x: jnet.apply(p, x, extract_layer_ids=ids))


def _forward_and_grads(jnet, tnet, params, x, *extra, tol_leaf=False):
    """Forward to TOL of the largest output and every parameter's
    gradient of sum(out · w) (w seeded) to TOL of the largest gradient
    (``tol_leaf``: of each leaf's largest); the JAX output and gradient
    from one compiled function."""
    load_flax(tnet, params)
    jx = [jnp.asarray(a) for a in (x, *extra)]
    shape = jax.eval_shape(lambda p: jnet.apply(p, *jx), params).shape
    w = np.random.default_rng(9).standard_normal(shape).astype(np.float32)

    def loss(p):
        out = jnet.apply(p, *jx)
        return jnp.sum(out * w), out
    (_, want), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = np.asarray(want)
    out = tnet(*[torch.from_numpy(a) for a in (x, *extra)])
    assert float(np.abs(to_np(out) - want).max()) <= TOL * max(
        1.0, float(np.abs(want).max()))
    (out * torch.from_numpy(w)).sum().backward()
    if tol_leaf:
        grads_close(jgrad, tnet, TOL, 1e-4)
        return
    ref = flax_to_torch(jax.device_get(jgrad))
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for name, p in tnet.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else to_np(p.grad)
        assert float(np.abs(g - ref[name].numpy()).max()) <= TOL * scale, \
            name


UNET = dict(in_channel=3, out_channel=3, inner_channel=8, cond_embed_dim=32,
            res_blocks=(1, 1), attn_res=(2,), channel_mults=(1, 2),
            num_head_channels=8, group_size=4, tanh=True)


@pytest.mark.parametrize("kind", ["gan", "freq_space", "uvit",
                                  "uvit_freq_space"])
def test_unet_mha_generator_matches_jax(kind):
    kw = dict(UNET, freq_space="freq" in kind,
              transformer_blocks=2 if "uvit" in kind else 0)
    # UViT's bottleneck: 6 x 6 tokens of 16 channels (12 px; 24 px over
    # the Haar bands)
    size = {"gan": 16, "freq_space": 32, "uvit": 12,
            "uvit_freq_space": 24}[kind]
    x = np.random.default_rng(0).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    jnet, tnet = junet.UNetMHA(**kw), tunet.UNetMHA(**kw)
    params = _tree(jnet, jnp.asarray(x))
    _forward_and_grads(jnet, tnet, params, x)
    if "uvit" in kind:
        assert tnet.mid_t0.ff.proj_in.weight.shape[1] == 16
    ids = [0, 2, 3]
    feats = _jit_taps(jnet, ids)(params, jnp.asarray(x))
    got = tnet(torch.from_numpy(x), extract_layer_ids=ids)
    assert [tuple(f.shape[1:]) for f in got] == [
        tuple(f.shape[1:]) for f in feats]
    assert tnet.layer_channels(ids) == [f.shape[-1] for f in feats]
    for a, b in zip(got, feats):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5)
    with pytest.raises(IndexError, match="G_nblocks"):
        tnet.layer_channels([9])


def test_uvit_block_layer_norm_clamp_matches_jax():
    """A TransformerBlock over tokens one of which is constant but for
    1e-4 noise (variance ~1e-8, under the 1e-5 clamp): to 1e-4."""
    rng = np.random.default_rng(3)
    b, n, c = 2, 10, 16
    z = rng.standard_normal((b, n, c)).astype(np.float32)
    z[:, 4] = 0.7 + 1e-4 * rng.standard_normal((b, c))
    emb = rng.standard_normal((b, 24)).astype(np.float32)
    jblk = junet.TransformerBlock(num_heads=1, num_head_channels=8)
    params = _tree(jblk, jnp.asarray(z), jnp.asarray(emb), seed=4)
    tblk = load_flax(tunet.TransformerBlock(c, 24, 1, 8), params)
    want = np.asarray(jblk.apply(params, jnp.asarray(z), jnp.asarray(emb)))
    got = to_np(tblk(torch.from_numpy(z), torch.from_numpy(emb)))
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())
    ln = to_np(tunet.uvit_layernorm(torch.from_numpy(z)))
    np.testing.assert_allclose(
        ln, np.asarray(junet._uvit_layernorm(jnp.asarray(z))), atol=TOL)
    assert np.abs(ln[:, 4]).max() < 0.1       # clamped, not blown up


@pytest.mark.parametrize("freq_space", [False, True])
def test_resnet_attn_diff_matches_jax(freq_space):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 16, 16, 7)).astype(np.float32)
    emb = rng.standard_normal((2, 12)).astype(np.float32)
    kw = dict(out_channels=3, nb_mask_attn=4, nb_mask_input=1, ngf=8,
              n_blocks=2, cond_embed_dim=12, freq_space=freq_space)
    jnet = jres.ResnetGeneratorAttnDiff(**kw)
    tnet = tres.ResnetGeneratorAttnDiff(7, **kw)
    params = _tree(jnet, jnp.asarray(x), jnp.asarray(emb), seed=2)
    if freq_space:
        load_flax(tnet, params)
        want = np.asarray(jnet.apply(params, jnp.asarray(x),
                                     jnp.asarray(emb)))
        got = to_np(tnet(torch.from_numpy(x), torch.from_numpy(emb)))
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    else:
        _forward_and_grads(jnet, tnet, params, x, emb, tol_leaf=True)


def test_hdit_gan_matches_jax():
    x = np.random.default_rng(11).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    kw = dict(patch_size=4, widths=(32, 64, 64), depths=(2, 1, 2),
              d_head=16, window=4, out_channels=3)
    jnet = jhdit.HDiT(last_zero_init=False, **kw)
    tnet = thdit.HDiT(3, gan=True, **kw)
    params = _tree(jnet, jnp.asarray(x), seed=12)
    assert "t_0" not in params["params"]
    load_flax(tnet, params)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    got = to_np(tnet(torch.from_numpy(x)))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    for ids in ([1], [0, 4, 8]):
        feats = _jit_taps(jnet, ids)(params, jnp.asarray(x))
        got_f = tnet(torch.from_numpy(x), extract_layer_ids=ids)
        assert tnet.layer_channels(ids) == [f.shape[-1] for f in feats]
        for a, b in zip(got_f, feats):
            np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-4)


