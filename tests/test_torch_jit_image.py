"""The image JiT of the port (``joligen_tpu_torch/models/modules/jit.py``
``JiT``, ``G_netG: vit``) and palette with a raw-t trunk against the JAX
package on the CPU, fp32, seeded numpy inputs, seeded weights through the
converter (every zero-initialised leaf, ``adaLN``, ``final_adaLN``,
``final_proj`` and ``ms_1``, filled from a seed first: zeros hide errors):

1. a small ``JiT`` (patch 4, hidden 64, 2 heads of 32, depth 3, 16 px, 7
   input channels, 3 classes): forward and the gradients of the input and
   every parameter, to 1e-4, with the prefix (2 registers and 4 in-context
   tokens from block 1) and mask-size conditioning, without a prefix
   (``in_context_start`` at the depth), with the prefix at block 0 and
   ``y=None`` (the null class); under ``tpu_remat`` the same values;
2. the converter on ``blocks_pre``/``blocks_post``, ``in_context_posemb``,
   ``register_tokens`` and ``y_embed``, both ways bit for bit, and an optax
   adam state the same way;
3. ``from_opt`` against the JAX ``from_opt`` over the variant table and
   the ``G_vit_*`` overrides (``G_vit_disable_bottleneck`` among them); the
   b2b_image_256 denoiser (JiT-B/16 at 256 px, 6 input channels) at full
   width on the meta device: every name and shape against
   ``jax.eval_shape`` of the JAX module, 130,454,784 parameters, 4 + 8
   blocks; JiT-H's head dim 80 on a JiT cut to depth 2 and 2 heads,
   forward and gradients against JAX; head dims outside the kernels'
   list refused by their check;
4. palette's raw-t denoiser (``PaletteDenoiser`` with the JiT trunk, mask
   and class conditioning, one clipped mask channel): the loss of a
   training forward and every gradient against the JAX composition with
   the same host draws, to 1e-4; the DDIM sampler (10 steps) and 3 DDPM
   steps on the same weights against the JAX samplers, to 1e-3.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, seeded_tree
from joligen_tpu.models import diffusion_networks as jdn
from joligen_tpu.models.modules import jit as jj
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.ops.schedules import NoiseSchedule as JaxNoiseSchedule
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import diffusion_networks as tdn
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_state_to_torch,
                                              torch_adam_state_to_optax,
                                              torch_to_flax)
from joligen_tpu_torch.models.modules import jit as tj
from joligen_tpu_torch.models.modules import palette_diffusion as tpd
from joligen_tpu_torch.ops import flash_attention as fa
from joligen_tpu_torch.ops.schedules import NoiseSchedule
from joligen_tpu_torch.options import TrainOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "example_ddpm_noglasses2glasses.json")
TOL = 1e-4
B, SIZE, CIN = 2, 16, 7
SMALL = dict(patch_size=4, hidden_size=64, depth=3, num_heads=2,
             bottleneck_dim=16, num_classes=3, out_channels=3)
CASES = {
    "prefix_mask_size": dict(in_context_start=1, num_register_tokens=2,
                             in_context_len=4, mask_size_conditioning=True),
    "no_prefix": dict(in_context_start=3, num_register_tokens=2,
                      in_context_len=4),
    "prefix_at_0_null_class": dict(in_context_start=0, num_register_tokens=2,
                                   in_context_len=4),
}
# b2b_image_256: JiT-B/16 over [y_cond, z] at 256 px
EXPECTED_PARAMS = 130_454_784


def _np(t):
    return t.detach().float().numpy()


def _grads_close(jgrads, module, tol=TOL):
    want = flax_to_torch(jax.device_get(jgrads))
    assert set(want) == {n for n, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        scale = max(1.0, float(want[name].abs().max()))
        err = float((p.grad - want[name]).abs().max())
        assert err <= tol * scale, (name, err, scale)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, SIZE, SIZE, CIN)).astype(np.float32)
    t = rng.uniform(0, 1, (B,)).astype(np.float32)
    ms = rng.uniform(0, 1, (B, 6)).astype(np.float32)
    return x, t, np.array([1, 3], np.int32), ms


@pytest.fixture(scope="module")
def trees():
    """{case: (JAX JiT, seeded tree)}: shapes from ``jax.eval_shape``."""
    x, t, y, ms = _inputs(0)
    out = {}
    for i, (case, kw) in enumerate(CASES.items()):
        jnet = jj.JiT(**SMALL, **kw)
        shapes = jax.eval_shape(lambda r: jnet.init(
            r, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y),
            mask_size=jnp.asarray(ms)), jax.random.PRNGKey(0))
        out[case] = (jnet, seeded_tree(shapes, 10 + i, 0.05, lecun=True))
    return out


@pytest.mark.parametrize("case,remat", [
    ("prefix_mask_size", False), ("no_prefix", False),
    ("prefix_at_0_null_class", False), ("prefix_mask_size", True)])
def test_jit_matches_jax_forward_and_gradients(trees, case, remat):
    jnet, tree = trees[case]
    params = jax.tree.map(jnp.asarray, tree)
    x, t, y, ms = _inputs(1)
    y_in = None if case == "prefix_at_0_null_class" else y
    cot = np.random.default_rng(2).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)

    def f(p, xx):
        return jnet.apply(p, xx, jnp.asarray(t),
                          y=None if y_in is None else jnp.asarray(y_in),
                          mask_size=jnp.asarray(ms))
    want, vjp = jax.vjp(f, params, jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))

    tnet = tj.JiT(CIN, remat=remat, **SMALL, **CASES[case])
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    zero_init = [tnet.final_adaLN, tnet.final_proj]
    zero_init += [blk.adaLN for blk in (getattr(tnet, "blocks_pre", [])
                                        or tnet.blocks_post)[:1]]
    if tnet.mask_size_conditioning:
        zero_init.append(tnet.ms_1)
    for leaf in zero_init:
        assert float(leaf.weight.detach().abs().max()) > 0
    assert hasattr(tnet, "blocks_pre") == (tnet.start > 0)
    assert hasattr(tnet, "register_tokens") == tnet.insert_prefix
    xt = torch.from_numpy(x).requires_grad_()
    got = tnet(xt, torch.from_numpy(t),
               y=None if y_in is None else torch.from_numpy(y_in).long(),
               mask_size=torch.from_numpy(ms))
    assert got.shape == (B, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), atol=TOL,
                               rtol=TOL)
    _grads_close(jp, tnet)


def test_jit_tree_and_adam_state_round_trip_exactly(trees):
    _, tree = trees["prefix_mask_size"]
    sd = flax_to_torch(tree)
    pre = tree["params"]["blocks_pre"]["block"]["qkv"]["kernel"]
    post = tree["params"]["blocks_post"]["block"]["mlp"]["w2"]["kernel"]
    assert pre.shape[0] == 1 and post.shape[0] == 2
    np.testing.assert_array_equal(sd["blocks_post.1.mlp.w2.weight"].numpy(),
                                  post[1].T)
    for raw in ("y_embed", "register_tokens", "in_context_posemb"):
        np.testing.assert_array_equal(sd[raw].numpy(), tree["params"][raw])
    back = torch_to_flax(sd)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf)
    tx = optax.adamw(1e-4)
    state = tx.init(jax.tree.map(jnp.asarray, tree))
    rng = np.random.default_rng(6)
    state = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)) if a.ndim else a, state)
    mine = optax_state_to_torch(jax.device_get(state))
    assert set(mine["mu"]) == set(sd)
    again = torch_adam_state_to_optax(mine, jax.device_get(state))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _opts(argv):
    args = ["--config_json", EXAMPLE, *argv]
    return (TrainOptions().parse_cli(args), JaxTrainOptions().parse_cli(args))


@pytest.mark.parametrize("argv", [
    [], ["--G_vit_variant", "JiT-L/16"],
    ["--G_vit_variant", "JiT-H/32", "--G_vit_disable_bottleneck"],
    ["--G_vit_variant", "JiT-B/8", "--G_vit_depth", "5",
     "--G_vit_in_context_start", "7", "--G_vit_num_register_tokens", "4",
     "--G_vit_num_classes", "3", "--alg_b2b_mask_size_conditioning",
     "--tpu_remat"]])
def test_from_opt_matches_jax(argv):
    topt, jopt = _opts(["--model_type", "b2b", "--G_netG", "vit", *argv])
    jnet = jj.JiT.from_opt(jopt)
    with torch.device("meta"):
        tnet = tj.JiT.from_opt(topt, 6)
    assert (tnet.patch_size, tnet.hidden_size, tnet.depth, tnet.num_heads,
            tnet.num_classes, tnet.num_register_tokens, tnet.in_context_len,
            tnet.out_channels, tnet.mask_size_conditioning, tnet.remat) == (
        jnet.patch_size, jnet.hidden_size, jnet.depth, jnet.num_heads,
        jnet.num_classes, jnet.num_register_tokens, jnet.in_context_len,
        jnet.out_channels, jnet.mask_size_conditioning, jnet.remat)
    assert tnet.patch_bneck.weight.shape[0] == jnet.bottleneck_dim
    assert tnet.start == max(0, min(jnet.in_context_start, jnet.depth))


def _flax_shapes(state_dict):
    """The flax path and shape of every leaf of a (meta) state dict, the
    blocks of a stack stacked again."""
    out = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        name, shape = parts[-1], tuple(t.shape)
        if name == "weight":
            name, shape = (("scale", shape) if len(shape) == 1
                           else ("kernel", shape[::-1]))
        if parts[0] in ("blocks_pre", "blocks_post"):
            path = ".".join([parts[0], "block"] + parts[2:-1] + [name])
            depth = out.get(path, (0,))[0]
            out[path] = (max(depth, int(parts[1]) + 1),) + shape
        else:
            out[".".join(parts[:-1] + [name])] = shape
    return out


def test_b2b_image_256_tree_matches_jax_names_and_shapes():
    topt, jopt = _opts(["--model_type", "b2b", "--G_netG", "vit",
                        "--data_load_size", "256", "--data_crop_size",
                        "256"])
    jnet = jj.JiT.from_opt(jopt)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, 256, 256, 6)), jnp.zeros((1,)),
        jnp.zeros((1,), jnp.int32)), jax.random.PRNGKey(0))["params"]
    want = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        tnet = tj.JiT.from_opt(topt, 6)
    assert _flax_shapes(tnet.state_dict()) == want
    n = sum(p.numel() for p in tnet.parameters())
    assert n == sum(int(np.prod(s)) for s in want.values()) == \
        EXPECTED_PARAMS
    assert len(tnet.blocks_pre) == 4 and len(tnet.blocks_post) == 8
    assert tnet.hidden_size // tnet.num_heads == 64


def test_jit_h_image_256_tree_matches_jax_count():
    """The image JiT-H/16 under b2b at 256 px: 951,432,256 parameters,
    the JAX package's count, 32 blocks of 16 heads of 80."""
    topt, jopt = _opts(["--model_type", "b2b", "--G_netG", "vit",
                        "--data_load_size", "256", "--data_crop_size",
                        "256", "--G_vit_variant", "JiT-H/16"])
    jnet = jj.JiT.from_opt(jopt)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, 256, 256, 6)), jnp.zeros((1,)),
        jnp.zeros((1,), jnp.int32)), jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        tnet = tj.JiT.from_opt(topt, 6)
    n = sum(p.numel() for p in tnet.parameters())
    assert n == sum(int(np.prod(leaf.shape))
                    for leaf in jax.tree.leaves(shapes)) == 951_432_256
    assert tnet.depth == 32 and tnet.hidden_size // tnet.num_heads == 80


def test_jit_h_head_dim_80_blocks_match_jax():
    """JiT-H/16's head dim (1280 over 16 heads) on a JiT cut to depth 2 and
    2 heads of 80: forward and every gradient against JAX; its full-width
    tree on the meta device gives the same head dim."""
    topt, _ = _opts(["--model_type", "b2b", "--G_netG", "vit",
                     "--G_vit_variant", "JiT-H/16"])
    with torch.device("meta"):
        full = tj.JiT.from_opt(topt, 6)
    assert full.hidden_size // full.num_heads == 80
    assert 80 in fa.SUPPORTED_HEAD_DIMS
    kw = dict(SMALL, hidden_size=160, num_heads=2, depth=2,
              in_context_start=1, num_register_tokens=2, in_context_len=4)
    x, t, y, ms = _inputs(3)
    jnet = jj.JiT(**kw)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y)),
        jax.random.PRNGKey(0))
    tree = seeded_tree(shapes, 14, 0.05, lecun=True)
    cot = np.random.default_rng(4).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)
    @jax.jit
    def fwd_bwd(p, xx):
        out, vjp = jax.vjp(lambda a, b: jnet.apply(
            a, b, jnp.asarray(t), y=jnp.asarray(y)), p, xx)
        return out, vjp(jnp.asarray(cot))
    want, (jp, jx) = fwd_bwd(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(x))
    tnet = tj.JiT(CIN, **kw)
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    assert tnet.hidden_size // tnet.num_heads == 80
    xt = torch.from_numpy(x).requires_grad_()
    got = tnet(xt, torch.from_numpy(t), y=torch.from_numpy(y).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jx), atol=TOL,
                               rtol=TOL)
    _grads_close(jp, tnet)


@pytest.mark.parametrize("hd", [48, 112, 144, 176, 12])
def test_head_dims_outside_the_list_are_refused_by_the_kernels(hd):
    """What the kernels take is checked before a launch (on a CUDA tensor);
    here on a CPU tensor of the same shape."""
    assert hd not in fa.SUPPORTED_HEAD_DIMS
    q = torch.zeros(1, 4, 16, hd)
    with pytest.raises(ValueError, match="still refused: 48, 112, 144"):
        fa._check_kernel_inputs(q, (("q", q),))


# -------------------------------------------------------------------------
# palette with the JiT trunk (raw t)
# -------------------------------------------------------------------------
PAL_ARGS = ["--G_netG", "vit", "--G_vit_depth", "3", "--G_vit_hidden_size",
            "64", "--G_vit_num_heads", "2", "--G_vit_patch_size", "4",
            "--G_vit_bottleneck_dim", "16", "--G_vit_in_context_start", "1",
            "--G_vit_in_context_len", "4", "--G_vit_num_register_tokens",
            "2", "--G_vit_num_classes", "3", "--data_crop_size", str(SIZE),
            "--data_load_size", str(SIZE), "--alg_diffusion_cond_embed",
            "mask_and_class", "--f_s_semantic_nclasses", "3",
            "--G_diff_n_timestep_train", "200", "--G_diff_n_timestep_test",
            "50", "--tpu_bf16", "false"]


@pytest.fixture(scope="module")
def palette_pair():
    """The palette raw-t denoisers of both packages on one seeded tree."""
    topt, jopt = _opts(PAL_ARGS)
    jnet = jdn.define_G(jopt)
    x = jnp.zeros((1, SIZE, SIZE, 6))
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, x, jnp.zeros((1,)), cls=jnp.zeros((1,), jnp.int32),
        mask=jnp.zeros((1, SIZE, SIZE, 1), jnp.int32)), jax.random.PRNGKey(0))
    tree = seeded_tree(shapes, 21, 0.05, lecun=True)
    assert set(tree["params"]) == {"inner"}     # no layer of its own
    tnet = tdn.define_G(topt)
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    assert tnet.raw_t and tnet.inner.patch_bneck.weight.shape[1] == 16 * 7
    return topt, jopt, jnet, tree, tnet


def _palette_batch(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((B, SIZE, SIZE, 1), np.int32)
    mask[0, 2:10, 3:13] = 1
    mask[1, 6:15, 1:8] = 2          # a label of 2, clipped to 1
    cond = np.where(mask > 0, -1.0, gt).astype(np.float32)
    return gt, cond, mask, np.array([2, 0], np.int32)


def test_palette_raw_t_loss_and_every_gradient_match_jax(palette_pair):
    topt, jopt, jnet, tree, tnet = palette_pair
    gt, cond, mask, cls = _palette_batch(3)
    rng = np.random.default_rng(4)
    gammas = rng.uniform(0.1, 0.9, (B,)).astype(np.float32)
    noise = rng.standard_normal(gt.shape).astype(np.float32)

    # the noised input on the host (q_sample inside the mask)
    mclip = np.clip(mask, 0, 1).astype(np.float32)
    g4 = gammas[:, None, None, None]
    y_noisy = np.sqrt(g4) * gt + np.sqrt(1 - g4) * noise
    x_in = np.concatenate([cond, y_noisy * mclip + (1 - mclip) * gt], -1)

    def jloss(p):
        out = jnet.apply(p, jnp.asarray(x_in), jnp.asarray(gammas),
                         cls=jnp.asarray(cls), mask=jnp.asarray(mask))
        return ((out - noise) ** 2 * mclip).mean()
    want, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree))
    tnet.zero_grad()
    out = tnet(torch.from_numpy(x_in), torch.from_numpy(gammas),
               cls=torch.from_numpy(cls).long(), mask=torch.from_numpy(mask))
    got = ((out - torch.from_numpy(noise)) ** 2
           * torch.from_numpy(mclip)).mean()
    got.backward()
    assert abs(got.item() - float(want)) <= TOL * max(1.0, abs(float(want)))
    _grads_close(jgrads, tnet)
    tnet.zero_grad()


def test_palette_raw_t_samplers_match_jax(palette_pair):
    topt, jopt, jnet, tree, tnet = palette_pair
    gt, cond, mask, cls = _palette_batch(5)
    y_t = np.random.default_rng(6).standard_normal(gt.shape).astype(
        np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    jsched = JaxNoiseSchedule.for_phase(jopt, "test")
    tsched = NoiseSchedule.for_phase(topt, "test")

    def japply(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return jnet.apply(p, x, g, cls=cls, mask=mask, ref=ref,
                          zero_gamma=zero_gamma)

    def tapply(x, g, cls=None, mask=None, zero_gamma=False):
        return tnet(x, g, cls=cls, mask=mask, zero_gamma=zero_gamma)
    common = dict(y_cond=jnp.asarray(cond), y_t=jnp.asarray(y_t),
                  y_0=jnp.asarray(gt), mask=jnp.asarray(mask),
                  cls=jnp.asarray(cls))
    tcommon = dict(y_cond=torch.from_numpy(cond), y_t=torch.from_numpy(y_t),
                   y_0=torch.from_numpy(gt), mask=torch.from_numpy(mask),
                   cls=torch.from_numpy(cls).long())
    want = jpd.ddim_sample(japply, params, jax.random.PRNGKey(0), jsched,
                           num_steps=10, **common)
    with torch.no_grad():
        got = tpd.ddim_sample(tapply, None, tsched, num_steps=10, **tcommon)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-3,
                               rtol=1e-3)
    # three DDPM steps from t = 2 on the same noises
    noise_seq = np.random.default_rng(7).standard_normal(
        (3,) + gt.shape).astype(np.float32)
    short = JaxNoiseSchedule.create("linear", 3, 1e-4, 0.09)
    short_t = NoiseSchedule.create("linear", 3, 1e-4, 0.09)
    want = jpd.ddpm_sample(japply, params, jax.random.PRNGKey(0), short,
                           noise_seq=noise_seq, **common)
    with torch.no_grad():
        got = tpd.ddpm_sample(tapply, None, short_t, noise_seq=noise_seq,
                              **tcommon)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-3,
                               rtol=1e-3)
    outside = np.broadcast_to(mask == 0, gt.shape)
    np.testing.assert_allclose(_np(got)[outside], gt[outside], atol=1e-6)
