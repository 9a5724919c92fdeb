"""HAT, ITTR and the GAN factory's new trees in the port against the JAX
package, on the CPU, fp32, seeded numpy inputs and seeded weights through
the converter:

1. ``calculate_rpi_sa``, ``calculate_rpi_oca``, ``calculate_mask`` and the
   window partition exactly; ``HAT`` (2 groups of 2 blocks, window 8) at
   32 px (shifted windows) and 8 px (the window clamped to the image, no
   shift), forward to 1e-4, deterministic, and its group taps;
2. ``DPSA`` with no ties in its top-k (a seeded continuous input), at k <
   side (both prunings) and k ≥ side (none); ``ITTRGenerator`` forward and
   its ``extract_layer_ids`` to 1e-4;
3. ``define_G`` for every new name at horse2zebra's options cut small (HAT
   shrunk in both packages): the port's state-dict keys and shapes
   against the JAX init's tree, the converter both ways bit for bit
   (UViT's raw (out, in) kernels, HAT's ``rpb``, ITTR's ``g``/``b`` and
   transposed convs), the raw leaves the port's init draws, the NCE taps'
   channels; and each at its factory width on the meta device against
   ``jax.eval_shape`` (names, shapes, parameter counts).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import ROOT, few_torch_threads, load_flax, to_np
from joligen_tpu.models import gan_networks as jgan
from joligen_tpu.models.modules import hat as jhat
from joligen_tpu.models.modules import ittr as jittr
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import gan_networks as tgan
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import hat as that
from joligen_tpu_torch.models.modules import ittr as tittr
from joligen_tpu_torch.options import TrainOptions
from test_torch_gan_zoo import TOL, _jit_taps, _tree


@pytest.mark.parametrize("wsz", [4, 8, 16])
def test_hat_index_and_mask_helpers_exact(wsz):
    np.testing.assert_array_equal(that.calculate_rpi_sa(wsz),
                                  jhat.calculate_rpi_sa(wsz))
    owsz = int(wsz * 0.5) + wsz
    np.testing.assert_array_equal(that.calculate_rpi_oca(wsz, owsz),
                                  jhat.calculate_rpi_oca(wsz, owsz))
    for h, w in ((4 * wsz, 4 * wsz), (2 * wsz, 3 * wsz)):
        np.testing.assert_array_equal(
            that.calculate_mask(h, w, wsz, wsz // 2),
            jhat.calculate_mask(h, w, wsz, wsz // 2))
    x = np.arange(2 * 2 * wsz * 2 * wsz * 3, dtype=np.float32).reshape(
        2, 2 * wsz, 2 * wsz, 3)
    win = that.window_partition(torch.from_numpy(x), wsz)
    jwin = np.asarray(jhat.window_partition(jnp.asarray(x), wsz))
    np.testing.assert_array_equal(to_np(win), jwin.reshape(win.shape))
    np.testing.assert_array_equal(
        to_np(that.window_reverse(win, wsz, 2 * wsz, 2 * wsz)), x)


HAT_SMALL = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 2),
                 window_size=8)


@pytest.mark.parametrize("size", [32, 8])
def test_hat_matches_jax(size):
    """32 px: 16 windows a group, odd blocks shifted by 4 with the seam
    mask; 8 px: the window clamped to the image, no shift."""
    x = np.random.default_rng(5).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    jnet = jhat.HAT(out_channels=3, **HAT_SMALL)
    tnet = that.HAT(3, 3, img_size=size, **HAT_SMALL)
    params = _tree(jnet, jnp.asarray(x), seed=6)
    load_flax(tnet, params)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    got = to_np(tnet(torch.from_numpy(x)))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_array_equal(to_np(tnet(torch.from_numpy(x))), got)
    assert tnet._windows(size, size, "cpu")[1] == (4 if size == 32 else 0)
    feats = _jit_taps(jnet, [0, 9])(params, jnp.asarray(x))
    got_f = tnet(torch.from_numpy(x), extract_layer_ids=[0, 9])
    assert len(got_f) == len(feats) == 2 == len(tnet.layer_channels([0, 9]))
    for a, b in zip(got_f, feats):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("top_k", [4, 8])
def test_dpsa_matches_jax(top_k):
    """dim_head = side = 8: top-k 4 prunes channels and rows, 8 prunes
    nothing; the summed-key scores of a continuous seeded input have no
    ties."""
    x = np.random.default_rng(7).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    jm = jittr.DPSA(top_k, top_k, dim_head=8, heads=2)
    params = _tree(jm, jnp.asarray(x), seed=8)
    tm = load_flax(tittr.DPSA(16, top_k, top_k, dim_head=8, heads=2), params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = to_np(tm(torch.from_numpy(x).permute(0, 3, 1, 2))).transpose(
        0, 2, 3, 1)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_ittr_generator_matches_jax():
    x = np.random.default_rng(9).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    kw = dict(out_channels=3, ngf=4, n_blocks=2, img_size=32,
              height_top_k=4, width_top_k=4)
    jnet = jittr.ITTRGenerator(**kw)
    tnet = tittr.ITTRGenerator(3, **kw)
    params = _tree(jnet, jnp.asarray(x), seed=10)
    load_flax(tnet, params)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    got = to_np(tnet(torch.from_numpy(x)))
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
    feats = _jit_taps(jnet, [1])(params, jnp.asarray(x))
    got_f = tnet(torch.from_numpy(x), extract_layer_ids=[1])
    assert tnet.layer_channels([1]) == [16] and len(got_f) == 1
    np.testing.assert_allclose(to_np(got_f[0]), np.asarray(feats[0]),
                               atol=1e-4)


# horse2zebra cut small for each new generator; HAT shrunk in both
# packages (its factory width is fixed: 4 groups of 6 blocks of 96)
SMALL_OPTS = {"G_ngf": 8, "G_nblocks": 2, "data_crop_size": 32,
              "G_unet_mha_channel_mults": [1, 2], "G_unet_mha_res_blocks":
              [1, 1], "G_unet_mha_num_head_channels": 8,
              "G_unet_mha_group_norm_size": 4, "G_hdit_widths": [32, 64],
              "G_hdit_depths": [2, 2], "G_uvit_num_transformer_blocks": 2}
NEW_G = ["unet_mha", "uvit", "unet_256", "unet_128", "hdit", "hat", "ittr"]


def _opts(netg, small):
    with open(os.path.join(ROOT, "examples",
                           "example_gan_horse2zebra.json")) as f:
        cfg = json.load(f)
    out = []
    for cls in (JaxTrainOptions, TrainOptions):
        opt = cls().parse_json(cfg, verbose=False)
        opt.G_netG = netg
        if small:
            for k, v in SMALL_OPTS.items():
                setattr(opt, k, v)
        out.append(opt)
    return out


def _flax_leaves(tree):
    return {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("netg", NEW_G)
def test_define_g_trees_and_converter(netg, monkeypatch):
    for mod in (jhat, that):
        monkeypatch.setattr(mod, "HAT", functools.partial(
            mod.HAT, embed_dim=12, depths=(2, 2), num_heads=(2, 2)))
    jopt, opt = _opts(netg, small=True)
    jnet, tnet = jgan.define_G(jopt), tgan.define_G(opt)
    x = jnp.zeros((1, 32, 32, 3))
    params = _tree(jnet, x, seed=13)
    sd = flax_to_torch(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    tnet.load_state_dict(sd, strict=True)
    back = torch_to_flax(tnet.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.device_get(params))
    # the port's init draws every raw leaf flax draws
    tgan.init_raw_leaves(tnet, torch.Generator().manual_seed(0))
    for name, p in tnet.named_parameters():
        if name.endswith(("qkv_kernel", "rpb")):
            assert p.std() > 0, name
    # the NCE taps of horse2zebra's layers (cut_model.select_nce_layers)
    from joligen_tpu_torch.models.cut_model import select_nce_layers
    ids = select_nce_layers(opt)
    feats = jax.eval_shape(lambda p: jnet.apply(
        p, x, extract_layer_ids=ids), params)
    assert tnet.layer_channels(ids) == [f.shape[-1] for f in feats]


@pytest.mark.parametrize("netg", NEW_G)
def test_define_g_factory_width_matches_jax(netg):
    """Each new G at horse2zebra's options, 256 px, on the meta device:
    every leaf's name and shape against ``jax.eval_shape`` of the JAX
    factory's net."""
    jopt, opt = _opts(netg, small=False)
    jnet = jgan.define_G(jopt)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, 256, 256, 3))), jax.random.PRNGKey(0))
    want = _flax_leaves(shapes["params"])
    with torch.device("meta"):
        tnet = tgan.define_G(opt)
    sd = tnet.state_dict()
    names = set()
    for key, t in sd.items():
        parts = key.split(".")
        leaf, shape = parts[-1], tuple(t.shape)
        if leaf == "weight":
            if len(shape) == 1:
                leaf = "scale"
            elif len(shape) == 4:
                leaf, shape = "kernel", (shape[2], shape[3], shape[1],
                                         shape[0])
            else:
                leaf, shape = "kernel", shape[::-1]
        names.add(("/".join(parts[:-1] + [leaf]), shape))
    assert names == set(want.items())
    n = sum(p.numel() for p in tnet.parameters())
    assert n == sum(int(np.prod(s)) for s in want.values()) > 0


def test_hat_remat_gradients_equal():
    """``remat`` (``tpu_remat``) runs each group under checkpointing: the
    same output and the same gradients, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(15).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32))
    nets = [that.HAT(3, 3, img_size=32, remat=r, **HAT_SMALL)
            for r in (False, True)]
    gen = torch.Generator().manual_seed(16)
    for p in nets[0].parameters():
        torch.nn.init.normal_(p, 0.0, 0.05, generator=gen)
    nets[1].load_state_dict(nets[0].state_dict())
    outs, grads = [], []
    for net in nets:
        out = net(x)
        outs.append(out)
        grads.append(torch.autograd.grad(out.square().sum(),
                                         list(net.parameters())))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
