"""The segformer nets of the port (``joligen_tpu_torch/models/modules/
segformer.py``) against the JAX package's, on the CPU, with seeded weights
(flax's default law) carried by the converter and the same numpy inputs:

1. every module (``OverlapPatchEmbed``, ``EfficientAttention`` with and
   without spatial reduction, ``MixFFN``, ``MiTBlock``, ``MiTBackbone``,
   ``SegformerHead``, ``SegformerSegmenter``, ``SegformerGeneratorAttn``)
   in fp32 to 1e-4 of the largest output; in bf16 to 2e-2 of the L2 norm
   of the JAX fp32 output, and as close to JAX's bf16 output as twice
   that one's own distance from fp32 (two bf16 programs that round at
   different places drift about 1.5 % apart through the backbone's eight
   blocks, each nearer to fp32 than to the other); the backbone, segmenter
   and generator at 72 px, where the stage grids are 18, 9, 5 and 3, so
   that the ``SAME`` padding of the ``sr`` convs and the head's resizes
   are not whole multiples;
2. the factories on ``example_gan_mario2sonic.json``: the segformer G
   (3,931,824 parameters, as ``jax.eval_shape`` counts the JAX one), the
   ``f_s_net: segformer`` segmenter and the projected D with the MiT
   trunk, each in fp32 to 1e-4; the D's trunk gives no gradient;
3. ``load_mit_backbone`` on an npz the test writes: the same tree in both
   packages, bit for bit, under ``backbone`` and ``feature_network``;
4. the converter, both ways, bit for bit on every segformer tree;
5. bdd100k's ``dinov2_vitb14`` projected D raises in both packages.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, err_and_scale, few_torch_threads,
                               load_flax, seeded_tree, to_np)
from joligen_tpu.models import gan_networks as jgan
from joligen_tpu.models.modules import segformer as jseg
from joligen_tpu.models.modules import semantic_networks as jsem
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import gan_networks as tgan
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import segformer as tseg
from joligen_tpu_torch.models.modules import semantic_networks as tsem
from joligen_tpu_torch.options import TrainOptions

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}
W = tseg.B0_WIDTHS


def _nhwc(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _feats(seed, size):
    """Stage features of a ``size``² input: (1, s, s, width) each."""
    return [_nhwc(seed + i, (2, s, s, w))
            for i, (s, w) in enumerate(zip(tseg.mit_tap_sizes(size), W))]


# name: (JAX module, port module, input)
def _cases(jdt, tdt):
    return {
        "embed0": (jseg.OverlapPatchEmbed(32, 7, 4, dtype=jdt),
                   tseg.OverlapPatchEmbed(3, 32, 7, 4, tdt),
                   _nhwc(1, (2, 30, 30, 3))),
        "embed_s2": (jseg.OverlapPatchEmbed(64, 3, 2, dtype=jdt),
                     tseg.OverlapPatchEmbed(32, 64, 3, 2, tdt),
                     _nhwc(2, (2, 9, 9, 32))),
        "attn_sr4": (jseg.EfficientAttention(2, 4, dtype=jdt),
                     tseg.EfficientAttention(64, 2, 4, tdt),
                     _nhwc(3, (2, 9, 11, 64))),
        "attn_sr1": (jseg.EfficientAttention(5, 1, dtype=jdt),
                     tseg.EfficientAttention(160, 5, 1, tdt),
                     _nhwc(4, (2, 3, 3, 160))),
        "ffn": (jseg.MixFFN(dtype=jdt), tseg.MixFFN(32, dtype=tdt),
                _nhwc(5, (2, 7, 6, 32))),
        "block": (jseg.MiTBlock(1, 8, dtype=jdt),
                  tseg.MiTBlock(32, 1, 8, tdt), _nhwc(6, (2, 18, 18, 32))),
        "backbone": (jseg.MiTBackbone(dtype=jdt),
                     tseg.MiTBackbone(dtype=tdt), _nhwc(7, (2, 72, 72, 3))),
        "head": (jseg.SegformerHead(7, dtype=jdt),
                 tseg.SegformerHead(W, 7, dtype=tdt), _feats(8, 72)),
        "segmenter": (jseg.SegformerSegmenter(19, dtype=jdt),
                      tseg.SegformerSegmenter(3, 19, dtype=tdt),
                      _nhwc(9, (2, 72, 72, 3))),
        "generator": (jseg.SegformerGeneratorAttn(dtype=jdt),
                      tseg.SegformerGeneratorAttn(dtype=tdt),
                      _nhwc(10, (2, 72, 72, 3))),
    }


def _pair(jmod, tmod, x, seed, ref32=False):
    """Seeded flax weights into both; (port output(s), JAX output(s),
    tree), and with ``ref32`` JAX's fp32 output(s) last."""
    jx = ([jnp.asarray(f) for f in x] if isinstance(x, list)
          else jnp.asarray(x))
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(k, jx),
                                      jax.random.PRNGKey(0)), seed, 0.05,
                       lecun=True)
    load_flax(tmod, tree)
    want = jax.jit(jmod.apply)(jax.tree.map(jnp.asarray, tree), jx)
    tx = ([torch.from_numpy(f) for f in x] if isinstance(x, list)
          else torch.from_numpy(x))
    with torch.no_grad():
        got = tmod(tx)
    if not ref32:
        return got, want, tree
    ref = jax.jit(jmod.clone(dtype=jnp.float32).apply)(
        jax.tree.map(jnp.asarray, tree), jx)
    return got, want, tree, ref


def _listed(t):
    return list(t) if isinstance(t, (list, tuple)) else [t]


def _close(got, want, dt, what, ref32=None):
    """fp32: ``got`` to 1e-4 of ``want``'s largest value. bf16: ``got`` to
    2e-2 of ``ref32``'s L2 norm, and to ``want`` (JAX in bf16) within twice
    ``want``'s distance from ``ref32``."""
    refs = _listed(ref32) if ref32 is not None else [None] * len(
        _listed(want))
    for g, w, r in zip(_listed(got), _listed(want), refs):
        g = to_np(g)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if dt == "fp32":
            err, scale = err_and_scale(g, w, norm=False)
            assert err <= 1e-4 * scale, (what, err, scale)
            continue
        err, scale = err_and_scale(g, r, norm=True)
        own, _ = err_and_scale(w, r, norm=True)
        apart, _ = err_and_scale(g, w, norm=True)
        assert err <= 2e-2 * scale and apart <= 2 * own, (
            what, err, apart, own, scale)


@pytest.mark.parametrize("dt", sorted(DT))
@pytest.mark.parametrize("name", sorted(_cases(jnp.float32, torch.float32)))
def test_segformer_module_matches_jax(name, dt):
    jmod, tmod, x = _cases(*DT[dt])[name]
    got, want, _, ref = _pair(jmod, tmod, x, 11, ref32=True)
    if name == "generator":
        assert got.dtype == torch.float32
    _close(got, want, dt, name, ref)


def test_mit_tap_sizes_and_heads():
    assert tseg.mit_tap_sizes(72) == [18, 9, 5, 3]
    assert tseg.mit_tap_sizes(128) == [32, 16, 8, 4]
    assert [tseg.mit_heads(w) for w in W] == [1, 2, 5, 8]
    feats = jax.eval_shape(
        lambda k: jseg.MiTBackbone().init_with_output(
            k, jnp.zeros((1, 72, 72, 3)))[0], jax.random.PRNGKey(0))
    assert [f.shape[1] for f in feats] == [18, 9, 5, 3]


def test_generator_features_and_taps_match_jax():
    """The stage features one pass returns with the output
    (``with_features``), the same as ``extract_layer_ids``'s and JAX's."""
    jmod = jseg.SegformerGeneratorAttn()
    tmod = tseg.SegformerGeneratorAttn()
    x = _nhwc(12, (2, 64, 64, 3))
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(k, jnp.asarray(x)),
                                      jax.random.PRNGKey(0)), 13, 0.05,
                       lecun=True)
    load_flax(tmod, tree)
    ids = [0, 1, 2, 3]
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                      extract_layer_ids=ids)
    with torch.no_grad():
        out, feats = tmod(torch.from_numpy(x), with_features=ids)
        alone = tmod(torch.from_numpy(x), extract_layer_ids=ids)
        plain = tmod(torch.from_numpy(x))
    assert torch.equal(out, plain)
    assert tmod.layer_channels(ids) == [f.shape[-1] for f in want] == list(W)
    for f, a, w in zip(feats, alone, want):
        assert torch.equal(f, a)
        _close(f, w, "fp32", "taps")


def _mario_opts(extra=None):
    with open(os.path.join(ROOT, "examples",
                           "example_gan_mario2sonic.json")) as f:
        cfg = json.load(f)
    cfg.setdefault("tpu", {})["bf16"] = False
    for k, v in (extra or {}).items():
        cfg.setdefault(k, {}).update(v)
    return (JaxTrainOptions().parse_json(cfg, verbose=False),
            TrainOptions().parse_json(cfg, verbose=False))


def _count(tree):
    return sum(int(np.prod(v.shape)) for v in jax.tree.leaves(tree))


@pytest.mark.parametrize("net", ["G", "f_s", "projected_d"])
def test_factories_build_mario2sonic_nets(net):
    """The factories on mario2sonic (``f_s_net: segformer`` and
    ``D_proj_network_type: segformer`` set) at 64 px, fp32."""
    jopt, opt = _mario_opts({"f_s": {"net": "segformer"},
                             "D": {"proj_network_type": "segformer"}})
    x = _nhwc(14, (2, 64, 64, 3))
    if net == "G":
        jmod, tmod = jgan.define_G(jopt), tgan.define_G(opt)
    elif net == "f_s":
        jmod, tmod = jsem.define_f(jopt), tsem.define_f(opt)
    else:
        jmod = jgan.define_D(jopt, ["projected_d"])["D_B_projected_d"]
        opt.data_crop_size = 64
        tmod = tgan.define_D(opt, ["projected_d"])["D_B_projected_d"]
    got, want, tree = _pair(jmod, tmod, x, 15)
    _close(got, want, "fp32", net)
    if net == "G":
        shapes = jax.eval_shape(lambda k: jmod.init(
            k, jnp.zeros((1, 128, 128, 3))), jax.random.PRNGKey(0))
        assert _count(shapes) == sum(
            p.numel() for p in tmod.parameters()) == 3_931_824
    if net == "projected_d":
        xt = torch.from_numpy(x).requires_grad_(True)
        tmod(xt).square().sum().backward()
        assert xt.grad is None or not xt.grad.any()
        assert all(p.grad is None or not p.grad.any()
                   for p in tmod.frozen_parameters())
        assert any(p.grad is not None and p.grad.any()
                   for n, p in tmod.named_parameters()
                   if n.startswith("disc"))


def test_cut_nce_taps_for_segformer():
    from joligen_tpu.models.cut_model import CUTModel
    from joligen_tpu_torch.models.cut_model import select_nce_layers
    jopt, opt = _mario_opts()
    assert select_nce_layers(opt) == CUTModel._select_nce_layers(jopt) == [
        0, 1, 2, 3]


def _write_mit_npz(path, seed):
    shapes = jax.eval_shape(lambda k: jseg.MiTBackbone().init(
        k, jnp.zeros((1, 32, 32, 3))), jax.random.PRNGKey(0))["params"]
    tree = seeded_tree(shapes, seed, 0.05)
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                flat["/".join(pre + (k,))] = v
    walk(tree, ())
    np.savez(path, **flat)
    return tree


def test_load_mit_backbone_matches_jax(tmp_path, monkeypatch):
    """The npz under ``backbone`` (G, f_s) and ``feature_network`` (the
    projected D): the port's nets hold the JAX trees bit for bit; the rest
    of each net is untouched; without the file nothing loads."""
    tseg_net = tseg.SegformerGeneratorAttn()
    assert not tseg.load_mit_backbone(tseg_net)
    monkeypatch.setenv("JOLIGEN_TPU_WEIGHTS_DIR", str(tmp_path))
    assert not tseg.load_mit_backbone(tseg_net)
    tree = _write_mit_npz(tmp_path / "segformer_mit_b0.npz", 21)
    for jmod, tmod, node in (
            (jseg.SegformerGeneratorAttn(), tseg.SegformerGeneratorAttn(),
             "backbone"),
            (jseg.SegformerSegmenter(7), tseg.SegformerSegmenter(3, 7),
             "backbone"),
            (jgan.define_D(_mario_opts(
                {"D": {"proj_network_type": "segformer"}})[0],
                ["projected_d"])["D_B_projected_d"],
             tgan.define_D(_mario_opts(
                 {"D": {"proj_network_type": "segformer"}})[1],
                 ["projected_d"])["D_B_projected_d"], "feature_network")):
        init = seeded_tree(jax.eval_shape(lambda k: jmod.init(
            k, jnp.zeros((1, 128, 128, 3))), jax.random.PRNGKey(0)), 22,
            0.05)
        load_flax(tmod, init)
        before = {k: v.clone() for k, v in tmod.state_dict().items()}
        want = jseg.load_mit_backbone(init, node_name=node)
        assert tseg.load_mit_backbone(tmod, node)
        got = torch_to_flax(tmod.state_dict())
        flat_w = flax_to_torch(jax.device_get(want))
        flat_t = flax_to_torch(tree)
        for k, v in tmod.state_dict().items():
            assert torch.equal(v, flat_w[k]), k
            if k.startswith(node + "."):
                assert torch.equal(v, flat_t[k[len(node) + 1:]]), k
            else:
                assert torch.equal(v, before[k]), k
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.device_get(want))


@pytest.mark.parametrize("net", ["G", "f_s", "projected_d"])
def test_converter_carries_segformer_trees_both_ways(net):
    """Every leaf (the depthwise ``dw`` kernels HWIO (3, 3, 1, C) as OIHW
    (C, 1, 3, 3), the LayerNorm ``scale``s as ``weight``s) both ways, bit
    for bit."""
    jopt, opt = _mario_opts({"f_s": {"net": "segformer"},
                             "D": {"proj_network_type": "segformer"}})
    if net == "G":
        jmod, tmod = jgan.define_G(jopt), tgan.define_G(opt)
    elif net == "f_s":
        jmod, tmod = jsem.define_f(jopt), tsem.define_f(opt)
    else:
        jmod = jgan.define_D(jopt, ["projected_d"])["D_B_projected_d"]
        tmod = tgan.define_D(opt, ["projected_d"])["D_B_projected_d"]
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(
        k, jnp.zeros((1, 128, 128, 3))), jax.random.PRNGKey(0)), 23, 0.05)
    load_flax(tmod, tree)
    sd = tmod.state_dict()
    if net != "projected_d":
        dw = sd["backbone.s0b0.ffn.dw.weight"]
        assert dw.shape == (128, 1, 3, 3)
        np.testing.assert_array_equal(
            dw.numpy(), tree["params"]["backbone"]["s0b0"]["ffn"]["dw"][
                "kernel"].transpose(3, 2, 0, 1))
    back = torch_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_bdd100k_projected_d_raises_in_both_packages():
    """``example_tutorial_bdd100k``'s D: ``dinov2_vitb14`` as the projected
    trunk, which neither package builds."""
    path = os.path.join(ROOT, "examples", "example_tutorial_bdd100k.json")
    with open(path) as f:
        cfg = json.load(f)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    assert opt.D_proj_network_type == "dinov2_vitb14"
    assert "projected_d" in opt.D_netDs
    with pytest.raises(NotImplementedError, match="dinov2_vitb14"):
        jgan.define_D(jopt)
    with pytest.raises(NotImplementedError, match="dinov2_vitb14"):
        tgan.define_D(opt)
