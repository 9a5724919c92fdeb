"""The vision-aided discriminator and its frozen towers against the JAX
package, on the CPU:

1. CLIP ViT-B/16 and DINOv2 ViT-B/14 at full width, batch 1, fp32, through
   their ``preprocess`` from 128 px (the resize grows) and 256 px (it
   shrinks, antialiased): the embedding and the token grid to 1e-4 of
   their largest magnitude. The weights are a seeded tree with every leaf
   non-zero: the zero-initialised embeddings, position tables and CLIP's
   ``proj`` would otherwise make the comparison vacuous (LayerScales at
   1 + N(0, 0.05)).
2. Each npz loader against the JAX loader on a synthetic npz written here:
   the same tree, bit for bit; and the weights swapped into the
   discriminator's towers (``load_clip_ref_encoder``, ``load_dino_into``)
   as the JAX package swaps them.
3. ``VisionAidedDiscriminator`` with both members and the towers shrunk
   (monkeypatched in both packages' tower modules, where the
   discriminators look them up): the logits to 1e-4 of their largest in
   fp32, and with bf16 heads to 2e-2 of their L2 norm. At full tower size:
   the output is (B, 115), and the parameter counts equal the JAX module's
   (``jax.eval_shape``).
4. Reference properties the port copies: CLIP's zero-initialised ``proj``
   makes its global features exactly 0 when no weights file is present
   (so its global head sees only its bias); ``D_vision_aided_backbones``
   parses as the JAX factory parses it (``swin`` skipped with a notice, an
   empty list falling back to clip).
5. The converter carries every leaf of the discriminator both ways bit for
   bit, and through checkpoint files both ways.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (err_and_scale, few_torch_threads, h2z_cfg,
                               load_flax, seeded_tree, to_np)
from joligen_tpu.models import gan_networks as jgan
from joligen_tpu.models.modules import vision_aided_d as jva
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.utils import clip_vit as jclip
from joligen_tpu.utils import dinov2 as jdino
from joligen_tpu_torch.models import gan_networks as tgan
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import vision_aided_d as tva
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.utils import checkpoint_io
from joligen_tpu_torch.utils import clip_vit as tclip
from joligen_tpu_torch.utils import dinov2 as tdino

TOWERS = {"clip": (jclip, tclip, "CLIPVisualViT"),
          "dino": (jdino, tdino, "DINOv2ViT")}
SMALL = dict(dim=64, depth=2, heads=2)
# full width: the heads, and each tower (jax.eval_shape of the JAX module)
FULL_PARAMS = {"D": 175_001_860, "freezenet_clip": 86_192_640,
               "freezenet_dino": 86_579_712}


def _tree(shapes, seed):
    """A seeded tree with every leaf non-zero; LayerScales near 1."""
    tree = seeded_tree(shapes, seed, 0.05, lecun=True)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ls1", "ls2"):
                t[k] = v + 1.0
    walk(tree)
    return tree


@pytest.fixture
def small_towers(monkeypatch):
    """Both packages' towers at dim 64, depth 2, 2 heads."""
    for jmod, tmod, cls in TOWERS.values():
        monkeypatch.setattr(jmod, cls, functools.partial(getattr(jmod, cls),
                                                         **SMALL))
        monkeypatch.setattr(tmod, cls, functools.partial(getattr(tmod, cls),
                                                         **SMALL))


@pytest.mark.parametrize("size", [128, 256])
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_tower_matches_jax_at_full_width(tower, size):
    jmod, tmod, cls = TOWERS[tower]
    x = np.random.default_rng(size).uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32)
    jnet = getattr(jmod, cls)(return_tokens=True)
    xj = jmod.preprocess(jnp.asarray(x))
    tree = _tree(jax.eval_shape(lambda r: jnet.init(r, xj),
                                jax.random.PRNGKey(0)), 3)
    jemb, jtok = jnet.apply(jax.tree.map(jnp.asarray, tree), xj)
    tnet = load_flax(getattr(tmod, cls)(return_tokens=True), tree)
    with torch.no_grad():
        temb, ttok = tnet(tmod.preprocess(torch.from_numpy(x)))
    assert ttok.shape == jtok.shape == (1, 224 // tnet.patch,
                                        224 // tnet.patch, 768)
    for got, want in ((temb, jemb), (ttok, jtok)):
        err, scale = err_and_scale(to_np(got), want, norm=False)
        assert scale > 0.1 and err <= 1e-4 * scale, (tower, size, err, scale)


def _torch_attn(rng, d, nblocks):
    """An npz's per-block attention leaves in torch layout."""
    out = {}
    for i in range(nblocks):
        out[f"block{i}.attn.qkv_w"] = rng.normal(size=(3 * d, d))
        out[f"block{i}.attn.qkv_b"] = rng.normal(size=(3 * d,))
        out[f"block{i}.attn.proj_w"] = rng.normal(size=(d, d))
        out[f"block{i}.attn.proj_b"] = rng.normal(size=(d,))
    return out


def _write_clip_npz(path, d=128, nblocks=2, seed=0):
    rng = np.random.default_rng(seed)
    z = {"conv1.kernel": rng.normal(size=(16, 16, 3, d)),
         "class_embedding": rng.normal(size=(d,)),
         "positional_embedding": rng.normal(size=(197, d)),
         "proj": rng.normal(size=(d, 512))}
    for n in ("ln_pre", "ln_post"):
        z[f"{n}.scale"], z[f"{n}.bias"] = rng.normal(size=(2, d))
    for i in range(nblocks):
        for n in ("ln_1", "ln_2"):
            z[f"block{i}.{n}.scale"], z[f"block{i}.{n}.bias"] = \
                rng.normal(size=(2, d))
        z[f"block{i}.c_fc.kernel"] = rng.normal(size=(d, 4 * d))
        z[f"block{i}.c_fc.bias"] = rng.normal(size=(4 * d,))
        z[f"block{i}.c_proj.kernel"] = rng.normal(size=(4 * d, d))
        z[f"block{i}.c_proj.bias"] = rng.normal(size=(d,))
    z.update(_torch_attn(rng, d, nblocks))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in z.items()})


def _write_dino_npz(path, d=384, nblocks=2, seed=1):
    rng = np.random.default_rng(seed)
    z = {"cls_token": rng.normal(size=(1, 1, d)),
         "pos_embed": rng.normal(size=(1, 37 * 37 + 1, d)),
         "patch_embed.kernel": rng.normal(size=(14, 14, 3, d)),
         "patch_embed.bias": rng.normal(size=(d,)),
         "norm.scale": rng.normal(size=(d,)),
         "norm.bias": rng.normal(size=(d,))}
    for i in range(nblocks):
        for n in ("norm1", "norm2"):
            z[f"block{i}.{n}.scale"], z[f"block{i}.{n}.bias"] = \
                rng.normal(size=(2, d))
        z[f"block{i}.ls1"], z[f"block{i}.ls2"] = rng.normal(size=(2, d))
        z[f"block{i}.fc1.kernel"] = rng.normal(size=(d, 4 * d))
        z[f"block{i}.fc1.bias"] = rng.normal(size=(4 * d,))
        z[f"block{i}.fc2.kernel"] = rng.normal(size=(4 * d, d))
        z[f"block{i}.fc2.bias"] = rng.normal(size=(d,))
    z.update(_torch_attn(rng, d, nblocks))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in z.items()})


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, want):
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert set(a) == set(b)
    for path, v in b.items():
        v = np.asarray(v)
        assert a[path].dtype == v.dtype and a[path].shape == v.shape, path
        np.testing.assert_array_equal(a[path], v, err_msg=str(path))


def test_npz_loaders_match_jax_and_swap_into_the_towers(tmp_path,
                                                        monkeypatch):
    """Both readers bit for bit against the JAX readers; then, with the
    files in ``JOLIGEN_TPU_WEIGHTS_DIR``, the discriminator's towers swapped
    as the JAX package swaps them (the heads untouched)."""
    _write_clip_npz(tmp_path / "clip_vitb16.npz")
    _write_dino_npz(tmp_path / "dinov2_vitb14.npz")
    for jload, tload, f in (
            (jclip.load_clip_params, tclip.load_clip_params,
             "clip_vitb16.npz"),
            (jdino.load_dinov2_params, tdino.load_dinov2_params,
             "dinov2_vitb14.npz")):
        _assert_trees_equal(tload(str(tmp_path / f)),
                            jax.device_get(jload(str(tmp_path / f))))

    # the towers of the files' sizes, in both packages
    sizes = {"clip": dict(dim=128, depth=2, heads=2),
             "dino": dict(dim=384, depth=2, heads=6)}
    for tower, (jmod, tmod, cls) in TOWERS.items():
        for mod in (jmod, tmod):
            monkeypatch.setattr(mod, cls, functools.partial(
                getattr(mod, cls), **sizes[tower]))
    x = jnp.zeros((1, 32, 32, 3))
    jd = jva.VisionAidedDiscriminator(backbones=("clip", "dino"))
    tree = _tree(jax.eval_shape(lambda r: jd.init(r, x),
                                jax.random.PRNGKey(0)), 5)
    td = load_flax(tva.VisionAidedDiscriminator(backbones=("clip", "dino")),
                   tree)
    assert not tclip.load_clip_ref_encoder(td)      # no weights dir yet
    monkeypatch.setenv("JOLIGEN_TPU_WEIGHTS_DIR", str(tmp_path))
    assert tclip.load_clip_ref_encoder(td) and tdino.load_dino_into(td)
    want = jdino.load_dino_into(jclip.load_clip_ref_encoder(tree))
    _assert_trees_equal(torch_to_flax(td.state_dict()),
                        jax.device_get(want))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_vision_aided_discriminator_matches_jax(small_towers, dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jd = jva.VisionAidedDiscriminator(backbones=("clip", "dino"), dtype=jdt)
    tree = _tree(jax.eval_shape(lambda r: jd.init(r, jnp.asarray(x)),
                                jax.random.PRNGKey(0)), 7)
    want = jd.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    td = load_flax(tva.VisionAidedDiscriminator(backbones=("clip", "dino"),
                                                dtype=tdt), tree)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    # 49 + 1 (clip: 14 x 14 tokens, one stride-2 conv) + 64 + 1 (dino)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 115)
    err, scale = err_and_scale(to_np(got), want, norm=dt == "bf16")
    assert err <= (2e-2 if dt == "bf16" else 1e-4) * scale, (err, scale)


def test_full_size_output_shape_and_parameter_counts():
    """At full tower size: (B, 115) logits and the JAX module's parameter
    counts, in total and per tower (the JAX side by ``jax.eval_shape``)."""
    jd = jva.VisionAidedDiscriminator(backbones=("clip", "dino"))
    x = jnp.zeros((1, 128, 128, 3))
    out, shapes = jax.eval_shape(
        lambda r: jd.init_with_output(r, x), jax.random.PRNGKey(0))
    count = lambda t: sum(int(np.prod(v.shape))  # noqa: E731
                          for _, v in _leaves(t))
    jcounts = {"D": count(shapes),
               **{k: count(shapes["params"][k])
                  for k in ("freezenet_clip", "freezenet_dino")}}
    td = tva.VisionAidedDiscriminator(backbones=("clip", "dino"))
    tcounts = {"D": sum(p.numel() for p in td.parameters()),
               **{k: sum(p.numel() for p in getattr(td, k).parameters())
                  for k in ("freezenet_clip", "freezenet_dino")}}
    assert jcounts == tcounts == FULL_PARAMS
    assert sum(p.numel() for p in td.frozen_parameters()) == (
        FULL_PARAMS["freezenet_clip"] + FULL_PARAMS["freezenet_dino"])
    with torch.no_grad():
        got = td(torch.zeros(1, 128, 128, 3))
    assert got.shape == out.shape == (1, 115)


def test_clip_zero_proj_gives_zero_global_features_without_weights(
        small_towers):
    """Reference property: with no weights file CLIP keeps its zero
    ``proj``, so its embedding is exactly 0, in both packages (the JAX
    module's own init; the port's flax-default init)."""
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jnet = jclip.CLIPVisualViT(return_tokens=True)
    xj = jclip.preprocess(jnp.asarray(x))
    jemb, jtok = jnet.apply(jnet.init(jax.random.PRNGKey(0), xj), xj)
    td = tgan.flax_default_init(
        tva.VisionAidedDiscriminator(backbones=("clip",)),
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        temb, ttok = td.freezenet_clip(tclip.preprocess(torch.from_numpy(x)))
    assert not np.asarray(jemb).any() and not temb.any()
    assert np.abs(np.asarray(jtok)).max() > 0 and ttok.abs().max() > 0
    for name in ("class_embedding", "positional_embedding", "proj"):
        assert not getattr(td.freezenet_clip, name).any(), name


@pytest.mark.parametrize("spec,want", [
    ("clip+dino+swin", ("clip", "dino")), ("dinov2+clip", ("dino", "clip")),
    ("swin", ("clip",)), ("", ("clip",)), ("CLIP+clip_l", ("clip",))])
def test_backbones_parse_as_the_jax_factory(tmp_path, capsys, spec, want):
    cfg = h2z_cfg(tmp_path, {"D": {"netDs": ["vision_aided"],
                                   "vision_aided_backbones": spec}})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jbk = jgan.define_D(jopt)["D_B_vision_aided"].backbones
    jout = capsys.readouterr().out
    assert tgan.vision_aided_backbones(opt) == jbk == want
    tout = capsys.readouterr().out
    assert ("'swin' not ported" in tout) == ("'swin' not ported" in jout) \
        == ("swin" in spec)


def test_converter_carries_every_leaf_both_ways(small_towers, tmp_path):
    """Every leaf of the discriminator (towers and heads): flax -> port
    (strict) -> flax bit for bit; a checkpoint the port writes reads back
    through flax's msgpack, and one flax writes loads into the port."""
    jd = jva.VisionAidedDiscriminator(backbones=("clip", "dino"))
    tree = jax.device_get(_tree(jax.eval_shape(
        lambda r: jd.init(r, jnp.zeros((1, 32, 32, 3))),
        jax.random.PRNGKey(0)), 9))
    td = load_flax(tva.VisionAidedDiscriminator(backbones=("clip", "dino")),
                   tree)
    back = torch_to_flax(td.state_dict())
    _assert_trees_equal(back, tree)
    leaves = {p[-1] for p, _ in _leaves(tree)}
    assert {"class_embedding", "positional_embedding", "proj", "cls_token",
            "pos_embed", "ls1", "ls2", "kernel", "scale"} <= leaves
    path = str(tmp_path / "latest_net_D_B_vision_aided.pth")
    checkpoint_io.save(path, back)
    with open(path, "rb") as f:
        restored = serialization.from_bytes(
            jax.tree.map(np.zeros_like, tree), f.read())
    _assert_trees_equal(restored, tree)
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))
    td.load_state_dict(flax_to_torch(checkpoint_io.load(path)))
    for k, t in td.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), flax_to_torch(tree)[k]
                                      .numpy())
