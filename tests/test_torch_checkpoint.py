"""The flax <-> torch converter and the port's msgpack checkpoint I/O against
flax.serialization: exact both ways, at full width on the param tree of
examples/example_ddpm_noglasses2glasses.json."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization, traverse_util

from joligen_tpu.models.diffusion_networks import define_G as jax_define_G
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models.base import BaseModel
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.diffusion_networks import define_G, init_weights
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.utils import checkpoint_io

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "example_ddpm_noglasses2glasses.json")


def _example_cfg():
    with open(EXAMPLE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def full_width_tree():
    """The example config's flax param tree (shapes from eval_shape),
    filled with seeded random values."""
    opt = JaxTrainOptions().parse_json(_example_cfg(), verbose=False)
    net = jax_define_G(opt)
    size = opt.data_crop_size
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 6)),
        jnp.zeros((1,)), mask=jnp.zeros((1, size, size, 1), jnp.int32)))
    rng = np.random.default_rng(0)
    flat = traverse_util.flatten_dict(shapes)
    return traverse_util.unflatten_dict(
        {k: rng.standard_normal(v.shape, dtype=np.float32)
         for k, v in flat.items()})


def _assert_trees_identical(a, b):
    fa, fb = traverse_util.flatten_dict(a), traverse_util.flatten_dict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k]), k


def test_options_parse_like_the_jax_package():
    cfg = _example_cfg()
    assert vars(TrainOptions().parse_json(cfg, verbose=False)) == vars(
        JaxTrainOptions().parse_json(cfg, verbose=False))


def test_full_width_tree_converts_exactly(full_width_tree):
    flat = traverse_util.flatten_dict(full_width_tree)
    assert len(flat) == 327
    assert sum(v.size for v in flat.values()) == 62_838_467
    sd = flax_to_torch(full_width_tree)
    opt = TrainOptions().parse_json(_example_cfg(), verbose=False)
    net = define_G(opt)
    net.load_state_dict(sd, strict=True)     # every leaf has its place
    assert sum(p.numel() for p in net.parameters()) == 62_838_467
    _assert_trees_identical(torch_to_flax(net.state_dict()), full_width_tree)
    # conv HWIO -> OIHW and dense (in, out) -> (out, in)
    p = full_width_tree["params"]["inner"]
    assert torch.equal(sd["inner.in_conv.weight"], torch.from_numpy(
        p["in_conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
    assert sd["inner.in_conv.weight"].shape == (64, 262, 3, 3)
    assert torch.equal(sd["inner.AttentionBlock_0.qkv.weight"],
                       torch.from_numpy(p["AttentionBlock_0"]["qkv"]
                                        ["kernel"].T.copy()))


def test_flax_file_loads_bit_identically(full_width_tree, tmp_path):
    blob = serialization.to_bytes(full_width_tree)
    got = checkpoint_io.loads(blob)
    _assert_trees_identical(got, full_width_tree)
    # the writer reproduces flax's bytes
    assert checkpoint_io.dumps(full_width_tree) == blob


def test_port_file_loads_in_flax(tmp_path):
    opt = TrainOptions().parse_json(_example_cfg(), verbose=False)
    opt.G_ngf = 32
    net = init_weights(define_G(opt), torch.Generator().manual_seed(0),
                       zero_init_std=0.01)
    tree = torch_to_flax(net.state_dict())
    path = tmp_path / "latest_net_G_A.pth"
    checkpoint_io.save(path, tree)
    target = jax.tree.map(np.zeros_like, tree)
    restored = serialization.from_bytes(target, path.read_bytes())
    _assert_trees_identical(restored, tree)


def test_save_and_load_networks_roundtrip(tmp_path):
    opt = TrainOptions().parse_json(_example_cfg(), verbose=False)
    opt.G_ngf, opt.G_unet_mha_channel_mults = 32, [1, 2]
    opt.G_unet_mha_res_blocks = [1, 1]
    opt.checkpoints_dir, opt.name = str(tmp_path), "run"
    a = BaseModel(opt, device="cpu")
    a.add_net("G_A", init_weights(define_G(opt),
                                  torch.Generator().manual_seed(1)),
              use_ema=True)
    init_weights(a.ema_nets["G_A"], torch.Generator().manual_seed(2))
    a.save_networks("latest")
    assert sorted(os.listdir(tmp_path / "run")) == [
        "latest_net_G_A.pth", "latest_net_G_A_ema.pth"]
    b = BaseModel(opt, device="cpu")
    b.add_net("G_A", define_G(opt), use_ema=True)
    b.load_networks("latest")
    for src, dst in ((a.nets, b.nets), (a.ema_nets, b.ema_nets)):
        for k, v in src["G_A"].state_dict().items():
            assert torch.equal(v, dst["G_A"].state_dict()[k]), k


@pytest.mark.parametrize("blob", [
    b"\xc0",                                   # nil
    b"\xc3",                                   # true
    b"\xd4\x02\x00",                           # ext type 2 (complex)
    b"\x81\xb9__msgpack_chunked_array__\x01",  # flax's chunked array
])
def test_reader_rejects_unsupported_values(blob):
    with pytest.raises(ValueError):
        checkpoint_io.loads(blob)


def test_reader_decodes_scalar_forms():
    import msgpack
    values = {"a": -5, "b": 300, "c": -40000, "d": 2 ** 40, "e": 1.5,
              "f": "x" * 40, "g": b"\x01\x02"}
    assert checkpoint_io.loads(msgpack.packb(values)) == values
    assert checkpoint_io.dumps(values) == msgpack.packb(
        dict(sorted(values.items())))
