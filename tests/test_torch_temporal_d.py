"""The temporal projected discriminator of the port
(``joligen_tpu_torch/models/modules/projected_d.py``,
``TemporalProjectedDiscriminator``, ``D_netDs temporal``) against the JAX
package's on the CPU, seeded clips from numpy and seeded weights through
the converter:

1. fp32, 2 clips of 3 frames: at 64 px, at 64 px resized to 48 (the
   antialiased bilinear resize) and on 1-channel clips (tiled to 3): the
   logits and the gradients of every parameter (the LSTM cells and the
   patch heads; the frozen trunk's and projections' are 0 in both) to
   1e-4 of the largest; no gradient reaches the clip in either package;
2. bf16 (1 clip of 2 frames): the logits within 2e-2 (relative, by norm)
   of the JAX module's in bf16;
3. ``define_D`` and the CUT init: the LSTM kernels lecun-normal over their
   2c rows, their biases 0; the converter both ways bit for bit (the raw
   ``lstm_w{i}`` and ``lstm_b{i}``); the tutorial's 256 px D against
   ``jax.eval_shape``: every name and shape, 12,016,372 parameters (the
   trunk and projections 4,686,576 of them, frozen).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, seeded_tree  # noqa: F401
from joligen_tpu.models.modules import projected_d as jpd
from joligen_tpu_torch.models import gan_networks as tgan
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.cut_model import init_discriminator
from joligen_tpu_torch.models.modules import projected_d as tpd
from joligen_tpu_torch.options import TrainOptions

B, F, SIZE = 2, 3, 64
EXPECTED_PARAMS, EXPECTED_FROZEN = 12_016_372, 4_686_576


def _tree(jd, x, seed=3):
    shapes = jax.eval_shape(lambda r: jd.init(r, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    return seeded_tree(shapes, seed, 0.05, lecun=True)


def _clips(channels, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, F, SIZE, SIZE, channels)).astype(
        np.float32)


@pytest.mark.parametrize("interp,channels", [(-1, 3), (48, 3), (-1, 1)])
def test_temporal_d_matches_jax_forward_and_gradients(interp, channels):
    x = _clips(channels)
    jd = jpd.TemporalProjectedDiscriminator(interp=interp)
    tree = _tree(jd, x)
    params = jax.tree.map(jnp.asarray, tree)
    want, vjp = jax.vjp(jd.apply, params, jnp.asarray(x))
    cot = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    jp, jx = vjp(jnp.asarray(cot))
    assert not np.asarray(jx).any()

    td = tpd.TemporalProjectedDiscriminator(SIZE, interp=interp)
    td.load_state_dict(flax_to_torch(tree), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = td(xt)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    got.backward(torch.from_numpy(cot))
    assert xt.grad is None
    ref = flax_to_torch(jax.device_get(jp))
    frozen = {id(p) for p in td.frozen_parameters()}
    for name, p in td.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(1e-8, float(ref[name].abs().max()))
        if id(p) in frozen:
            assert not ref[name].any() and not g.any(), name
            continue
        assert float(ref[name].abs().max()) > 0, name
        assert float((g - ref[name]).abs().max()) <= 1e-4 * max(1.0, scale), \
            name


def test_temporal_d_bf16_matches_jax():
    x = _clips(3, seed=4)[:1, :2]
    jd = jpd.TemporalProjectedDiscriminator(dtype=jnp.bfloat16)
    tree = _tree(jd, x, seed=5)
    want = np.asarray(jd.apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x)), np.float32)
    td = tpd.TemporalProjectedDiscriminator(SIZE, dtype=torch.bfloat16)
    td.load_state_dict(flax_to_torch(tree), strict=True)
    with torch.no_grad():
        got = td(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def _tutorial_opt(size):
    opt = TrainOptions().parse_json({
        "model_type": "cut", "dataroot": "unused",
        "data": {"dataset_mode": "temporal_labeled_mask_online",
                 "crop_size": size, "load_size": size},
        "D": {"netDs": ["temporal"]}}, verbose=False)
    return opt


def test_define_d_init_converter_and_full_width_tree():
    opt = _tutorial_opt(256)
    net = tgan.define_D(opt)["D_B_temporal"]
    init_discriminator("D_B_temporal", net, torch.Generator().manual_seed(0),
                       opt)
    for i, c in enumerate(net.proj.channels):
        w, b = getattr(net, f"lstm_w{i}"), getattr(net, f"lstm_b{i}")
        assert w.shape == (2 * c, 4 * c) and not b.any()
        # flax's lecun-normal over the 2c rows, truncated at 2 std
        std = float(w.detach().std())
        want = (1.0 / (2 * c)) ** 0.5
        assert 0.9 * want < std < 1.1 * want, (i, std, want)
    sd = net.state_dict()
    back = flax_to_torch(torch_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k

    jd = jpd.TemporalProjectedDiscriminator(interp=opt.D_proj_interp)
    shapes = jax.eval_shape(lambda r: jd.init(
        r, jnp.zeros((1, 2, 256, 256, 3))), jax.random.PRNGKey(0))
    want = {".".join(str(k.key) for k in path): leaf.shape for path, leaf
            in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    got = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            torch_to_flax(sd)["params"]):
        got[".".join(str(k.key) for k in path)] = leaf.shape
    assert got == want
    assert sum(p.numel() for p in net.parameters()) == sum(
        int(np.prod(s)) for s in want.values()) == EXPECTED_PARAMS
    assert sum(p.numel() for p in net.frozen_parameters()) == \
        EXPECTED_FROZEN
