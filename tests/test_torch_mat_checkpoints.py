"""MAT's converter rule, checkpoints, R1 penalty and model pieces in the
port against the JAX package, on the CPU:

1. the converter with MAT's rule (``weight_leaves``): the G and D trees
   and their Adam states (non-zero moments after a JAX update) to the port
   and back, bit for bit; without the rule MAT's tree is refused, and the
   rule leaves a ``kernel`` tree's mapping as it was;
2. checkpoints both ways: the port's files (G, its EMA, D) read by the
   JAX model's ``load_networks``, and the JAX model's files read by the
   port in phase test, bit for bit;
3. the R1 penalty (the squared input gradient of both trunks' summed
   logits) and its D gradient alone, to 1e-4 of the largest value (fp32),
   on an input with no lrelu output within fp32 rounding of the kink;
4. ``_ema_beta`` with and without the ramp against the JAX method (1e-6);
   ``set_input`` (the label mask inverted, the mask classes inside the
   hole); the noise modes (``none`` draws nothing, ``const`` the same
   draws at every call, ``random`` new ones); a request in noise mode
   ``none`` against the JAX model to 1e-4;
5. the raises: video MAT (``alg_mat_motion``, a 5-D batch) naming ROADMAP
   Queue 1 item 11 and Queue 2 item 1; ``create_model`` without a card
   and without the CPU asked for.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_mat_common import (BASE, WZ, batch, close, grads_close,
                               init_tree, kink_ties, load_mat, mat_models,
                               small_cfg, to_np)
from joligen_tpu.models import mat_model as jmm
from joligen_tpu.models.modules import mat as jm
from joligen_tpu.models.train_state import make_optimizer as jax_optimizer
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models import mat_model as tmm
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_adam_state_to_torch,
                                              torch_adam_state_to_optax,
                                              torch_to_flax)
from joligen_tpu_torch.models.modules import mat as tm
from joligen_tpu_torch.models.train_state import make_optimizer
from joligen_tpu_torch.options import TrainOptions


def _trees():
    img = np.zeros((1, 32, 32, 3), np.float32)
    m = np.ones((1, 32, 32, 1), np.float32)
    z = np.zeros((1, WZ), np.float32)
    g = init_tree(jm.MATGenerator(base=BASE, w_dim=WZ, z_dim=WZ,
                                  stage1_dim=12), (img, m, z),
                  {"rng": jax.random.PRNGKey(0)}, 1)
    d = init_tree(jm.MATDiscriminator(base=BASE), (img, m, img), {}, 2)
    return g, d


def _equal_trees(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    for path, leaf in fa:
        other = np.asarray(fb[path])
        assert other.dtype == np.asarray(leaf).dtype, path
        assert other.shape == np.shape(leaf), path
        np.testing.assert_array_equal(other, np.asarray(leaf), str(path))


def test_converter_rule_is_exact_both_ways(tmp_path):
    g, d = _trees()
    opt = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
    opt.steps_per_epoch = 1
    for tree, net in ((g, tm.MATGenerator(32, 3, BASE, WZ, WZ,
                                          stage1_dim=12)),
                      (d, tm.MATDiscriminator(32, 3, BASE))):
        tree = jax.device_get(tree)
        sd = flax_to_torch(tree, weight_leaves=True)
        net.load_state_dict(sd, strict=True)       # the port's layouts
        _equal_trees(torch_to_flax(net.state_dict(), True), tree)
        with pytest.raises(ValueError, match="unmapped"):
            flax_to_torch(tree)
        # the Adam state after one update: moments non-zero
        tx = jax_optimizer(opt, 2e-3)
        grads = jax.tree.map(lambda a: jnp.asarray(
            np.random.default_rng(3).standard_normal(a.shape), jnp.float32),
            tree)
        _, state = tx.update(grads, tx.init(tree), tree)
        port = optax_adam_state_to_torch(state, weight_leaves=True)
        adam = make_optimizer(opt, 2e-3, dict(net.named_parameters()))
        adam.load_state_dict(port)
        assert adam.count == 1 and all(float(m.abs().max()) > 0
                                       for m in adam.mu)
        back = torch_adam_state_to_optax(adam.state_dict(),
                                         tx.init(tree), weight_leaves=True)
        _equal_trees(back, state)
    # a conv kernel tree maps as before with or without the rule
    k = {"params": {"c": {"kernel": np.ones((3, 3, 2, 4), np.float32),
                          "bias": np.zeros(4, np.float32)}}}
    for rule in (False, True):
        assert tuple(flax_to_torch(k, rule)["c.weight"].shape) == (4, 2, 3, 3)


def _perturb(net, scale):
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            p.add_(scale * (i + 1) / 100.0)


def test_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    jmodel, tmodel = mat_models(tmp_path, monkeypatch)
    for i, name in enumerate(("G_A", "D")):
        _perturb(tmodel.nets[name], 0.1 + i)
    _perturb(tmodel.ema_nets["G_A"], 0.3)
    tmodel.save_networks("port")
    jmodel.load_networks("port", load_optim=False)
    for name, net, ema in (("G_A", tmodel.nets["G_A"], False),
                           ("G_A", tmodel.ema_nets["G_A"], True),
                           ("D", tmodel.nets["D"], False)):
        state = jmodel.states[name]
        tree = jax.device_get(state.ema_params if ema else state.params)
        want = flax_to_torch(tree, True)
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), (name, ema, k)
    # the JAX model's files into the port's phase-test model (G and EMA)
    jmodel.states["G_A"] = jmodel.states["G_A"].replace(
        params=jax.tree.map(lambda x: x * 0.5, jmodel.states["G_A"].params))
    jmodel.save_networks("jax")
    served = create_model(tmodel.opt, phase="test", device="cpu")
    assert set(served.nets) == {"G_A"}
    served.load_networks("jax")
    state = jax.device_get(jmodel.states["G_A"])
    for net, tree in ((served.nets["G_A"], state.params),
                      (served.ema_nets["G_A"], state.ema_params)):
        want = flax_to_torch(tree, True)
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_r1_penalty_and_its_d_gradient_match_jax():
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    m = np.ones((4, 32, 32, 1), np.float32)
    m[:, 6:20, 10:28] = 0.0
    jd = jm.MATDiscriminator(base=BASE)
    params = init_tree(jd, (real, m, real), {}, 5)
    td = load_mat(tm.MATDiscriminator(32, 3, BASE), params)
    assert kink_ties(td, lambda dt: td(torch.from_numpy(real).to(dt),
                                       torch.from_numpy(m),
                                       torch.from_numpy(real).to(dt))) == 0

    def pen(p):
        def d_real(img):
            a, b = jd.apply(p, img, m, img)
            return jnp.sum(a) + jnp.sum(b)
        g = jax.grad(d_real)(real)
        return jnp.mean(jnp.sum(g ** 2, axis=(1, 2, 3)))
    want, jgrads = jax.jit(jax.value_and_grad(pen))(params)
    x = torch.from_numpy(real).requires_grad_(True)
    a, b = td(x, torch.from_numpy(m), x)
    got = tmm.r1_penalty(a.sum() + b.sum(), x)
    got.backward()
    close(to_np(got), want, 1e-4)
    assert float(want) > 0
    grads_close(jgrads, td, 1e-4)


@pytest.mark.parametrize("rampup", [0.0, 0.05])
def test_ema_beta_matches_jax(rampup):
    stub = types.SimpleNamespace(ema_kimg=10.0, ema_rampup=rampup)
    for step, b in ((0, 8), (3, 8), (500, 8), (0, 2), (9999, 2)):
        want = float(jmm.MATModel._ema_beta(stub, jnp.asarray(step, jnp.int32),
                                            b))
        got = tmm.MATModel._ema_beta(stub, step, b)
        assert abs(got - want) <= 1e-6, (step, b, got, want)


def test_set_input_noise_modes_and_a_none_request(tmp_path, monkeypatch):
    extra = {"alg": {"mat": {"noise_mode_eval": "none",
                             "mask_class_conditioning": True}}}
    jmodel, tmodel = mat_models(tmp_path, monkeypatch, extra)
    b = batch(7, classes=3)
    got = tmodel.set_input(b)
    want = jmodel.set_input(b)
    assert set(got) == set(want) == {"real", "mask", "mask_class"}
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    hole = b["B_label_mask"] > 0
    assert (got["mask"][hole] == 0).all() and (got["mask"][~hole] == 1).all()
    assert (got["mask_class"][~hole] == 0).all()
    assert (got["mask_class"][hole] == b["B_label_mask"][hole]).all()

    gen = torch.Generator().manual_seed(1)
    assert tmodel._noise("none", 2, None, gen) is None
    c1, c2 = (tmodel._noise("const", 2, None, gen) for _ in range(2))
    r1, r2 = (tmodel._noise("random", 2, None, gen) for _ in range(2))
    assert torch.equal(c1["inj_mul_map"], c2["inj_mul_map"])
    assert all(torch.equal(x, y) for x, y in zip(c1["noise"], c2["noise"]))
    assert not torch.equal(r1["noise"][0], r2["noise"][0])
    assert set(r1["inj_mul_map"].unique().tolist()) == {0.0, 1.0}

    seed = 5
    want = jmodel.inference(b, seed=seed)
    got = tmodel.inference(b, seed=seed, draws={"z": torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(seed), (2, WZ))))})
    close(got, want, 1e-4)
    keep = np.broadcast_to(~hole, b["B"].shape)
    np.testing.assert_array_equal(got[keep], b["B"][keep])


def test_raises(tmp_path, monkeypatch):
    cfg = small_cfg(tmp_path, {"alg": {"mat": {"motion": True}}})
    opt = TrainOptions().parse_json(cfg, verbose=False)
    with pytest.raises(NotImplementedError,
                       match="item 11.*Queue 2 item 1"):
        create_model(opt, device="cpu")
    opt = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
    opt.steps_per_epoch = 1
    model = create_model(opt, phase="test", device="cpu")
    clip = {"B": np.zeros((1, 3, 32, 32, 3), np.float32),
            "B_label_mask": np.zeros((1, 3, 32, 32, 1), np.int32)}
    with pytest.raises(NotImplementedError, match="item 11"):
        model.set_input(clip)
    with pytest.raises(NotImplementedError, match="item 11"):
        model.nets["G_A"](torch.zeros(1, 3, 32, 32, 3),
                          torch.ones(1, 3, 32, 32, 1), torch.zeros(1, WZ))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(opt, phase="test")
    assert create_model(opt, phase="test", cpu=True).device.type == "cpu"
