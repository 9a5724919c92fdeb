"""The port's radam, lion, madgrad and muon (models/train_state.py) against
the JAX package's make_optimizer (optax 0.2.6 and its own madgrad): 12
updates with fixed host gradients over a tree with a 1-D bias, a 2-D Dense,
an nn.scan stack (3-D kernels, 2-D biases) and a 4-D conv, with and
without a bf16 first moment and MultiSteps; the port's state dict round
trip; a JAX ``_optim.pkl`` read by ``BaseModel.load_networks``'s
unpickler (no optax class), then one more update equal to JAX's; and
Muon's adam/muon split against optax's on the real small-width JiTViD
tree.

Tolerances: parameters after 12 updates atol 2e-5 (the Adam allowance of
tests/test_torch_train_state.py: one bf16 rounding of mu can fall either
way); for Lion, whose update is a sign, at most 1 % of a leaf's elements
may differ by more, each by at most 2 x lr a step.
"""

import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.models import train_state as jts
from joligen_tpu_torch.models import train_state as tts
from joligen_tpu_torch.models.base import _PlainUnpickler
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_state_to_torch,
                                              torch_to_flax)
from joligen_tpu_torch.models.modules.unet_mha import Conv, Dense

LR = 1e-3
STEPS = 12


def _opt(**kw):
    base = dict(train_optim="adamw", train_beta1=0.9, train_beta2=0.999,
                train_optim_eps=1e-8, train_optim_weight_decay=0.01,
                train_lr_policy="linear", train_n_epochs=2,
                train_n_epochs_decay=4, steps_per_epoch=2,
                tpu_optim_moment_dtype="float32", train_iter_size=1)
    base.update(kw)
    return SimpleNamespace(**base)


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv = Dense(4, 6)


class _Net(nn.Module):
    """flax tree: Conv_0 (4-D kernel, bias), Dense_0 (2-D kernel, 1-D bias),
    blocks1/block/qkv (a scan stack of 2: 3-D kernel, 2-D bias) and a raw
    2-D table y_embed."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(2, 4, 3)
        self.Dense_0 = Dense(4, 3)
        self.blocks1 = nn.ModuleList([_Block(), _Block()])
        self.y_embed = nn.Parameter(torch.zeros(5, 3))


def _host_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"Conv_0": {"kernel": f(3, 3, 2, 4), "bias": f(4)},
            "Dense_0": {"kernel": f(4, 3), "bias": f(3)},
            "blocks1": {"block": {"qkv": {"kernel": f(2, 4, 6),
                                          "bias": f(2, 6)}}},
            "y_embed": f(5, 3)}


def _jax_run(opt, params, iter_size):
    tx = jts.make_optimizer(opt, LR, iter_size=iter_size)
    p = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda st, g: jts.apply_updates(st, g, tx))
    return step, tx, jts.NetState(params=p, opt_state=tx.init(p),
                                  step=jnp.zeros((), jnp.int32))


def _port_run(opt, params, iter_size):
    net = _Net()
    net.load_state_dict(flax_to_torch(params))
    tx = tts.make_optimizer(opt, LR, dict(net.named_parameters()),
                            iter_size=iter_size)
    return net, tts.NetState(net, None, tx)


def _port_step(state, grads_tree):
    g = flax_to_torch(grads_tree)
    tts.apply_updates(state, [g[n] for n, _ in state.net.named_parameters()])


def _assert_close(net, jax_params, optim, updates):
    got = torch_to_flax(net.state_dict())["params"]
    want = jax.device_get(jax_params)

    def check(a, b):
        b = np.asarray(b)
        bad = np.abs(a - b) > 2e-5
        if optim != "lion":
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
            return
        assert bad.sum() <= 0.01 * a.size, bad.sum()
        assert np.abs(a - b).max() <= 2 * LR * updates + 2e-5
    jax.tree.map(check, got, want)


CASES = [(o, m, i) for o in ("radam", "lion", "madgrad", "muon")
         for m in ("float32", "bfloat16") for i in (1, 2)
         if m == "float32" or o in ("radam", "lion")]


@pytest.mark.parametrize("optim,moment,iter_size", CASES)
def test_twelve_updates_match_jax(optim, moment, iter_size):
    opt = _opt(train_optim=optim, tpu_optim_moment_dtype=moment,
               train_beta2=0.95 if optim == "muon" else 0.999)
    params = _host_tree(1)
    jstep, _, js = _jax_run(opt, params, iter_size)
    net, ps = _port_run(opt, params, iter_size)
    rng = np.random.default_rng(2)
    for k in range(STEPS * iter_size):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        js = jstep(js, jax.tree.map(jnp.asarray, g))
        _port_step(ps, g)
    _assert_close(net, js.params, optim, STEPS)
    # the port's own state dict: a second optimizer loads it bit for bit
    state = ps.tx.state_dict()
    other = tts.make_optimizer(opt, LR, dict(_Net().named_parameters()),
                               iter_size=iter_size)
    other.load_state_dict(pickle.loads(pickle.dumps(state)))
    again = other.state_dict()
    jax.tree.map(np.testing.assert_array_equal, state, again)


def test_muon_labels_follow_the_flax_rank():
    """Muon takes the 2-D flax leaves: the top-level Dense kernel
    (transposed), the raw table and the scan stack's bias (the stack's 2
    biases as one matrix); adam the rest."""
    net = _Net()
    labels = {"/".join(p): (lab, st, tr) for p, _, st, tr, lab in
              tts.muon_labels([(n, p.dim())
                               for n, p in net.named_parameters()])}
    tx = jax.eval_shape(lambda: jts.make_optimizer(
        _opt(train_optim="muon"), LR).init(jax.tree.map(
            jnp.asarray, _host_tree(0))))
    want = jax.tree_util.tree_flatten_with_path(
        tx.inner_states["muon"].inner_state[0].mu,
        is_leaf=lambda x: type(x).__name__ == "MaskedNode")[0]
    want = {"/".join(k.key for k in path):
            "adam" if type(v).__name__ == "MaskedNode" else "muon"
            for path, v in want}
    assert {k: v[0] for k, v in labels.items()} == want
    assert labels["blocks1/block/qkv/bias"] == ("muon", True, False)
    assert labels["Dense_0/kernel"] == ("muon", False, True)


def _write_optim(path, states):
    with open(path, "wb") as f:
        pickle.dump(states, f)


@pytest.mark.parametrize("optim,iter_size", [
    ("adam", 1), ("adamw", 2), ("radam", 1), ("radam", 2), ("lion", 1),
    ("lion", 2), ("madgrad", 1), ("madgrad", 2), ("muon", 1), ("muon", 2)])
def test_jax_optim_pkl_loads_and_steps(tmp_path, optim, iter_size):
    """3 JAX updates, its state pickled as ``BaseModel.save_networks``
    does (bf16 moments for lion and radam), read by the port's unpickler
    with no optax class, loaded, then one more update equal to JAX's."""
    moment = "bfloat16" if optim in ("radam", "lion") else "float32"
    opt = _opt(train_optim=optim, tpu_optim_moment_dtype=moment)
    params = _host_tree(3)
    jstep, _, js = _jax_run(opt, params, iter_size)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params) for _ in range(4 * iter_size)]
    for g in grads[:3 * iter_size]:
        js = jstep(js, jax.tree.map(jnp.asarray, g))
    _write_optim(tmp_path / "latest_optim.pkl",
                 {"G_A": jax.device_get(js.opt_state)})
    with open(tmp_path / "latest_optim.pkl", "rb") as f:
        loaded = _PlainUnpickler(f).load()["G_A"]
    net, ps = _port_run(opt, jax.device_get(js.params), iter_size)
    ps.tx.load_state_dict(optax_state_to_torch(loaded))
    for g in grads[3 * iter_size:]:
        js = jstep(js, jax.tree.map(jnp.asarray, g))
        _port_step(ps, g)
    _assert_close(net, js.params, optim, 1)


def test_unpickler_refuses_other_classes(tmp_path):
    path = tmp_path / "x_optim.pkl"
    _write_optim(path, {"G_A": SimpleNamespace(a=1)})
    with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError):
        _PlainUnpickler(f).load()


def test_muon_labels_on_jitvid_match_optax():
    """The small-width JiTViD of tests/test_torch_vit_vid.py (a segment of
    1 block and a scan stack of 2): the port's labels of its torch
    parameters, by their flax leaves, equal optax's partition of the JAX
    tree (jax.eval_shape)."""
    from test_torch_vit_vid import CIN, SMALL, _small_pair
    from joligen_tpu_torch.models.modules.vit_vid import JiTViD

    _, tree = _small_pair()
    state = jax.eval_shape(lambda t: jts.make_optimizer(
        _opt(train_optim="muon"), LR).init(t),
        jax.tree.map(jnp.asarray, tree))
    want = jax.tree_util.tree_flatten_with_path(
        state.inner_states["muon"].inner_state[0].mu,
        is_leaf=lambda x: type(x).__name__ == "MaskedNode")[0]
    want = {tuple(k.key for k in path)[1:]:
            "adam" if type(v).__name__ == "MaskedNode" else "muon"
            for path, v in want}
    with torch.device("meta"):
        net = JiTViD(CIN, **SMALL)
    got = {p: lab for p, _, _, _, lab in tts.muon_labels(
        [(n, p.dim()) for n, p in net.named_parameters()])}
    assert got == want
    assert got[("blocks1", "block", "qkv", "kernel")] == "adam"
    assert got[("blocks1", "block", "qkv", "bias")] == "muon"
    assert got[("y_embed",)] == "muon"
