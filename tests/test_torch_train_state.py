"""The port's train state (models/train_state.py) against the JAX package's
(joligen_tpu/models/train_state.py, optax): the LR schedules of every
policy, 12 adam/adamw steps with fixed host gradients (fp32 moments and a
bf16 first moment, train_iter_size 1 and 2) with the EMA, and the optax <->
port optimizer-state converter (models/convert.py).

Tolerances: schedules rtol 1e-6 (both float32); parameters, EMA and moments
after 12 steps atol 2e-6 with fp32 moments (the update is ~lr = 1e-3 per
step; the two differ only in fp32 rounding), 2e-5 with a bf16 first moment
(one bf16 rounding of mu, 2**-8 relative, can fall either way).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from joligen_tpu.models import train_state as jts
from joligen_tpu_torch.models import train_state as tts
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_adam_state_to_torch,
                                              torch_adam_state_to_optax,
                                              torch_to_flax)
from joligen_tpu_torch.models.modules.unet_mha import Conv, Dense


def _opt(**kw):
    base = dict(train_optim="adamw", train_beta1=0.9, train_beta2=0.999,
                train_optim_eps=1e-8, train_optim_weight_decay=0.01,
                train_lr_policy="linear", train_n_epochs=2,
                train_n_epochs_decay=4, steps_per_epoch=2,
                train_lr_decay_iters=2, train_lr_steps=[1, 3],
                tpu_optim_moment_dtype="float32", train_iter_size=1)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("policy", ["linear", "step", "multistep", "cosine",
                                    "plateau"])
def test_lr_schedules_match_jax(policy):
    opt = _opt(train_lr_policy=policy, steps_per_epoch=3, train_n_epochs=4,
               train_n_epochs_decay=5)
    want = jts.make_lr_schedule(opt, 2e-4)
    got = tts.make_lr_schedule(opt, 2e-4)
    steps = [0, 1, 5, 11, 12, 13, 20, 26, 40]
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(jnp.int32(s))) for s in steps],
                               rtol=1e-6, atol=0)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(2, 4, 3)
        self.Dense_0 = Dense(4, 3)


def _host_params(seed):
    rng = np.random.default_rng(seed)
    return {"params": {
        "Conv_0": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(
            np.float32), "bias": rng.standard_normal(4).astype(np.float32)},
        "Dense_0": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                    "bias": rng.standard_normal(3).astype(np.float32)}}}


def _host_grads(n, seed):
    rng = np.random.default_rng(seed)
    like = _host_params(0)
    return [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), like) for _ in range(n)]


def _jax_state(opt, params, iter_size):
    """The JAX optimizer and state, and its step jitted as the JAX training
    step is (XLA's rounding under jit is what the port follows)."""
    tx = jts.make_optimizer(opt, 1e-3, iter_size=iter_size)
    p = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda st, g: jts.apply_updates(st, g, tx, ema_beta=0.9))
    return step, tx, jts.NetState(params=p, opt_state=tx.init(p),
                                  ema_params=jax.tree.map(jnp.copy, p),
                                  step=jnp.zeros((), jnp.int32))


def _port_state(opt, params, iter_size):
    net = _Net()
    net.load_state_dict(flax_to_torch(params))
    ema = _Net().requires_grad_(False)
    ema.load_state_dict(net.state_dict())
    tx = tts.make_optimizer(opt, 1e-3, dict(net.named_parameters()),
                            iter_size=iter_size)
    return tts.NetState(net, ema, tx)


def _port_step(state, grads_tree):
    g = flax_to_torch(grads_tree)
    tts.apply_updates(state, [g[n] for n, _ in state.net.named_parameters()],
                      ema_beta=0.9)


def _assert_trees_close(port_module, jax_tree, atol):
    got = torch_to_flax(port_module.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=atol, rtol=0), got, jax.device_get(jax_tree))


@pytest.mark.parametrize("optim", ["adam", "adamw"])
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("iter_size", [1, 2])
def test_twelve_steps_match_optax(optim, moment, iter_size):
    opt = _opt(train_optim=optim, tpu_optim_moment_dtype=moment)
    params = _host_params(1)
    jstep, _, js = _jax_state(opt, params, iter_size)
    ps = _port_state(opt, params, iter_size)
    atol = 2e-6 if moment == "float32" else 2e-5
    for g in _host_grads(12, seed=2):
        js = jstep(js, jax.tree.map(jnp.asarray, g))
        _port_step(ps, g)
        _assert_trees_close(ps.net, js.params, atol)
        _assert_trees_close(ps.ema, js.ema_params, atol)
    assert ps.step == int(js.step) == 12
    # the inner optimizer counted real updates only (the schedule's count)
    mine = ps.tx.state_dict()
    if iter_size > 1:
        assert mine["gradient_step"] == 6 and mine["mini_step"] == 0
        mine = mine["inner"]
    assert mine["count"] == 12 // iter_size
    theirs = optax_adam_state_to_torch(jax.device_get(js.opt_state))
    theirs = theirs["inner"] if iter_size > 1 else theirs
    assert theirs["count"] == mine["count"]
    for k in mine["mu"]:
        np.testing.assert_allclose(mine["mu"][k], theirs["mu"][k], atol=atol)
        np.testing.assert_allclose(mine["nu"][k], theirs["nu"][k],
                                   atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("moment,iter_size", [("float32", 1),
                                              ("bfloat16", 2)])
def test_optimizer_state_converter_round_trip(moment, iter_size):
    """Start both packages from one mid-run optimizer state: JAX runs 5
    steps, its state goes to the port through the converter and back
    unchanged, then both run 5 more steps and agree."""
    opt = _opt(tpu_optim_moment_dtype=moment)
    jstep, tx, js = _jax_state(opt, _host_params(3), iter_size)
    grads = _host_grads(10, seed=4)
    for g in grads[:5]:
        js = jstep(js, jax.tree.map(jnp.asarray, g))
    host = jax.device_get(js)
    ps = _port_state(opt, host.params, iter_size)
    ps.ema.load_state_dict(flax_to_torch(host.ema_params))
    ps.tx.load_state_dict(optax_adam_state_to_torch(host.opt_state))
    back = torch_adam_state_to_optax(ps.tx.state_dict(),
                                     tx.init(js.params))
    assert jax.tree.structure(back) == jax.tree.structure(host.opt_state)
    jax.tree.map(lambda a, b: (np.testing.assert_array_equal(
        np.asarray(a, np.float32), np.asarray(b, np.float32)),
        np.testing.assert_equal(np.asarray(a).dtype, np.asarray(b).dtype)),
        back, host.opt_state)
    for g in grads[5:]:
        js = jstep(js, jax.tree.map(jnp.asarray, g))
        _port_step(ps, g)
    atol = 2e-6 if moment == "float32" else 2e-5
    _assert_trees_close(ps.net, js.params, atol)
    _assert_trees_close(ps.ema, js.ema_params, atol)


def test_unported_optimizers_raise():
    net = _Net()
    for name in ("radam", "lion", "madgrad", "muon"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            tts.make_optimizer(_opt(train_optim=name), 1e-3,
                               dict(net.named_parameters()))
