"""Helpers shared by ``tests/test_torch_cm_model.py`` and
``tests/test_torch_cm_gan.py``: the consistency models' small config (16 px,
ngf 8, mults 1,2, head dim 16, batch 2, masked inpainting conditioned on A,
6 input channels as the example configs, fp32), the JAX and port models
from the same weights, the draws of the JAX step, and the trajectory of
``CMModel.optimize_prepared`` against the JAX model's jitted step
(``_make_step``), each step's draws made with ``jax.random`` from the key
the JAX step splits.

Tolerances, as ``tests/test_torch_gan_cut.py``: every loss 1e-4 (relative);
every parameter and the EMA 1e-4, except that an element whose gradient
cancels to within rounding noise may take Adam's sign-like first steps the
other way (within 2 x lr a step) in at most 1 % of a leaf's elements.
Elements whose exact gradient is 0 carry only rounding noise and are held
to 2 x lr a step: the key third of each attention ``qkv`` bias (a key bias
shifts every score of a query alike, which the softmax ignores) and the
basic D's conv biases before an InstanceNorm.
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_gan_common import (fast_init_net_state, load_flax, merge,
                               pool_draws, to_np)
from joligen_tpu.models import cm_model as jcm_model
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models.modules import cm as jcm
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions

SIZE, BATCH, LR = 16, 2, 2e-4
FLIP_SHARE = 1e-2
BASE = {
    "model_type": "cm", "name": "cm",
    "data": {"crop_size": SIZE, "load_size": SIZE},
    "G": {"netG": "unet_mha", "ngf": 8,
          "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                       "attn_res": [2], "num_head_channels": 16,
                       "group_norm_size": 4}},
    "alg": {"diffusion": {"task": "inpainting", "cond_embed_dim": 32},
            "cm": {"num_steps": 400000}},
    "train": {"batch_size": BATCH, "G_ema": True, "G_ema_beta": 0.9,
              "optim": "adamw", "optim_weight_decay": 0.01, "G_lr": LR,
              "D_lr": LR},
    "tpu": {"bf16": False},
}


def small_cfg(tmp, extra=None):
    cfg = merge(copy.deepcopy(BASE), copy.deepcopy(extra or {}))
    cfg["checkpoints_dir"] = str(tmp)
    return cfg


def models(cfg, monkeypatch):
    """(JAX model, port model) of ``cfg`` with the same seeded weights (the
    JAX init replaced by ``fast_init_net_state``)."""
    monkeypatch.setattr(jcm_model, "init_net_state", fast_init_net_state(7))
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    tm = create_model(opt, device="cpu")
    assert list(tm.nets) == list(jm.states)
    for name, net in tm.nets.items():
        load_flax(net, jm.states[name].params)
    load_flax(tm.ema_nets["G_A"], jm.states["G_A"].ema_params)
    return jm, tm


def batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((BATCH, SIZE, SIZE, 1), np.int32)
    mask[0, 2:10, 3:12] = 1
    mask[1, 6:15, 1:7] = 1
    return {"A": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(
                np.float32),
            "B": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(
                np.float32),
            "B_label_mask": mask}


def _t(a):
    return torch.from_numpy(np.array(a))


def step_draws(key, jm, tm):
    """The draws of the JAX step for ``key``: split in 3; the consistency
    forward splits rngs[0] into the timesteps' (or ECT's t's) and the
    noise's keys; the pool takes rngs[1]."""
    rngs = jax.random.split(key, 3)
    rng_t, rng_n = jax.random.split(rngs[0])
    if jm.is_ect:
        draws = {"t_normal": _t(jax.random.normal(rng_t, (BATCH,)))}
    else:
        n = jcm.improved_timesteps_schedule(jm.step_count, jm.total_steps)
        probs = jcm.lognormal_timestep_probs(jcm.karras_schedule(n))
        draws = {"timesteps": _t(jax.random.choice(
            rng_t, n - 1, shape=(BATCH,), p=jnp.asarray(probs)))}
    draws["noise"] = _t(jax.random.normal(rng_n, (BATCH, SIZE, SIZE, 3)))
    if jm.with_gan:
        draws["pool"] = pool_draws(rngs[1], BATCH, tm.pool.pool_size)
    return draws


def _zero_gradient(name, pname, shape, n_layers):
    """The elements of a leaf whose exact gradient is 0 (module doc)."""
    zero = np.zeros(shape, bool)
    if pname.endswith(".qkv.bias"):
        c = shape[0] // 3
        zero[c:2 * c] = True
    if name.startswith("D_B_basic") and pname in {
            f"Conv_{i}.bias" for i in range(1, n_layers + 1)}:
        zero[:] = True
    return zero


def params_close(states, tm, i):
    """Every parameter of the port's nets and G's EMA against the JAX
    states after step ``i`` (module doc)."""
    bad = []
    nets = dict(tm.nets, G_A_ema=tm.ema_nets["G_A"])
    bound = 2 * LR * (i + 1)
    for name, net in nets.items():
        tree = (states["G_A"].ema_params if name == "G_A_ema"
                else states[name].params)
        want = flax_to_torch(jax.device_get(tree))
        for pname, p in net.named_parameters():
            diff = np.abs(to_np(p) - want[pname].numpy())
            zero = _zero_gradient(name, pname, diff.shape,
                                  tm.opt.D_n_layers)
            if (diff[zero] > bound + 1e-6).any():
                bad.append((i, name, pname, "zero", float(diff.max())))
            off = diff[~zero] > 1e-4
            if off.size and off.mean() > FLIP_SHARE:
                bad.append((i, name, pname, int(off.sum()), off.size))
            if (diff[~zero] > bound + 1e-4).any():
                bad.append((i, name, pname, float(diff.max())))
    assert not bad, bad


def snapshot(tm):
    return {n: [p.detach().clone() for p in net.parameters()]
            for n, net in tm.nets.items()}


def run_trajectory(jm, tm, steps, check=None):
    """``steps`` steps of both models on the same batches and draws; after
    each, the losses and parameters (module doc), then ``check(i, before,
    pool)`` with the port's parameters before the step and the JAX pool."""
    assert tm.conditional and jm.conditional
    assert tm.is_ect == jm.is_ect and tm.with_gan == jm.with_gan
    stage = (jm.ect_stage if jm.is_ect else jcm.improved_timesteps_schedule(
        jm.step_count, jm.total_steps))
    step = jm._make_step(stage)
    # committed like the step's outputs, so the step compiles once
    states, pool = jax.device_put(
        (jm.states, jm.pool if jm.with_gan else None), jax.devices()[0])
    for i in range(steps):
        b = batch(20 + i)
        key = jax.random.PRNGKey(300 + i)
        draws = step_draws(key, jm, tm)
        inp = jm.set_input(b)
        states, pool, jlosses = step(
            states, pool, key, *(jnp.asarray(inp[k])
                                 for k in ("gt", "y_cond", "mask")))
        jm.step_count += BATCH
        before = snapshot(tm)
        tlosses = tm.optimize_prepared(tm.prepare_batch(b), draws)
        assert set(tlosses) == set(jlosses)
        for k, v in jlosses.items():
            assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(tlosses[k]), float(v))
        params_close(states, tm, i)
        if check is not None:
            check(i, before, pool)
    assert tm.step_count == steps * BATCH
