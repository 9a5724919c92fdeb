"""Helpers of ``tests/test_torch_recut.py``, ``_recycle_gan.py`` and
``_cut_options.py``: nuplet batches, the JAX CUT step's draws with the
options of ReCUT's slice (flips, ReCUT's NCE ids, D diffusion, APA), the
elements whose gradient is exactly 0, the port's state and the JAX step's
as one dict, and the 3-step trajectory of the port against the JAX step,
held as ``tests/_torch_glasses_common.py::run_trajectory`` holds the
glasses trajectories: each step's losses (to 1e-4 relative) and pools
(to 1e-3) from the state the two packages share before it; the weights
on the port's own run, never resynced, with the Adam allowance of
``ROADMAP.md`` Queue 3 (at most 1 % of a leaf's elements past 1e-4, none
past 2 x lr a step; the exact-zero gradients to 2 x lr a step)."""

import copy
import functools
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_gan_common import (aug_draws, fast_init_net_state, load_flax,
                               patch_ids, pool_draws, to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models.modules import unet_mha as junet
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_adam_state_to_torch)
from joligen_tpu_torch.models.modules import unet_mha as tunet
from joligen_tpu_torch.options import TrainOptions

SIZE, NUPLET, STEPS, LR = 32, 3, 3, 2e-4
FLIP_SHARE = 1e-2
# 4 channels a group in the unet_128 P nets at ngf 8 (ROADMAP.md Queue 3:
# one channel a group makes the conv biases before it exact-zero
# gradients, noise that Adam turns into full steps)
GROUP_SIZE = 4


def build_models(tmp, cfg, jax_module):
    """The JAX model (its nets' init without XLA: seeded trees, no init
    scheme) and the port's on the same weights, both packages' UNetMHA at
    GROUP_SIZE channels a group."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_module, "init_net_state", fast_init_net_state(400))
        mp.setattr(jax_module, "scheme_from_opt",
                   lambda state, key, opt: state)
        for mod in (junet, tunet):
            mp.setattr(mod, "UNetMHA", functools.partial(
                mod.UNetMHA, group_size=GROUP_SIZE))
        jopt = JaxTrainOptions().parse_json(copy.deepcopy(cfg),
                                            verbose=False)
        jopt.steps_per_epoch = 4
        jm = jax_create_model(jopt)
        opt = TrainOptions().parse_json(copy.deepcopy(cfg), verbose=False)
        opt.steps_per_epoch = 4
        tm = create_model(opt, device="cpu")
    assert set(tm.nets) == set(jm.states)
    for name, net in tm.nets.items():
        load_flax(net, jm.states[name].params)
    for name, net in tm.ema_nets.items():
        load_flax(net, jm.states[name].ema_params)
    return jm, tm


def nuplet_batch(seed, batch, masks=True):
    """A and B nuplets (batch, NUPLET, SIZE, SIZE, 3) and rectangle label
    masks (1 inside) of both."""
    rng = np.random.default_rng(seed)
    shape = (batch, NUPLET, SIZE, SIZE, 3)
    out = {k: rng.uniform(-1, 1, shape).astype(np.float32) for k in "AB"}
    if masks:
        for k in ("A_label_mask", "B_label_mask"):
            m = np.zeros(shape[:-1] + (1,), np.int64)
            for b in range(batch):
                y, x = rng.integers(0, SIZE // 2, 2)
                m[b, :, y:y + SIZE // 3, x:x + SIZE // 3] = 1
            out[k] = m
    return out


def _qsample_draws(key, p, shape):
    """``_qsample(x, key)``'s draws (``cut_model.py:832-846``) at the
    diffusion p ``p``: t (0 for an image left clean) and the noise."""
    k1, k2, k3 = jax.random.split(key, 3)
    b = shape[0]
    t_cur = 10 + p * (1000 - 10)
    ar = jnp.arange(1, 1001, dtype=jnp.float32)
    logw = jnp.where(ar <= t_cur, jnp.log(ar), -jnp.inf)
    t = jax.random.categorical(k1, logw[None], axis=-1, shape=(b,)) + 1
    frac = jnp.minimum(p * 64.0, 48.0) / 64.0
    t = jnp.where(jax.random.uniform(k2, (b,)) < frac, t, 0)
    eps = jax.random.normal(k3, shape, jnp.float32)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(eps)))


def cut_draws(key, jm, tm, n, pool_count, d_diff_p):
    """The JAX CUT step's draws for ``key`` (``cut_model.py:502-950``) at a
    folded batch of ``n`` images, the pool holding ``pool_count`` images
    and the diffusion p at ``d_diff_p`` before the step: rngs[0] split for
    the flip, G's augmentation, each D but a mask D, then the two NCE
    calls (ReCUT's ids from fold_in(that key, 1717)); rngs[1] the pool,
    rngs[2] and
    rngs[3] D's DiffAugment, fold_in(rngs[4], 7) the diffusion noise,
    rngs[6] and rngs[7] APA, and fold_in(rngs[6], crc32(name) % 1000) the
    gumbel noise of a mask D ``name``."""
    rngs = jax.random.split(key, 8)
    shape = (n, SIZE, SIZE, 3)
    r = rngs[0]
    draws = {}
    if tm.flip_equivariance:
        r, rf = jax.random.split(r)
        draws["flip"] = torch.tensor(bool(jax.random.bernoulli(rf)))
    r, rng_aug = jax.random.split(r)
    for name in jm.netDs:
        if "mask" not in name:      # the mask D has no G term
            r, _ = jax.random.split(r)
    rng_nce, rng_idt = jax.random.split(r)
    feats = tm.nets["G_A"](torch.zeros(1, SIZE, SIZE, 3),
                           extract_layer_ids=tm.nce_layers)
    hws = [f.shape[1] * f.shape[2] for f in feats]
    draws["nce"] = patch_ids(rng_nce, hws, tm.num_patches)
    draws["nce_idt"] = patch_ids(rng_idt, hws, tm.num_patches)
    if tm.recut:
        draws["nce_recut"] = patch_ids(jax.random.fold_in(r, 1717), hws,
                                       tm.num_patches)
    draws["pool"] = pool_draws(rngs[1], n, tm.pool.pool_size)
    if tm.diff_policy:
        for k, rk in (("g_aug", rng_aug), ("d_real_aug", rngs[2]),
                      ("d_fake_aug", rngs[3])):
            draws[k] = aug_draws(rk, shape, tm.diff_policy, tm.diff_prob)
    if tm.d_diffusion:
        ka, kb = jax.random.split(jax.random.fold_in(rngs[4], 7))
        p = jnp.asarray(d_diff_p, jnp.float32)
        draws["d_diffusion"] = {"real": _qsample_draws(ka, p, shape),
                                "fake": _qsample_draws(kb, p, shape)}
    if tm.apa:
        count = min(pool_count + n, tm.pool.pool_size)
        draws["apa"] = {
            "idx": torch.from_numpy(np.array(jax.random.randint(
                rngs[6], (n,), 0, max(count, 1)))).long(),
            "u": torch.from_numpy(np.array(jax.random.uniform(
                rngs[7], (n,))))}
    for name in jm.netDs:
        if "mask" in name:
            key_g = jax.random.fold_in(rngs[6],
                                       zlib.crc32(name.encode()) % 1000)
            draws.setdefault("gumbel", {})[name] = torch.from_numpy(
                np.array(jax.random.uniform(
                    key_g, (n, SIZE, SIZE, tm.nclasses_fs),
                    minval=1e-6, maxval=1.0 - 1e-6)))
    return draws


def zero_grad_masks(tm):
    """{net.parameter: element mask} of the gradients that are exactly 0:
    the conv biases right before an InstanceNorm (the resnet Gs' but their
    heads), the basic and mask Ds' middle conv biases, and with the
    contrastive D its last conv bias too (the contrastive loss is unchanged
    when every logit shifts alike), and the key third of each attention ``qkv`` bias
    (it shifts all of a query's scores alike)."""
    out = {}
    for name, net in tm.nets.items():
        resnet_g = name.startswith("G_") and "resnet" in tm.opt.G_netG
        for n, p in net.named_parameters():
            if n.endswith("qkv.bias"):
                m = torch.zeros(p.shape, dtype=bool)
                m[p.numel() // 3:2 * p.numel() // 3] = True
                out[f"{name}.{n}"] = m
            elif resnet_g and n.endswith(".bias") and ".head." not in n:
                out[f"{name}.{n}"] = torch.ones(p.shape, dtype=bool)
            elif ("basic" in name or "mask" in name) and any(
                    n == f"Conv_{i}.bias"
                    for i in range(1, tm.opt.D_n_layers + 1
                                   + getattr(tm, "contrastive_d", False))):
                out[f"{name}.{n}"] = torch.ones(p.shape, dtype=bool)
    return out


def pools(tm):
    return [tm.pool_A, tm.pool_B] if hasattr(tm, "pool_A") else [tm.pool]


def port_state(tm):
    """A copy of everything a port step changes: each net's parameters and
    EMA, its optimizer state and step count, the pools, APA's and the
    diffusion noise's p."""
    return copy.deepcopy({
        "nets": {n: net.state_dict() for n, net in tm.nets.items()},
        "ema": {n: net.state_dict() for n, net in tm.ema_nets.items()},
        "tx": {n: s.tx.state_dict() for n, s in tm.states.items()},
        "step": {n: s.step for n, s in tm.states.items()},
        "pools": [(p.buffer, p.count) for p in pools(tm)],
        "p": (getattr(tm, "apa_p", None), getattr(tm, "d_diff_p", None))})


def set_port_state(tm, state):
    for name, net in tm.nets.items():
        net.load_state_dict(state["nets"][name])
        tm.states[name].tx.load_state_dict(copy.deepcopy(state["tx"][name]))
        tm.states[name].step = state["step"][name]
    for name, net in tm.ema_nets.items():
        net.load_state_dict(state["ema"][name])
    for pool, (buf, count) in zip(pools(tm), state["pools"]):
        pool.buffer.copy_(buf)
        pool.count = count
    if state["p"][0] is not None:
        tm.apa_p, tm.d_diff_p = (p.clone() for p in state["p"])


def jax_state(tm, states, jpools, p=(None, None)):
    """The JAX step's state (params, EMA, optax adam state, pools, the
    two p) as a ``port_state``."""
    states, jpools = jax.device_get((states, jpools))
    return {
        "nets": {n: flax_to_torch(states[n].params) for n in tm.nets},
        "ema": {n: flax_to_torch(states[n].ema_params) for n in tm.ema_nets},
        "tx": {n: optax_adam_state_to_torch(states[n].opt_state)
               for n in tm.states},
        "step": {n: int(states[n].step) for n in tm.states},
        "pools": [(torch.from_numpy(np.array(q.buffer)), int(q.count))
                  for q in jpools],
        "p": tuple(None if v is None else torch.tensor(float(v))
                   for v in p)}


def check_weights(tm, states, i, zero):
    """Every parameter (and EMA) of the port's own run against the JAX
    step's, with the Adam allowance."""
    bad = []
    nets = dict(tm.nets)
    nets.update({f"{n}_ema": net for n, net in tm.ema_nets.items()})
    for name, net in nets.items():
        tree = (states[name[:-4]].ema_params if name.endswith("_ema")
                else states[name].params)
        want = flax_to_torch(jax.device_get(tree))
        for pname, p in net.named_parameters():
            diff = np.abs(to_np(p) - want[pname].numpy())
            mask = zero.get(f"{name.removesuffix('_ema')}.{pname}")
            mask = (np.zeros(diff.shape, bool) if mask is None
                    else mask.numpy())
            off = mask & (diff > 2 * LR * (i + 1) + 1e-6)
            rest = diff[~mask]
            if rest.size and (rest > 1e-4).mean() > FLIP_SHARE:
                bad.append((i, name, pname, int((rest > 1e-4).sum()),
                            rest.size))
            off |= ~mask & (diff > 2 * LR * (i + 1) + 1e-4)
            if off.any():
                bad.append((i, name, pname, float(diff.max())))
    assert not bad, bad


def check_losses(i, tlosses, jlosses):
    assert set(tlosses) == set(jlosses), (set(tlosses) ^ set(jlosses))
    for k, v in jlosses.items():
        assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), (i, k, float(tlosses[k]), float(v))


def run_cut_trajectory(jm, tm, batches, keys, on_step=None):
    """The port's CUT model against the JAX step over ``batches`` with the
    JAX draws of ``keys`` (see the module doc); ``on_step(i, tlosses,
    jlosses, draws)`` adds a step's own checks. APA's and the diffusion
    noise's p are carried as the JAX step carries them."""
    step = jm._make_step()
    # copies (the step donates its inputs, and the checkpoint tests read
    # jm's own state again), committed like the step's outputs, so the
    # step compiles once
    states, pool, apa_p, d_diff_p = jax.device_put(jax.tree.map(
        jnp.copy, (jm.states, jm.pool, jm.apa_p, jm.d_diff_p)),
        jax.devices()[0])
    zero = zero_grad_masks(tm)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"),
                             int_keys=("mask_A", "mask_B"))
        n = dev["real_A"].shape[0]
        shared = jax_state(tm, states, [pool], (apa_p, d_diff_p))
        draws = cut_draws(key, jm, tm, n, int(pool.count), float(d_diff_p))
        states, pool, apa_p, d_diff_p, jlosses = step(
            states, pool, apa_p, d_diff_p, key, dev)
        own = port_state(tm) if i else None
        set_port_state(tm, shared)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch), draws)
        check_losses(i, tlosses, jlosses)
        np.testing.assert_allclose(to_np(tm.pool.buffer),
                                   np.asarray(pool.buffer), atol=1e-3)
        if on_step is not None:
            on_step(i, tlosses, jlosses, draws)
        if own is not None:
            # the port's own run: back to its state, the same step again
            set_port_state(tm, own)
            tm.optimize_prepared(tm.prepare_batch(batch), draws)
        check_weights(tm, states, i, zero)
    return states
