"""CUT with each new generator against the JAX package, on the CPU.

horse2zebra's options cut small (32 px, batch 2, 16 patches, a pool of 3,
fp32, DiffAugment ``color,cutout``, MoNCE with the identity NCE), the
``basic`` D alone, and ``--G_netG`` set to ``unet_mha``, ``uvit`` (2
transformer blocks), ``unet_256``, ``hdit``, ``ittr`` and ``hat`` (shrunk
in both packages: its factory width is fixed), each at a small width (ngf 8,
``G_nblocks`` 2, which picks the unet Gs' NCE taps; 4 channels a GroupNorm
group, in ``unet_256`` too). G, F and D start from the same weights; the
draws (patch ids of each NCE tap, the pool, DiffAugment) are the JAX
step's.

1. For each G but UViT (``unet_256``, ``hdit`` and ``hat`` in
   ``tests/test_torch_cut_zoo_more.py``): the step's G loss (the JAX ``_g_loss``, forward)
   through F on G's encoder taps, every term (G_GAN, G_NCE) and the total
   to 1e-4 relative. The gradients of these Gs are held in
   ``tests/test_torch_gan_zoo*.py``.
2. With UViT, a whole step against the JAX step: the losses to 1e-4
   relative, the pool to 1e-3, every parameter after the step with the
   Adam allowance of ``tests/test_torch_gan_cut.py`` (a first Adam step
   moves an element by about lr in the sign of its gradient: at most 1 %
   of a leaf's elements past 1e-4, none past 2 × lr; the exact-zero
   gradients, the key third of an attention ``qkv`` bias and the basic D's
   conv biases before an InstanceNorm, to 2 × lr).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (fast_init_net_state, few_torch_threads,
                               h2z_cfg, load_flax, to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu.models.modules import hat as jhat
from joligen_tpu.models.modules import unet_mha as junet
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import hat as that
from joligen_tpu_torch.models.modules import unet_mha as tunet
from joligen_tpu_torch.options import TrainOptions
from test_torch_gan_cut import _batch, _step_draws

LR = 2e-4
FLIP_SHARE = 1e-2
SMALL = {"G": {"ngf": 8, "nblocks": 2, "unet_mha_channel_mults": [1, 2],
               "unet_mha_res_blocks": [1, 1],
               "unet_mha_num_head_channels": 8,
               "unet_mha_group_norm_size": 4, "hdit_widths": [32, 64],
               "hdit_depths": [2, 2], "uvit_num_transformer_blocks": 2},
         "D": {"netDs": ["basic"]}}
HAT_SMALL = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 2))


def _zero_grad(tm):
    out = {}
    for n, p in tm.nets["G_A"].named_parameters():
        if n.endswith("qkv.bias"):
            m = torch.zeros(p.shape, dtype=bool)
            m[p.numel() // 3:2 * p.numel() // 3] = True
            out[f"G_A.{n}"] = m
    for i in range(1, tm.opt.D_n_layers + 1):
        out[f"D_B_basic.Conv_{i}.bias"] = torch.ones(
            tm.nets["D_B_basic"].get_parameter(f"Conv_{i}.bias").shape,
            dtype=bool)
    return out


def _positive_scales(init):
    """``init_net_state`` with HDiT's attention scales positive (a seeded
    N(0, .) scale takes a square root)."""
    def wrapped(*args, **kw):
        state = init(*args, **kw)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.abs(v) + 1.0 if "attn_scale" in str(p) else v,
            state.params)
        return state.replace(params=params,
                             opt_state=state.opt_state, ema_params=None)
    return wrapped


def _models(tmp_path, monkeypatch, netg):
    monkeypatch.setattr(jcut_model, "init_net_state",
                        _positive_scales(fast_init_net_state(500)))
    monkeypatch.setattr(jcut_model, "scheme_from_opt",
                        lambda state, key, opt: state)
    for mod in (jhat, that):
        monkeypatch.setattr(mod, "HAT", functools.partial(mod.HAT,
                                                          **HAT_SMALL))
    for mod in (junet, tunet):
        # unet_256 takes the factory's 32 groups: 4 channels a group here
        monkeypatch.setattr(mod, "UNetMHA", functools.partial(
            mod.UNetMHA, group_size=4))
    cfg = h2z_cfg(tmp_path, dict(SMALL, G=dict(SMALL["G"], netG=netg)))
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, device="cpu")
    assert tm.nce_layers == jm.nce_layers
    for name, net in tm.nets.items():
        load_flax(net, jm.states[name].params)
    return jm, tm


# the Gs of this file (tests/test_torch_cut_zoo_more.py runs the others)
G_LOSS_NETGS = ("unet_mha", "ittr")


@pytest.mark.parametrize("netg", G_LOSS_NETGS)
def test_cut_g_loss_with_new_generator_matches_jax(tmp_path, monkeypatch,
                                                   netg):
    check_g_loss(*_models(tmp_path, monkeypatch, netg))


def check_g_loss(jm, tm):
    """The step's G loss (the JAX ``_g_loss`` on the key the step gives
    it, jitted, forward): every term to 1e-4 relative."""
    batch = _batch(31)
    key = jax.random.PRNGKey(2001)
    dev = quantize_batch(jm.set_input(batch), float_keys=("real_A",
                                                          "real_B"))
    inp = {k: dequantize_on_device(jnp.asarray(v), "image")
           for k, v in dev.items()}
    d_params = {n: jm.states[n].params for n in jm.netDs}
    rng_g = jax.random.split(key, 8)[0]
    jtotal, (jlosses, _, _, _) = jax.jit(
        lambda pG, pF: jm._g_loss(pG, pF, d_params, rng_g, inp))(
            jm.states["G_A"].params, jm.states["F"].params)
    real = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    with torch.no_grad():
        total, losses, _ = tm._g_loss(real["real_A"], real["real_B"],
                                      _step_draws(key, jm, tm))
    assert set(losses) == set(jlosses)
    for k, v in list(jlosses.items()) + [("total", jtotal)]:
        got = float(total if k == "total" else losses[k])
        assert abs(got - float(v)) <= 1e-4 * max(1.0, abs(float(v))), (
            k, got, float(v))


def test_cut_step_with_uvit_matches_jax(tmp_path, monkeypatch):
    """A whole CUT step with the UViT G against the JAX step."""
    jm, tm = _models(tmp_path, monkeypatch, "uvit")
    batch = _batch(30)
    key = jax.random.PRNGKey(2000)
    dev = quantize_batch(jm.set_input(batch), float_keys=("real_A",
                                                          "real_B"))
    states, pool, _, _, jlosses = jm._make_step()(
        jm.states, jm.pool, jm.apa_p, jm.d_diff_p, key, dev)
    tlosses = tm.optimize_prepared(tm.prepare_batch(batch),
                                   _step_draws(key, jm, tm))
    assert set(tlosses) == set(jlosses)
    for k, v in jlosses.items():
        assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), (k, float(tlosses[k]), float(v))
    np.testing.assert_allclose(to_np(tm.pool.buffer),
                               np.asarray(pool.buffer), atol=1e-3)
    zero = _zero_grad(tm)
    bad = []
    for name, net in tm.nets.items():
        want = flax_to_torch(jax.device_get(states[name].params))
        for pname, p in net.named_parameters():
            diff = np.abs(to_np(p) - want[pname].numpy())
            mask = zero.get(f"{name}.{pname}")
            mask = np.zeros(diff.shape, bool) if mask is None else \
                mask.numpy()
            rest = diff[~mask]
            if rest.size and (rest > 1e-4).mean() > FLIP_SHARE:
                bad.append((name, pname, int((rest > 1e-4).sum()),
                            rest.size))
            if (diff > 2 * LR + np.where(mask, 1e-6, 1e-4)).any():
                bad.append((name, pname, float(diff.max())))
    assert not bad, bad
