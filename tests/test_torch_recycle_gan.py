"""ReCycleGAN (``--model_type re_cycle_gan``) against the JAX package, on
the CPU.

A 3-step trajectory of ``CycleGANModel.optimize_prepared`` against the JAX
step (``_make_step``) in fp32, on horse2zebra's options at a small width
(resnet_attn Gs at ngf 8 and 1 block, the basic Ds at ndf 8, DiffAugment
``color,cutout``, the projected GAN mode, ``rec_noise`` 0.1, no identity
terms, which ``tests/test_torch_cycle_gan.py`` holds, to keep the JAX
step's compile under a minute; P_A and P_B
the default ``unet_128`` at ngf 8, 4 channels a group in both packages),
over nuplets of 3 frames, 2 a batch (4 folded images), with
``alg_re_adversarial_loss_p``, the JAX step's draws fed (``rec_noise``,
both pools, DiffAugment). The projection threshold is raised to 100 so
that the gate opens and the recycle terms count (P's lambda · L1 of about
5 keeps the default gate of 1 shut). Held as ``tests/_torch_re_common.py``
sets out: each step's losses (``P_proj_real_A``/``_B``,
``G_recycle_A``/``_B``, ``G_proj_adversarial`` among them) to 1e-4, the
gate alike in both packages, both pools to 1e-3, and both Gs, both Ps and
the four Ds on the port's own run with the Adam allowance. The
checkpoints are in ``tests/test_torch_re_checkpoints.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (aug_draws, few_torch_threads,  # noqa: F401
                               h2z_cfg, pool_draws, to_np)
from _torch_re_common import (SIZE, STEPS, build_models, check_losses,
                              check_weights, jax_state, nuplet_batch,
                              port_state, set_port_state, zero_grad_masks)
from joligen_tpu.models import cycle_gan_model as jcg
from joligen_tpu.parallel.mesh import quantize_batch

P_THRESHOLD = 100.0


def recycle_cfg(tmp):
    return h2z_cfg(tmp, {
        "model_type": "re_cycle_gan", "G": {"nblocks": 1},
        "D": {"netDs": ["basic"]},
        "data": {"dataset_mode": "nuplet_unaligned_labeled_mask"},
        "alg": {"cyclegan": {"rec_noise": 0.1, "lambda_identity": 0.0},
                "re": {"projection_threshold": P_THRESHOLD,
                       "adversarial_loss_p": True}}})


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return build_models(tmp_path_factory.mktemp("recycle"),
                        recycle_cfg(tmp_path_factory.mktemp("ck")), jcg)


def step_draws(key, tm, n):
    """The JAX step's draws for ``key`` at a folded batch of ``n``
    (``cycle_gan_model.py:218-290``): split in 8; rngs[0] split for
    rec_noise; rngs[1] and rngs[2] the pools of A and B;
    fold_in(rngs[4], i) and fold_in(rngs[5], i) D i's real and fake
    DiffAugment."""
    rngs = jax.random.split(key, 8)
    shape = (n, SIZE, SIZE, 3)
    draws = {"pool_A": pool_draws(rngs[1], n, tm.pool_A.pool_size),
             "pool_B": pool_draws(rngs[2], n, tm.pool_B.pool_size),
             "rec_noise": tuple(
                 torch.from_numpy(np.array(jax.random.normal(
                     r, shape, jnp.float32)))
                 for r in jax.random.split(rngs[0])),
             "d_real_aug": {}, "d_fake_aug": {}}
    for di, (sname, _, _) in enumerate(tm.d_names):
        for k, r in (("d_real_aug", rngs[4]), ("d_fake_aug", rngs[5])):
            draws[k][sname] = aug_draws(jax.random.fold_in(r, di), shape,
                                        tm.diff_policy, tm.diff_prob)
    return draws


def test_recycle_gan_trajectory_matches_jax_step(pair):
    jm, tm = pair
    assert tm.recycle and jm.recycle and tm.p_adversarial
    assert (tm.rec_noise, tm.diff_policy, tm.gan_mode) == (
        jm.rec_noise, jm.diff_policy, jm.gan_mode)
    for name in ("P_A", "P_B"):
        assert tm.nets[name].in_conv.weight.shape[1] == 6
    step = jm._make_step()
    # copies (the step donates its inputs; the checkpoint test reads jm's
    # own state again), committed like the step's outputs
    states, pools = jax.device_put(jax.tree.map(
        jnp.copy, (jm.states, (jm.pool_A, jm.pool_B))), jax.devices()[0])
    zero = zero_grad_masks(tm)
    for i in range(STEPS):
        batch = nuplet_batch(10 + i, 2, masks=False)
        key = jax.random.PRNGKey(1000 + i)
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"))
        shared = jax_state(tm, states, pools)
        states, pools, jlosses = step(states, pools, key, dev)
        own = port_state(tm) if i else None
        set_port_state(tm, shared)
        draws = step_draws(key, tm, 4)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch), draws)
        check_losses(i, tlosses, jlosses)
        assert {"P_proj_real_A", "P_proj_real_B", "G_recycle_A",
                "G_recycle_B", "G_proj_adversarial"} <= set(tlosses)
        gate = (float(jlosses["P_proj_real_A"])
                + float(jlosses["P_proj_real_B"])) / 2 <= P_THRESHOLD
        assert gate and (float(tlosses["P_proj_real_A"])
                         + float(tlosses["P_proj_real_B"])) / 2 \
            <= P_THRESHOLD
        assert float(tlosses["G_recycle_A"]) > 0
        for tp, jp in zip((tm.pool_A, tm.pool_B), pools):
            np.testing.assert_allclose(to_np(tp.buffer),
                                       np.asarray(jp.buffer), atol=1e-3)
        if own is not None:
            # the port's own run: back to its state, the same step again
            set_port_state(tm, own)
            tm.optimize_prepared(tm.prepare_batch(batch), draws)
        check_weights(tm, states, i, zero)
