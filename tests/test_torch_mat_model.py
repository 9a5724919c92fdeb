"""MAT's training step and request in the port (``joligen_tpu_torch/models/
mat_model.py``) against the JAX model's, on the CPU, fp32: the example
config cut small (base 16, w and z 64, stage-1 dim 12, 32 px, batch 2,
style mixing 0.5 as the option's default), both models on the same seeded
weights (every leaf non-zero) and the same VGG trunk, the JAX step's draws
replayed from its keys and fed to the port (``_torch_mat_common``):

- a 3-step trajectory with ``alg_mat_d_reg_every`` 2 (steps 0 and 2 take
  R1), once as configured and once with ``alg_mat_transformer_lr`` (two
  Adams): every loss (``G_adv``, ``G_adv_stg1``, ``G_pcp``, ``G_l1``,
  ``G_tot``, ``D_main``, ``D_r1``, ``D_tot``), ``w_avg`` and the EMA beta
  to 1e-4 (relative, of at least 1); G, its EMA and D with the Adam
  allowance of the other trajectories (at most 1 % of a leaf's elements
  past 1e-4, by at most 2 x lr a step); then a request with truncation
  0.7 toward the trained ``w_avg``, the JAX model's ``const`` noise and z
  fed, to 1e-4, known pixels bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_mat_common import (WZ, batch, close, mat_models, noise_draws,
                               step_draws, to_np, weights_close)


def _close_scalar(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (what, got, want)


@pytest.mark.parametrize("tf_lr", [None, 1e-3])
def test_three_step_trajectory_and_request_match_jax(tmp_path, monkeypatch,
                                                     tf_lr):
    extra = {"alg": {"mat": {"d_reg_every": 2}}}
    if tf_lr:
        extra["alg"]["mat"]["transformer_lr"] = tf_lr
    jm, tm = mat_models(tmp_path, monkeypatch, extra)
    assert tm.r1_every == 2 and tm.nets["G_A"].style_mixing_prob == 0.5
    if tf_lr:
        groups = tm.states["G_A"].tx.groups
        assert set(groups) == {"base", "tf"}
        assert all(any(k in n for k in ("tran", "attn"))
                   for n in groups["tf"].names)
        assert groups["tf"].schedule(0) == pytest.approx(tf_lr)
    start = {n: p.detach().clone()
             for n, p in tm.nets["G_A"].named_parameters()}
    lr = 2e-3
    r1 = []
    for i in range(3):
        b, key = batch(10 + i), jax.random.PRNGKey(20 + i)
        step = int(jm.states["G_A"].step)
        monkeypatch.setattr(jm, "next_rng", lambda k=key: k)
        want = jm.optimize_prepared(jm.prepare_batch(b))
        got = tm.optimize_prepared(tm.prepare_batch(b), draws=step_draws(
            key, tm.nets["G_A"], 2, WZ, tm.noise_mode_train))
        assert set(got) == set(want) == {
            "G_adv", "G_adv_stg1", "G_pcp", "G_l1", "G_tot", "D_main",
            "D_r1", "D_tot"}
        for k, v in want.items():
            _close_scalar(got[k], v, (i, k))
        r1.append(float(got["D_r1"]))
        _close_scalar(tm.ema_beta, jm._ema_beta(jnp.asarray(step), 2),
                      (i, "beta"))
        close(to_np(tm.w_avg), jm.w_avg, 1e-4)
        weights_close(i, tm, jm, lr)
    assert r1[0] > 0 and r1[1] == 0 and r1[2] > 0
    assert max((p.detach() - start[n]).abs().max().item()
               for n, p in tm.nets["G_A"].named_parameters()) > 1e-4

    # a request on the EMA weights: truncation toward the trained w_avg,
    # the const noise (JAX key 0) and z from the seed fed
    b, seed = batch(40), 3
    want = jm.inference(b, truncation_psi=0.7, seed=seed)
    got = tm.inference(b, truncation_psi=0.7, seed=seed, draws={
        "z": torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (2, WZ)))),
        "noise": noise_draws(jax.random.PRNGKey(0), tm.nets["G_A"], 2)})
    close(got, want, 1e-4)
    keep = np.broadcast_to(b["B_label_mask"] == 0, b["B"].shape)
    np.testing.assert_array_equal(got[keep], b["B"][keep])
