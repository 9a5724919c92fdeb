"""``CMModel`` as ``cm_gan`` against the JAX ``CMModel``, on the CPU, in
fp32, at the small width of ``tests/_torch_cm_common.py`` with the basic D
(ndf 8, 2 layers) at ``iter_size`` 2 and a pool of 3: 4 micro-steps of
``optimize_prepared`` against the JAX step with the JAX keys' draws fed
(the timesteps, the noise, the pool's draws), at the tolerances of
``_torch_cm_common``. ``MultiSteps`` wraps G's and the D's optimizers: each
net changes on the second and fourth micro-steps only; the pool holds the
student's outputs to 1e-4.
"""

import numpy as np
import torch

# few_torch_threads: an autouse fixture, active once imported
from _torch_cm_common import models, run_trajectory, small_cfg
from _torch_gan_common import few_torch_threads, to_np

CM_GAN = {"model_type": "cm_gan",
          "D": {"netDs": ["basic"], "ndf": 8, "n_layers": 2},
          "train": {"iter_size": 2, "pool_size": 3}}


def test_cm_gan_trajectory_matches_jax_step(tmp_path, monkeypatch):
    jm, tm = models(small_cfg(tmp_path, CM_GAN), monkeypatch)
    assert tm.d_names == ["D_B_basic"]

    def check(i, before, pool):
        for name, net in tm.nets.items():
            moved = any(not torch.equal(a, b)
                        for a, b in zip(before[name], net.parameters()))
            assert moved == (i % 2 == 1), (i, name)
        np.testing.assert_allclose(to_np(tm.pool.buffer),
                                   np.asarray(pool.buffer), atol=1e-4)

    run_trajectory(jm, tm, 4, check)
