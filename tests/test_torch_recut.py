"""ReCUT (``--model_type re_cut_semantic_mask``) with FastCUT's flips
against the JAX package, on the CPU.

A 3-step trajectory of ``CUTModel.optimize_prepared`` against the JAX
step (``_make_step``) in fp32, on ``example_gan_noglasses2glasses.json``
at a small width (mobile_resnet_attn G at ngf 8 and 2 blocks, the basic D
at ndf 8, f_s nf 16 (2 channels a group), 32 px, 16 patches at the NCE
taps 0 and 4 of the config's five, to keep the JAX step's compile under a
minute; P_B the default ``unet_128`` at ngf 8, 4 channels a group in both
packages), over nuplets of 3 frames, 2 a batch (4 folded images) with
label masks, the JAX step's draws fed
(the flip, the patch ids of the three NCE terms, the pool), with
``alg_cut_flip_equivariance`` and ``alg_re_adversarial_loss_p``. The
thresholds of f_s and of P are raised to 10 and 100, so that both gates
open and G's semantic and ReCUT terms count (P's 10 · L1 of about 5 keeps
the default gate of 1 shut). The keys are picked so that the three steps
meet both flip values. Held as ``tests/_torch_re_common.py`` sets out:
each step's losses (``P_proj_real_B``, ``G_recut``,
``G_proj_fake_B_adversarial`` among them) to 1e-4, P's gate alike in both
packages, the pool to 1e-3, and G, its EMA, F, f_s, P_B and the D on the
port's own run with the Adam allowance. The checkpoints are in
``tests/test_torch_re_checkpoints.py``.
"""

import json
import os

import pytest

import jax

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import ROOT, few_torch_threads, merge  # noqa: F401
from _torch_re_common import (STEPS, build_models, nuplet_batch,
                              run_cut_trajectory)
from joligen_tpu.models import cut_model as jcut_model

P_THRESHOLD = 100.0


def recut_cfg(tmp):
    with open(os.path.join(ROOT, "examples",
                           "example_gan_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    return merge(cfg, {
        "model_type": "re_cut_semantic_mask", "checkpoints_dir": str(tmp),
        "G": {"ngf": 8, "nblocks": 2}, "D": {"ndf": 8, "netDs": ["basic"]},
        "data": {"crop_size": 32, "load_size": 32, "num_threads": 1,
                 "dataset_mode": "nuplet_unaligned_labeled_mask"},
        "alg": {"cut": {"num_patches": 16, "flip_equivariance": True,
                        "nce_layers": "0,4"},
                "re": {"projection_threshold": P_THRESHOLD,
                       "adversarial_loss_p": True}},
        "f_s": {"nf": 16, "semantic_threshold": 10.0},
        "train": {"batch_size": 2, "pool_size": 3},
        "tpu": {"bf16": False}})


def flip_keys():
    """STEPS keys from 1000 on whose flip draws take both values."""
    keys = [jax.random.PRNGKey(1000 + i) for i in range(STEPS)]

    def flip(k):
        r = jax.random.split(k, 8)[0]
        return bool(jax.random.bernoulli(jax.random.split(r)[1]))
    base = 1000
    while len({flip(k) for k in keys}) < 2:
        base += STEPS
        keys = [jax.random.PRNGKey(base + i) for i in range(STEPS)]
    return keys


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return build_models(tmp_path_factory.mktemp("recut"),
                        recut_cfg(tmp_path_factory.mktemp("ck")), jcut_model)


def test_recut_trajectory_matches_jax_step(pair):
    jm, tm = pair
    assert tm.recut and jm.recut and tm.semantic_mask and jm.semantic_mask
    assert tm.flip_equivariance and jm.flip_equivariance
    assert tm.nets["P_B"].in_conv.weight.shape[1] == 6
    flips, gates = [], []

    def on_step(i, tlosses, jlosses, draws):
        flips.append(bool(draws["flip"]))
        assert {"P_proj_real_B", "G_recut", "G_proj_fake_B_adversarial",
                "G_sem_mask", "f_s"} <= set(tlosses)
        gate = float(jlosses["P_proj_real_B"]) <= P_THRESHOLD
        gates.append(gate)
        assert (float(tlosses["P_proj_real_B"]) <= P_THRESHOLD) == gate
        assert (float(tlosses["G_recut"]) != 0.0) == gate
    run_cut_trajectory(jm, tm, [nuplet_batch(10 + i, 2)
                                for i in range(STEPS)], flip_keys(), on_step)
    assert set(flips) == {False, True} and all(gates)
