"""The CycleGAN trajectory of ``tests/test_torch_cycle_gan.py`` with the
``unet_256`` generators (their middle attention runs the plain route of
K1–K3 on the CPU), lsgan with one-sided label smoothing, ``D_noise``, no
DiffAugment, no identity terms (``lambda_identity`` 0) and the ``basic`` Ds
alone; its own file, so the two JAX steps compile in parallel workers."""

import functools

import pytest

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.models.modules import unet_mha as junet
from joligen_tpu_torch.models.modules import unet_mha as tunet
from test_torch_cycle_gan import build_pair, run_trajectory

RUN = ("unet_256_options",)
# 4 channels a group: at ngf 8 the factory's 32 would give one channel a
# group, whose norm makes the conv biases before it exact-zero gradients
# (noise that Adam turns into full steps, ROADMAP.md Queue 3)
GROUP_SIZE = 4


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for mod in (junet, tunet):
            mp.setattr(mod, "UNetMHA", functools.partial(
                mod.UNetMHA, group_size=GROUP_SIZE))
        return build_pair(tmp_path_factory, RUN)


@pytest.mark.parametrize("case", RUN)
def test_cycle_gan_unet_trajectory_matches_jax_step(pair, case):
    jm, tm = pair[case]
    # the unet's middle AttentionBlock: 2 heads of 32 over 2 x 2 tokens
    net = tm.nets["G_A"]
    assert net.AttentionBlock_0.heads == 2
    assert net.ResBlock_0.GroupNorm32_0.GroupNorm_0.num_groups == 4
    run_trajectory(jm, tm)
