"""ReCUT's and ReCycleGAN's checkpoints and requests against the JAX
package, on the CPU, at the trajectories' configs
(``tests/test_torch_recut.py``, ``tests/test_torch_recycle_gan.py``), the
models of both packages on the same seeded weights: the P files
(``{prefix}_net_P_B.pth``, and ``_P_A`` for ReCycleGAN, as the JAX
``save_networks`` writes every state) from the port into the JAX model
and from the JAX model into the port, bit for bit; ``inference`` of a
nuplet batch (frames 0..N-2 folded, as the JAX ``set_input`` folds them)
against the JAX model's, in both directions for ReCycleGAN. No JAX step is
compiled here.
"""

import numpy as np
import pytest
import torch

import jax

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_re_common import SIZE, build_models, nuplet_batch
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu.models import cycle_gan_model as jcg
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.utils import checkpoint_io
from test_torch_recut import recut_cfg
from test_torch_recycle_gan import recycle_cfg


@pytest.fixture(scope="module")
def recut_pair(tmp_path_factory):
    return build_models(tmp_path_factory.mktemp("recut"),
                        recut_cfg(tmp_path_factory.mktemp("ck")), jcut_model)


@pytest.fixture(scope="module")
def recycle_pair(tmp_path_factory):
    return build_models(tmp_path_factory.mktemp("recycle"),
                        recycle_cfg(tmp_path_factory.mktemp("ck")), jcg)


def test_recut_checkpoints_and_inference(recut_pair, tmp_path):
    """The port's P_B file into the JAX model and the JAX model's into the
    port, bit for bit; ``inference`` of a nuplet batch (frames 0..N-2
    folded) against the JAX model's."""
    jm, tm = recut_pair
    tm.save_dir = jm.save_dir = str(tmp_path)
    tm.save_networks("latest")
    assert (tmp_path / "latest_net_P_B.pth").exists()
    jm.load_networks("latest", load_optim=False)
    want = flax_to_torch(jax.device_get(jm.states["P_B"].params))
    for k, v in tm.nets["P_B"].state_dict().items():
        assert torch.equal(want[k], v), k
    for p in tm.nets["P_B"].parameters():
        p.data.add_(0.5)
    jm.save_networks("jax")
    tree = checkpoint_io.load(str(tmp_path / "jax_net_P_B.pth"))
    tm.load_networks("jax", load_optim=False)
    for k, v in tm.nets["P_B"].state_dict().items():
        assert torch.equal(flax_to_torch(tree)[k], v), k
    batch = nuplet_batch(21, 2)
    got = tm.inference(batch, use_ema=False)
    want = np.asarray(jm.inference(batch, use_ema=False))
    assert got.shape == want.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_recycle_gan_checkpoints_and_inference(recycle_pair, tmp_path):
    """P_A's and P_B's files from the port into the JAX model and from the
    JAX model into the port, bit for bit; ``inference`` of a nuplet batch
    (frames 0..N-2 folded) both ways against the JAX model's."""
    jm, tm = recycle_pair
    tm.save_dir = jm.save_dir = str(tmp_path)
    tm.save_networks("latest")
    jm.load_networks("latest", load_optim=False)
    for name in ("P_A", "P_B"):
        want = flax_to_torch(jax.device_get(jm.states[name].params))
        for k, v in tm.nets[name].state_dict().items():
            assert torch.equal(want[k], v), (name, k)
        for p in tm.nets[name].parameters():
            p.data.mul_(1.5)
    jm.save_networks("jax")
    tm.load_networks("jax", load_optim=False)
    for name in ("P_A", "P_B"):
        tree = checkpoint_io.load(str(tmp_path / f"jax_net_{name}.pth"))
        for k, v in tm.nets[name].state_dict().items():
            assert torch.equal(flax_to_torch(tree)[k], v), (name, k)
    batch = nuplet_batch(21, 2, masks=False)
    for direction in ("AtoB", "BtoA"):
        got = tm.inference(batch, use_ema=False, direction=direction)
        want = np.asarray(jm.inference(batch, use_ema=False,
                                       direction=direction))
        assert got.shape == want.shape == (4, SIZE, SIZE, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)
