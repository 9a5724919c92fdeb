"""CycleGAN's projected D with a MiT trunk (``--D_proj_network_type
segformer``) and the trunk weights files: a deliberate deviation of the
port from the JAX package, held here.

Both weights files are written seeded under a temporary
``JOLIGEN_TPU_WEIGHTS_DIR``: ``segformer_mit_b0.npz`` (the MiT tree) and
``efficientnet_lite0.npz`` (the EfficientNet-Lite0 tree). The port's
CycleGAN loads into each projected D the trunk it builds: both domains'
MiT trunks hold the MiT file bit for bit, and the EfficientNet file is
read by nothing. The JAX CycleGAN (built only: its nets' init without XLA,
no step compiled) calls ``load_efficientnet_trunk`` whatever the trunk
(``joligen_tpu/models/cycle_gan_model.py:64-68``), which puts the
EfficientNet tree in the MiT trunk's place: its trunk's top-level keys are
EfficientNet's, recorded here. The JAX CUT loads the MiT file into a MiT
trunk, as the port does for both models.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (fast_init_net_state,  # noqa: F401
                               few_torch_threads, h2z_cfg, seeded_tree)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import cycle_gan_model as jcg
from joligen_tpu.models.modules import projected_d as jproj
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models import cut_model as tcut
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions
from test_torch_segformer import _write_mit_npz


def _write_efficientnet_npz(path, seed):
    shapes = jax.eval_shape(lambda k: jproj.EfficientNetLiteTrunk().init(
        k, jnp.zeros((1, 32, 32, 3))), jax.random.PRNGKey(0))["params"]
    tree = seeded_tree(shapes, seed, 0.05)
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                flat[".".join(pre + (k,))] = v
    walk(tree, ())
    np.savez(path, **flat)
    return tree


def test_cycle_gan_loads_the_trunk_it_builds(tmp_path, monkeypatch):
    monkeypatch.setenv("JOLIGEN_TPU_WEIGHTS_DIR", str(tmp_path))
    mit = _write_mit_npz(tmp_path / "segformer_mit_b0.npz", 31)
    eff = _write_efficientnet_npz(tmp_path / "efficientnet_lite0.npz", 32)
    cfg = h2z_cfg(tmp_path / "ck", {
        "model_type": "cycle_gan",
        "D": {"netDs": ["projected_d"], "proj_network_type": "segformer"}})

    def unused(*args, **kwargs):
        raise AssertionError("the EfficientNet file was read")
    monkeypatch.setattr(tcut, "load_efficientnet_trunk", unused)
    tm = create_model(TrainOptions().parse_json(cfg, verbose=False),
                      device="cpu")
    want = flax_to_torch(mit)
    for sname in ("D_B_projected_d_A", "D_B_projected_d_B"):
        trunk = tm.nets[sname].feature_network.state_dict()
        assert sorted(trunk) == sorted(want)
        for k, v in trunk.items():
            assert torch.equal(v, want[k]), (sname, k)

    # the JAX CycleGAN on the same directory swaps EfficientNet's tree in
    monkeypatch.setattr(jcg, "init_net_state", fast_init_net_state(500))
    monkeypatch.setattr(jcg, "scheme_from_opt", lambda state, key, opt: state)
    jm = jax_create_model(JaxTrainOptions().parse_json(cfg, verbose=False))
    for sname in ("D_B_projected_d_A", "D_B_projected_d_B"):
        trunk = jm.states[sname].params["params"]["feature_network"]
        assert sorted(trunk) == sorted(eff) != sorted(mit)
        np.testing.assert_array_equal(np.asarray(trunk["stem"]["kernel"]),
                                      eff["stem"]["kernel"])
