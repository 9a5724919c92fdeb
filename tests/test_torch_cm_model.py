"""``CMModel`` (model type ``cm``) against the JAX ``CMModel``, on the CPU,
in fp32, at the small width of ``tests/_torch_cm_common.py``:

1. a 3-step iCT trajectory of ``optimize_prepared`` (masked, AdamW with
   weight decay, EMA) against the JAX model's jitted step with the JAX
   keys' draws fed (the timestep indices, the noise), at the tolerances of
   ``_torch_cm_common``;
2. one ECT step (``alg_ddpm_ft_mode ect`` with the finetune projection);
3. checkpoints the JAX ``load_networks`` reads, and the reverse, bit for
   bit;
4. the perceptual terms add ``G_perceptual`` to a step; ``previous_frame``
   video conditioning raises.

``cm_gan`` is in ``tests/test_torch_cm_gan.py``.
"""

import jax
import pytest
import torch

# few_torch_threads: an autouse fixture, active once imported
from _torch_cm_common import batch, models, run_trajectory, small_cfg
from _torch_gan_common import few_torch_threads
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions

ECT = {"alg": {"ddpm_ft_mode": "ect", "diffusion": {"ddpm_cm_ft": True}}}


@pytest.mark.parametrize("case,steps", [("ict", 3), ("ect", 1)])
def test_trajectory_matches_jax_step(tmp_path, monkeypatch, case, steps):
    jm, tm = models(small_cfg(tmp_path, ECT if case == "ect" else None),
                    monkeypatch)
    assert tm.is_ect == (case == "ect")
    run_trajectory(jm, tm, steps)


def _nets_equal(nets_trees):
    for net, tree in nets_trees:
        want = flax_to_torch(jax.device_get(tree))
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    """The port's net files load into the JAX model and the JAX model's
    into the port, G and its EMA, bit for bit."""
    jm, tm = models(small_cfg(tmp_path), monkeypatch)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.01)
    tm.save_networks("port")
    jm.load_networks("port", load_optim=False)
    _nets_equal(((tm.nets["G_A"], jm.states["G_A"].params),
                 (tm.ema_nets["G_A"], jm.states["G_A"].ema_params)))
    jm.states["G_A"] = jm.states["G_A"].replace(params=jax.tree.map(
        lambda x: x * 0.5, jm.states["G_A"].params))
    jm.save_networks("jax")
    served = create_model(tm.opt, phase="test", device="cpu")
    served.load_networks("jax")
    _nets_equal(((served.nets["G_A"], jm.states["G_A"].params),
                 (served.ema_nets["G_A"], jm.states["G_A"].ema_params)))


@pytest.mark.parametrize("model_type,option", [
    ("cm", "alg_cm_perceptual_loss"), ("cm_gan", "alg_cm_perceptual_loss"),
    ("sc", "alg_sc_perceptual_loss")])
def test_perceptual_terms_raise(tmp_path, model_type, option):
    """The perceptual option builds the model, and a step adds its
    ``G_perceptual`` (the term against the JAX package:
    ``tests/test_torch_metrics_models.py``)."""
    # cm_gan with the basic D of ``test_torch_cm_gan.py`` (16 px)
    extra = ({"D": {"netDs": ["basic"], "ndf": 8, "n_layers": 2}}
             if model_type == "cm_gan" else None)
    opt = TrainOptions().parse_json(small_cfg(tmp_path, extra),
                                    verbose=False)
    opt.model_type = model_type
    setattr(opt, option, ["LPIPS"])
    tm = create_model(opt, phase="train", device="cpu")
    losses = tm.optimize_parameters(batch(0))
    assert 0.0 < float(losses["G_perceptual"]) < float(losses["G_tot"])


def test_previous_frame_video_batches_raise(tmp_path):
    opt = TrainOptions().parse_json(small_cfg(tmp_path), verbose=False)
    opt.alg_diffusion_cond_image_creation = "previous_frame"
    tm = create_model(opt, device="cpu")
    video = {k: v[:, None] for k, v in batch(0).items()}
    with pytest.raises(NotImplementedError, match="item 11"):
        tm.set_input(video)
    # image batches take the A image, as in the JAX model
    assert "y_cond" in tm.set_input(batch(0))
