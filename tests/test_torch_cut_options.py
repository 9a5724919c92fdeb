"""The CUT options of ReCUT's slice against the JAX package, on the CPU:
the contrastive D (``train_use_contrastive_loss_D``), adaptive pseudo
augmentation (``dataaug_APA``, p from 0.3), diffusion-noise D augmentation
(``dataaug_D_diffusion`` every step) and the supervised L1, LPIPS and
DISTS terms (``alg_cut_supervised_loss``) of aligned data, together.

1. A 3-step trajectory of ``CUTModel.optimize_prepared`` against the JAX
   step (``_make_step``) in fp32, on horse2zebra's options at a small
   width (resnet_attn G at ngf 8 and 2 blocks, the basic D at ndf 8,
   DiffAugment ``color,cutout``, 32 px, batch 2, 16 patches at the NCE
   taps 0 and 4, a pool of 3),
   the VGG16 trunk of the perceptual terms on one seeded tree in both
   packages (``_torch_metrics_common.shared_nets``), the JAX step's draws
   fed (patch ids, the pool, DiffAugment, the diffusion noise's t and
   noise, APA's pool indices and uniforms), APA's and the diffusion
   noise's p carried from step to step as the JAX step carries them (the
   latter set to 0.5 at the start in both packages, so that images are
   noised). Held
   as ``tests/_torch_re_common.py`` sets out: each step's losses, among
   them ``G_supervised``, ``APA_p`` and ``D_diff_p``, to 1e-4; the pool to
   1e-3; G, F and the D on the port's own run with the Adam allowance. Both
   p move; the steps noise some images and leave others clean, and swap
   some reals for pool images.
2. The options through ``joligen_tpu_torch/train.py`` over the ``aligned``
   layout (2 steps): finite losses, both p logged; one request through
   ``scripts/gen_single_image.py``.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, few_torch_threads,  # noqa: F401
                               h2z_cfg)
from _torch_metrics_common import shared_nets, shared_tree  # noqa: F401
from _torch_re_common import STEPS, build_models, run_cut_trajectory
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu_torch import train
from joligen_tpu_torch.scripts import gen_single_image as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth

D_DIFF_P0 = 0.5
OPTIONS = {"train": {"use_contrastive_loss_D": True, "batch_size": 2,
                     "pool_size": 3},
           "dataaug": {"APA": True, "APA_p": 0.3, "D_diffusion": True,
                       "D_diffusion_every": 1},
           "alg": {"cut": {"supervised_loss": ["L1", "LPIPS", "DISTS"],
                           "nce_layers": "0,4",
                           "lambda_supervised": 2.0,
                           "lambda_perceptual": 0.5}}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for k in "AB"}


def test_cut_options_trajectory_matches_jax_step(shared_nets, tmp_path):
    cfg = h2z_cfg(tmp_path / "ck", dict(OPTIONS, D={"netDs": ["basic"]},
                                        data={"dataset_mode": "aligned"}))
    jm, tm = build_models(tmp_path, cfg, jcut_model)
    shared_tree("vgg", 0)     # made here, not inside the JAX step's trace
    assert (tm.contrastive_d, tm.apa, tm.d_diffusion, tm.supervised) == (
        jm.contrastive_d, jm.apa, jm.d_diffusion, jm.supervised) == (
        True, True, True, ["L1", "LPIPS", "DISTS"])
    # the diffusion noise's p from 0.5 in both packages (it starts at 0,
    # where it noises no image: min(64 p, 48) / 64 of them)
    jm.d_diff_p = jnp.asarray(D_DIFF_P0, jnp.float32)
    tm.d_diff_p = torch.tensor(D_DIFF_P0)
    seen, noised = [], []

    def on_step(i, tlosses, jlosses, draws):
        assert {"G_supervised", "APA_p", "D_diff_p"} <= set(tlosses)
        seen.append((float(tlosses["APA_p"]), float(tlosses["D_diff_p"])))
        for k in ("real", "fake"):
            t, _ = draws["d_diffusion"][k]
            noised.extend(t.tolist())
        use = draws["apa"]["u"] < seen[-1][0]
        noised.append(-int(use.sum()))
    run_cut_trajectory(jm, tm, [_batch(10 + i) for i in range(STEPS)],
                       [jax.random.PRNGKey(1000 + i) for i in range(STEPS)],
                       on_step)
    apa, diff = zip(*seen)
    assert apa[0] != 0.3 and len(set(apa)) == STEPS
    assert diff[0] != D_DIFF_P0 and len(set(diff)) == STEPS
    # images noised (t > 0) and left clean (t = 0), reals swapped for pool
    # images (the negative counts)
    assert max(noised) > 10 and 0 in noised and min(noised) < 0


def test_cut_options_train_and_serve(tmp_path):
    root = str(tmp_path / "data")
    synth.write_aligned(root, 4, 32)
    ckpt = str(tmp_path / "ckpt")
    model = train.launch_training(train.TrainOptions().parse_cli([
        "--cpu", "--config_json",
        os.path.join(ROOT, "examples", "example_gan_horse2zebra.json"),
        "--dataroot", root, "--checkpoints_dir", ckpt, "--name", "opts",
        "--data_dataset_mode", "aligned", "--data_load_size", "32",
        "--data_crop_size", "32", "--G_ngf", "8", "--G_nblocks", "2",
        "--D_ndf", "8", "--D_netDs", "basic", "--data_num_threads", "1",
        "--train_batch_size", "2", "--train_n_epochs", "1",
        "--train_n_epochs_decay", "0", "--output_print_freq", "1",
        "--alg_cut_num_patches", "16", "--train_use_contrastive_loss_D",
        "--dataaug_APA", "--dataaug_APA_p", "0.3", "--dataaug_D_diffusion",
        "--dataaug_D_diffusion_every", "1", "--alg_cut_flip_equivariance",
        "--alg_cut_supervised_loss", "MSE", "LPIPS"]), cpu=True)
    losses = {k: float(v) for k, v in model.loss_log.items()}
    assert {"G_supervised", "APA_p", "D_diff_p"} <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    out = gen.main(["--cpu", "--model_in_file",
                    os.path.join(ckpt, "opts", "latest_net_G_A.pth"),
                    "--img_in", os.path.join(root, "trainA", "0000.png"),
                    "--img_out", str(tmp_path / "o.png")])
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8
