"""CUT's GAN video mode on the port (``joligen_tpu_torch/models/
cut_model.py``: clips folded into the batch, the temporal projected D on
whole clips every ``D_temporal_every`` steps, ``G_temporal``) against the
JAX package, on the CPU, fp32:

1. a 3-step trajectory of ``CUTModel.optimize_prepared`` against the JAX
   step (``_make_step``) on horse2zebra's options at a small width
   (``mobile_resnet_attn`` G at ngf 8 and 2 blocks; the projected, basic
   and temporal Ds at ndf 8; DiffAugment ``color,cutout``; the unet f_s
   of 3 classes at nf 16 with ``train_semantic_mask``, its gate open; 2
   clips of 3 frames at 32
   px, ``D_temporal_every`` 2), the JAX step's draws fed
   (``tests/_torch_re_common.py``, over the 6 folded frames): each step's
   losses, ``G_temporal`` and ``D_D_B_temporal`` among them, to 1e-4
   (relative), the frame-level pool to 1e-3, every net on the port's own
   run with the Adam allowance; at step 1, the off step, the temporal D
   reports 0 and its parameters and Adam state stay bit for bit, in both
   packages;
2. ``set_input`` keeps every frame of a clip in its masks (the step folds
   the clip) while ReCUT's nuplets still drop their last frame;
3. the video variant of the bdd100k tutorial's command cut small, trained
   by ``train.py`` over ``temporal_labeled_mask_online`` (two steps, the
   temporal D on the first only) and served one frame by
   ``scripts/gen_single_image.py``.
"""

import copy
import os
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, h2z_cfg, to_np  # noqa: F401
from _torch_re_common import (SIZE, build_models, check_losses,
                              check_weights, cut_draws, jax_state,
                              port_state, set_port_state, zero_grad_masks)
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch import train
from joligen_tpu_torch.models import cut_model as tcut
from joligen_tpu_torch.models.modules.projected_d import \
    TemporalProjectedDiscriminator
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image as gen
from joligen_tpu_torch.tools.synthetic_datasets import write_video

B, F, NCLASSES, STEPS = 2, 3, 3, 3
VIDEO = {"D": {"netDs": ["projected_d", "basic", "temporal"],
               "temporal_every": 2},
         "G": {"netG": "mobile_resnet_attn"},
         "data": {"dataset_mode": "temporal_labeled_mask_online",
                  "temporal_number_frames": F},
         "train": {"semantic_mask": True, "G_ema": True},
         # 2 channels a group in f_s's GroupNorms (one would make the
         # conv biases before them exact-zero gradients); its gate open
         "f_s": {"net": "unet", "semantic_nclasses": NCLASSES, "nf": 16,
                 "semantic_threshold": 10.0}}


def _clips(seed):
    """A and B clips (B, F, SIZE, SIZE, 3) and A's label masks, a
    rectangle of class 1 or 2 a clip that moves a pixel a frame."""
    rng = np.random.default_rng(seed)
    shape = (B, F, SIZE, SIZE, 3)
    out = {k: rng.uniform(-1, 1, shape).astype(np.float32) for k in "AB"}
    mask = np.zeros(shape[:-1] + (1,), np.int64)
    for b in range(B):
        y, x = rng.integers(2, SIZE // 2, 2)
        for f in range(F):
            mask[b, f, y + f:y + f + 10, x:x + 12] = 1 + b
    out["A_label_mask"] = mask
    return out


def _d_state(tm, name):
    return copy.deepcopy((tm.nets[name].state_dict(),
                          tm.states[name].tx.state_dict()))


def _states_equal(a, b):
    (pa, ta), (pb, tb) = a, b
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    flat_a = jax.tree_util.tree_leaves(ta)
    flat_b = jax.tree_util.tree_leaves(tb)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert (torch.equal(x, y) if torch.is_tensor(x)
                else np.array_equal(np.asarray(x), np.asarray(y)))


def test_cut_video_trajectory_matches_jax_step(tmp_path):
    cfg = h2z_cfg(tmp_path / "ck", VIDEO)
    jm, tm = build_models(tmp_path, cfg, jcut_model)
    assert jm._video and tm.temporal_d
    assert tm.d_temporal_every == jm.d_temporal_every == 2
    assert isinstance(tm.nets["D_B_temporal"], TemporalProjectedDiscriminator)
    step = jm._make_step()
    states, pool, apa_p, d_diff_p = jax.device_put(jax.tree.map(
        jnp.copy, (jm.states, jm.pool, jm.apa_p, jm.d_diff_p)),
        jax.devices()[0])
    zero = zero_grad_masks(tm)
    name = "D_B_temporal"
    for i in range(STEPS):
        batch, key = _clips(10 + i), jax.random.PRNGKey(20 + i)
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"),
                             int_keys=("mask_A", "mask_B"))
        assert dev["real_A"].shape == (B, F, SIZE, SIZE, 3)
        shared = jax_state(tm, states, [pool], (apa_p, d_diff_p))
        draws = cut_draws(key, jm, tm, B * F, int(pool.count),
                          float(d_diff_p))
        jd_before = jax.device_get(states[name])
        states, pool, apa_p, d_diff_p, jlosses = step(
            states, pool, apa_p, d_diff_p, key, dev)
        own = port_state(tm) if i else None
        set_port_state(tm, shared)
        before = _d_state(tm, name)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch), draws)
        check_losses(i, tlosses, jlosses)
        assert float(tlosses["G_temporal"]) > 0
        assert float(tlosses["G_sem_mask"]) > 0
        np.testing.assert_allclose(to_np(tm.pool.buffer),
                                   np.asarray(pool.buffer), atol=1e-3)
        moved = not all(torch.equal(v, before[0][k]) for k, v in
                        tm.nets[name].state_dict().items())
        jd_after = jax.device_get(states[name])
        if i == 1:           # the off step: 0, nothing moves
            assert float(tlosses[f"D_{name}"]) == 0.0
            _states_equal(_d_state(tm, name), before)
            for a, b in zip(jax.tree_util.tree_leaves(jd_before),
                            jax.tree_util.tree_leaves(jd_after)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert float(tlosses[f"D_{name}"]) > 0 and moved
        if own is not None:
            # the port's own run: back to its state, the same step again
            set_port_state(tm, own)
            tm.optimize_prepared(tm.prepare_batch(batch), draws)
        check_weights(tm, states, i, zero)


def test_clip_masks_keep_every_frame_and_nuplets_drop_the_last():
    batch = _clips(3)
    batch["B_label_mask"] = batch["A_label_mask"] + 1
    for recut, frames in ((False, F), (True, F - 1)):
        stub = types.SimpleNamespace(recut=recut, mask_f_s_B=True,
                                     sem_idt=False, sem_cls_B=False)
        out = tcut.CUTModel.set_input(stub, batch)
        m = batch["A_label_mask"][:, :frames]
        np.testing.assert_array_equal(out["mask_A"],
                                      m.reshape((-1,) + m.shape[2:]))
        assert out["mask_B"].shape == (B * frames, SIZE, SIZE, 1)
        if recut:
            assert out["real_A"].shape == (B * frames, SIZE, SIZE, 3)
        else:           # the clip itself stays whole
            assert out["real_A"].shape == (B, F, SIZE, SIZE, 3)
    for drop_last, frames in ((False, F), (True, F - 1)):
        folded = tcut.fold_frames(batch, drop_last=drop_last)
        assert folded["A"].shape == (B * frames, SIZE, SIZE, 3)


def test_tutorial_video_variant_trains_and_serves(tmp_path):
    root = str(tmp_path / "data")
    write_video(root, 6, 40, seed=5, domains=("A", "B"))
    model = train.launch_training(TrainOptions().parse_cli([
        "--model_type", "cut", "--dataroot", root,
        "--data_dataset_mode", "temporal_labeled_mask_online",
        "--data_relative_paths", "--data_load_size", "32",
        "--data_crop_size", "32", "--data_online_creation_crop_size_A", "36",
        "--data_online_creation_crop_delta_A", "2",
        "--data_online_creation_crop_size_B", "36",
        "--data_online_creation_crop_delta_B", "2",
        "--data_temporal_number_frames", str(F),
        "--data_temporal_frame_step", "1", "--G_netG", "mobile_resnet_attn",
        "--G_ngf", "8", "--G_nblocks", "2", "--D_ndf", "8",
        "--D_proj_interp", "-1",
        "--D_netDs", "projected_d", "basic", "temporal",
        "--train_semantic_mask", "--f_s_net", "unet", "--f_s_nf", "8",
        "--f_s_semantic_nclasses", "11", "--train_batch_size", "2",
        "--train_G_ema", "--alg_cut_num_patches", "16",
        "--data_max_dataset_size", "4", "--train_n_epochs", "1",
        "--train_n_epochs_decay", "0", "--output_print_freq", "2",
        "--output_display_freq", "0", "--data_num_threads", "1",
        "--checkpoints_dir", str(tmp_path / "ckpt"), "--name", "cv"]),
        cpu=True)
    assert model.states["G_A"].step == 2
    losses = model.get_current_losses()
    # step 1 is off the temporal D's cadence of 4
    assert float(losses["D_D_B_temporal"]) == 0.0
    assert float(losses["G_temporal"]) > 0
    run = tmp_path / "ckpt" / "cv"
    assert (run / "latest_net_D_B_temporal.pth").exists()
    out = gen.main(["--cpu", "--model_in_file",
                    str(run / "latest_net_G_A.pth"),
                    "--img_in", os.path.join(root, "trainA", "vid0",
                                             "frame_000.png"),
                    "--img_out", str(tmp_path / "out.png")])
    assert out.shape == (40, 40, 3) and out.dtype == np.uint8
