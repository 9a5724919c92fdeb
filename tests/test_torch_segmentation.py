"""The standalone segmentation model (``--model_type segmentation``) of the
port against the JAX package's, on the CPU, on
``example_gan_noglasses2glasses.json`` cut small (the unet f_s at nf 16,
32 px, batch 2, fp32):

1. 3 steps of both models from the same seeded weights on the same
   batches, whose label masks hold a label at ``f_s_semantic_nclasses``
   (its cross-entropy counts 0 in both: an all-zero one-hot): the loss
   ``f_s`` to 1e-5 and every weight to 1e-5 after each step;
2. then ``inference`` (argmax label maps, (B, H, W, 1) int32) equal, and
   ``compute_miou`` (a float) equal;
3. the train CLI (``python -m joligen_tpu_torch.train --model_type
   segmentation``) over ``synthetic_datasets.write_unaligned_labeled``: it
   saves ``latest_net_f_s.pth``, which the JAX model reads back bit for
   bit, and ``--train_continue`` reloads it and saves it again byte for
   byte; with ``train_mask_compute_miou`` the loop prints ``mIoU failed``
   and trains on, as the JAX loop does (``compute_miou`` gives a float,
   which the loop reads as a dict).
"""

import copy
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, fast_init_net_state,  # noqa: F401
                               few_torch_threads, load_flax, merge, to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import segmentation_model as jseg_model
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.tools import synthetic_datasets as synth

SIZE, BATCH, STEPS, NCLASSES = 32, 2, 3, 2
EXAMPLE = os.path.join(ROOT, "examples", "example_gan_noglasses2glasses.json")


def seg_cfg(tmp):
    with open(EXAMPLE) as f:
        cfg = json.load(f)
    return merge(cfg, {
        "model_type": "segmentation", "checkpoints_dir": str(tmp),
        "data": {"crop_size": SIZE, "load_size": SIZE},
        "f_s": {"nf": 16}, "train": {"batch_size": BATCH},
        "tpu": {"bf16": False}})


def seg_batch(seed):
    """Images and label masks of A: a rectangle of 1 and one of
    NCLASSES (out of range) on 0."""
    rng = np.random.default_rng(seed)
    m = np.zeros((BATCH, SIZE, SIZE, 1), np.int32)
    for b in range(BATCH):
        for label in (1, NCLASSES):
            y, x = rng.integers(0, SIZE // 2, 2)
            m[b, y:y + SIZE // 3, x:x + SIZE // 3] = label
    return {"A": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(
        np.float32), "A_label_mask": m}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = seg_cfg(tmp_path_factory.mktemp("seg"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jseg_model, "init_net_state", fast_init_net_state(600))
        jopt = JaxTrainOptions().parse_json(copy.deepcopy(cfg),
                                            verbose=False)
        jopt.steps_per_epoch = 4
        jm = jax_create_model(jopt)
    opt = TrainOptions().parse_json(copy.deepcopy(cfg), verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, device="cpu")
    assert set(tm.nets) == set(jm.states) == {"f_s"}
    load_flax(tm.nets["f_s"], jm.states["f_s"].params)
    return jm, tm


def test_steps_inference_and_miou_match_jax(pair):
    jm, tm = pair
    for i in range(STEPS):
        batch = seg_batch(10 + i)
        assert (batch["A_label_mask"] == NCLASSES).any()
        want = float(jm.optimize_parameters(batch)["f_s"])
        got = float(tm.optimize_parameters(batch)["f_s"])
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (i, got, want)
        ref = flax_to_torch(jax.device_get(jm.states["f_s"].params))
        for k, v in tm.nets["f_s"].state_dict().items():
            err = float(np.abs(to_np(v) - ref[k].numpy()).max())
            assert err <= 1e-5, (i, k, err)
    batch = seg_batch(20)
    got, want = tm.inference(batch), jm.inference(batch)
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, 1)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    miou = tm.compute_miou(batch)
    assert isinstance(miou, float) and 0.0 < miou <= 1.0
    assert miou == jm.compute_miou(batch)


def _digests(run_dir):
    return {f: hashlib.sha256(open(os.path.join(run_dir, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(run_dir))
            if f.startswith("latest_")}


def test_train_cli_saves_reloads_and_miou_fails_on(tmp_path, capsys):
    from joligen_tpu_torch import train
    root = str(tmp_path / "data")
    synth.write_unaligned_labeled(root, 4, SIZE)
    ckpt = str(tmp_path / "ckpt")
    args = ["--cpu", "--config_json", EXAMPLE, "--model_type",
            "segmentation", "--dataroot", root, "--checkpoints_dir", ckpt,
            "--name", "seg", "--data_load_size", str(SIZE),
            "--data_crop_size", str(SIZE), "--f_s_nf", "16",
            "--train_n_epochs", "1", "--train_n_epochs_decay", "0",
            "--output_print_freq", "2", "--output_display_freq", "0",
            "--data_num_threads", "1", "--tpu_bf16", "false",
            "--train_mask_compute_miou", "--train_mask_miou_every", "2"]
    train.main(args)
    out = capsys.readouterr().out
    assert "mIoU failed" in out and "f_s: " in out
    run_dir = os.path.join(ckpt, "seg")
    saved = _digests(run_dir)
    assert set(saved) == {"latest_net_f_s.pth", "latest_optim.pkl"}
    # the JAX model reads the port's f_s file
    with open(os.path.join(run_dir, "train_config.json")) as f:
        jopt = JaxTrainOptions().parse_json(json.load(f), verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jseg_model, "init_net_state", fast_init_net_state(601))
        jm = jax_create_model(jopt, phase="test")
    jm.save_dir = run_dir
    jm.load_networks("latest", load_optim=False)
    tm = create_model(TrainOptions().parse_json(
        json.load(open(os.path.join(run_dir, "train_config.json"))),
        verbose=False), phase="test", device="cpu")
    tm.save_dir = run_dir
    tm.load_networks("latest")
    want = flax_to_torch(jax.device_get(jm.states["f_s"].params))
    for k, v in tm.nets["f_s"].state_dict().items():
        assert torch.equal(want[k], v), k
    # --train_continue with no epoch left: reloads and saves latest again
    train.main(args + ["--train_continue", "--train_epoch_count", "3"])
    assert "resumed from checkpoint" in capsys.readouterr().out
    assert _digests(run_dir) == saved
