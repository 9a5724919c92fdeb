"""The train-time metrics and perceptual terms of the port's models
(``joligen_tpu_torch/models/base.py``, the cm, sc and b2b models,
``train.py``, ``test.py``) against the JAX package, on the CPU, with both
packages' fallback networks on shared seeded trees
(``_torch_metrics_common.shared_nets``):

1. ``init_metrics`` and ``compute_metrics_test`` of both packages' base
   models driven by a stub ``inference`` that returns the same fixed arrays:
   the real statistics, every image metric but FID (1e-4 relative; KID,
   MSID and DINOv2, differences of terms ~1, 1e-4 absolute) with the
   ``_test`` suffix and the fallback marker in the JAX key order, the
   ``train_nb_img_max_fid`` cut, PSNR under ``alg_palette_metric_mask``,
   the saved image pairs (at most 8, the same PNGs); clips: the frames
   folded, FVD;
2. ``perceptual_terms`` (LPIPS and DISTS) and their gradient with respect
   to ``pred`` against the JAX method, on images and on 1-channel clips
   (folded, tiled), to 1e-4 (the gradient: of its L2 norm);
3. the cm, sc and b2b (video) models with both perceptual terms on, their
   draws fed: what each gives ``perceptual_terms`` (cm and b2b the masked
   output and ground truth, sc its one-step x-prediction against the
   ground truth), ``G_perceptual`` = lambda x the terms, and the terms and
   their gradient with respect to ``pred`` against the JAX method, to 1e-4
   (the gradient: of its L2 norm);
4. ``train.py`` with the metrics on over a two-image test set at a tiny
   width: an evaluation mid-run and ``eval_results.json`` with the JAX
   package's key set; then ``python -m joligen_tpu_torch.test`` on the
   checkpoint (``--cpu``), its ``metrics/<timestamp>.json``.
"""

import functools
import glob
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from _torch_metrics_common import close, imgs, shared_nets  # noqa: F401
from joligen_tpu.models import base as jbase
from joligen_tpu.utils import metrics as jmet
from joligen_tpu_torch import test as ttest
from joligen_tpu_torch.models import base as tbase
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.utils import metrics as tmet
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.train import launch_training

RTOL = 1e-4
KINDS = ["LPIPS", "DISTS"]


def _rel(got, want, rtol=RTOL, floor=1e-12):
    """|got - want| within ``rtol`` of max(|want|, ``floor``)."""
    assert abs(got - want) <= rtol * max(abs(want), floor), (got, want)


# ---------------------------------------------------------------------------
# 1. compute_metrics_test
# ---------------------------------------------------------------------------

class _Stub:
    """A base model of either package with a fixed ``inference``."""

    def __init__(self, opt, save_dir, outs):
        self.opt, self.save_dir, self.outs = opt, save_dir, outs
        self.device = torch.device("cpu")

    def inference(self, batch, **kw):
        return self.outs[int(batch["idx"])]


class _JaxStub(_Stub, jbase.BaseModel):
    pass


class _PortStub(_Stub, tbase.BaseModel):
    pass


def _loader(video):
    """Batches of 2 (the last of 1): ``B``, its mask, an index; and the
    stub's outputs, the ``B`` moved."""
    rng = np.random.default_rng(3)
    shape = (2, 3, 24, 24, 3) if video else (2, 32, 32, 3)
    batches, outs = [], []
    for i, n in enumerate((2, 2, 2, 1)):
        b = rng.uniform(-1, 1, (n,) + shape[1:]).astype(np.float32)
        m = (rng.uniform(0, 1, b.shape[:-1] + (1,)) > 0.4).astype(np.int32)
        batches.append({"B": b, "B_label_mask": m, "idx": np.array(i)})
        outs.append(np.clip(b + 0.4 * rng.standard_normal(b.shape), -1, 1)
                    .astype(np.float32))
    return batches, outs


@pytest.mark.parametrize("video", [False, True])
def test_compute_metrics_test_matches_jax(shared_nets, tmp_path, monkeypatch,
                                          video):
    batches, outs = _loader(video)
    # no FID here (a 2048 x 2048 eigendecomposition in each package): its
    # keys in test 4, its value in ``test_torch_metrics.py``
    metrics = (["PSNR", "SSIM", "FVD"] if video else
               ["KID", "MSID", "PSNR", "SSIM", "LPIPS", "DINOv2"])
    opt = types.SimpleNamespace(
        model_type="palette", train_metrics_list=metrics,
        train_nb_img_max_fid=12 if video else 5, alg_palette_metric_mask=True,
        train_metrics_save_images=True)
    # the image extractors' batch (which the last one pads to) at 8 in both
    # packages, so that they run 8 images, not 32
    for mod in (jmet, tmet):
        for cls in (mod.InceptionV3Features, mod.DINOv2Features):
            monkeypatch.setattr(cls.__init__, "__defaults__", (8,) + (
                cls.__init__.__defaults__[1:]))
    got, want = {}, {}
    for name, cls, res in (("jax", _JaxStub, want), ("port", _PortStub, got)):
        model = cls(opt, str(tmp_path / name), outs)
        model.init_metrics(batches)
        res.update(model.compute_metrics_test(batches))
        res["stats"] = model.real_stats
    for g, w in zip(got.pop("stats"), want.pop("stats")):
        close(g, w, RTOL)
    assert list(got) == list(want)
    assert all(k.endswith("_test") for k in got)
    marked = [k for k in want if jmet.FALLBACK_MARKER in k]
    assert sorted(k.split("(")[0] for k in marked) == sorted(
        m for m in metrics if m not in ("PSNR", "SSIM"))
    for k, v in want.items():
        # KID, MSID and DINOv2 are differences of terms ~1 (the cubic
        # kernel's means, the spectrum's moments, 1 - cos): 1e-4 of 1
        _rel(got[k], v, floor=1.0 if k.startswith(("KID", "MSID", "DINOv2"))
             else 1e-12)
    # at most 8 pairs, the same PNGs
    names = sorted(os.listdir(tmp_path / "port" / "metrics_imgs_test"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "metrics_imgs_test"))
    assert len(names) == 2 * (8 if video else 6)   # whole batches up to 8
    for n in names:
        got, want = (Image.open(tmp_path / pkg / "metrics_imgs_test" / n)
                     for pkg in ("port", "jax"))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# 2. perceptual_terms
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_terms_fn():
    """The jitted JAX ``perceptual_terms`` (both kinds) and the gradient of
    their sum with respect to ``pred``, on one model stub, so its VGG
    trunk is built once (under ``shared_nets``: the shared tree)."""
    stub = object.__new__(jbase.BaseModel)
    stub._perc_feats = jmet.vgg_feature_fn((16, 16, 3))   # outside the trace

    def total(p, t):
        terms = jbase.BaseModel.perceptual_terms(stub, p, t, KINDS)
        return sum(terms.values()), terms
    return jax.jit(jax.value_and_grad(total, has_aux=True))


def _jax_terms(pred, target):
    (_, terms), grad = _jax_terms_fn()(jnp.asarray(pred), jnp.asarray(target))
    return {k: float(v) for k, v in terms.items()}, np.asarray(grad)


def grad_close(got, want):
    """A gradient within 1e-4 of its L2 norm (DISTS divides by the
    features' variances + 1e-6, which lifts single elements' fp32 noise to
    ~1e-4 of the largest)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.linalg.norm(got - want), np.linalg.norm(want)
    assert 0 < scale and err <= RTOL * scale, (float(err), float(scale))


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 2, 16, 16, 1)])
def test_perceptual_terms_and_gradient_match_jax(shared_nets, shape):
    rng = np.random.default_rng(4)
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = np.clip(target + 0.5 * rng.standard_normal(shape), -1, 1) \
        .astype(np.float32)
    want, want_grad = _jax_terms(pred, target)
    stub = object.__new__(tbase.BaseModel)
    stub.device = torch.device("cpu")
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tbase.BaseModel.perceptual_terms(stub, p, torch.from_numpy(target),
                                           KINDS)
    assert sorted(got) == sorted(want) == ["dists", "lpips"]
    for k, v in want.items():
        _rel(float(got[k].detach()), v)
    sum(got.values()).backward()
    grad_close(p.grad.numpy(), want_grad)


# ---------------------------------------------------------------------------
# 3. the models' perceptual terms
# ---------------------------------------------------------------------------

def _model(kind, tmp_path):
    """(port model in phase train, a prepared batch, fed draws, lambda)."""
    if kind == "b2b":
        from test_torch_b2b import clips
        from test_torch_b2b import small_cfg as b2b_cfg
        cfg = b2b_cfg(tmp_path, {"alg": {"b2b": {
            "perceptual_loss": KINDS, "lambda_perceptual": 0.7}}})
        raw = clips(5)
    else:
        from _torch_cm_common import batch, small_cfg
        cfg = small_cfg(tmp_path, {"model_type": kind, "alg": {kind: {
            "perceptual_loss": KINDS, "lambda_perceptual": 0.7}}})
        raw = batch(5)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, phase="train", device="cpu")
    gt = raw["B"]
    b = gt.shape[0]
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    noise = t(rng.standard_normal(gt.shape).astype(np.float32))
    draws = {"cm": {"timesteps": t(rng.integers(0, 9, b)),
                    "noise": noise},
             "sc": {"dt_base": t(rng.integers(0, 7, b)),
                    "t_u": t(rng.uniform(0, 1, b).astype(np.float32)),
                    "noise": noise, "mode_u": t(np.float32(0.5))},
             "b2b": {"t_normal": t(rng.standard_normal(b).astype(
                         np.float32)),
                     "t_uniform": t(rng.uniform(0, 1, b).astype(np.float32)),
                     "t_mix": t(rng.uniform(0, 1, b).astype(np.float32)),
                     "noise": noise}}[kind]
    return tm, tm.prepare_batch(raw), draws, 0.7


@pytest.mark.parametrize("kind", ["cm", "sc", "b2b"])
def test_models_perceptual_terms_match_jax(shared_nets, tmp_path, kind):
    tm, dev, draws, lam = _model(kind, tmp_path)
    assert tm.perceptual == KINDS and tm.lambda_perceptual == lam
    seen = {}
    orig = tm.perceptual_terms

    def spy(pred, target, kinds, mean=None, std=None):
        out = orig(pred, target, kinds, mean, std)
        seen.update(pred=pred.detach().numpy(), target=target.numpy(),
                    terms={k: float(v) for k, v in out.items()},
                    grad=torch.autograd.grad(sum(out.values()), pred,
                                             retain_graph=True)[0].numpy())
        return out
    tm.perceptual_terms = spy
    if kind == "cm":
        losses, pred = tm._g_losses(dev["gt"], dev.get("y_cond"),
                                    dev["mask"], draws)
        m = torch.clamp(dev["mask"].float(), 0, 1)
        np.testing.assert_array_equal(seen["pred"], (pred * m).detach())
        np.testing.assert_array_equal(seen["target"], dev["gt"] * m)
        g_perc = losses["G_perceptual"]
    elif kind == "sc":
        g_perc = tm.optimize_prepared(dev, draws)["G_perceptual"]
        np.testing.assert_array_equal(seen["target"], dev["gt"])
    else:
        _, aux = tm._loss_fn(dev, draws)
        g_perc = aux["G_perceptual"]
        gt = tbase.dequantize(dev["gt"], "image")
        m = torch.clamp(tbase.dequantize(dev["mask"], "label").float(), 0, 1)
        np.testing.assert_array_equal(seen["target"], gt * m)
        assert seen["pred"].ndim == 5          # clips: the frames folded
    _rel(float(g_perc), lam * sum(seen["terms"].values()), 1e-6)
    want, want_grad = _jax_terms(seen["pred"], seen["target"])
    for k, v in want.items():
        _rel(seen["terms"][k], v)
    grad_close(seen["grad"], want_grad)


# ---------------------------------------------------------------------------
# 4. train.py and test.py
# ---------------------------------------------------------------------------

class _Acts:
    """A stand-in image extractor: seeded activations."""

    def __init__(self, is_fallback):
        self.is_fallback = is_fallback

    def __call__(self, imgs):
        return np.random.default_rng(len(imgs)).standard_normal(
            (len(imgs), 8))


def test_train_and_test_entry_points_write_metrics(shared_nets, tmp_path,
                                                   capsys, monkeypatch):
    root = str(tmp_path / "data")
    synth.write_labeled(root, 4, 16, seed=0)
    synth.write_test_split("labeled", root, 2, 16)
    metrics = ["KID", "PSNR", "SSIM", "LPIPS"]
    # the image extractor's batch (which it pads to) at the test split's 2
    monkeypatch.setattr(tmet.InceptionV3Features.__init__, "__defaults__",
                        (2,) + tmet.InceptionV3Features.__init__.__defaults__[
                            1:])
    argv = ["--dataroot", root, "--model_type", "palette",
            "--data_dataset_mode", "self_supervised_labeled_mask",
            "--data_load_size", "16", "--data_crop_size", "16",
            "--data_relative_paths", "--data_num_threads", "1",
            "--G_netG", "unet_mha", "--G_ngf", "8",
            "--G_unet_mha_channel_mults", "1", "2",
            "--G_unet_mha_res_blocks", "1", "1",
            "--G_unet_mha_num_head_channels", "8",
            "--G_unet_mha_group_norm_size", "4",
            "--G_diff_n_timestep_test", "4", "--G_diff_n_timestep_train", "8",
            "--alg_diffusion_cond_embed", "mask",
            "--alg_diffusion_cond_embed_dim", "16", "--tpu_bf16", "false",
            "--train_batch_size", "2", "--train_n_epochs", "1",
            "--train_n_epochs_decay", "0", "--output_display_freq", "0",
            "--train_compute_metrics_test", "true",
            "--train_metrics_every", "2",
            "--train_metrics_list", *metrics, "--test_batch_size", "2",
            "--checkpoints_dir", str(tmp_path / "ckpt"), "--name", "m"]
    opt = TrainOptions().parse_cli(argv)
    launch_training(opt, cpu=True)
    printed = capsys.readouterr().out
    assert printed.count("metrics[test] ") == 2      # iterations 2 and 4
    run_dir = tmp_path / "ckpt" / "m"
    with open(run_dir / "eval_results.json") as f:
        results = json.load(f)
    # the JAX key set: its compute_metrics on stand-ins of the networks
    monkeypatch.setattr(jmet.LPIPS, "__call__", lambda self, a, b: 0.0)
    a = imgs(9, 2, 16)
    want_keys = {f"{k}_test" for k in jmet.compute_metrics(
        a, a, metrics, extractor=_Acts(True))}
    assert list(results) == ["test"] and set(results["test"]) == want_keys
    assert all(np.isfinite(v) for v in results["test"].values())
    # the offline evaluation of that checkpoint
    out = ttest.main(["--test_model_dir", str(run_dir), "--cpu",
                      "--test_metrics_list", "FID", "PSNR",
                      "--test_batch_size", "2", "--sampling_steps", "2",
                      "--sampling_method", "ddim"])
    files = glob.glob(str(run_dir / "metrics" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f) == out
    assert set(out["test"]) == {f"{jmet.metric_key('FID', True)}_test",
                                "PSNR_test"}
