"""Six palette example configs (xview, mapillary, mario, df2kost, SEN2VEN,
viton_tutorial), each cut to a small width on the CPU (crop 32,
ngf 16, mults 1,2, one res block a level, attention at ds 2 and in the mid
block, fp32) over a synthetic dataset in its on-disk layout
(``joligen_tpu_torch/tools/synthetic_datasets.py``), against the JAX
package:

1. the dataset items and ``set_input`` (the conditioning image: ``y_t``,
   the canny sketch, ``low_res``, pix2pix; mask and class), with ``random``
   and numpy seeded alike: items as ``tests/test_torch_data.py`` holds them,
   the sketch, masks and classes exactly, ``low_res`` within 1e-5 of the JAX
   cv2 path;
2. one training forward's loss (1e-5 relative) and every parameter
   gradient (1e-4 of the leaf's largest, as ``test_torch_palette_train.py``)
   on the same converted weights, batch and host draws;
3. DDIM-10 from a shared ``y_t`` (1e-3, as ``test_torch_palette_slice.py``);
4. end to end on the port alone: ``launch_training`` for two steps, then one
   request through ``scripts/gen_single_image_diffusion.py`` from the trained
   checkpoint in the config's request mode (``--bbox_in`` for the online
   configs, with fixed canny thresholds for mapillary; super-resolution and
   pix2pix whole images; viton_tutorial with ``--mask_in``), and for mario
   ``inference_per_class``.
"""

import copy
import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.ops.schedules import extract as jextract
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu_torch.data import create_dataset
from joligen_tpu_torch.data.loader import collate
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules.palette_diffusion import \
    continuous_gammas
from joligen_tpu_torch.ops.cv_resize import resize_area, resize_cubic
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.train import launch_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, STEPS = 32, 2, 200
ZERO_INIT = ("out_conv", "proj_out", "out_proj")
# per config: dataset layout, its image size, and options beyond SMALL;
# mario's class embedding holds 2 classes, the second the null class, so its
# boxes are all of class 1
CONFIGS = {
    "xview": ("online", 64, {"data": {"online_creation": {
        "crop_size_A": 40, "crop_delta_A": 0}}}),
    "mapillary": ("online", 64, {"data": {"online_creation": {
        "crop_size_A": 40, "crop_delta_A": 4}}}),
    "mario": ("online", 64, {"data": {"online_creation": {
        "crop_size_A": 40, "crop_delta_A": 4, "mask_delta_A": [[3]]}}}),
    # train-time metrics (FID on the test set) are not ported
    "df2kost": ("single", 40, {"train": {"compute_metrics_test": False}}),
    "SEN2VEN": ("aligned", 48, {"data": {"load_size": 40}}),
    # the noglasses2glasses layout, with random masks (rand_mask_A)
    "viton_tutorial": ("labeled", 40, {}),
}
SMALL = {
    "data": {"load_size": SIZE, "crop_size": SIZE, "num_threads": 1},
    "G": {"ngf": 16, "unet_mha": {"channel_mults": [1, 2],
                                  "res_blocks": [1, 1], "attn_res": [2],
                                  "num_head_channels": 16,
                                  "group_norm_size": 8},
          "diff_n_timestep_train": STEPS, "diff_n_timestep_test": STEPS},
    "train": {"batch_size": BATCH, "n_epochs": 1, "n_epochs_decay": 0,
              "save_epoch_freq": 100},
    "output": {"print_freq": BATCH, "display_freq": 0},
    "tpu": {"bf16": False},
}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request, tmp_path_factory):
    """(name, cfg dict, dataroot) of one example config, cut to size."""
    name = request.param
    layout, size, extra = CONFIGS[name]
    root = tmp_path_factory.mktemp(f"data_{name}")
    kw = {"classes": (1,)} if name == "mario" else {}
    synth.WRITERS[layout](str(root), 4, size, seed=len(name), **kw)
    with open(os.path.join(ROOT, "examples", f"example_ddpm_{name}.json")) \
            as f:
        cfg = json.load(f)
    _merge(cfg, SMALL)
    _merge(cfg, extra)
    cfg.update(dataroot=str(root), name=name, checkpoints_dir=str(
        tmp_path_factory.mktemp(f"ckpt_{name}")))
    return name, cfg, str(root)


def _options(cfg):
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    return jopt, opt


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _batch(jds, tds):
    """The first BATCH items of both datasets (equal, as test_torch_data
    holds them), collated by the port's loader."""
    items = []
    for i in range(BATCH):
        want, got = (_seeded(lambda ds=ds: ds[i], 100 + i)
                     for ds in (jds, tds))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0,
                                           err_msg=k)
        items.append(got)
    return collate(items)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def walk(tree, zero):
        return {k: (walk(v, zero or k in ZERO_INIT) if isinstance(v, dict)
                    else np.asarray(v) * (1.0 + 0.1 * rng.standard_normal(
                        v.shape)).astype(np.float32)
                    + (rng.normal(0, 0.05, v.shape).astype(np.float32)
                       if zero else 0.0))
                for k, v in tree.items()}
    return walk(jax.device_get(params), False)


@pytest.fixture(scope="module")
def pair(config):
    """Both packages' datasets, a batch and models with the same perturbed
    weights."""
    name, cfg, _ = config
    jopt, opt = _options(cfg)
    batch = _batch(jax_create_dataset(jopt), create_dataset(opt))
    jm = jax_create_model(jopt, phase="test")
    params = _perturbed(jm.states["G_A"].params, seed=1)
    tm = create_model(opt, phase="test", device="cpu")
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        net.load_state_dict(flax_to_torch(params))
    return name, batch, jm, params, tm


def test_set_input_matches_jax(pair):
    name, batch, jm, _, tm = pair
    want = _seeded(lambda: jm.set_input(batch), 9)
    got = _seeded(lambda: tm.set_input(batch), 9)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k == "y_cond" and name == "df2kost":
            np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    gt, cond = got["gt"], got["y_cond"]
    if name == "mapillary":           # canny edges inside the mask only
        inside = got["mask"][..., 0] > 0
        np.testing.assert_array_equal(cond[~inside], gt[~inside])
        assert set(np.unique(cond[inside])) <= {-1.0, 1.0}
    elif name == "df2kost":           # super-resolution: no mask
        assert "mask" not in got
        np.testing.assert_array_equal(cond[0], resize_cubic(
            resize_area(gt[0], 4), (SIZE, SIZE)))
    elif name == "SEN2VEN":           # pix2pix: A conditions, no mask
        assert "mask" not in got
        np.testing.assert_array_equal(cond, batch["A"])
    elif name == "mario":
        assert got["cls"].tolist() == [1] * BATCH
    else:
        assert got["mask"].max() > 0


def _jax_loss_fn(jm):
    """The JAX PaletteModel._loss_fn with host draws in place of its
    jax.random keys (no label dropout, no min-SNR in these configs)."""
    sched = jm.sched_train

    def loss_fn(params, y_cond, gt, mask, cls, d):
        y_cond = dequantize_on_device(y_cond, "image")
        gt = dequantize_on_device(gt, "image")
        mask = dequantize_on_device(mask, "label")
        g_lo = jextract(sched.gammas, d["t"] - 1, 1)
        g_hi = jextract(sched.gammas, d["t"], 1)
        gammas = (g_hi - g_lo) * d["u"] + g_lo
        y_noisy = jpd.q_sample(gt, gammas.reshape(-1, 1, 1, 1), d["noise"])
        if mask is not None:
            m = jnp.clip(mask.astype(gt.dtype), 0.0, 1.0)
            y_noisy = y_noisy * m + (1.0 - m) * gt
        x_in = jnp.concatenate([y_cond, y_noisy], axis=-1)
        noise_hat = jm.netG.apply(params, x_in, gammas, cls=cls, mask=mask)
        return jm.lambda_G * jpd.masked_elementwise_loss(
            d["noise"], noise_hat, mask=mask, kind=jm.loss_kind)
    return loss_fn


def _inputs(jm, tm, batch):
    """JAX inputs (y_cond, gt, mask, cls) and the port's prepared batch,
    each built with ``random`` and numpy seeded alike."""
    inp = _seeded(lambda: quantize_batch(
        jm.set_input(batch), float_keys=("y_cond", "gt"),
        int_keys=("mask",)), 9)
    j = [None if inp.get(k) is None else jnp.asarray(inp[k])
         for k in ("y_cond", "gt", "mask", "cls")]
    return j, _seeded(lambda: tm.prepare_batch(batch), 9)


def test_loss_and_every_gradient_match_jax(pair):
    _, batch, jm, params, tm = pair
    assert jm.dropout_prob == 0.0 and not jm.minsnr
    rng = np.random.default_rng(3)
    d = {"t": rng.integers(1, STEPS, BATCH).astype(np.int32),
         "u": rng.uniform(0, 1, BATCH).astype(np.float32),
         "noise": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
             np.float32)}
    jin, dev = _inputs(jm, tm, batch)
    want_loss, want_grads = jax.value_and_grad(_jax_loss_fn(jm))(
        params, *jin, jax.tree.map(jnp.asarray, d))
    want = flax_to_torch(jax.device_get(want_grads))

    net = tm.nets["G_A"].requires_grad_(True)
    t = torch.from_numpy(d["t"]).long()
    draws = {"t": t, "noise": torch.from_numpy(d["noise"]),
             "gammas": continuous_gammas(tm.sched_train, t,
                                         torch.from_numpy(d["u"]))}
    loss = tm._loss_fn(dev, draws)
    names, ps = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    net.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(names) == set(want)
    scale = max(v.abs().max().item() for v in want.values())
    for n, g in zip(names, grads):
        w = want[n].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-4 * max(np.abs(w).max(), 1e-2 * scale), err_msg=n)


def test_ddim10_matches_jax(pair):
    _, batch, jm, params, tm = pair
    y_t = np.random.default_rng(2).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    (y_cond, gt, mask, cls), dev = _inputs(jm, tm, batch)
    net = jm.netG

    def apply_fn(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return net.apply(p, x, g, cls=cls, mask=mask, ref=ref,
                         zero_gamma=zero_gamma)

    want = jpd.ddim_sample(
        apply_fn, params, jax.random.PRNGKey(0), jm.sched_test,
        dequantize_on_device(y_cond, "image"), y_t=jnp.asarray(y_t),
        y_0=dequantize_on_device(gt, "image"),
        mask=dequantize_on_device(mask, "label"), cls=cls, num_steps=10,
        eta=0.5, out_channel=3)
    got = tm.sample(dev, y_t=torch.from_numpy(y_t), sampling_method="ddim",
                    num_steps=10).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=0)


def _request_args(name, root, ckpt, out):
    """The request of ``name``'s kind on the dataset's first image."""
    if name in ("xview", "mapillary", "mario"):
        img = os.path.join(root, "trainA", "imgs", "0000.png")
        extra = ["--bbox_in", os.path.join(root, "trainA", "bbox",
                                           "0000.txt")]
        if name == "mapillary":
            extra += ["--alg_diffusion_sketch_canny_thresholds", "100",
                      "400"]
    elif name == "df2kost":
        img = os.path.join(root, "trainA", "0000.png")
        extra = ["--alg_diffusion_super_resolution_downsample"]
    elif name == "viton_tutorial":
        img = os.path.join(root, "trainA", "imgs", "0000.png")
        extra = ["--mask_in", os.path.join(root, "trainA", "masks",
                                           "0000.png")]
    else:
        img = os.path.join(root, "trainA", "0000.png")
        extra = []
    return img, gen.build_parser().parse_args([
        "--model_in_file", ckpt, "--img_in", img, "--dir_out", out,
        "--name", "req", "--sampling_method", "ddim", "--sampling_steps",
        "10", "--seed", "0", "--cpu", *extra])


def test_trains_and_serves_end_to_end(config, tmp_path):
    name, cfg, root = config
    _, opt = _options(cfg)
    losses = []
    model = launch_training(opt, cpu=True, step_callback=lambda m, i:
                            losses.append(float(m.loss_log["G_tot"])))
    assert len(losses) == 4 // BATCH and np.isfinite(losses).all()
    assert model.param_count()["G_A"] > 0
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    img_path, args = _request_args(name, root, ckpt, str(tmp_path))
    full, served, _ = gen.inference(args)
    src = np.asarray(Image.open(img_path).convert("RGB"))
    assert full.shape == src.shape and full.dtype == np.uint8
    out = sorted(os.listdir(tmp_path))
    if args.bbox_in:
        with open(tmp_path / "req_orig_bbox.json") as f:
            x1, y1, x2, y2 = json.load(f)
        assert 0 <= x1 < x2 <= src.shape[1] and 0 <= y1 < y2 <= src.shape[0]
        outside = np.ones(src.shape[:2], bool)
        outside[y1:y2, x1:x2] = False
        np.testing.assert_array_equal(full[outside], src[outside])
        assert "req_orig_bbox.json" in out
    assert "req_generated.png" in out and "req_cond.png" in out
    if name == "mario":
        # one output per class: inference with every class label set to
        # each class in turn, the generator seeded alike
        ds = create_dataset(served.opt)
        batch = collate([_seeded(lambda i=i: ds[i], 4) for i in range(BATCH)])
        kw = dict(sampling_method="ddim", num_steps=10)
        served.generator.manual_seed(5)
        per_class = served.inference_per_class(batch, **kw)
        assert sorted(per_class) == [1]        # the config's one class
        served.generator.manual_seed(5)
        want = served.inference(dict(batch, B_label_cls=np.full_like(
            batch["B_label_cls"], 1)), **kw)
        np.testing.assert_array_equal(per_class[1], want)
        assert per_class[1].shape == (BATCH, SIZE, SIZE, 3)
