"""Palette with the ``uvit`` and ``resnet_attn`` denoisers and with
``train_feat_wavelet`` (the ``unet_mha`` trunk on Haar bands), against the
JAX package on the CPU: ``example_ddpm_noglasses2glasses.json`` (mask
conditioning, its ``cond_embed_dim`` 256 cut to 32) at a small width (32
px, ngf 16, mults 1,2, one res block a level, attention at ds 2, 2 UViT
blocks; resnet_attn with 2 blocks and 4 masks; fp32), over the synthetic
labeled-mask layout:

1. the training forward's loss (1e-5 relative) and every parameter
   gradient (1e-4 of the leaf's largest, a floor of 1e-2 of the largest of
   all, as ``tests/test_torch_palette_configs.py``) on the same weights (the
   JAX init's tree with every leaf, the zero-initialised ones too, moved by
   seeded noise), batch and host draws: the denoiser's forward and
   backward through the palette loss;
2. DDIM-10 from a shared ``y_t`` (1e-3);
3. end to end on the port: ``launch_training`` for two steps, then a
   ``--mask_in`` request through ``scripts/gen_single_image_diffusion.py``
   from the trained checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

# few_torch_threads, one_palette_init: autouse fixtures, active once
# imported
from _torch_gan_common import few_torch_threads, one_palette_init  # noqa
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu_torch.data import create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules.palette_diffusion import \
    continuous_gammas
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.train import launch_training
from test_torch_palette_configs import (BATCH, SIZE, SMALL, STEPS, _batch,
                                        _inputs, _jax_loss_fn, _merge,
                                        _options)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the training draws: with seed 3 one ReLU input of resnet_attn's content
# decoder sits 6e-7 from 0, on the other side in fp32 than in float64 (and
# than in the JAX package's fp32): that one element moves the stem's
# gradient by 4e-4 of its largest, while every other element of the port's
# fp32 gradient is within 1e-6 of its float64 one
DRAWS_SEED = 4
VARIANTS = {
    "uvit": {"G": {"netG": "uvit", "uvit_num_transformer_blocks": 2}},
    "resnet_attn": {"G": {"netG": "resnet_attn", "nblocks": 2,
                          "attn_nb_mask_attn": 4}},
    "wavelet": {"train": {"feat_wavelet": True}},
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, tmp_path_factory):
    """(name, cfg dict, dataroot) of the example config cut to size with
    the variant's options."""
    name = request.param
    root = tmp_path_factory.mktemp(f"data_{name}")
    synth.write_labeled(str(root), 4, 40, seed=3)
    with open(os.path.join(ROOT, "examples",
                           "example_ddpm_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    _merge(cfg, SMALL)
    _merge(cfg, {"alg": {"diffusion": {"cond_embed_dim": 32}},
                 "data": {"load_size": 40}})
    _merge(cfg, VARIANTS[name])
    cfg.update(dataroot=str(root), name=name, checkpoints_dir=str(
        tmp_path_factory.mktemp(f"ckpt_{name}")))
    return name, cfg, str(root)


def _noisy(params, seed):
    """Every leaf moved by seeded noise: no zero-initialised layer (UViT's
    ``proj_kernel`` and ``to_scale_shift``, ``film``, ``out_proj``) stays
    zero."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.05, np.shape(v))).astype(
            np.float32), jax.device_get(params))


@pytest.fixture(scope="module")
def pair(variant):
    name, cfg, _ = variant
    jopt, opt = _options(cfg)
    batch = _batch(jax_create_dataset(jopt), create_dataset(opt))
    jm = jax_create_model(jopt, phase="test")
    params = _noisy(jm.states["G_A"].params, seed=1)
    tm = create_model(opt, phase="test", device="cpu")
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        net.load_state_dict(flax_to_torch(params))
    return name, batch, jm, params, tm


def test_loss_and_every_gradient_match_jax(pair):
    name, batch, jm, params, tm = pair
    inner = tm.nets["G_A"].inner
    assert type(inner).__name__ == {
        "uvit": "UNetMHA", "resnet_attn": "ResnetGeneratorAttnDiff",
        "wavelet": "UNetMHA"}[name]
    assert getattr(inner, "freq_space", False) == (name == "wavelet")
    rng = np.random.default_rng(DRAWS_SEED)
    d = {"t": rng.integers(1, STEPS, BATCH).astype(np.int32),
         "u": rng.uniform(0, 1, BATCH).astype(np.float32),
         "noise": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
             np.float32)}
    jin, dev = _inputs(jm, tm, batch)
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jm)))(
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
    from test_torch_palette_configs import test_ddim10_matches_jax as ddim
    ddim(pair)


def test_trains_and_serves_end_to_end(variant, tmp_path):
    name, cfg, root = variant
    _, opt = _options(cfg)
    losses = []
    model = launch_training(opt, cpu=True, step_callback=lambda m, i:
                            losses.append(float(m.loss_log["G_tot"])))
    assert len(losses) == 4 // BATCH and np.isfinite(losses).all()
    assert model.param_count()["G_A"] > 0
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    img = os.path.join(root, "trainA", "imgs", "0000.png")
    args = gen.build_parser().parse_args([
        "--model_in_file", ckpt, "--img_in", img, "--dir_out",
        str(tmp_path), "--name", "req", "--mask_in",
        os.path.join(root, "trainA", "masks", "0000.png"),
        "--sampling_method", "ddim", "--sampling_steps", "10", "--seed",
        "0", "--cpu"])
    full, _, _ = gen.inference(args)
    src = np.asarray(Image.open(img).convert("RGB"))
    assert full.shape == src.shape and full.dtype == np.uint8
    assert "req_generated.png" in os.listdir(tmp_path)


@pytest.mark.parametrize("args,count", [
    (["--G_netG", "uvit"], 72_451_587),
    (["--G_netG", "resnet_attn"], 12_929_573),
    (["--train_feat_wavelet"], 63_296_396)])
def test_full_width_trees_match_jax(args, count):
    """The example config at 128 px with each variant (the smoke's
    palette_uvit_128, palette_resnet_attn_128, palette_wavelet_128), on the
    meta device: every leaf's name and shape against ``jax.eval_shape`` of
    the JAX denoiser, and the parameter count the smoke asserts."""
    from joligen_tpu.models.diffusion_networks import define_G as jdefine
    from joligen_tpu.options import TrainOptions as JaxTrainOptions
    from joligen_tpu_torch.models.diffusion_networks import define_G
    from joligen_tpu_torch.models.convert import torch_to_flax
    from joligen_tpu_torch.options import TrainOptions
    example = ["--config_json", os.path.join(
        ROOT, "examples", "example_ddpm_noglasses2glasses.json"), *args]
    jnet = jdefine(JaxTrainOptions().parse_cli(example))
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, 128, 128, 6)), jnp.zeros((1,)),
        cls=jnp.zeros((1,), jnp.int32),
        mask=jnp.zeros((1, 128, 128, 1), jnp.int32)), jax.random.PRNGKey(0))
    want = {"/".join(str(p.key) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                shapes["params"])}
    with torch.device("meta"):
        tnet = define_G(TrainOptions().parse_cli(example))
    # the converter's names and layouts, on zeros of the meta shapes
    tree = torch_to_flax({k: torch.zeros(v.shape)
                          for k, v in tnet.state_dict().items()})
    got = {"/".join(str(p.key) for p in path): leaf.shape
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               tree["params"])}
    assert got == want
    n = sum(p.numel() for p in tnet.parameters())
    assert n == sum(int(np.prod(s)) for s in want.values()) == count
