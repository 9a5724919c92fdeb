"""The whole serving slice, on a small palette config on the CPU.

1. The JAX PaletteModel's jitted ``run`` (palette_model.py:329-345),
   reproduced here with a shared y_t (the JAX one draws it from jax.random
   inside the jit): uint8 wire step, device decode, DDIM-10 with the model's
   test schedule and EMA params. The port's PaletteModel loads the JAX
   model's checkpoint files and does the same steps.
2. The port's ``inference`` with a seeded generator equals that composition
   when its first draw is y_t.
3. The port's gen_single_image_diffusion script serves a request end to
   end from a checkpoint directory.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models.modules.palette_diffusion import ddim_sample
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
from joligen_tpu_torch.scripts.common import to_m1p1, to_uint8

SIZE = 16
CFG = {
    "model_type": "palette", "name": "slice",
    "data": {"crop_size": SIZE, "load_size": SIZE},
    "G": {"netG": "unet_mha", "ngf": 16,
          "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                       "attn_res": [2], "num_head_channels": 16},
          "diff_n_timestep_test": 200},
    "alg": {"diffusion": {"task": "inpainting", "cond_embed": "mask",
                          "cond_embed_dim": 32},
            "palette": {"sampling_method": "ddpm"}},
    "train": {"G_ema": True},
    "tpu": {"bf16": False},
}
ZERO_INIT = ("out_conv", "proj_out", "out_proj")


def _batch(seed):
    rng = np.random.default_rng(seed)
    crop = rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((1, SIZE, SIZE, 1), np.int32)
    mask[:, 3:12, 5:14] = 1
    cond = np.where(mask > 0, rng.uniform(-1, 1, crop.shape), crop).astype(
        np.float32)
    return {"A": cond, "B": crop, "B_label_mask": mask}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX PaletteModel with perturbed random params and a distinct EMA,
    saved as the JAX package saves it. Returns (jax model, directory)."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = dict(CFG, checkpoints_dir=str(d))
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jm = jax_create_model(jopt, phase="test")
    rng = np.random.default_rng(0)

    def perturb(tree, zero=False):
        return {k: (perturb(v, zero or k in ZERO_INIT) if isinstance(v, dict)
                    else np.asarray(v) * (1.0 + 0.1 * rng.standard_normal(
                        v.shape)).astype(np.float32)
                    + (rng.normal(0, 0.05, v.shape).astype(np.float32)
                       if zero else 0.0))
                for k, v in tree.items()}
    st = jm.states["G_A"]
    jm.states["G_A"] = st.replace(
        params=perturb(jax.device_get(st.params)),
        ema_params=perturb(jax.device_get(st.ema_params)))
    jm.save_dir = str(d)
    jm.save_networks("latest")
    with open(d / "train_config.json", "w") as f:
        json.dump(cfg, f)
    return jm, d


def _port_model(d):
    opt = TrainOptions().parse_json(json.loads(
        (d / "train_config.json").read_text()), verbose=False)
    m = create_model(opt, phase="test", device="cpu")
    m.save_dir = str(d)
    m.load_networks("latest")
    return m


def test_ddim10_slice_matches_jax_run(checkpoint):
    jm, d = checkpoint
    batch = _batch(1)
    y_t = np.random.default_rng(2).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)

    inp = quantize_batch(jm.set_input(batch), float_keys=("y_cond", "gt"),
                         int_keys=("mask",))
    net = jm.netG

    def apply_fn(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return net.apply(p, x, g, cls=cls, mask=mask, ref=ref,
                         zero_gamma=zero_gamma)

    def run(p, y_cond, y_0, mask):
        y_cond = dequantize_on_device(y_cond, "image")
        y_0 = dequantize_on_device(y_0, "image")
        mask = dequantize_on_device(mask, "label")
        return ddim_sample(apply_fn, p, jax.random.PRNGKey(0), jm.sched_test,
                           y_cond, y_t=jnp.asarray(y_t), y_0=y_0, mask=mask,
                           num_steps=10, eta=0.5, out_channel=3)
    want = np.asarray(jax.jit(run)(jm.states["G_A"].ema_params,
                                   jnp.asarray(inp["y_cond"]),
                                   jnp.asarray(inp["gt"]),
                                   jnp.asarray(inp["mask"])))

    tm = _port_model(d)
    dev = tm.prepare_batch(batch)
    assert dev["y_cond"].dtype == torch.uint8 and dev["mask"].dtype == \
        torch.uint8
    got = tm.sample(dev, y_t=torch.from_numpy(y_t), sampling_method="ddim",
                    num_steps=10).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    # the EMA weights are the ones sampled with
    raw = tm.sample(dev, y_t=torch.from_numpy(y_t), sampling_method="ddim",
                    num_steps=10, use_ema=False).numpy()
    assert np.abs(raw - got).max() > 1e-3


@pytest.mark.parametrize("method", ["ddim", "ddpm"])
def test_inference_equals_composition_with_first_draw_as_y_t(checkpoint,
                                                             method):
    _, d = checkpoint
    tm = _port_model(d)
    tm.sched_test = type(tm.sched_test).for_phase(20, "test")
    batch = _batch(3)
    tm.generator.manual_seed(11)
    got = tm.inference(batch, sampling_method=method)
    tm.generator.manual_seed(11)
    y_t = torch.randn((1, SIZE, SIZE, 3), generator=tm.generator)
    want = tm.sample(tm.prepare_batch(batch), y_t=y_t,
                     sampling_method=method).numpy()
    assert np.array_equal(got, want)
    u8 = tm.inference(batch, sampling_method="ddim", output_uint8=True)
    assert u8.dtype == np.uint8 and u8.shape == (1, SIZE, SIZE, 3)


def test_script_serves_a_request_on_cpu(checkpoint, tmp_path):
    _, d = checkpoint
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    m = np.zeros((40, 40), np.uint8)
    m[8:30, 10:25] = 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    args = gen.build_parser().parse_args([
        "--model_in_file", str(d / "latest_net_G_A.pth"),
        "--img_in", str(tmp_path / "img.png"),
        "--mask_in", str(tmp_path / "mask.png"),
        "--dir_out", str(tmp_path / "out"), "--sampling_method", "ddim",
        "--seed", "0", "--cpu"])
    full, model, _ = gen.inference(args)
    assert full.shape == img.shape and model.device.type == "cpu"
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == sorted(f"img_{s}.png" for s in (
        "orig", "cond", "generated", "generated_crop", "y_t", "mask"))
    crop_u8 = np.asarray(Image.open(tmp_path / "out" /
                                    "img_generated_crop.png"))
    keep = np.asarray(Image.open(tmp_path / "out" / "img_mask.png")) == 0
    # outside the mask: the uint8-quantised input crop, decoded
    crop = to_m1p1(np.asarray(Image.fromarray(img).resize(
        (SIZE, SIZE), Image.BICUBIC)))
    q = quantize_batch({"x": crop}, float_keys=("x",))["x"]
    expect = to_uint8(torch.from_numpy(q).float().numpy() / 127.5 - 1.0)
    assert keep.sum() > 0
    assert np.array_equal(crop_u8[keep], expect[keep])
    # a second request reuses the loaded model
    gen.inference(args, lmodel=model, lopt=model.opt)
    bad = gen.build_parser().parse_args([
        "--model_in_file", str(d / "latest_net_G_A.pth"),
        "--img_in", str(tmp_path / "img.png"), "--bbox_in", "b.txt",
        "--cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gen.inference(bad, lmodel=model, lopt=model.opt)
