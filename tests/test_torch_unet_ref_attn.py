"""Ref-conditioned palette on the port (``unet_mha_ref_attn``, the ref
branch of the denoiser, the ref datasets, ``--ref_in``) against the JAX
package, on the CPU, fp32, with seeded weights in which every leaf, the
zero-initialised ``proj_out`` and ``out_proj`` included, is non-zero:

1. ``legacy_attention`` (fp32 to 1e-5; bf16 to 2e-2 of the output's L2
   norm) and ``AttentionBlockRef`` at a plain, a ``use_ref`` and a
   ``terminal`` site (1e-5);
2. ``UNetRefAttn`` at a small width (ngf 8, mults 1,2, one res block a
   level, attention at ds 2, so that the ref decoder stops at a terminal
   site and the main decoder's last level has no site), 16 px:
   the output with and without a reference, and the gradient of every
   parameter, the input's and the reference's, to 1e-4 of their largest;
   the parameter names and count of the example config at full width
   (147,557,059, as ``jax.eval_shape`` counts the JAX net);
3. ``PaletteDenoiser``'s conv-encoder ``ref`` branch (``ref_enc0..2``,
   ``ref_proj``, the halved gamma share), with and without mask
   conditioning and without a reference, and its frozen CLIP branch (the
   tower shrunk), to 1e-4 of the largest output;
4. the four ref dataset modes' items, with ``random`` and numpy seeded
   alike, equal to the JAX package's (1e-6);
5. a 3-step Adam+EMA trajectory of ``PaletteModel.optimize_prepared`` on
   ``example_ddpm_unetref_viton.json`` cut small, against the JAX loss and
   ``apply_updates`` on the same batches (``ref_A`` among them) and host
   draws: losses 1e-4 (relative), parameters and EMA 2e-5, but for the
   elements whose gradient is 0 in exact arithmetic, where Adam turns
   rounding noise into steps of up to lr of either sign: those within
   2 × lr a step (the keys' qkv biases, since a constant added to every key
   leaves the softmax as it is; the biases of the last ref block, whose
   output reaches only the terminal site's InstanceNorm);
6. a ``--ref_in`` request of ``scripts/gen_single_image_diffusion.py``:
   the batch equal to the one the JAX script builds, the output the JAX
   DDIM-10 run on it from the port's first draw (1e-3);
7. the viton_ref layout trained end to end for two steps and served a
   ``--ref_in`` request, on the port alone.
"""

import copy
import functools
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (err_and_scale, few_torch_threads, grads_close,
                               load_flax, merge, one_palette_init,
                               seeded_tree, to_np)
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import diffusion_networks as jdn
from joligen_tpu.models import train_state as jts
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.models.modules import unet_ref_attn as jref
from joligen_tpu.ops.schedules import extract as jextract
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu_torch.data import PORTED_MODES, create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models import diffusion_networks as tdn
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import unet_ref_attn as tref
from joligen_tpu_torch.models.modules.palette_diffusion import (
    PaletteDenoiser, continuous_gammas)
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth
from joligen_tpu_torch.train import launch_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, STEPS = 16, 2, 200
NET = dict(inner_channel=8, cond_embed_dim=32, res_blocks=(1, 1),
           attn_res=(2,), channel_mults=(1, 2), num_head_channels=8,
           group_size=4)
# the viton_ref config cut small
SMALL = {
    "data": {"load_size": SIZE, "crop_size": SIZE, "num_threads": 1},
    "G": {"ngf": 8, "unet_mha": {"channel_mults": [1, 2],
                                 "res_blocks": [1, 1], "attn_res": [2],
                                 "num_head_channels": 8,
                                 "group_norm_size": 4},
          "diff_n_timestep_train": STEPS, "diff_n_timestep_test": STEPS},
    "train": {"batch_size": BATCH, "n_epochs": 1, "n_epochs_decay": 0,
              "save_epoch_freq": 100, "G_ema_beta": 0.9},
    "output": {"print_freq": BATCH, "display_freq": 0},
    "tpu": {"bf16": False},
}


def _rand(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_legacy_attention_matches_jax(dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    qkv = _rand(1, (2, 3 * 24, 20))
    want = np.asarray(jref._legacy_attention(jnp.asarray(qkv, jdt), 3),
                      np.float32)
    got = tref.legacy_attention(torch.from_numpy(qkv).to(tdt), 3)
    assert got.dtype == tdt and got.shape == (2, 24, 20)
    err, scale = err_and_scale(to_np(got), want, norm=dt == "bf16")
    assert err <= (2e-2 if dt == "bf16" else 1e-5) * scale, (err, scale)


@pytest.mark.parametrize("site", ["plain", "use_ref", "terminal"])
def test_attention_block_ref_matches_jax(site):
    kw = {"use_ref": site == "use_ref", "terminal": site == "terminal"}
    x = _rand(2, (2, 4, 5, 16))
    qkv_ref = _rand(3, (2, 48, 20))
    jmod = jref.AttentionBlockRef(num_head_channels=8, **kw)
    jargs = (jnp.asarray(x), jnp.asarray(qkv_ref) if kw["use_ref"] else None)
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(k, *jargs),
                                      jax.random.PRNGKey(0)), 4, 0.2)
    assert ("proj_out" in tree["params"]) == (site != "terminal")
    tmod = load_flax(tref.AttentionBlockRef(16, num_head_channels=8, **kw),
                     tree)
    jout, jqkv = jmod.apply(tree, *jargs)
    with torch.no_grad():
        out, qkv = tmod(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(qkv_ref) if kw["use_ref"] else None)
    np.testing.assert_allclose(to_np(qkv), np.asarray(jqkv), atol=1e-5)
    if site == "terminal":
        assert out is None and jout is None
        return
    np.testing.assert_allclose(to_np(out.permute(0, 2, 3, 1)),
                               np.asarray(jout), atol=1e-5)


def _ref_unet_pair(seed):
    jmod = jref.UNetRefAttn(in_channel=6, out_channel=3, **NET)
    tmod = tref.UNetRefAttn(in_channel=6, out_channel=3, **NET)
    x, emb, ref = (_rand(seed, (2, SIZE, SIZE, 6)), _rand(seed + 1, (2, 32)),
                   _rand(seed + 2, (2, SIZE, SIZE, 3)))
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(
        k, jnp.asarray(x), jnp.asarray(emb), ref=jnp.asarray(ref)),
        jax.random.PRNGKey(0)), seed + 3, 0.05, lecun=True)
    load_flax(tmod, tree)
    return jmod, tmod, tree, x, emb, ref


def test_unet_ref_attn_forward_and_gradients_match_jax():
    jmod, tmod, tree, x, emb, ref = _ref_unet_pair(10)
    names = {k.split(".")[0] for k in tmod.state_dict()}
    # four sites a tower; the ref decoder stops at its terminal site, the
    # last at ds 2, which has no proj_out, and before its level's upsampler
    assert {"AttnRef_3", "RefAttn_3"} <= names
    assert not {"AttnRef_4", "RefAttn_4"} & names
    assert tmod.RefAttn_3.terminal and not hasattr(tmod.RefAttn_3,
                                                   "proj_out")
    assert sum(n.startswith("RefResBlock") for n in names) == 7
    assert sum(n.startswith("ResBlock") for n in names) == 10
    cot = np.random.default_rng(11).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)

    def f(p, a, e, r):
        return jnp.sum(jmod.apply(p, a, e, ref=r) * cot)

    apply = jax.jit(jmod.apply)
    jout = apply(params, jnp.asarray(x), jnp.asarray(emb),
                 ref=jnp.asarray(ref))
    jgp, jgx, jgr = jax.jit(jax.grad(f, argnums=(0, 1, 3)))(
        params, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(ref))
    xt, rt = (torch.from_numpy(a).requires_grad_(True) for a in (x, ref))
    out = tmod(xt, torch.from_numpy(emb), ref=rt)
    assert out.dtype == torch.float32
    err, scale = err_and_scale(to_np(out), jout, norm=False)
    assert err <= 1e-4 * scale, (err, scale)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, jgx), (rt.grad, jgr)):
        err, scale = err_and_scale(to_np(got), want, norm=False)
        assert scale > 0 and err <= 1e-4 * scale, (err, scale)
    grads_close(jgp, tmod, 1e-4, 1e-6)
    # without a reference (zeros) and without an embedding (ones)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = apply(params, jnp.asarray(x))
    err, scale = err_and_scale(to_np(got), want, norm=False)
    assert err <= 1e-4 * scale, (err, scale)


def test_example_config_at_full_width_matches_jax_tree():
    with open(os.path.join(ROOT, "examples",
                           "example_ddpm_unetref_viton.json")) as f:
        cfg = json.load(f)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jnet = jdn.define_G(jopt)
    shapes = jax.eval_shape(lambda k: jnet.init(
        k, jnp.zeros((1, 128, 128, 6)), jnp.zeros((1,)),
        ref=jnp.zeros((1, 128, 128, 3))), jax.random.PRNGKey(0))
    # flax's shapes in torch's layout: HWIO -> OIHW, (in, out) -> (out, in)
    order = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}
    want = {k: tuple(v.shape[i] for i in order[len(v.shape)])
            for k, v in zip(flax_to_torch(jax.tree.map(
                lambda a: np.zeros((1,) * len(a.shape), np.float32),
                shapes)), jax.tree.leaves(shapes))}
    net = tdn.define_G(opt)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)) == \
        sum(p.numel() for p in net.parameters()) == 147_557_059


@pytest.mark.parametrize("conditioning", ["ref", "mask_ref"])
def test_denoiser_conv_ref_branch_matches_jax(conditioning):
    extra = 32 if "mask" in conditioning else 0
    jmod = jpd.PaletteDenoiser(
        inner=jref.UNetRefAttn(in_channel=6, out_channel=3, **NET),
        cond_embed_dim=32, conditioning=conditioning, nclasses=3)
    tmod = PaletteDenoiser(
        tref.UNetRefAttn(in_channel=6, out_channel=3, x_channels=6 + extra,
                         **NET),
        cond_embed_dim=32, conditioning=conditioning, nclasses=3)
    assert tmod.gamma_dim == 16 and tmod.ref_proj.weight.shape == (16, 256)
    x, ref = _rand(20, (2, SIZE, SIZE, 6)), _rand(21, (2, SIZE, SIZE, 3))
    gam = np.array([0.3, 0.8], np.float32)
    mask = np.zeros((2, SIZE, SIZE, 1), np.int32)
    mask[:, 3:9, 4:12] = 2
    jkw = {"mask": jnp.asarray(mask)} if extra else {}
    tkw = {"mask": torch.from_numpy(mask)} if extra else {}
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(
        k, jnp.asarray(x), jnp.asarray(gam), ref=jnp.asarray(ref), **jkw),
        jax.random.PRNGKey(0)), 22, 0.05, lecun=True)
    load_flax(tmod, tree)
    for with_ref in (True, False):
        want = jmod.apply(tree, jnp.asarray(x), jnp.asarray(gam),
                          ref=jnp.asarray(ref) if with_ref else None, **jkw)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x), torch.from_numpy(gam),
                       ref=torch.from_numpy(ref) if with_ref else None,
                       **tkw)
        err, scale = err_and_scale(to_np(got), want, norm=False)
        assert err <= 1e-4 * scale, (with_ref, err, scale)


def test_denoiser_clip_ref_branch_matches_jax(monkeypatch):
    """``alg_diffusion_ref_embed_net: clip``: the frozen CLIP tower (shrunk
    to dim 64, depth 2 in both packages; every table seeded), SiLU and
    ``ref_proj``; the tower gives no gradient."""
    from joligen_tpu.utils import clip_vit as jclip
    from joligen_tpu_torch.utils import clip_vit as tclip
    for mod in (jclip, tclip):
        monkeypatch.setattr(mod, "CLIPVisualViT", functools.partial(
            mod.CLIPVisualViT, dim=64, depth=2, heads=2))
    jmod = jpd.PaletteDenoiser(
        inner=jref.UNetRefAttn(in_channel=6, out_channel=3, **NET),
        cond_embed_dim=32, conditioning="ref", ref_embed_net="clip")
    tmod = PaletteDenoiser(tref.UNetRefAttn(in_channel=6, out_channel=3,
                                            **NET),
                           cond_embed_dim=32, conditioning="ref",
                           ref_embed_net="clip")
    x, ref = _rand(23, (2, SIZE, SIZE, 6)), _rand(24, (2, SIZE, SIZE, 3))
    gam = np.array([0.3, 0.8], np.float32)
    tree = seeded_tree(jax.eval_shape(lambda k: jmod.init(
        k, jnp.asarray(x), jnp.asarray(gam), ref=jnp.asarray(ref)),
        jax.random.PRNGKey(0)), 25, 0.05, lecun=True)
    load_flax(tmod, tree)
    want = jax.jit(jmod.apply)(tree, jnp.asarray(x), jnp.asarray(gam),
                               ref=jnp.asarray(ref))
    got = tmod(torch.from_numpy(x), torch.from_numpy(gam),
               ref=torch.from_numpy(ref))
    err, scale = err_and_scale(to_np(got), want, norm=False)
    assert err <= 1e-4 * scale, (err, scale)
    got.square().sum().backward()
    assert all(p.grad is None or not p.grad.any()
               for p in tmod.freezenet_clip.parameters())
    assert tmod.ref_proj.weight.grad.abs().max() > 0


REF_MODES = ("unaligned_labeled_mask_ref",
             "unaligned_labeled_mask_online_ref",
             "self_supervised_labeled_mask_ref",
             "self_supervised_labeled_mask_online_ref")


@pytest.mark.parametrize("mode", REF_MODES)
def test_ref_dataset_items_match_jax(mode, tmp_path):
    assert mode in PORTED_MODES
    root = str(tmp_path)
    online = "online" in mode
    if "unaligned" in mode:
        (synth.write_online_ab if online else synth.write_unaligned_labeled)(
            root, 3, 48 if online else 24, seed=5)
    else:
        (synth.write_online if online else synth.write_labeled)(
            root, 3, 48 if online else 24, seed=5)
    synth.write_refs(root, 3, seed=6, ref_size=20)
    cfg = {"model_type": "palette", "dataroot": root,
           "data": {"dataset_mode": mode, "load_size": 20, "crop_size": 16,
                    "relative_paths": True,
                    "online_creation": {"crop_size_A": 24, "crop_delta_A": 4,
                                        "crop_size_B": 24,
                                        "crop_delta_B": 4}}}
    jds = jax_create_dataset(JaxTrainOptions().parse_json(cfg, verbose=False))
    tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False))
    assert len(jds) == len(tds) == 3
    for i in range(3):
        items = []
        for ds in (jds, tds):
            random.seed(30 + i)
            np.random.seed(30 + i)
            items.append(ds[i])
        want, got = items
        assert "ref_A" in got and got["ref_A"].shape == (16, 16, 3)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0,
                                           err_msg=k)
            else:
                assert got[k] == w, k


def _viton_cfg(tmp, extra=None):
    with open(os.path.join(ROOT, "examples",
                           "example_ddpm_unetref_viton.json")) as f:
        cfg = json.load(f)
    merge(cfg, copy.deepcopy(SMALL))
    cfg["checkpoints_dir"] = str(tmp)
    return merge(cfg, extra or {})


def _batch(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((BATCH, SIZE, SIZE, 1), np.int32)
    mask[0, 2:10, 3:13] = 1
    mask[1, 5:15, 1:7] = 1
    cond = np.where(mask > 0, 0.0, gt).astype(np.float32)
    ref = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return {"A": cond, "B": gt, "B_label_mask": mask, "ref_A": ref}


def _draws(seed):
    rng = np.random.default_rng(seed)
    return {"t": rng.integers(1, STEPS, BATCH).astype(np.int32),
            "u": rng.uniform(0, 1, BATCH).astype(np.float32),
            "noise": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
                np.float32)}


def _seeded_params(jm, seed):
    shapes = jax.eval_shape(lambda: jm.states["G_A"].params)
    return seeded_tree(shapes, seed, 0.05, lecun=True)


def test_ref_trajectory_matches_jax(tmp_path):
    cfg = _viton_cfg(tmp_path)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    jm = jax_create_model(jopt, phase="test")
    tm = create_model(opt, phase="train", device="cpu")
    assert jm.use_ref and tm.use_ref and opt.train_optim == "adam"
    params = _seeded_params(jm, 40)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        load_flax(net, params)
    sched, tx = jm.sched_train, jm.txs["G_A"]

    def loss_fn(p, y_cond, gt, mask, ref, d):
        y_cond, gt, ref = (dequantize_on_device(a, "image")
                           for a in (y_cond, gt, ref))
        mask = dequantize_on_device(mask, "label")
        g_lo = jextract(sched.gammas, d["t"] - 1, 1)
        g_hi = jextract(sched.gammas, d["t"], 1)
        gammas = (g_hi - g_lo) * d["u"] + g_lo
        y_noisy = jpd.q_sample(gt, gammas.reshape(-1, 1, 1, 1), d["noise"])
        m = jnp.clip(mask.astype(gt.dtype), 0.0, 1.0)
        y_noisy = y_noisy * m + (1.0 - m) * gt
        noise_hat = jm.netG.apply(p, jnp.concatenate([y_cond, y_noisy], -1),
                                  gammas, mask=mask, ref=ref)
        return jm.lambda_G * jpd.masked_elementwise_loss(
            d["noise"], noise_hat, mask=mask, kind=jm.loss_kind)

    @jax.jit
    def jstep(state, inp, d):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, *inp, d)
        return jts.apply_updates(state, grads, tx, jm.ema_beta), loss, grads

    p = jax.tree.map(jnp.asarray, params)
    js = jts.NetState(params=p, opt_state=tx.init(p),
                      ema_params=jax.tree.map(jnp.copy, p),
                      step=jnp.zeros((), jnp.int32))
    for i in range(3):
        batch, d = _batch(50 + i), _draws(60 + i)
        inp = quantize_batch(jm.set_input(batch),
                             float_keys=("y_cond", "gt", "ref"),
                             int_keys=("mask",))
        js, want, grads = jstep(js, [jnp.asarray(inp[k]) for k in (
            "y_cond", "gt", "mask", "ref")], jax.tree.map(jnp.asarray, d))
        if i == 0:
            g0 = flax_to_torch(jax.device_get(grads))
        dev = tm.prepare_batch(batch)
        assert "ref" in dev
        t = torch.from_numpy(d["t"]).long()
        losses = tm.optimize_prepared(dev, draws={
            "t": t, "noise": torch.from_numpy(d["noise"]),
            "gammas": continuous_gammas(tm.sched_train, t,
                                        torch.from_numpy(d["u"]))})
        np.testing.assert_allclose(losses["G_tot"].item(), float(want),
                                   rtol=1e-4)
    # the elements of exactly zero gradient: below 1e-7 of the largest
    # element of the first step's JAX gradient (their rounding noise is
    # below 1e-8 of it here)
    top = max(g.abs().max().item() for g in g0.values())
    lr = float(opt.train_G_lr)
    host = jax.device_get(js)
    for module, tree in ((tm.nets["G_A"], host.params),
                         (tm.ema_nets["G_A"], host.ema_params)):
        want = flax_to_torch(tree)
        for k, v in module.state_dict().items():
            g = g0[k].abs()
            noise = g <= 1e-7 * top
            diff = (v - want[k]).abs()
            assert diff[~noise].max() <= 2e-5 if (~noise).any() else True, k
            assert not noise.any() or diff[noise].max() <= 2 * lr * 3, k
    start = flax_to_torch(params)
    moved = max((v - start[k]).abs().max().item()
                for k, v in tm.nets["G_A"].state_dict().items())
    assert moved > 1e-4


def _jax_script():
    path = os.path.join(ROOT, "scripts", "gen_single_image_diffusion.py")
    spec = importlib.util.spec_from_file_location("jax_gen_single_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ref_in_request_matches_jax_script(tmp_path):
    cfg = _viton_cfg(tmp_path, {"name": "ref"})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jm = jax_create_model(jopt, phase="test")
    params, ema = _seeded_params(jm, 70), _seeded_params(jm, 71)
    jm.states["G_A"] = jm.states["G_A"].replace(params=params,
                                                ema_params=ema)
    jm.save_dir = str(tmp_path / "ref")
    os.makedirs(jm.save_dir)
    jm.save_networks("latest")
    with open(tmp_path / "ref" / "train_config.json", "w") as f:
        json.dump(cfg, f)
    rng = np.random.default_rng(72)
    Image.fromarray(rng.integers(0, 256, (24, 20, 3), np.uint8)).save(
        tmp_path / "img.png")
    Image.fromarray(rng.integers(0, 256, (30, 26, 3), np.uint8)).save(
        tmp_path / "ref.png")
    mask = np.zeros((24, 20), np.uint8)
    mask[4:14, 5:15] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    argv = ["--model_in_file", str(tmp_path / "ref" / "latest_net_G_A.pth"),
            "--img_in", str(tmp_path / "img.png"),
            "--mask_in", str(tmp_path / "mask.png"),
            "--ref_in", str(tmp_path / "ref.png"),
            "--dir_out", str(tmp_path / "out"), "--sampling_method", "ddim",
            "--sampling_steps", "10", "--seed", "3", "--cpu"]

    # the batch the JAX script builds
    jgen, seen = _jax_script(), []
    jm.inference = lambda batch, **kw: seen.append(batch) or batch["B"]
    jgen.inference(jgen.build_parser().parse_args(argv), lmodel=jm,
                   lopt=jm.opt)
    jbatch, = seen

    from joligen_tpu_torch.scripts.common import load_model_from_file
    model, mopt = load_model_from_file(argv[1], cpu=True)
    got, infer = [], model.inference

    def recording(batch, **kw):
        got.append((batch, infer(batch, **kw)))
        return got[-1][1]
    model.inference = recording
    full, _, _ = gen.inference(gen.build_parser().parse_args(argv),
                               lmodel=model, lopt=mopt)
    (tbatch, out), = got
    assert sorted(tbatch) == sorted(jbatch)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(tbatch[k], v, err_msg=k)
    assert tbatch["ref_A"].shape == (1, SIZE, SIZE, 3)
    assert full.shape == (24, 20, 3)

    # the JAX DDIM-10 run on that batch from the port's first draw
    y_t = torch.randn((1, SIZE, SIZE, 3),
                      generator=torch.Generator().manual_seed(3))
    inp = quantize_batch(jm.set_input(jbatch),
                         float_keys=("y_cond", "gt", "ref"),
                         int_keys=("mask",))
    net = jm.netG

    def apply_fn(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return net.apply(p, x, g, cls=cls, mask=mask, ref=ref,
                         zero_gamma=zero_gamma)

    def dev(k, kind="image"):
        return dequantize_on_device(jnp.asarray(inp[k]), kind)
    want = jax.jit(lambda p, y_cond, y_t, y_0, mask, ref: jpd.ddim_sample(
        apply_fn, p, jax.random.PRNGKey(0), jm.sched_test, y_cond, y_t=y_t,
        y_0=y_0, mask=mask, ref=ref, num_steps=10, eta=0.5, out_channel=3))(
        jax.tree.map(jnp.asarray, ema), dev("y_cond"),
        jnp.asarray(y_t.numpy()), dev("gt"), dev("mask", "label"),
        dev("ref"))
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-3, rtol=0)


def test_viton_ref_trains_and_serves_end_to_end(tmp_path):
    root = str(tmp_path / "data")
    synth.write_online_ref(root, 4, 48, seed=8)
    cfg = _viton_cfg(tmp_path, {
        "dataroot": root, "name": "viton_ref",
        "data": {"online_creation": {"crop_size_A": 24, "crop_delta_A": 4}}})
    opt = TrainOptions().parse_json(cfg, verbose=False)
    losses = []
    launch_training(opt, cpu=True, step_callback=lambda m, i:
                    losses.append(float(m.loss_log["G_tot"])))
    assert len(losses) == 4 // BATCH and np.isfinite(losses).all()
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    args = gen.build_parser().parse_args([
        "--model_in_file", ckpt,
        "--img_in", os.path.join(root, "trainA", "imgs", "0000.png"),
        "--bbox_in", os.path.join(root, "trainA", "bbox", "0000.txt"),
        "--ref_in", os.path.join(root, "trainA", "ref", "0000.png"),
        "--dir_out", str(tmp_path / "out"), "--sampling_method", "ddim",
        "--sampling_steps", "4", "--seed", "0", "--cpu"])
    full, _, _ = gen.inference(args)
    assert full.shape == (48, 48, 3) and full.dtype == np.uint8
    assert os.path.exists(tmp_path / "out" / "0000_generated.png")
