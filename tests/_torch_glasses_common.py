"""Helpers of ``tests/test_torch_glasses_cut*.py``: noglasses2glasses cut
small, its towers shrunk in both packages, the models of both packages on
the same weights, batches with label masks, the JAX step's draws, and the
3-step trajectory against the JAX step (its checks are set out in
``tests/test_torch_glasses_cut.py``)."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_gan_common import (ROOT, fast_init_net_state, grads_close,
                               load_flax, merge, patch_ids, pool_draws,
                               to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu.utils import clip_vit as jclip
from joligen_tpu.utils import dinov2 as jdino
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.utils import clip_vit as tclip
from joligen_tpu_torch.utils import dinov2 as tdino

SIZE, BATCH, STEPS, LR = 32, 2, 3, 2e-4
FLIP_SHARE = 1e-2
SMALL = dict(dim=64, depth=2, heads=2)


def glasses_cfg(tmp, extra=None):
    """noglasses2glasses cut small, fp32, the basic and vision-aided Ds,
    the semantic gate opened (threshold 10)."""
    with open(os.path.join(ROOT, "examples",
                           "example_gan_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    merge(cfg, {
        "checkpoints_dir": str(tmp), "G": {"ngf": 8, "nblocks": 2},
        "D": {"ndf": 8, "netDs": ["basic", "vision_aided"]},
        "data": {"crop_size": SIZE, "load_size": SIZE, "num_threads": 1},
        "alg": {"cut": {"num_patches": 16}},
        "f_s": {"nf": 16, "semantic_threshold": 10.0},
        "train": {"batch_size": BATCH, "pool_size": 3},
        "tpu": {"bf16": False}})
    return merge(cfg, extra or {})


@pytest.fixture
def small_towers(monkeypatch):
    """Both packages' towers at dim 64, depth 2, 2 heads."""
    for mod, cls in ((jclip, "CLIPVisualViT"), (jdino, "DINOv2ViT"),
                     (tclip, "CLIPVisualViT"), (tdino, "DINOv2ViT")):
        monkeypatch.setattr(mod, cls, functools.partial(getattr(mod, cls),
                                                        **SMALL))


@pytest.fixture
def fast_jax_init(monkeypatch):
    monkeypatch.setattr(jcut_model, "init_net_state",
                        fast_init_net_state(200))
    monkeypatch.setattr(jcut_model, "scheme_from_opt",
                        lambda state, key, opt: state)


def models(tmp, extra=None):
    cfg = glasses_cfg(tmp, extra)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, device="cpu")
    assert set(tm.nets) == set(jm.states)
    for name, net in tm.nets.items():
        load_flax(net, jm.states[name].params)
    for name, net in tm.ema_nets.items():
        load_flax(net, jm.states[name].ema_params)
    return jm, tm


def batch_of(seed):
    """Images and rectangle label masks (1 inside) of A and B."""
    rng = np.random.default_rng(seed)
    out = {k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
           for k in ("A", "B")}
    for k in ("A_label_mask", "B_label_mask"):
        m = np.zeros((BATCH, SIZE, SIZE, 1), np.int64)
        for b in range(BATCH):
            y, x = rng.integers(0, SIZE // 2, 2)
            m[b, y:y + SIZE // 3, x:x + SIZE // 3] = 1
        out[k] = m
    return out


def step_draws(key, jm, tm):
    """The JAX step's draws for ``key``: rngs[0] split for G's
    augmentation, each D, then the two NCE calls; rngs[1] the pool."""
    rngs = jax.random.split(key, 8)
    r, _ = jax.random.split(rngs[0])
    for _ in jm.netDs:
        r, _ = jax.random.split(r)
    rng_nce, rng_idt = jax.random.split(r)
    feats = tm.nets["G_A"](torch.zeros(1, SIZE, SIZE, 3),
                           extract_layer_ids=tm.nce_layers)
    hws = [f.shape[1] * f.shape[2] for f in feats]
    return {"nce": patch_ids(rng_nce, hws, tm.num_patches),
            "nce_idt": patch_ids(rng_idt, hws, tm.num_patches),
            "pool": pool_draws(rngs[1], BATCH, tm.pool.pool_size)}


def zero_grad_biases(tm):
    """Conv biases right before an InstanceNorm (exact gradient 0)."""
    names = {f"G_A.{n}" for n, _ in tm.nets["G_A"].named_parameters()
             if n.endswith(".bias") and ".head." not in n}
    return names | {f"D_B_basic.Conv_{i}.bias"
                    for i in range(1, tm.opt.D_n_layers + 1)}


def g_loss_inputs(jm):
    """A batch as both steps see it after the wire: the JAX step's ``inp``
    and the port's tensors."""
    dev = quantize_batch(jm.set_input(batch_of(3)),
                         float_keys=("real_A", "real_B"),
                         int_keys=("mask_A", "mask_B"))
    inp = {k: dequantize_on_device(jnp.asarray(v), "label" if "mask" in k
                                   else "image") for k, v in dev.items()}
    return inp, {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}


def check_g_gradient(jm, tm):
    """G's gradient of its whole loss, semantic terms included, against
    ``jax.grad`` of the JAX ``_g_loss`` on the same f_s, the gate open."""
    key = jax.random.PRNGKey(7)
    inp, t = g_loss_inputs(jm)
    jinp = dict(inp, _fs_params=jm.states["f_s"].params,
                _fs_gate=jnp.asarray(1.0))
    d_params = {n: jm.states[n].params for n in jm.netDs}
    rng_g = jax.random.split(key, 8)[0]
    jgrad = jax.jit(jax.grad(lambda pG: jm._g_loss(
        pG, jm.states["F"].params, d_params, rng_g, jinp)[0]))(
            jm.states["G_A"].params)
    total, losses, _ = tm._g_loss(t["real_A"], t["real_B"],
                                  step_draws(key, jm, tm), t["mask_A"],
                                  t["mask_B"], torch.tensor(1.0))
    assert {"G_sem_mask", "G_out_mask"} <= set(losses)
    netG = tm.nets["G_A"]
    for p, g in zip(netG.parameters(), torch.autograd.grad(
            total, list(netG.parameters()))):
        p.grad = g
    grads_close(jgrad, netG, 1e-4, 1e-4)
    for p in netG.parameters():
        p.grad = None


def run_trajectory(jm, tm, adamw):
    """STEPS steps of both packages from the same weights on the same
    batches and draws; every check of the trajectory after each, and the
    towers at the end: as they started (``adamw`` False) or decayed."""
    towers = {n: p.detach().clone() for n, p in
              tm.nets["D_B_vision_aided"].named_parameters()
              if n.startswith("freezenet_")}
    step = jm._make_step()
    states, pool = jax.device_put((jm.states, jm.pool), jax.devices()[0])
    zero = zero_grad_biases(tm)
    for i in range(STEPS):
        batch = batch_of(10 + i)
        key = jax.random.PRNGKey(1000 + i)
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"),
                             int_keys=("mask_A", "mask_B"))
        states, pool, _, _, jlosses = step(states, pool, jm.apa_p,
                                           jm.d_diff_p, key, dev)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch),
                                       step_draws(key, jm, tm))
        assert set(tlosses) == set(jlosses)
        assert {"f_s", "G_sem_mask", "G_out_mask"} <= set(tlosses)
        assert ("G_sem_mask_idt" in tlosses) == adamw
        for k, v in jlosses.items():
            assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(tlosses[k]), float(v))
        bad = []
        nets = dict(tm.nets)
        nets.update({f"{n}_ema": net for n, net in tm.ema_nets.items()})
        for name, net in nets.items():
            tree = (states[name[:-4]].ema_params if name.endswith("_ema")
                    else states[name].params)
            want = flax_to_torch(jax.device_get(tree))
            for pname, p in net.named_parameters():
                diff = np.abs(to_np(p) - want[pname].numpy())
                if f"{name.removesuffix('_ema')}.{pname}" in zero:
                    off = diff > 2 * LR * (i + 1) + 1e-6
                elif pname.startswith("freezenet_"):
                    off = diff > 1e-6
                else:
                    off = diff > 1e-4
                    if off.mean() > FLIP_SHARE:
                        bad.append((i, name, pname, int(off.sum()), diff.size))
                    off = diff > 2 * LR * (i + 1) + 1e-4
                if off.any():
                    bad.append((i, name, pname, float(diff.max())))
        assert not bad, bad
        np.testing.assert_allclose(to_np(tm.pool.buffer),
                                   np.asarray(pool.buffer), atol=1e-3)
    # frozen towers: untouched by adam, decayed (and so moved) by adamw
    moved = [n for n, p in tm.nets["D_B_vision_aided"].named_parameters()
             if n in towers and not torch.equal(p, towers[n])]
    assert (sorted(moved) == sorted(
        n for n in towers if towers[n].any())) if adamw else not moved
