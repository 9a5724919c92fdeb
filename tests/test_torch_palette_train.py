"""The training slice on a small palette config on the CPU (crop 32, ngf 16,
mults 1,2, one res block per level; the mid block's attention runs through
the port's flash-attention autograd Function, K1-K3's plain versions), in
fp32, against the JAX package:

1. One training forward's loss and every parameter gradient against
   ``jax.value_and_grad`` of the JAX composition (``q_sample``,
   ``min_snr_weight``, the denoiser and ``masked_elementwise_loss`` of
   ``joligen_tpu/models/modules/palette_diffusion.py``, as
   ``palette_training_outputs`` and ``PaletteModel._loss_fn`` compose them),
   on the same converted weights, batch and host draws (t, u, noise, keep):
   mask conditioning with MSE, min-SNR, multiscale_MSE, and label dropout.
2. A 12-step AdamW+EMA trajectory of ``PaletteModel.optimize_prepared``
   against the jitted JAX step built from ``apply_updates``.

Tolerances: loss 1e-5 relative; gradients 1e-4 of the largest gradient of
their leaf (fp32 sums in another order through ~20 layers), or 1e-6 of the
largest gradient of all for a leaf whose exact gradient is 0; parameters and
EMA after 12 steps 2e-5 (AdamW at lr 2e-4 moves a parameter ~2.4e-3; a
gradient within 1e-4 moves its update by less than that).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads, one_palette_init: autouse fixtures, active once
# imported
from _torch_gan_common import few_torch_threads, one_palette_init  # noqa: F401
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import train_state as jts
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.ops.schedules import extract as jextract
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules.palette_diffusion import \
    continuous_gammas
from joligen_tpu_torch.options import TrainOptions

SIZE, BATCH = 32, 2
ZERO_INIT = ("out_conv", "proj_out", "out_proj")
CASES = {
    "mask_MSE": {},
    "minsnr": {"alg": {"palette": {"minsnr": True}}},
    "multiscale_MSE": {"alg": {"palette": {"loss": "multiscale_MSE"}}},
    "dropout": {"alg": {"diffusion": {"dropout_prob": 0.5}}},
}


def _cfg(tmp, case):
    cfg = {
        "model_type": "palette", "name": "train", "checkpoints_dir": str(tmp),
        "data": {"crop_size": SIZE, "load_size": SIZE},
        "G": {"netG": "unet_mha", "ngf": 16,
              # 8 groups: with one channel per group a conv bias before a
              # GroupNorm has an exactly zero gradient, rounding noise that
              # Adam would scale up to full steps of random sign
              "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                           "num_head_channels": 16, "group_norm_size": 8},
              "diff_n_timestep_train": 200},
        "alg": {"diffusion": {"task": "inpainting", "cond_embed": "mask",
                              "cond_embed_dim": 32},
                "palette": {"loss": "MSE"}},
        "train": {"G_ema": True, "G_ema_beta": 0.9, "optim": "adamw",
                  "optim_weight_decay": 0.01, "n_epochs": 1,
                  "n_epochs_decay": 2},
        "tpu": {"bf16": False},
    }
    for sec, kv in CASES[case].items():
        for sub, vals in kv.items():
            cfg[sec].setdefault(sub, {}).update(vals)
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((BATCH, SIZE, SIZE, 1), np.int32)
    mask[0, 4:20, 6:26] = 1
    mask[1, 10:30, 2:14] = 1
    cond = np.where(mask > 0, 0.0, gt).astype(np.float32)
    return {"A": cond, "B": gt, "B_label_mask": mask}


def _draws(seed, steps):
    """Host draws of one training forward: t in 1..T-1, u, noise, keep."""
    rng = np.random.default_rng(seed)
    return {"t": rng.integers(1, steps, BATCH).astype(np.int32),
            "u": rng.uniform(0, 1, BATCH).astype(np.float32),
            "noise": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
                np.float32),
            "keep_u": rng.uniform(0, 1, BATCH).astype(np.float32)}


def _perturbed(params, seed):
    """The JAX init with every leaf perturbed and the zero-initialised
    layers given small values, so every branch carries gradient."""
    rng = np.random.default_rng(seed)

    def walk(tree, zero):
        return {k: (walk(v, zero or k in ZERO_INIT) if isinstance(v, dict)
                    else np.asarray(v) * (1.0 + 0.1 * rng.standard_normal(
                        v.shape)).astype(np.float32)
                    + (rng.normal(0, 0.05, v.shape).astype(np.float32)
                       if zero else 0.0))
                for k, v in tree.items()}
    return walk(jax.device_get(params), False)


def _models(tmp, case):
    cfg = _cfg(tmp, case)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = 4
    jm = jax_create_model(jopt, phase="test")
    params = _perturbed(jm.states["G_A"].params, seed=1)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, phase="train", device="cpu")
    sd = flax_to_torch(params)
    tm.nets["G_A"].load_state_dict(sd)
    tm.ema_nets["G_A"].load_state_dict(sd)
    return jm, params, tm


def _jax_loss_fn(jm, opt_case):
    """The JAX PaletteModel._loss_fn with host draws in place of its
    jax.random keys."""
    sched = jm.sched_train

    def loss_fn(params, y_cond, gt, mask, d):
        y_cond = dequantize_on_device(y_cond, "image")
        gt = dequantize_on_device(gt, "image")
        mask = dequantize_on_device(mask, "label")
        t = d["t"]
        g_lo = jextract(sched.gammas, t - 1, 1)
        g_hi = jextract(sched.gammas, t, 1)
        gammas = (g_hi - g_lo) * d["u"] + g_lo
        bshape = (gt.shape[0], 1, 1, 1)
        y_noisy = jpd.q_sample(gt, gammas.reshape(bshape), d["noise"])
        m = jnp.clip(mask.astype(gt.dtype), 0.0, 1.0)
        y_noisy = y_noisy * m + (1.0 - m) * gt
        net_mask = mask
        if jm.dropout_prob > 0.0:
            keep = d["keep_u"] >= jm.dropout_prob
            net_mask = jnp.where(keep.reshape(bshape), mask,
                                 jnp.full_like(mask, 1))   # null class 1
        x_in = jnp.concatenate([y_cond, y_noisy], axis=-1)
        noise_hat = jm.netG.apply(params, x_in, gammas, mask=net_mask)
        weight = (jpd.min_snr_weight(sched, t).reshape(bshape)
                  if jm.minsnr else 1.0)
        loss = jpd.masked_elementwise_loss(d["noise"], noise_hat, mask=mask,
                                           weight=weight, kind=jm.loss_kind)
        return jm.lambda_G * loss
    return loss_fn


def _jax_inputs(jm, batch):
    inp = quantize_batch(jm.set_input(batch), float_keys=("y_cond", "gt"),
                         int_keys=("mask",))
    return [jnp.asarray(inp[k]) for k in ("y_cond", "gt", "mask")]


def _port_draws(tm, d):
    t = torch.from_numpy(d["t"]).long()
    return {"t": t,
            "gammas": continuous_gammas(tm.sched_train, t,
                                        torch.from_numpy(d["u"])),
            "noise": torch.from_numpy(d["noise"]),
            "keep_u": torch.from_numpy(d["keep_u"])}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax(tmp_path, case):
    jm, params, tm = _models(tmp_path, case)
    assert tm.null_class == 1 and tm.loss_kind == jm.loss_kind
    batch, d = _batch(0), _draws(1, 200)
    loss_fn = _jax_loss_fn(jm, case)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(
        params, *_jax_inputs(jm, batch), jax.tree.map(jnp.asarray, d))
    want = flax_to_torch(jax.device_get(want_grads))

    dev = tm.prepare_batch(batch)
    loss = tm._loss_fn(dev, _port_draws(tm, d))
    names = [n for n, _ in tm.nets["G_A"].named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.nets["G_A"].parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(names) == set(want) and len(names) == len(want)
    scale = max(v.abs().max().item() for v in want.values())
    for n, g in zip(names, grads):
        w = want[n].numpy()
        # a leaf whose gradient is zero in exact arithmetic (a conv bias
        # under a per-channel GroupNorm) holds rounding noise on both sides
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-4 * max(np.abs(w).max(), 1e-2 * scale), err_msg=n)
    # the attention branch carries gradient, through the Function's backward
    attn = want["inner.AttentionBlock_0.qkv.weight"].abs().max()
    assert attn > 0


def test_twelve_step_adamw_ema_trajectory_matches_jax(tmp_path):
    jm, params, tm = _models(tmp_path, "mask_MSE")
    tx = jm.txs["G_A"]
    loss_fn = _jax_loss_fn(jm, "mask_MSE")

    @jax.jit
    def jstep(state, y_cond, gt, mask, d):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, y_cond, gt,
                                                  mask, d)
        return jts.apply_updates(state, grads, tx, jm.ema_beta), loss

    p = jax.tree.map(jnp.asarray, params)
    js = jts.NetState(params=p, opt_state=tx.init(p),
                      ema_params=jax.tree.map(jnp.copy, p),
                      step=jnp.zeros((), jnp.int32))
    for i in range(12):
        batch, d = _batch(10 + i % 3), _draws(100 + i, 200)
        js, want_loss = jstep(js, *_jax_inputs(jm, batch),
                              jax.tree.map(jnp.asarray, d))
        losses = tm.optimize_prepared(tm.prepare_batch(batch),
                                      draws=_port_draws(tm, d))
        np.testing.assert_allclose(losses["G_tot"].item(), float(want_loss),
                                   rtol=1e-4)
    state = tm.states["G_A"]
    assert state.step == 12 and state.tx.count == 12
    host = jax.device_get(js)
    for module, tree in ((tm.nets["G_A"], host.params),
                         (tm.ema_nets["G_A"], host.ema_params)):
        got = torch_to_flax(module.state_dict())
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, atol=2e-5, rtol=0), got, tree)
    # the trajectory moved the parameters, and the EMA lags them
    start = flax_to_torch(params)
    moved = max((v - start[k]).abs().max().item()
                for k, v in tm.nets["G_A"].state_dict().items())
    assert moved > 1e-3
    assert not torch.equal(tm.nets["G_A"].in_conv.weight
                           if hasattr(tm.nets["G_A"], "in_conv") else
                           tm.nets["G_A"].inner.in_conv.weight,
                           tm.ema_nets["G_A"].inner.in_conv.weight)
