"""The consistency model's modules (``joligen_tpu_torch/models/modules/
cm.py``) against the JAX package's (``joligen_tpu/models/modules/cm.py``),
on the CPU, in fp32, at a small width (16 px, ngf 8, mults 1,2, one res
block a level, attention at ds 2 and in the mid block, head dim 16):

1. the host tables (discretisation schedule, Karras sigmas, lognormal
   timestep probabilities, loss weights) at sample counts on both sides of
   stage changes: the counts and sigmas exactly, the probabilities and
   weights to 1e-6 (relative; ``math.erf`` in place of scipy's);
2. the scalings, ECT's t -> r map and the pseudo-Huber loss (1e-6);
3. ``CMDenoiser`` with the JAX weights carried across, in both scaling
   variants (1e-4 of the output's scale);
4. ``cm_training_outputs`` and ``ect_training_outputs`` with the draws that
   the JAX functions take from their keys fed (1e-4);
5. ``cm_sample`` over the 5 serving sigmas with ``noise_seq`` (1e-3);
6. the converter round trip of a tree with ``sigma_embed/W``, bit for bit,
   and ``W``'s gradient: exactly 0;
7. the example configs' trunks take 6 input channels in both packages.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, few_torch_threads, load_flax,
                               seeded_tree, to_np)
from joligen_tpu.models.diffusion_networks import \
    define_inner_G as jax_define_inner_G
from joligen_tpu.models.modules import cm as jcm
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models.cm_model import (SAMPLING_SIGMAS,
                                               is_conditional,
                                               trunk_in_channels)
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.diffusion_networks import define_inner_G
from joligen_tpu_torch.models.modules import cm as tcm
from joligen_tpu_torch.options import TrainOptions

SIZE, BATCH, EMB = 16, 2, 32
SMALL = {
    "model_type": "cm",
    "data": {"crop_size": SIZE, "load_size": SIZE},
    "G": {"netG": "unet_mha", "ngf": 8,
          "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                       "attn_res": [2], "num_head_channels": 16,
                       "group_norm_size": 4}},
    "alg": {"diffusion": {"cond_embed_dim": EMB}},
    "tpu": {"bf16": False},
}


@pytest.fixture(scope="module")
def nets():
    """(the JAX CMDenoiser's apply, its seeded params, the port's
    CMDenoiser with them)."""
    jopt = JaxTrainOptions().parse_json(SMALL, verbose=False)
    opt = TrainOptions().parse_json(SMALL, verbose=False)
    jnet = jcm.CMDenoiser(inner=jax_define_inner_G(jopt), cond_embed_dim=EMB)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, x, jnp.ones((1,)), x_cond=x, train=True), jax.random.PRNGKey(0))
    params = jax.tree.map(jnp.asarray, seeded_tree(shapes, 3, 0.05,
                                                   lecun=True))
    tnet = tcm.CMDenoiser(define_inner_G(opt, 6), EMB)
    load_flax(tnet, params)
    # the JAX denoiser, jitted once (a program for each scaling variant)
    japply = jax.jit(lambda p, x, s, c, train: jnet.apply(
        p, x, s, x_cond=c, train=train), static_argnums=4)
    return japply, params, tnet


def _inputs(seed):
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((BATCH, SIZE, SIZE, 1), np.int32)
    mask[0, 2:10, 3:12] = 1
    mask[1, 6:15, 1:7] = 1
    return y0, cond, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got, want = to_np(got), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("total", [400_000, 1_000_000])
def test_host_tables_match_jax(total):
    per_stage = total // 8
    counts = sorted({0, 16, per_stage - 16, per_stage, per_stage + 16,
                     2 * per_stage, 3 * per_stage, 7 * per_stage + 8, total,
                     4 * total})
    seen = set()
    for step in counts:
        n = tcm.improved_timesteps_schedule(step, total)
        assert n == jcm.improved_timesteps_schedule(step, total), step
        seen.add(n)
        sig = tcm.karras_schedule(n)
        np.testing.assert_array_equal(sig, jcm.karras_schedule(n))
        for fn in ("lognormal_timestep_probs", "improved_loss_weighting"):
            want = getattr(jcm, fn)(sig)
            np.testing.assert_allclose(getattr(tcm, fn)(sig), want,
                                       rtol=1e-6, atol=0, err_msg=fn)
        s, p, w = tcm.stage_tables(n, torch.device("cpu"))
        np.testing.assert_array_equal(s.numpy(), sig)
        np.testing.assert_array_equal(w.numpy(),
                                      tcm.improved_loss_weighting(sig))
    # 11 sigmas at the start, doubling each stage up to 1281
    assert min(seen) == 11 and max(seen) == 1281 and len(seen) >= 5


def test_scalings_and_losses_match_jax():
    rng = np.random.default_rng(1)
    sig = np.exp(rng.normal(-1.1, 2.0, 64)).astype(np.float32)
    for train in (True, False):
        for fn in ("skip_scaling", "output_scaling"):
            np.testing.assert_allclose(
                getattr(tcm, fn)(_t(sig), train).numpy(),
                np.asarray(getattr(jcm, fn)(jnp.asarray(sig), train)),
                rtol=1e-6, atol=1e-7, err_msg=f"{fn} {train}")
    for stage in range(4):
        np.testing.assert_allclose(
            tcm.ect_t_to_r_sigmoid(_t(sig), stage).numpy(),
            np.asarray(jcm.ect_t_to_r_sigmoid(jnp.asarray(sig), stage)),
            rtol=1e-6, atol=1e-7)
    a, b = (rng.normal(0, 1, (3, 8, 8, 3)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        tcm.pseudo_huber_loss(_t(a), _t(b)).numpy(),
        np.asarray(jcm.pseudo_huber_loss(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("train", [True, False])
def test_denoiser_forward_matches_jax(nets, train):
    japply, params, tnet = nets
    y0, cond, _ = _inputs(2)
    sig = np.array([0.3, 12.0], np.float32)
    want = japply(params, jnp.asarray(y0), jnp.asarray(sig),
                            jnp.asarray(cond), train)
    with torch.no_grad():
        got = tnet(_t(y0), _t(sig), x_cond=_t(cond), train=train)
    _close(got, want, 1e-4)


def _port_apply(tnet):
    return lambda x, s, c, train: tnet(x, s, x_cond=c, train=train)


def test_training_outputs_match_jax_with_fed_draws(nets):
    """iCT at two stages, and ECT, with the JAX keys' draws."""
    japply, params, tnet = nets
    y0, cond, mask = _inputs(3)
    jy, jc, jm = (jnp.asarray(a) for a in (y0, cond, mask))
    total = 400_000
    for step in (0, 3 * total // 8):
        key = jax.random.PRNGKey(10 + step)
        pred, target, w = jcm.cm_training_outputs(
            japply, params, key, step, total, jy, y_cond=jc,
            mask=jm)
        n = jcm.improved_timesteps_schedule(step, total)
        rng_t, rng_n = jax.random.split(key)
        probs = jcm.lognormal_timestep_probs(jcm.karras_schedule(n))
        draws = {"timesteps": _t(jax.random.choice(
            rng_t, n - 1, shape=(BATCH,), p=jnp.asarray(probs))),
            "noise": _t(jax.random.normal(rng_n, y0.shape))}
        tp, tt, tw = tcm.cm_training_outputs(
            _port_apply(tnet), None, step, total, _t(y0), y_cond=_t(cond),
            mask=_t(mask), draws=draws)
        assert tp.requires_grad and not tt.requires_grad
        for got, want in ((tp, pred), (tt, target), (tw, w)):
            _close(got, want, 1e-4)

    key = jax.random.PRNGKey(5)
    outs = jcm.ect_training_outputs(japply, params, key, 1, jy,
                                    y_cond=jc, mask=jm)
    rng_t, rng_n = jax.random.split(key)
    draws = {"t_normal": _t(jax.random.normal(rng_t, (BATCH,))),
             "noise": _t(jax.random.normal(rng_n, y0.shape))}
    got = tcm.ect_training_outputs(_port_apply(tnet), None, 1, _t(y0),
                                   y_cond=_t(cond), mask=_t(mask),
                                   draws=draws)
    for g, w in zip(got, outs):
        _close(g, w, 1e-4)


def test_sampler_matches_jax_with_fed_noise(nets):
    japply, params, tnet = nets
    y0, cond, mask = _inputs(4)
    sigmas = list(SAMPLING_SIGMAS)
    noise = np.random.default_rng(6).standard_normal(
        (len(sigmas),) + y0.shape).astype(np.float32)
    want = jcm.cm_sample(japply, params, jax.random.PRNGKey(0),
                         sigmas, jnp.asarray(y0), y_cond=jnp.asarray(cond),
                         mask=jnp.asarray(mask), noise_seq=noise)
    with torch.no_grad():
        got = tcm.cm_sample(_port_apply(tnet), None, sigmas, _t(y0),
                            y_cond=_t(cond), mask=_t(mask),
                            noise_seq=_t(noise))
    _close(got, want, 1e-3)
    # outside the mask: the input, exactly
    keep = np.broadcast_to(mask == 0, y0.shape)
    np.testing.assert_array_equal(to_np(got)[keep], y0[keep])


def test_converter_round_trip_carries_W(nets):
    _, params, tnet = nets
    tree = jax.device_get(params)["params"]
    sd = flax_to_torch(tree)
    assert sd["sigma_embed.W"].shape == (EMB // 2,)
    back = torch_to_flax(sd)["params"]

    def leaves(t, p=()):
        for k, v in t.items():
            yield from (leaves(v, p + (k,)) if isinstance(v, dict)
                        else [(p + (k,), np.asarray(v))])
    want, got = dict(leaves(tree)), dict(leaves(back))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # W is a parameter behind a detach: its gradient is exactly 0
    y0, cond, _ = _inputs(7)
    out = tnet(_t(y0), torch.tensor([1.0, 2.0]), x_cond=_t(cond))
    gw, gp = torch.autograd.grad(out.square().mean(), [
        tnet.sigma_embed.W, tnet.sigma_embed.proj0.weight],
        allow_unused=True)
    assert gw is None and gp.abs().max() > 0


@pytest.mark.parametrize("name", ["cm", "cm_gan"])
def test_example_trunks_take_six_channels(name, monkeypatch):
    """The JAX model's own init on the example config, by shape only
    (``init_net_state`` replaced by ``jax.eval_shape`` of the same init),
    and the port's first conv (built, not initialised, OIHW)."""
    from joligen_tpu.models import cm_model as jcm_model
    with open(os.path.join(ROOT, "examples",
                           f"example_{name}_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    monkeypatch.setattr(
        jcm_model, "init_net_state",
        lambda rng, module, inputs, tx, use_ema=False, init_kwargs=None:
        jax.eval_shape(lambda r: module.init(r, *inputs,
                                             **(init_kwargs or {})), rng))
    jm = jcm_model.CMModel(JaxTrainOptions().parse_json(cfg, verbose=False))
    assert jm.conditional
    assert jm.states["G_A"]["params"]["inner"]["in_conv"]["kernel"].shape \
        == (3, 3, 6, 64)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    assert opt.alg_diffusion_cond_image_creation is None
    cin = trunk_in_channels(opt, is_conditional(opt, "inpainting"))
    assert cin == 6
    assert define_inner_G(opt, cin).in_conv.weight.shape == (64, 6, 3, 3)
