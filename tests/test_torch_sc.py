"""The shortcut model (``joligen_tpu_torch/models/modules/sc.py``,
``models/sc_model.py``) against the JAX package's, on the CPU, in fp32, at
the small width of ``tests/_torch_cm_common.py`` (16 px, ngf 8, mults 1,2,
head dim 16, conditioned on A):

1. ``timestep_embedding`` at the model's t and dt_base (1e-6);
2. ``SCDenoiser`` with the JAX weights carried across (1e-4 of the output's
   scale);
3. ``sc_training_outputs`` with the JAX keys' draws fed (dt_base, t, the
   noise, the mode's uniform), once with bootstrap targets and once with
   flow-matching targets (1e-4);
4. ``sc_sample`` at 4 steps from a fed initial noise (1e-3), the image
   outside the mask the zeroed base, as the JAX sampler recombines;
5. a 2-step ``SCModel`` trajectory (masked, AdamW, EMA) against the JAX
   model's jitted step with each step's draws fed, at the tolerances of
   ``_torch_cm_common``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_cm_common import (BATCH, SIZE, batch, params_close, small_cfg)
from _torch_gan_common import (fast_init_net_state, few_torch_threads,
                               load_flax, seeded_tree, to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import sc_model as jsc_model
from joligen_tpu.models.diffusion_networks import \
    define_inner_G as jax_define_inner_G
from joligen_tpu.models.modules import sc as jsc
from joligen_tpu.ops.schedules import timestep_embedding as jax_embedding
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.diffusion_networks import define_inner_G
from joligen_tpu_torch.models.modules import sc as tsc
from joligen_tpu_torch.ops.schedules import timestep_embedding
from joligen_tpu_torch.options import TrainOptions

EMB = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got, want = to_np(got), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(the JAX SCDenoiser's jitted apply, its seeded params, the port's
    SCDenoiser with them)."""
    cfg = small_cfg(tmp_path_factory.mktemp("sc"), {"model_type": "sc"})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jnet = jsc.SCDenoiser(inner=jax_define_inner_G(jopt), cond_embed_dim=EMB)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    t = jnp.zeros((1,), jnp.float32)
    shapes = jax.eval_shape(lambda r: jnet.init(r, x, t, t, x_cond=x),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(jnp.asarray, seeded_tree(shapes, 4, 0.05,
                                                   lecun=True))
    tnet = tsc.SCDenoiser(define_inner_G(opt, 6), EMB)
    load_flax(tnet, params)
    japply = jax.jit(lambda p, x, t, dt, c: jnet.apply(p, x, t, dt,
                                                       x_cond=c))
    return japply, params, tnet


def _port_apply(tnet):
    return lambda x, t, dt, c: tnet(x, t, dt, x_cond=c)


def _inputs(seed):
    b = batch(seed)
    return b["B"], b["A"], b["B_label_mask"]


def test_timestep_embedding_matches_jax():
    """At the shortcut model's inputs: t in [0, 1] and dt_base in 0..7
    (an fp32 angle of hundreds of radians carries the ulp of its
    frequency, which the two packages' exp round differently)."""
    t = np.concatenate([np.arange(8), np.random.default_rng(0).uniform(
        0, 1, 8)]).astype(np.float32)
    for dim in (256, 7):
        np.testing.assert_allclose(
            timestep_embedding(_t(t), dim).numpy(),
            np.asarray(jax_embedding(jnp.asarray(t), dim)), rtol=1e-6,
            atol=1e-6)


def test_denoiser_forward_matches_jax(nets):
    japply, params, tnet = nets
    y0, cond, _ = _inputs(1)
    t = np.array([0.25, 0.5], np.float32)
    dt = np.array([3.0, 1.0], np.float32)
    want = japply(params, jnp.asarray(y0), jnp.asarray(t), jnp.asarray(dt),
                  jnp.asarray(cond))
    with torch.no_grad():
        got = tnet(_t(y0), _t(t), _t(dt), x_cond=_t(cond))
    _close(got, want, 1e-4)


def _draws(key, shape):
    """``sc_training_outputs``' draws from ``key``."""
    r_dt, r_t, r_n, r_mode = jax.random.split(key, 4)
    return {"dt_base": _t(jax.random.randint(r_dt, (shape[0],), 0, 7)),
            "t_u": _t(jax.random.uniform(r_t, (shape[0],))),
            "noise": _t(jax.random.normal(r_n, shape)),
            "mode_u": _t(jax.random.uniform(r_mode, ()))}


@pytest.mark.parametrize("ratio", [1.0, 0.0])
def test_training_outputs_match_jax_with_fed_draws(nets, ratio):
    """``ratio`` 1: the bootstrap targets; 0: the flow-matching ones."""
    japply, params, tnet = nets
    y0, cond, mask = _inputs(2)
    key = jax.random.PRNGKey(9)
    want = jsc.sc_training_outputs(
        japply, params, key, jnp.asarray(y0), y_cond=jnp.asarray(cond),
        mask=jnp.asarray(mask), bootstrap_ratio=ratio)
    got = tsc.sc_training_outputs(
        _port_apply(tnet), None, _t(y0), y_cond=_t(cond), mask=_t(mask),
        bootstrap_ratio=ratio, draws=_draws(key, y0.shape))
    assert got[0].requires_grad and not got[1].requires_grad
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_sampler_matches_jax_with_fed_noise(nets):
    japply, params, tnet = nets
    y0, cond, mask = _inputs(3)
    noise = np.random.default_rng(5).standard_normal(y0.shape).astype(
        np.float32)
    want = jsc.sc_sample(japply, params, None, jnp.asarray(y0),
                         y_cond=jnp.asarray(cond), mask=jnp.asarray(mask),
                         denoise_timesteps=4, noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tsc.sc_sample(_port_apply(tnet), None, _t(y0), y_cond=_t(cond),
                            mask=_t(mask), denoise_timesteps=4,
                            noise=_t(noise))
    _close(got, want, 1e-3)
    # outside the mask: the zeroed base y * (1 - m), here y itself
    keep = np.broadcast_to(mask == 0, y0.shape)
    np.testing.assert_array_equal(to_np(got)[keep], y0[keep])


def test_sc_model_trajectory_matches_jax_step(tmp_path, monkeypatch):
    monkeypatch.setattr(jsc_model, "init_net_state", fast_init_net_state(5))
    cfg = small_cfg(tmp_path, {"model_type": "sc"})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    tm = create_model(opt, device="cpu")
    assert tm.conditional and jm.conditional
    assert tm.denoise_timesteps == jm.denoise_timesteps == [16]
    load_flax(tm.nets["G_A"], jm.states["G_A"].params)
    load_flax(tm.ema_nets["G_A"], jm.states["G_A"].ema_params)
    jm.states["G_A"] = jax.device_put(jm.states["G_A"], jax.devices()[0])
    for i in range(2):
        b = batch(40 + i)
        key = jax.random.PRNGKey(70 + i)
        jm.next_rng = lambda key=key: key
        inp = jm.set_input(b)
        jlosses = jm.optimize_prepared({k: jnp.asarray(v)
                                        for k, v in inp.items()})
        tlosses = tm.optimize_prepared(tm.prepare_batch(b),
                                       _draws(key, b["B"].shape))
        assert set(tlosses) == set(jlosses) == {"G_tot"}
        want = float(jlosses["G_tot"])
        assert abs(float(tlosses["G_tot"]) - want) <= 1e-4 * max(1.0, want)
        params_close(jm.states, tm, i)
