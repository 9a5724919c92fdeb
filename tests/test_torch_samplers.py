"""Schedules, embeddings, resize and the DDIM/DDPM samplers of the port
against the JAX package, on a small mask-conditioned palette denoiser with
the same converted weights and the same host-drawn y_t and noise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.models.modules.unet_mha import UNetMHA as JUNet
from joligen_tpu.ops import resize as jresize
from joligen_tpu.ops import schedules as js
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.modules import palette_diffusion as tpd
from joligen_tpu_torch.models.modules.unet_mha import UNetMHA
from joligen_tpu_torch.ops import resize as tresize
from joligen_tpu_torch.ops import schedules as ts

SMALL = dict(out_channel=3, inner_channel=16, cond_embed_dim=32,
             res_blocks=(1, 1), attn_res=(2,), channel_mults=(1, 2),
             num_head_channels=16)
ZERO_INIT = ("out_conv", "proj_out", "out_proj")


@pytest.mark.parametrize("n,phase", [(1000, "test"), (2000, "train"),
                                     (50, "test")])
def test_schedule_tables_equal(n, phase):
    a, b = js.NoiseSchedule.for_phase(n, phase), ts.NoiseSchedule.for_phase(
        n, phase)
    for f in ("betas", "gammas", "gammas_prev", "sqrt_recip_gammas",
              "sqrt_recipm1_gammas", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("dim,cols", [(256, 1), (33, 1), (64, 2)])
def test_gamma_embedding(dim, cols):
    g = np.random.default_rng(dim).uniform(0, 1, (5, cols)).astype(np.float32)
    want = np.asarray(js.gamma_embedding(jnp.asarray(g), dim))
    got = ts.gamma_embedding(torch.from_numpy(g), dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    t = np.array([3, 0, 999])
    sched = ts.NoiseSchedule.for_phase(1000, "test")
    np.testing.assert_array_equal(
        ts.extract(sched.gammas, torch.from_numpy(t), 4).numpy(),
        np.asarray(js.extract(sched.gammas, jnp.asarray(t), 4)))


def test_nearest_up2():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    assert np.array_equal(tresize.nearest_up2(torch.from_numpy(x)).numpy(),
                          np.asarray(jresize.nearest_up2(jnp.asarray(x))))


@pytest.fixture(scope="module")
def denoisers():
    """(jax module, its params, torch module) on the same weights."""
    rng = np.random.default_rng(0)
    jm = jpd.PaletteDenoiser(inner=JUNet(in_channel=6, **SMALL),
                             cond_embed_dim=32, conditioning="mask")
    var = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8, 8, 6)), jnp.zeros((1,)),
                                 mask=jnp.zeros((1, 8, 8, 1), jnp.int32)))

    def walk(tree, zero):
        return {k: (walk(v, zero or k in ZERO_INIT) if isinstance(v, dict)
                    else (rng.normal(0, 0.05, v.shape).astype(np.float32)
                          if zero else np.asarray(v)))
                for k, v in tree.items()}
    var = walk(var, False)
    tm = tpd.PaletteDenoiser(UNetMHA(in_channel=6 + 32, **SMALL),
                             cond_embed_dim=32, conditioning="mask")
    tm.load_state_dict(flax_to_torch(var), strict=True)
    return jm, var, tm.eval()


def _inputs(seed, t_steps=None):
    rng = np.random.default_rng(seed)
    y_cond = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    y_0 = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    y_t = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    mask = np.zeros((2, 8, 8, 1), np.int32)
    mask[:, 2:6, 1:7] = 1
    noise = (None if t_steps is None else
             rng.standard_normal((t_steps, 2, 8, 8, 3)).astype(np.float32))
    return y_cond, y_0, y_t, mask, noise


def _fns(jm, tm):
    def japply(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return jm.apply(p, x, g, cls=cls, mask=mask, ref=ref,
                        zero_gamma=zero_gamma)

    def tapply(x, g, cls=None, mask=None, zero_gamma=False):
        return tm(x, g, cls=cls, mask=mask, zero_gamma=zero_gamma)
    return japply, tapply


def test_ddim10_matches_jax(denoisers):
    jm, var, tm = denoisers
    japply, tapply = _fns(jm, tm)
    sched = ts.NoiseSchedule.for_phase(1000, "test")
    y_cond, y_0, y_t, mask, _ = _inputs(1)
    want = np.asarray(jax.jit(lambda p: jpd.ddim_sample(
        japply, p, jax.random.PRNGKey(0), sched, jnp.asarray(y_cond),
        y_t=jnp.asarray(y_t), y_0=jnp.asarray(y_0), mask=jnp.asarray(mask),
        num_steps=10, eta=0.5))(var))
    with torch.inference_mode():
        got = tpd.ddim_sample(tapply, None, sched, torch.from_numpy(y_cond),
                              y_t=torch.from_numpy(y_t),
                              y_0=torch.from_numpy(y_0),
                              mask=torch.from_numpy(mask), num_steps=10,
                              eta=0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    # outside the mask the chain returns y_0 exactly
    out = mask[..., 0] == 0
    assert np.array_equal(got[out], y_0[out])


def test_ddpm50_matches_jax(denoisers):
    jm, var, tm = denoisers
    japply, tapply = _fns(jm, tm)
    sched = ts.NoiseSchedule.for_phase(50, "test")
    y_cond, y_0, y_t, mask, noise = _inputs(2, t_steps=50)
    want = np.asarray(jax.jit(lambda p: jpd.ddpm_sample(
        japply, p, jax.random.PRNGKey(0), sched, jnp.asarray(y_cond),
        y_t=jnp.asarray(y_t), y_0=jnp.asarray(y_0), mask=jnp.asarray(mask),
        noise_seq=jnp.asarray(noise)))(var))
    with torch.inference_mode():
        got = tpd.ddpm_sample(tapply, None, sched, torch.from_numpy(y_cond),
                              y_t=torch.from_numpy(y_t),
                              y_0=torch.from_numpy(y_0),
                              mask=torch.from_numpy(mask),
                              noise_seq=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_ddpm_draws_y_t_first_then_one_noise_per_step(denoisers):
    _, _, tm = denoisers
    _, tapply = _fns(None, tm)
    sched = ts.NoiseSchedule.for_phase(4, "test")
    y_cond, y_0, _, mask, _ = _inputs(3)
    args = (tapply,)
    kw = dict(y_0=torch.from_numpy(y_0), mask=torch.from_numpy(mask))
    with torch.inference_mode():
        got = tpd.ddpm_sample(*args, torch.Generator().manual_seed(4), sched,
                              torch.from_numpy(y_cond), **kw)
        g = torch.Generator().manual_seed(4)
        y_t = torch.randn((2, 8, 8, 3), generator=g)
        noise = torch.stack([torch.randn((2, 8, 8, 3), generator=g)
                             for _ in range(4)])
        want = tpd.ddpm_sample(*args, None, sched, torch.from_numpy(y_cond),
                               y_t=y_t, noise_seq=noise, **kw)
    assert torch.equal(got, want)
