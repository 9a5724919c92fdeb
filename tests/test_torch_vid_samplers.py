"""The DDIM and DDPM samplers of the port on (B, F, H, W, C) clips against
the JAX package's, on the CPU, fp32: the video denoiser
(``PaletteDenoiser`` around a two-level ``UNetVid``, seeded so that every
leaf is non-zero) on the same weights, y_t and per-step noise, DDIM-10 and
DDPM-50, to 1e-3; outside the mask each chain returns y_0 exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, load_flax, seeded_tree
from joligen_tpu.models.modules import palette_diffusion as jpd
from joligen_tpu.models.modules.unet_vid import UNetVid as JUNetVid
from joligen_tpu_torch.models.modules import palette_diffusion as tpd
from joligen_tpu_torch.models.modules.unet_vid import UNetVid
from joligen_tpu_torch.ops import schedules as ts

B, F, SIZE = 2, 4, 16
NET = dict(in_channel=6, out_channel=3, inner_channel=16, cond_embed_dim=32,
           res_blocks=(1, 1), attn_res=(2,), channel_mults=(1, 2),
           num_head_channels=16, group_size=8)


def _mask(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, F, SIZE, SIZE, 1), np.int32)
    for b in range(B):
        x0, y0 = rng.integers(1, SIZE // 2, 2)
        mask[b, :, y0:y0 + 6, x0:x0 + 7] = 1
    return mask


@pytest.fixture(scope="module")
def denoisers():
    """(jax module, its params, torch module): the video denoiser, seeded
    (every leaf non-zero)."""
    jm = jpd.PaletteDenoiser(inner=JUNetVid(**NET), cond_embed_dim=32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, F, 8, 8, 6)), jnp.zeros((1,)))
    var = seeded_tree(shapes, 70, 0.05, lecun=True)
    tm = tpd.PaletteDenoiser(UNetVid(**NET), cond_embed_dim=32)
    load_flax(tm, var)
    return jm, var, tm.eval()


@pytest.mark.parametrize("method,steps", [("ddim", 10), ("ddpm", 50)])
def test_samplers_on_clips_match_jax(denoisers, method, steps):
    jm, var, tm = denoisers
    rng = np.random.default_rng(8)
    shape = (B, F, SIZE, SIZE, 3)
    y_cond, y_0 = (rng.uniform(-1, 1, shape).astype(np.float32)
                   for _ in range(2))
    y_t = rng.standard_normal(shape).astype(np.float32)
    mask = _mask(9)
    noise = rng.standard_normal((steps,) + shape).astype(np.float32)
    sched = ts.NoiseSchedule.for_phase(1000 if method == "ddim" else steps,
                                       "test")
    kw = ({"num_steps": steps, "eta": 0.5} if method == "ddim"
          else {"noise_seq": noise})
    jfn = jpd.ddim_sample if method == "ddim" else jpd.ddpm_sample

    def japply(p, x, g, cls=None, mask=None, ref=None, zero_gamma=False):
        return jm.apply(p, x, g, cls=cls, mask=mask, zero_gamma=zero_gamma)
    want = np.asarray(jax.jit(lambda p: jfn(
        japply, p, jax.random.PRNGKey(0), sched, jnp.asarray(y_cond),
        y_t=jnp.asarray(y_t), y_0=jnp.asarray(y_0), mask=jnp.asarray(mask),
        **{k: jnp.asarray(v) if k == "noise_seq" else v
           for k, v in kw.items()}))(var))
    tfn = tpd.ddim_sample if method == "ddim" else tpd.ddpm_sample
    with torch.inference_mode():
        got = tfn(lambda x, g, cls=None, mask=None, zero_gamma=False: tm(
            x, g, cls=cls, mask=mask, zero_gamma=zero_gamma), None, sched,
            torch.from_numpy(y_cond), y_t=torch.from_numpy(y_t),
            y_0=torch.from_numpy(y_0), mask=torch.from_numpy(mask),
            **{k: torch.from_numpy(v) if k == "noise_seq" else v
               for k, v in kw.items()}).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    out = mask[..., 0] == 0
    assert np.array_equal(got[out], y_0[out])
