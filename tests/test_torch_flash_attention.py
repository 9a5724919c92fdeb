"""Kernel K1 of the port (flash-attention forward): its plain PyTorch version
against the JAX Pallas kernel run in interpret mode, on the grid of
tests/test_flash_attention.py plus the head dims 80, 128 and 160. The CUDA kernel itself is held against the
same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.ops.flash_attention import flash_attention as jax_flash
from joligen_tpu_torch.ops import flash_attention as fa

# the head dims 80 (JiT-H's blocks), 128 (JiT-L's motion module, MAT's at
# 4 heads) and 160 (JiT-H's motion module), one head, at S <= 32 (the
# packed tiling's side on the card) and past one 64-key tile
WIDE = [(5, 80, 1), (70, 80, 1), (8, 128, 1), (72, 128, 1), (5, 160, 1),
        (66, 160, 1)]
# the motion modules of unet_vid: head dim 8 over 8 and 6 frames
GRID = [(128, 64, 2), (256, 32, 1), (100, 64, 2), (5, 16, 2), (8, 8, 8),
        (6, 8, 8),
        *WIDE]
# vit_vid, small: its token motion modules, (B * T, F, 8 heads, 96), and
# its JiT blocks at S = 96 (32 in-context tokens and 64 patches), (B * F,
# 96, heads, 64); (B, S, H, D)
VIT_VID = [(4, 8, 8, 96), (2, 96, 3, 64)]


def _qkv(s, d, h, seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_lse(q, k, v):
    """Per-row logsumexp of the scaled scores, (B, H, S), in float64."""
    sc = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                   k.astype(np.float64)) / np.sqrt(q.shape[-1])
    mx = sc.max(-1, keepdims=True)
    return (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("s,d,h", GRID)
def test_reference_matches_pallas_kernel_fp32(s, d, h):
    q, k, v = _qkv(s, d, h, seed=s + d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), force=True))
    o, lse = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    assert o.dtype == torch.float32 and o.shape == (2, s, h, d)
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5, rtol=2e-5)
    assert lse.shape == (2, h, s)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("s,d,h", GRID)
def test_reference_matches_pallas_kernel_bf16(s, d, h):
    q, k, v = _qkv(s, d, h, seed=7 * s + d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, force=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,s,h,d", VIT_VID)
def test_reference_matches_pallas_kernel_at_vit_vid_shapes(b, s, h, d):
    q, k, v = _qkv(s, d, h, seed=b + s + d, b=b)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), force=True))
    o, lse = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    assert o.shape == (b, s, h, d) and d in fa.SUPPORTED_HEAD_DIMS
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v), atol=2e-5,
                               rtol=2e-5)


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    q, k, v = _qkv(100, 32, 2, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(tq, tk, tv, sm_scale=0.3)
    ref, _ = fa.flash_attention_reference(tq, tk, tv, sm_scale=0.3)
    assert torch.equal(o, ref)
    assert fa.LAUNCHES == before
    assert all(n == 0 for n in fa.LAUNCHES.values())


def test_reference_reads_strided_qkv_slices():
    # q/k/v as column slices of one fused projection, as AttentionBlock
    # hands them over: batch/sequence strides differ from a packed tensor
    rng = np.random.default_rng(0)
    n, s, h, d = 2, 37, 2, 16
    qkv = torch.from_numpy(rng.standard_normal((n, s, 3 * h * d))
                           .astype(np.float32))
    q, k, v = (t.reshape(n, s, h, d)
               for t in torch.split(qkv, h * d, dim=-1))
    assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1)
    o = fa.flash_attention(q, k, v)
    want = np.asarray(jax_flash(*(jnp.asarray(t.contiguous().numpy())
                                  for t in (q, k, v)), force=True))
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5, rtol=2e-5)


def test_wrapper_rejects_mismatched_inputs():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 9, 2, 16), q)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
