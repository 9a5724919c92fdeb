"""Kernels K2 and K3 of the port (flash-attention backward): the plain
PyTorch version, and gradients through the port's autograd Function on the
CPU, against ``jax.vjp`` of the JAX flash attention with the Pallas kernels
K1-K3 run in interpret mode, on the grid of tests/test_flash_attention.py
plus S = 160. The same seeded cotangent goes to both. The CUDA kernels are
held against the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: fp32 5e-4 (the JAX backward test's own), bf16 2e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from joligen_tpu.ops.flash_attention import flash_attention as jax_flash
from joligen_tpu_torch.ops import flash_attention as fa

GRID = [(128, 64, 2), (256, 32, 1), (100, 64, 2), (5, 16, 2), (160, 16, 2)]


def _inputs(s, d, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, h, d)).astype(np.float32)
            for _ in range(4)]                       # q, k, v, cotangent


def _jax_grads(q, k, v, g, dtype):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, force=True), *args)
    return [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g, dtype))]


def _port_grads(q, k, v, g, dtype):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(*args)
    assert o.dtype == dtype
    grads = torch.autograd.grad(o, args, torch.from_numpy(g).to(dtype))
    assert all(t.dtype == dtype for t in grads)
    return [t.float().numpy() for t in grads]


@pytest.mark.parametrize("s,d,h", GRID)
def test_autograd_function_matches_pallas_vjp_fp32(s, d, h):
    q, k, v, g = _inputs(s, d, h, seed=s + d)
    want = _jax_grads(q, k, v, g, jnp.float32)
    got = _port_grads(q, k, v, g, torch.float32)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("s,d,h", GRID)
def test_autograd_function_matches_pallas_vjp_bf16(s, d, h):
    q, k, v, g = _inputs(s, d, h, seed=3 * s + d)
    want = _jax_grads(q, k, v, g, jnp.bfloat16)
    got = _port_grads(q, k, v, g, torch.bfloat16)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=2e-2,
                                   err_msg=f"d{name}")


def test_plain_backward_is_the_kernels_algorithm():
    # the plain version from the forward's lse and delta equals autograd
    # through plain softmax attention, in float64
    q, k, v, g = (torch.from_numpy(x).double()
                  for x in _inputs(100, 32, 2, seed=11))
    o, lse = fa.flash_attention_reference(q, k, v)
    delta = fa.attention_delta(o, g)
    assert delta.shape == (2, 2, 100) and delta.dtype == torch.float32
    got = fa.flash_attention_bwd_reference(q, k, v, lse, delta, g)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    sc = torch.einsum("bshd,bthd->bhst", qq, kk) / np.sqrt(32)
    ref = torch.einsum("bhst,bthd->bshd", sc.softmax(-1), vv)
    want = torch.autograd.grad(ref, (qq, kk, vv), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_cpu_backward_counts_no_launch_and_inference_saves_nothing():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(37, 16, 2, seed=5))
    before = dict(fa.LAUNCHES)
    qq = q.clone().requires_grad_()
    o = fa.flash_attention(qq, k, v)
    assert o.grad_fn is not None
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    torch.autograd.grad(o, qq, g)
    assert fa.LAUNCHES == before
    assert all(n == 0 for n in fa.LAUNCHES.values())
    with torch.inference_mode():
        assert fa.flash_attention(qq, k, v).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(qq, k, v).grad_fn is None
