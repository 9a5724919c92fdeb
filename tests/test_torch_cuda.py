"""Kernel K1 (csrc/flash_attention_fwd.cu) on the card, against its plain
PyTorch version. Marked ``cuda``: they skip without a CUDA device. This file
imports neither jax nor the JAX package, so it runs on a machine with only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from joligen_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [(2, 128, 2, 64), (2, 256, 1, 32), (2, 100, 2, 64), (2, 5, 2, 16),
          (1, 256, 16, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(cuda, shape, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


def test_kernel_reads_strided_slices(cuda):
    n, s, h, d = 2, 77, 4, 32
    qkv = torch.randn(n, s, 3 * h * d, device=cuda)
    q, k, v = (t.reshape(n, s, h, d) for t in torch.split(qkv, h * d, -1))
    o = fa.flash_attention(q, k, v)
    ref, _ = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, ref, atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 32, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(*(torch.randn(1, 8, 2, 32, device=cuda,
                                         dtype=torch.float16),) * 3)
