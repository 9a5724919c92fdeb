"""What the flash-attention wrapper checks before it launches a kernel, and
how the kernels' libraries are named, on the CPU (no card needed): the bf16
(wgmma) route's 16-byte alignment rule, the query tiling option of the
forward (K1) and of the dQ backward (K2), the dtype routes, and the build
hash over the shared headers."""

import os

import pytest
import torch

from joligen_tpu_torch.ops import _build
from joligen_tpu_torch.ops import flash_attention as fa


def _fused_slices(n, s, h, d, dtype, extra=0):
    """q, k, v as column slices of one (n, s, 3 h d + extra) projection."""
    qkv = torch.randn(n, s, 3 * h * d + extra).to(dtype)
    return [qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
            for i in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_qkv_slices_pass_the_kernel_checks(dtype):
    q, k, v = _fused_slices(2, 77, 4, 32, dtype)
    assert q.stride(1) == 3 * 4 * 32
    fa._check_kernel_inputs(q, (("q", q), ("k", k), ("v", v)))


def _misaligned(case, dtype, n=2, s=8, h=2, d=16):
    """A (n, s, h, d) view whose base pointer ("base"), row stride ("rows")
    or batch stride ("batch") is one element off a 16-byte multiple."""
    if case == "base":
        return torch.randn(n * s * h * d + 1).to(dtype)[1:].view(n, s, h, d)
    if case == "rows":
        return torch.randn(n, s, h * d + 1).to(dtype)[..., :h * d].unflatten(
            -1, (h, d))
    return torch.randn(n, s * h * d + 1).to(dtype)[:, :s * h * d].unflatten(
        -1, (s, h, d))


@pytest.mark.parametrize("case", ["base", "rows", "batch"])
def test_bf16_route_needs_16_byte_alignment(case):
    t = _misaligned(case, torch.bfloat16)
    good = torch.randn(t.shape).bfloat16()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_kernel_inputs(good, (("q", good), ("k", t)))
    # the fp32 route (FMAs) copies no 16-byte lines and takes such layouts
    t32 = _misaligned(case, torch.float32)
    fa._check_kernel_inputs(t32, (("q", t32),))


def test_bf16_outputs_must_be_aligned():
    out = torch.empty(2 * 8 * 2 * 16 + 1).bfloat16()[1:].view(2, 8, 2, 16)
    with pytest.raises(ValueError, match="preallocated"):
        fa._check_out(out, (2, 8, 2, 16), torch.bfloat16)
    fa._check_out(torch.empty(2, 8, 2, 16).bfloat16(), (2, 8, 2, 16),
                  torch.bfloat16)


@pytest.mark.parametrize("shape,tile", [((1, 256, 16), 64),
                                        ((8, 256, 16), 128),
                                        ((8, 1024, 16), 128),
                                        ((3, 1000, 3), 64)])
def test_forward_query_tiling_follows_the_grid(shape, tile):
    # two warpgroups a block only where that grid still fills 132 SMs
    assert fa.fwd_q_tile(*shape, sm_count=132) == tile
    assert tile in fa.Q_TILES


def test_forward_refuses_an_unknown_query_tiling():
    q = torch.randn(1, 8, 2, 16).bfloat16()
    with pytest.raises(ValueError, match="q_tile"):
        fa._launch(q, q, q, 0.25, q_tile=96)


@pytest.mark.parametrize("shape,tile", [((1, 256, 16), 64),
                                        ((8, 256, 16), 128),
                                        ((8, 1024, 16), 128),
                                        ((3, 1000, 3), 64)])
def test_backward_query_tiling_follows_the_grid(shape, tile):
    # K2 takes two warpgroups a block only where that grid still fills 132
    # SMs
    assert fa.bwd_dq_q_tile(*shape, sm_count=132) == tile
    assert tile in fa.Q_TILES


@pytest.mark.parametrize("q_tile", [32, 96, 256])
def test_dq_backward_refuses_an_unknown_query_tiling(q_tile):
    b, s, h, d = 1, 8, 2, 16
    q = torch.randn(b, s, h, d).bfloat16()
    lse = torch.zeros(b, h, s)
    with pytest.raises(ValueError, match="q_tile"):
        fa._launch_bwd_dq(q, q, q, lse, lse, q, 0.25, q_tile=q_tile)


def test_routes_name_each_kernel_and_dtype():
    assert set(fa.ROUTES) == set(fa.LAUNCHES)
    for routes in fa.ROUTES.values():
        assert set(routes) == {"float32", "bfloat16"}
        assert routes["float32"] == "fma"
    assert fa.ROUTES["flash_attention_fwd"]["bfloat16"] == "wgmma"
    assert fa.ROUTES["flash_attention_bwd_dkv"]["bfloat16"] == "wgmma"
    assert fa.ROUTES["flash_attention_bwd_dq"]["bfloat16"] == "wgmma"


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    assert os.path.dirname(second) == _build.BUILD_DIR
