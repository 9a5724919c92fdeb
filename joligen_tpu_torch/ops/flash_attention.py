"""Flash attention, forward and backward: the port of kernels K1, K2 and K3 of
``joligen_tpu/ops/flash_attention.py`` (Pallas, TPU):

- K1 ``_fwd_kernel`` -> ``csrc/flash_attention_fwd.cu``;
- K2 ``_bwd_dq_kernel`` and K3 ``_bwd_dkv_kernel`` ->
  ``csrc/flash_attention_bwd.cu``.

``flash_attention`` keeps the JAX wrapper's signature and semantics
(``joligen_tpu/ops/flash_attention.py:265-294``): (B, S, H, D) in and out,
``sm_scale`` defaulting to 1/sqrt(D), keys at or past S masked, the output
cast to ``q.dtype``. When a gradient is needed it runs through
``FlashAttention``, the ``torch.autograd.Function`` standing for the JAX
``custom_vjp``: K1 forward (saving q, k, v, O and lse), then
``delta = rowsum(dO * O)`` and K2 + K3 backward.

- On a CUDA tensor each step launches its hand-written kernel or raises.
  There is no fallback to a library attention. ``ROUTES`` says which kernel
  a dtype takes: in bf16, K1, K2 and K3 run on the tensor cores
  (``wgmma``); in fp32 all three run on FMAs, which hold 1e-4 (TF32 would
  not).
- On a CPU tensor each step runs its plain PyTorch version
  (``flash_attention_reference``, ``flash_attention_bwd_reference``): the same
  algorithm, which the tests hold against the JAX kernels and
  ``chip_smoke.py`` holds the CUDA kernels against.

Head dims 8, 16, 32, 64, 80, 96, 128 and 160 (``SUPPORTED_HEAD_DIMS``; 8
is the first level of ``unet_vid``'s motion modules, 96 the token motion
modules of ``vit_vid``, 768 channels over 8 heads; 80 JiT-H's blocks, 1280
over 16; 128 JiT-L's motion module, 1024 over 8, and MAT's at 4 heads, 512
over 4; 160 JiT-H's motion module, 1280 over 8). Any other head dim raises
on the card. Sequences of at most ``PACK_MAX_S`` (32)
take the packed tiling on the card (``tiling``): a block holds whole
(batch, head) sequences, each padded to the power of two ``2**pack_log2(S)``
rows, and masks the scores to each sequence's own keys; longer ones the
plain tiling of 64 or 128 queries a block. Both launch the same kernels'
sources, held against the same plain versions.

``LAUNCHES`` counts each CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from ._build import launch

NEG_INF = -1e30
# keys per tile of every CUDA kernel, both routes (BLOCK_K in the .cu files;
# K3 owns a tile of this many keys), and of the plain versions' key chunks
BLOCK_K = 64
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128, 160)
# the longest sequence the packed tiling takes: a block's 64 rows hold at
# least two sequences of 32
PACK_MAX_S = 32
TILINGS = ("plain", "packed")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# queries per block of K1's and K2's bf16 routes: one warpgroup of 64
# queries, or two sharing each K/V tile (``fwd_q_tile`` and ``bwd_dq_q_tile``
# pick one)
Q_TILES = (64, 128)

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
ROUTES = {"flash_attention_fwd": {"float32": "fma", "bfloat16": "wgmma"},
          "flash_attention_bwd_dq": {"float32": "fma", "bfloat16": "wgmma"},
          "flash_attention_bwd_dkv": {"float32": "fma", "bfloat16": "wgmma"}}


def flash_attention_reference(q, k, v, sm_scale=None, block_k=BLOCK_K):
    """Plain PyTorch version of the kernel's algorithm: online softmax over
    ``block_k`` key chunks with fp32 running max, sum and accumulator;
    lse = m + log(l). (B, S, H, D) -> ((B, S, H, D) in q.dtype, (B, H, S)
    fp32). The last chunk is simply shorter: keys past S never enter, which
    is what the kernel's -1e30 mask gives exactly (exp underflows to 0)."""
    b, s, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3) * sm_scale        # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    acc = torch.zeros(b, h, s, d, dtype=torch.float32, device=q.device)
    m_i = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros(b, h, s, 1, dtype=torch.float32, device=q.device)
    for k0 in range(0, s, block_k):
        kc = kf[:, :, k0:k0 + block_k]
        vc = vf[:, :, k0:k0 + block_k]
        sc = qf @ kc.transpose(-1, -2)
        m_new = torch.maximum(m_i, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m_i - m_new)
        l_i = l_i * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vc
        m_i = m_new
    l_safe = torch.clamp(l_i, min=1e-30)
    o = (acc / l_safe).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m_i + torch.log(l_safe))[..., 0]
    return o, lse


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, (B, S, H, D) -> (B, H, S): computed
    once before K2 and K3, as JAX computes it outside Pallas
    (``flash_attention.py:183-184``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, lse, delta, do, sm_scale=None,
                                  block_k=BLOCK_K):
    """Plain PyTorch version of K2 + K3: P recomputed per ``block_k`` key
    chunk from the saved lse, dS = P * (dP - delta) * sm_scale, fp32
    accumulation; keys past S never enter (the last chunk is shorter).
    Returns (dq, dk, dv), (B, S, H, D) in q.dtype."""
    b, s, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    lse_ = lse.float()[..., None]                         # (B, H, S, 1)
    delta_ = delta.float()[..., None]
    dq = torch.zeros(b, h, s, d, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    for k0 in range(0, s, block_k):
        kc = kf[:, :, k0:k0 + block_k]
        vc = vf[:, :, k0:k0 + block_k]
        p = torch.exp(sm_scale * (qf @ kc.transpose(-1, -2)) - lse_)
        dp = dof @ vc.transpose(-1, -2)
        ds = p * (dp - delta_) * sm_scale
        dq += ds @ kc
        dk[:, :, k0:k0 + block_k] = ds.transpose(-1, -2) @ qf
        dv[:, :, k0:k0 + block_k] = p.transpose(-1, -2) @ dof
    return tuple(t.to(q.dtype).permute(0, 2, 1, 3).contiguous()
                 for t in (dq, dk, dv))


def _check(q, k, v):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _check_aligned(name, t):
    """The bf16 (wgmma) route copies 16-byte lines: every base pointer and
    the batch and row strides must be multiples of 16 bytes."""
    item = t.element_size()
    if (t.data_ptr() | t.stride(0) * item | t.stride(1) * item) % 16:
        raise ValueError(f"flash_attention kernel: {name} needs a 16-byte "
                         f"aligned pointer and batch/row strides, got "
                         f"{t.data_ptr() % 16} bytes off and strides "
                         f"{t.stride()}")


def _check_kernel_inputs(q, named):
    """What every kernel takes: a supported head dim and dtype, and (H, D)
    dims contiguous in each (B, S, H, D) input; in bf16 also 16-byte
    alignment."""
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        refused = [m for m in range(16, 161, 16)
                   if m not in SUPPORTED_HEAD_DIMS]
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}; still refused: "
                         f"{', '.join(map(str, refused))}, any head dim "
                         "past 160 and any other that is not a multiple "
                         "of 16")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    for name, t in named:
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"flash_attention kernel: {name} needs contiguous "
                             f"(H, D) dims, got strides {t.stride()}")
        if q.dtype == torch.bfloat16:
            _check_aligned(name, t)


def _check_out(t, shape, dtype):
    if t.shape != shape or t.dtype != dtype or not t.is_contiguous() or (
            dtype == torch.bfloat16 and t.data_ptr() % 16):
        raise ValueError("flash_attention kernel: bad preallocated outputs")


_SIGNATURES = {
    # name: (library, symbol, argtypes)
    "fwd": ("flash_attention_fwd", "jg_flash_attention_fwd",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "bwd_dq": ("flash_attention_bwd", "jg_flash_attention_bwd_dq",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 8
               + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "bwd_dkv": ("flash_attention_bwd", "jg_flash_attention_bwd_dkv",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 8
                + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
}


def pack_log2(s):
    """log2 of the rows a sequence of length ``s`` takes in the packed
    tiling: the least power of two >= s."""
    return max(0, (s - 1).bit_length())


def _pack_arg(q, tiling):
    """The kernels' ``sp_log2``: -1 for the plain tiling, else
    ``pack_log2(S)``. ``tiling`` None picks packed for S <= PACK_MAX_S."""
    s = q.shape[1]
    if tiling is None:
        tiling = "packed" if s <= PACK_MAX_S else "plain"
    if tiling not in TILINGS:
        raise ValueError(f"flash_attention kernel: tiling {tiling!r} not in "
                         f"{TILINGS}")
    if tiling == "packed" and s > PACK_MAX_S:
        raise ValueError(f"flash_attention kernel: the packed tiling takes "
                         f"S <= {PACK_MAX_S}, got {s}")
    return pack_log2(s) if tiling == "packed" else -1


def _call(name, counter, q, *args):
    """Launch on the current stream of q's device and count the launch;
    raises if the launch was refused."""
    launch(*_SIGNATURES[name], q.device, *args)
    LAUNCHES[counter] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def fwd_q_tile(b, s, h, sm_count):
    """Queries per block of K1's bf16 route: 128 (two warpgroups sharing
    each K/V tile) where that grid still has a block for every SM, else 64.
    On an H100 (132 SMs) ``chip_smoke.py`` timed 64 faster at a 128 px
    request, (B, S, H) = (1, 256, 16): 64 blocks against 32 of 128; and 128
    faster at (8, 256, 16) and (8, 1024, 16)."""
    return 128 if b * h * -(-s // 128) >= sm_count else 64


# K2's bf16 route follows the same rule: ``chip_smoke.py`` timed 128
# queries a block faster at both of its path shapes, (8, 256, 16) and
# (8, 1024, 16) (by about 11 % and 7 % on an H100)
bwd_dq_q_tile = fwd_q_tile


def _q_tile(q, q_tile):
    """``q_tile`` if given, else what ``fwd_q_tile`` picks for q's grid (64
    in fp32, whose FMA kernels take 64 queries a block); raises outside
    ``Q_TILES``."""
    if q_tile is None:
        b, s, h, _ = q.shape
        q_tile = 64 if q.dtype != torch.bfloat16 else fwd_q_tile(
            b, s, h, _sm_count(q.device.index or 0))
    if q_tile not in Q_TILES:
        raise ValueError(f"flash_attention kernel: q_tile {q_tile} not in "
                         f"{Q_TILES}")
    return q_tile


def _launch(q, k, v, sm_scale, out=None, q_tile=None, tiling=None):
    """Launch K1 into ``out`` = (o, lse), allocated here if None; ``q_tile``
    (bf16, plain tiling) overrides ``fwd_q_tile``, ``tiling`` ("plain" or
    "packed") the tiling picked from S."""
    b, s, h, d = q.shape
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v)))
    q_tile = _q_tile(q, q_tile)
    sp_log2 = _pack_arg(q, tiling)
    if out is None:
        out = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device),
               torch.empty((b, h, s), dtype=torch.float32, device=q.device))
    o, lse = out
    _check_out(o, (b, s, h, d), q.dtype)
    _check_out(lse, (b, h, s), torch.float32)
    _call("fwd", "flash_attention_fwd", q,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          lse.data_ptr(), b, s, h, d,
          q.stride(0), q.stride(1), k.stride(0), k.stride(1),
          v.stride(0), v.stride(1), float(sm_scale), _DTYPE_CODES[q.dtype],
          q_tile, sp_log2)
    return o, lse


def _bwd_inputs(q, k, v, lse, delta, do):
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("flash_attention backward: dO must match q's shape, "
                         "dtype and device")
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v), ("dO", do)))
    _check_out(lse, (b, h, s), torch.float32)
    _check_out(delta, (b, h, s), torch.float32)
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()],
            [q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), do.stride(0), do.stride(1)])


def _launch_bwd_dq(q, k, v, lse, delta, do, sm_scale, out=None,
                   q_tile=None, tiling=None):
    """Launch K2 into ``out`` (dq), allocated here if None; ``q_tile`` (bf16,
    plain tiling) overrides ``bwd_dq_q_tile``, ``tiling`` the tiling picked
    from S."""
    b, s, h, d = q.shape
    ptrs, strides = _bwd_inputs(q, k, v, lse, delta, do)
    q_tile = _q_tile(q, q_tile)
    sp_log2 = _pack_arg(q, tiling)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) \
        if out is None else out
    _check_out(dq, (b, s, h, d), q.dtype)
    _call("bwd_dq", "flash_attention_bwd_dq", q, *ptrs, dq.data_ptr(),
          b, s, h, d, *strides, float(sm_scale), _DTYPE_CODES[q.dtype],
          q_tile, sp_log2)
    return dq


def _launch_bwd_dkv(q, k, v, lse, delta, do, sm_scale, out=None,
                    tiling=None):
    """Launch K3 into ``out`` = (dk, dv), allocated here if None;
    ``tiling`` overrides the tiling picked from S."""
    b, s, h, d = q.shape
    ptrs, strides = _bwd_inputs(q, k, v, lse, delta, do)
    sp_log2 = _pack_arg(q, tiling)
    if out is None:
        out = tuple(torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                    for _ in range(2))
    dk, dv = out
    _check_out(dk, (b, s, h, d), q.dtype)
    _check_out(dv, (b, s, h, d), q.dtype)
    _call("bwd_dkv", "flash_attention_bwd_dkv", q, *ptrs, dk.data_ptr(),
          dv.data_ptr(), b, s, h, d, *strides, float(sm_scale),
          _DTYPE_CODES[q.dtype], sp_log2)
    return dk, dv


def _device_kind(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return q.device.type


def flash_attention_fwd(q, k, v, sm_scale=None):
    """(o, lse): o (B, S, H, D) in q.dtype, lse (B, H, S) fp32."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_kind(q) == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    return _launch(q, k, v, sm_scale)


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale=None):
    """(dq, dk, dv) of attention at (q, k, v) for the output gradient ``do``,
    from the forward's O and lse; each (B, S, H, D) in q.dtype."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    delta = attention_delta(o, do)
    if _device_kind(q) == "cpu":
        return flash_attention_bwd_reference(q, k, v, lse, delta, do,
                                             sm_scale)
    if do.stride(3) != 1 or do.stride(2) != do.shape[-1]:
        do = do.contiguous()
    dq = _launch_bwd_dq(q, k, v, lse, delta, do, sm_scale)
    dk, dv = _launch_bwd_dkv(q, k, v, lse, delta, do, sm_scale)
    return dq, dk, dv


@torch.library.custom_op("joligen_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sm_scale: float) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``flash_attention_fwd`` as one dispatcher op: a selective activation
    checkpoint (``remat_policy="conv"`` of ``UNetMHA``) can then keep its
    outputs, so that the recomputation of a block does not launch K1
    again."""
    return flash_attention_fwd(q, k, v, sm_scale)


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward (the JAX ``custom_vjp``,
    ``flash_attention.py:247-262``): forward K1, saving q, k, v, O and lse;
    backward delta, then K2 (dq) and K3 (dk, dv). Plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention_fwd_op(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale=None):
    """Multi-head attention. q, k, v: (B, S, H, D) -> (B, S, H, D). Without
    a gradient to track (inference, ``torch.inference_mode``) it runs the
    forward alone and saves nothing."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, sm_scale)
    return flash_attention_fwd(q, k, v, sm_scale)[0]
