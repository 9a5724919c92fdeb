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
  There is no fallback to a library attention.
- On a CPU tensor each step runs its plain PyTorch version
  (``flash_attention_reference``, ``flash_attention_bwd_reference``): the same
  algorithm, which the tests hold against the JAX kernels and
  ``chip_smoke.py`` holds the CUDA kernels against.

``LAUNCHES`` counts each CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library

NEG_INF = -1e30
BLOCK_K = 64          # key tile of the CUDA kernels (BLOCK_K in the .cu files)
SUPPORTED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}


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


def _check_kernel_inputs(q, named):
    """What every kernel takes: a supported head dim and dtype, and (H, D)
    dims contiguous in each (B, S, H, D) input."""
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    for name, t in named:
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"flash_attention kernel: {name} needs contiguous "
                             f"(H, D) dims, got strides {t.stride()}")


def _check_out(t, shape, dtype):
    if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
        raise ValueError("flash_attention kernel: bad preallocated outputs")


_SIGNATURES = {
    # name: (library, symbol, argtypes)
    "fwd": ("flash_attention_fwd", "jg_flash_attention_fwd",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "bwd_dq": ("flash_attention_bwd", "jg_flash_attention_bwd_dq",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 8
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "bwd_dkv": ("flash_attention_bwd", "jg_flash_attention_bwd_dkv",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 8
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}
_FN = {}


def _kernel(name):
    """The C entry point, built and loaded on first use, with its ctypes
    signature."""
    fn = _FN.get(name)
    if fn is None:
        lib, symbol, argtypes = _SIGNATURES[name]
        fn = getattr(load_library(lib), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FN[name] = fn
    return fn


def _call(name, counter, q, *args):
    """Launch on the current stream of q's device, count the launch, raise if
    the launch was refused."""
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
        LAUNCHES[counter] += 1
    if err != 0:
        estr = load_library(_SIGNATURES[name][0]).jg_cuda_error_string
        estr.restype = ctypes.c_char_p
        estr.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{counter} kernel launch failed: "
                           f"{estr(err).decode()} ({err})")


def _launch(q, k, v, sm_scale, out=None):
    """Launch K1 into ``out`` = (o, lse), allocated here if None."""
    b, s, h, d = q.shape
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v)))
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
          v.stride(0), v.stride(1), float(sm_scale), _DTYPE_CODES[q.dtype])
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


def _launch_bwd_dq(q, k, v, lse, delta, do, sm_scale, out=None):
    """Launch K2 into ``out`` (dq), allocated here if None."""
    b, s, h, d = q.shape
    ptrs, strides = _bwd_inputs(q, k, v, lse, delta, do)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) \
        if out is None else out
    _check_out(dq, (b, s, h, d), q.dtype)
    _call("bwd_dq", "flash_attention_bwd_dq", q, *ptrs, dq.data_ptr(),
          b, s, h, d, *strides, float(sm_scale), _DTYPE_CODES[q.dtype])
    return dq


def _launch_bwd_dkv(q, k, v, lse, delta, do, sm_scale, out=None):
    """Launch K3 into ``out`` = (dk, dv), allocated here if None."""
    b, s, h, d = q.shape
    ptrs, strides = _bwd_inputs(q, k, v, lse, delta, do)
    if out is None:
        out = tuple(torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                    for _ in range(2))
    dk, dv = out
    _check_out(dk, (b, s, h, d), q.dtype)
    _check_out(dv, (b, s, h, d), q.dtype)
    _call("bwd_dkv", "flash_attention_bwd_dkv", q, *ptrs, dk.data_ptr(),
          dv.data_ptr(), b, s, h, d, *strides, float(sm_scale),
          _DTYPE_CODES[q.dtype])
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


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward (the JAX ``custom_vjp``,
    ``flash_attention.py:247-262``): forward K1, saving q, k, v, O and lse;
    backward delta, then K2 (dq) and K3 (dk, dv). Plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, sm_scale)
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
