"""Flash-attention forward: the port of kernel K1,
``joligen_tpu/ops/flash_attention.py::_fwd_kernel`` (Pallas, TPU).

``flash_attention`` keeps the JAX wrapper's signature and semantics
(``joligen_tpu/ops/flash_attention.py:265-294``): (B, S, H, D) in and out,
``sm_scale`` defaulting to 1/sqrt(D), keys at or past S masked, the output
cast to ``q.dtype``.

- On a CUDA tensor it launches the hand-written kernel
  ``csrc/flash_attention_fwd.cu`` or raises. There is no fallback to a
  library attention, and it raises on a call that needs a gradient: the
  backward kernels (K2, K3) come with the training slice.
- On a CPU tensor it runs ``flash_attention_reference``, the plain PyTorch
  version of the same algorithm, which the tests hold against the JAX kernel
  and ``chip_smoke.py`` holds the CUDA kernel against.

``LAUNCHES["flash_attention_fwd"]`` counts the CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import load_library

NEG_INF = -1e30
BLOCK_K = 64          # key tile of the CUDA kernel (BLOCK_K in the .cu)
SUPPORTED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention_fwd": 0}


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


def _check(q, k, v):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


_FN = {}


def _kernel():
    """The C entry point, built and loaded on first use, with its ctypes
    signature."""
    fn = _FN.get("fwd")
    if fn is None:
        fn = load_library("flash_attention_fwd").jg_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _FN["fwd"] = fn
    return fn


def _launch(q, k, v, sm_scale, out=None):
    """Launch the kernel into ``out`` = (o, lse), allocated here if None."""
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"flash_attention kernel: {name} needs contiguous "
                             f"(H, D) dims, got strides {t.stride()}")
    fn = _kernel()
    if out is None:
        out = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device),
               torch.empty((b, h, s), dtype=torch.float32, device=q.device))
    o, lse = out
    if (o.shape != (b, s, h, d) or o.dtype != q.dtype or not o.is_contiguous()
            or lse.shape != (b, h, s) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention kernel: bad preallocated outputs")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, s, h, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), float(sm_scale),
                 _DTYPE_CODES[q.dtype], stream)
        LAUNCHES["flash_attention_fwd"] += 1
    if err != 0:
        estr = load_library("flash_attention_fwd").jg_cuda_error_string
        estr.restype = ctypes.c_char_p
        estr.argtypes = [ctypes.c_int]
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{estr(err).decode()} ({err})")
    return o, lse


def flash_attention_fwd(q, k, v, sm_scale=None):
    """(o, lse): o (B, S, H, D) in q.dtype, lse (B, H, S) fp32."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA has no backward kernel yet (K2/K3 come "
            "with the training slice, ROADMAP Queue 2)")
    return _launch(q, k, v, sm_scale)


def flash_attention(q, k, v, sm_scale=None):
    """Multi-head attention. q, k, v: (B, S, H, D) -> (B, S, H, D)."""
    return flash_attention_fwd(q, k, v, sm_scale)[0]
