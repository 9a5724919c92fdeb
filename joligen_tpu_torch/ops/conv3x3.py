"""3×3 tap convolution: the port of kernels P1 and P2 of
``tools/fused_resblock_probe.py`` (Pallas, TPU):

- P1 ``_conv_kernel`` (wrapper ``conv_pallas``) -> ``conv3x3_taps``;
- P2 ``_conv_kernel_v2`` (wrapper ``conv_pallas_v2``) ->
  ``conv3x3_taps_v2``;

both in ``csrc/conv3x3_tap.cu``. Each computes a 3×3 convolution with SAME
zero padding of NHWC ``x`` (B, H, W, C) by an HWIO weight (3, 3, C, Co),
accumulating in fp32 and returning (B, H, W, Co) in ``x.dtype``. P1 sums the
nine taps dy outer, dx inner; P2 sums three products of depth 3C, dx outer,
over the weight repacked as the JAX wrapper repacks it
(``w.permute(1, 0, 2, 3).reshape(3, 3C, Co)``,
``fused_resblock_probe.py:172``).

- On a CUDA tensor each wrapper launches its kernel or raises. There is no
  fallback to a library convolution, nor from one route to the other.
  ``ROUTES`` says which kernel a dtype takes: in bf16 both run one implicit
  GEMM on the tensor cores (``wgmma``: 64 pixels of a row by 128 output
  channels a warpgroup, K = 9C in each kernel's tap order); in fp32 both run
  on FMAs, which hold 1e-4 (TF32 would not).
- On a CPU tensor it runs its plain PyTorch version
  (``conv3x3_taps_reference``, ``conv3x3_taps_v2_reference``): the same
  taps in the same order, which the tests hold against the Pallas kernels
  and ``chip_smoke.py`` holds the CUDA kernels against.
- Both refuse what the kernels do not take: dtypes other than float32 and
  bfloat16, C or Co not a multiple of 8, P2's ``s2`` outside (8, 16, 32).

Weights: both packages take the conv weight as HWIO (3, 3, C, Co), so it
crosses between them as a numpy array unchanged; no converter entry is
needed.

``LAUNCHES`` counts each CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import launch

# C and Co: one 16-byte copy of 8 bf16 channels (the wgmma route zero-fills a
# part-filled 64-channel K step or 128-channel N tile); the FMA route's
# input chunk and output group
CHANNEL_MULTIPLE = 8
STRIPS = (8, 16, 32)      # P2's rows a block covers, the TPU's s2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P1 = 0                   # the kernel's variant code for P1; P2's is s2

LAUNCHES = {"conv3x3_taps": 0, "conv3x3_taps_v2": 0}
ROUTES = {"conv3x3_taps": {"float32": "fma", "bfloat16": "wgmma"},
          "conv3x3_taps_v2": {"float32": "fma", "bfloat16": "wgmma"}}


def _padded(x):
    """fp32 copy of NHWC ``x`` with one zero row and column on each side."""
    return F.pad(x.float(), (0, 0, 1, 1, 1, 1))


def repack_v2(w):
    """HWIO (3, 3, C, Co) -> (dx, 3C, Co) with the dy taps stacked along K."""
    _, _, c, co = w.shape
    return w.permute(1, 0, 2, 3).reshape(3, 3 * c, co)


def conv3x3_taps_reference(x, w):
    """Plain version of P1: nine fp32 tap products over shifted slices of
    the zero-padded input, dy outer and dx inner, one rounding at the end."""
    b, h, wd, _ = x.shape
    xp, wf = _padded(x), w.float()
    acc = torch.zeros(b, h, wd, w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
    return acc.to(x.dtype)


def conv3x3_taps_v2_reference(x, w):
    """Plain version of P2: the dy-shifted rows stacked along channels
    (B, H, W+2, 3C), then three fp32 products of depth 3C, one per dx."""
    b, h, wd, _ = x.shape
    xp = _padded(x)
    x3 = torch.cat([xp[:, dy:dy + h] for dy in range(3)], dim=-1)
    wt = repack_v2(w).float()
    acc = torch.zeros(b, h, wd, w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for dx in range(3):
        acc += x3[:, :, dx:dx + wd, :] @ wt[dx]
    return acc.to(x.dtype)


def _check(x, w):
    if (x.ndim != 4 or w.ndim != 4
            or tuple(w.shape[:3]) != (3, 3, x.shape[-1])):
        raise ValueError(f"conv3x3: x must be (B, H, W, C) and w (3, 3, C, "
                         f"Co), got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.device != w.device:
        raise ValueError("conv3x3: x and w must share one dtype and device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"conv3x3 kernel: dtype {x.dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    c, co = w.shape[2], w.shape[3]
    if c % CHANNEL_MULTIPLE or co % CHANNEL_MULTIPLE:
        raise ValueError(f"conv3x3 kernel: C = {c} and Co = {co} must be "
                         f"multiples of {CHANNEL_MULTIPLE}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3: unsupported device {x.device}")


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def kernel_taps(w, v2):
    """The nine taps of HWIO ``w`` as the kernel of its dtype reads them, in
    P1's order (``v2`` False: tap 3*dy+dx) or P2's (the (dx, 3C, Co)
    repack: tap 3*dx+dy): (9, C, Co) for the fp32 FMA kernel; for the bf16
    wgmma kernel each tap transposed, (9, Co, C), so that its rows are the
    K-major B operand."""
    _, _, c, co = w.shape
    taps = (repack_v2(w) if v2 else w).reshape(9, c, co)
    if w.dtype == torch.bfloat16:
        taps = taps.transpose(1, 2)
    return taps.contiguous()


def _launch(x, taps, variant, out=None):
    """Launch P1 (``variant`` 0) or P2 (``variant`` = s2) on ``taps`` from
    ``kernel_taps`` into ``out``, allocated here if None."""
    b, h, wd, c = x.shape
    co = taps.shape[1] if x.dtype == torch.bfloat16 else taps.shape[-1]
    if out is None:
        out = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    for name, t in (("x", x), ("taps", taps), ("out", out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3x3 kernel: {name} must be contiguous and "
                             f"16-byte aligned")
    if (out.shape != (b, h, wd, co) or out.dtype != x.dtype
            or taps.numel() != 9 * c * co or taps.dtype != x.dtype
            or taps.ndim != 3):
        raise ValueError("conv3x3 kernel: bad taps or preallocated output")
    launch("conv3x3_tap", "jg_conv3x3_tap", _ARGTYPES, x.device,
           x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, wd, c, co,
           variant, _DTYPE_CODES[x.dtype])
    LAUNCHES["conv3x3_taps" if variant == _P1 else "conv3x3_taps_v2"] += 1
    return out


def conv3x3_taps(x, w):
    """P1: 3×3 SAME conv of NHWC ``x`` by HWIO ``w``, (B, H, W, Co) in
    ``x.dtype``."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_taps_reference(x, w)
    return _launch(x, kernel_taps(w, v2=False), _P1)


def conv3x3_taps_v2(x, w, s2=16):
    """P2: the same conv as three products of depth 3C, over row tiles of
    ``s2`` rows (8, 16 or 32)."""
    _check(x, w)
    if s2 not in STRIPS:
        raise ValueError(f"conv3x3_taps_v2: s2 = {s2} not in {STRIPS}")
    if x.device.type == "cpu":
        return conv3x3_taps_v2_reference(x, w)
    return _launch(x, kernel_taps(w, v2=True), s2)
