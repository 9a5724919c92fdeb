"""Go/no-go probe for a fused ResBlock on the card: the port of
``tools/fused_resblock_probe.py``.

Stage A asks whether a hand-written tap-matmul 3×3 conv comes near the
library conv at the UNet's 128-channel hot site, (16, 128, 128, 128) bf16
NHWC: P1 (``ops/conv3x3.py::conv3x3_taps``, nine taps of depth C) and P2
(``conv3x3_taps_v2``, three products of depth 3C, at row tiles s2 = 8, 16,
32) against ``conv_library`` (``F.conv2d`` on channels_last tensors: cuDNN on
the card). Its "bar" line then compares twice the best tap conv with the
whole library ResBlock chain (GroupNorm, SiLU, conv, GroupNorm with FiLM,
SiLU, conv, skip): what a fused forward block would have to beat. The
measured lines are in ``PERF.md`` with the card's name and power limit.

Stage B, the fused block itself, is not ported: stage A decides whether it
is worth writing (``stage_b`` raises ``SystemExit``).

Timing: each call's output feeds the next (a dependency chain of ``iters``
calls), one warm chain, then the best of 3 chains, by CUDA events on the
card; on the CPU (``--cpu``) by the host clock, which times PyTorch's CPU
kernels and is no device metric.

Run:  python -m joligen_tpu_torch.tools.fused_resblock_probe
          [--stage a|b] [--iters 32] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv3x3 import STRIPS, conv3x3_taps, conv3x3_taps_v2
from . import device_line, timed

H = W = C = 128
BATCH = 16
REPS = 3
CORRECTNESS_TOL = 3e-2    # bf16 taps, fp32 accumulation on both sides


def conv_library(x, w):
    """The library conv (``conv_xla``'s counterpart): NHWC ``x``, HWIO ``w``
    -> NHWC in ``x.dtype``, through ``F.conv2d`` on channels_last views."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(xn, wn, padding=1).permute(0, 2, 3, 1)


def _gn(h, groups=4):
    """GroupNorm without affine, variance as E[x²] − E[x]² (fp32 in)."""
    n, hh, ww, c = h.shape
    g = h.reshape(n, hh, ww, groups, c // groups)
    mu = g.mean(dim=(1, 2, 4), keepdim=True)
    var = (g * g).mean(dim=(1, 2, 4), keepdim=True) - mu * mu
    return ((g - mu) * torch.rsqrt(var + 1e-5)).reshape(h.shape)


def chain_library(x, g1, b1, w1, cb1, sc, sh, w2, cb2):
    """The ResBlock chain at the hot site as the library runs it
    (``chain_xla``'s counterpart): compute in ``x.dtype``, GroupNorm
    statistics in fp32."""
    f = torch.float32
    h = _gn(x.to(f)) * g1 + b1
    h = F.silu(h).to(x.dtype)
    h = conv_library(h, w1) + cb1.to(x.dtype)
    h = _gn(h.to(f)) * sc[:, None, None, :] + sh[:, None, None, :]
    h = F.silu(h).to(x.dtype)
    h = conv_library(h, w2) + cb2.to(x.dtype)
    return x + h


def _time_chain(fn, x, iters, device):
    """Seconds per call of ``fn`` in a chain of ``iters`` dependent calls:
    one warm chain, then the best of ``REPS``."""
    def chain():
        v = x
        for _ in range(iters):
            v = fn(v)
        return v

    timed(chain, device)
    return min(timed(chain, device)[0] for _ in range(REPS)) / iters


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / max(1e-6, want.abs().max().item())).item()


def stage_a_launches(iters):
    """Kernel launches of one ``stage_a`` on the card: each variant once in
    the check, then in a warm chain and ``REPS`` chains of ``iters`` calls."""
    per_variant = 1 + (1 + REPS) * iters
    return {"conv3x3_taps": per_variant,
            "conv3x3_taps_v2": len(STRIPS) * per_variant}


def stage_a(iters, batch=BATCH, cpu=False):
    """Check P1 and P2 against the library conv on ``x[:2]``, then time the
    library conv, P1, P2 per s2 and the library chain. Returns the numbers
    (seconds per call) and prints them."""
    device = resolve_device(cpu)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, H, W, C)).to(
        device=device, dtype=torch.bfloat16) * 0.1
    w = torch.from_numpy(rng.randn(3, 3, C, C) * (1.0 / np.sqrt(9 * C))).to(
        device=device, dtype=torch.bfloat16)

    xs = x[:2]
    ref = conv_library(xs, w)
    err = _rel_err(conv3x3_taps(xs, w), ref)
    print(f"stage A correctness: rel err {err:.2e}")
    if not err < CORRECTNESS_TOL:
        raise AssertionError(f"tap conv mismatch vs library conv: {err}")
    errs_v2 = {}
    for s2 in STRIPS:
        errs_v2[s2] = _rel_err(conv3x3_taps_v2(xs, w, s2=s2), ref)
        if not errs_v2[s2] < CORRECTNESS_TOL:
            raise AssertionError(f"v2 s2={s2} mismatch {errs_v2[s2]}")

    flops = 2 * 9 * batch * H * W * C * C
    tx = _time_chain(lambda v: conv_library(v, w), x, iters, device)
    print(f"stage A: library conv {tx * 1e3:.3f} ms "
          f"({flops / tx / 1e12:.1f} TF/s)")
    tp = _time_chain(lambda v: conv3x3_taps(v, w), x, iters, device)
    print(f"  v1 (9 K=C taps, S=8):   {tp * 1e3:.3f} ms "
          f"({flops / tp / 1e12:.1f} TF/s)  ratio {tp / tx:.2f}x")
    best, t_v2 = tp, {}
    for s2 in STRIPS:
        t2 = t_v2[s2] = _time_chain(
            lambda v, s2=s2: conv3x3_taps_v2(v, w, s2=s2), x, iters, device)
        print(f"  v2 (3 K=3C taps, S={s2:2d}): {t2 * 1e3:.3f} ms "
              f"({flops / t2 / 1e12:.1f} TF/s)  ratio {t2 / tx:.2f}x")
        best = min(best, t2)

    # the bar a fused block must beat: the whole library chain (2 convs and
    # the GroupNorm/FiLM/SiLU/skip traffic) against 2 tap convs
    rng2 = np.random.RandomState(1)

    def vec(a, dtype=torch.float32):
        return torch.from_numpy(a).to(device=device, dtype=dtype)
    g1 = vec(rng2.uniform(0.5, 1.5, (C,)))
    b1 = vec(rng2.randn(C) * 0.1)
    cb = vec(rng2.randn(C) * 0.1)
    sc = vec(rng2.uniform(0.8, 1.2, (batch, C)))
    sh = vec(rng2.randn(batch, C) * 0.1)
    w2 = vec(rng2.randn(3, 3, C, C) / np.sqrt(9 * C), torch.bfloat16)
    tc = _time_chain(lambda v: chain_library(v, g1, b1, w, cb, sc, sh, w2, cb),
                     x, iters, device)
    print(f"stage A bar: library full chain {tc * 1e3:.3f} ms vs fused fwd "
          f"projection 2x{best * 1e3:.3f}+eps = {2 * best * 1e3:.3f} ms "
          f"-> projected fwd gain {(tc - 2 * best) * 1e3:+.3f} ms/block")
    return {"device": device_line(device), "batch": batch, "iters": iters,
            "flops": flops, "rel_err_v1": err, "rel_err_v2": errs_v2,
            "library_s": tx, "v1_s": tp, "v2_s": t_v2, "chain_s": tc,
            "best_tap_s": best, "ratio_v1": tp / tx}


def stage_b(iters):
    raise SystemExit(
        "stage B (the fused ResBlock forward) is not ported: stage A decides "
        "it. Compare 2x the best tap conv with the library chain in the "
        "stage-A lines of PERF.md (measured on the card, with its name and "
        "power limit) before writing a fused block.")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="a", choices=["a", "b"])
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock); default: the card")
    a = ap.parse_args(argv)
    device = resolve_device(a.cpu)
    print(f"device: {device_line(device)}")
    if a.stage == "a":
        return stage_a(a.iters, cpu=a.cpu)
    return stage_b(a.iters)


if __name__ == "__main__":
    main()
