"""The port's probes: ``fused_resblock_probe`` (kernels P1 and P2, the 3×3
tap conv) and ``bw_probe3`` (kernel P3, the chunked copy), ports of
the JAX package's ``tools/`` scripts of the same names. Each runs on the card
unless ``--cpu`` is given; without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import time

import torch

from .. import card_line


def device_line(device):
    """What a probe's times were taken on: the card's name and power limit
    (``card_line``, which raises if they cannot be read), or the CPU (host
    clock)."""
    if device.type != "cuda":
        return "cpu (host clock)"
    return card_line(device.index if device.index is not None
                     else torch.cuda.current_device())


def timed(fn, device):
    """(seconds, result) of ``fn()``: CUDA events around it on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out
