"""Copy-rate probe: the port of ``tools/bw_probe3.py``. It measures the rate
at which the card moves device memory through an exact chunked copy kernel
(P3, ``ops/copy.py::make_copy``: TMA bulk copies device memory -> shared
memory -> device memory through a ring of stages), in chunks of 256, 1024
and 4096 rows of 1024 elements, over a 1 GiB array in fp32 and in bf16.
``dst.copy_(src)`` is timed beside it as the library yardstick. The rates
measured on the card are in ``PERF.md``, beside the card's name and power
limit and the data sheet's memory rate.

Each case: two warm calls, then ``REPS`` calls timed together by CUDA events
(on the CPU, with ``--cpu``, by the host clock: no device metric). A call
allocates its output while the previous one is still held, so the warm-up
makes two: otherwise the first timed window holds a 1 GiB ``cudaMalloc``.
Two bytes move per byte of the array. The content depends on the row (``i % 997``), so
a stale tile would show; the copy is checked bit for bit outside the timed
window and a mismatch raises.

Run:  python -m joligen_tpu_torch.tools.bw_probe3 [--cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..ops.copy import make_copy
from . import device_line, timed

ROW = 1024
CHUNK_ROWS = (256, 1024, 4096)
DTYPES = (torch.float32, torch.bfloat16)
REPS = 8


def source(n_rows, row, dtype, device):
    """(n_rows, row) with row i holding i % 997 in ``dtype``."""
    idx = torch.arange(n_rows, dtype=torch.float32, device=device) % 997.0
    return idx.to(dtype)[:, None] * torch.ones((1, row), dtype=dtype,
                                               device=device)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _repeat(fn, reps):
    def go():
        out = None
        for _ in range(reps):
            out = fn()
        return out
    return go


WARM = 2
# kernel launches of one run_cases on the card: WARM warm calls and REPS
# timed calls per (dtype, chunk_rows) case
RUN_LAUNCHES = {"dma_copy": len(DTYPES) * len(CHUNK_ROWS) * (WARM + REPS)}


def run_cases(mib=1024, cpu=False):
    """Every (dtype, chunk_rows) case over a ``mib`` MiB array, then
    ``copy_``; prints one GB/s line each and returns them as records."""
    device = resolve_device(cpu)
    records = []
    for dtype in DTYPES:
        itemsize = torch.empty((), dtype=dtype).element_size()
        n_rows = mib * 2**20 // (ROW * itemsize)
        moved = REPS * n_rows * ROW * itemsize * 2      # read + write
        name = str(dtype).split(".")[-1]
        x = source(n_rows, ROW, dtype, device)
        for cr in CHUNK_ROWS:
            cr = min(cr, n_rows)
            run = make_copy(n_rows, ROW, cr, dtype, device)
            timed(_repeat(lambda: run(x), WARM), device)
            dt, y = timed(_repeat(lambda: run(x), REPS), device)
            exact = torch.equal(_bits(y), _bits(x))
            del y
            records.append({"kind": "dma_copy", "dtype": name,
                            "chunk_rows": cr, "bytes": n_rows * ROW * itemsize,
                            "reps": REPS, "seconds": dt,
                            "gb_per_s": moved / dt / 1e9, "exact": exact})
            print(f"dma_copy {name:9s} chunk={cr * ROW * itemsize // 1024:6d}"
                  f"KiB {moved / dt / 1e9:7.1f} GB/s "
                  f"{'ok' if exact else 'CORRUPT'}", flush=True)
            if not exact:
                raise AssertionError(f"dma_copy {name} chunk_rows {cr} "
                                     f"corrupted the copy")
        dst = torch.empty_like(x)
        timed(lambda: dst.copy_(x), device)
        dt, _ = timed(_repeat(lambda: dst.copy_(x), REPS), device)
        records.append({"kind": "copy_", "dtype": name, "chunk_rows": None,
                        "bytes": n_rows * ROW * itemsize, "reps": REPS,
                        "seconds": dt, "gb_per_s": moved / dt / 1e9,
                        "exact": torch.equal(_bits(dst), _bits(x))})
        print(f"copy_    {name:9s} library      {moved / dt / 1e9:7.1f} GB/s",
              flush=True)
        del x, dst
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock); default: the card")
    a = ap.parse_args(argv)
    device = resolve_device(a.cpu)
    print(f"device: {device_line(device)}")
    return run_cases(cpu=a.cpu)


if __name__ == "__main__":
    main()
