"""Double-buffered copy: the port of kernel P3, ``tools/bw_probe3.py``'s
``make_copy`` (Pallas, TPU), in ``csrc/dma_copy.cu``.

``make_copy(n_rows, row, chunk_rows, dtype, device)`` returns a callable that
copies an (n_rows, row) array exactly, chunk by chunk. The TPU kernel walks
the chunks in order on one core and DMAs each whole chunk into one of two
VMEM slots. On the card a chunk is the unit of work of one block: block i
copies rows [i * chunk_rows, (i + 1) * chunk_rows) through two fixed 16 KiB
shared-memory tiles (16-byte ``cp.async`` loads into one tile while the other
is stored), and waits for a tile's store before loading into it again, as
the TPU kernel waits for a slot's outgoing DMA. So ``chunk_rows`` sets how
many blocks share the copy: a 1 GiB fp32 array of 1024-wide rows is 1024
blocks at 256 rows and 64 at 4096.

- On a CUDA tensor the callable launches the kernel or raises. There is no
  fallback to ``Tensor.copy_``.
- On a CPU tensor it runs the plain version ``copy_reference``, a copy chunk
  by chunk.
- It refuses what the kernel does not take: ``n_rows`` not a multiple of
  ``chunk_rows`` (the TPU kernel silently drops the remainder rows), rows
  whose bytes are not a multiple of 16, and inputs of another shape, dtype
  or device.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import launch

VECTOR_BYTES = 16
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]

LAUNCHES = {"dma_copy": 0}


def copy_reference(x, chunk_rows):
    """Plain version: a new tensor equal to ``x``, filled chunk by chunk of
    ``chunk_rows`` rows."""
    y = torch.empty_like(x)
    for r0 in range(0, x.shape[0], chunk_rows):
        y[r0:r0 + chunk_rows] = x[r0:r0 + chunk_rows]
    return y


def _launch(x, chunk_rows, out):
    if not (out.is_contiguous() and out.shape == x.shape
            and out.dtype == x.dtype and out.device == x.device):
        raise ValueError("dma_copy kernel: bad preallocated output")
    if x.data_ptr() % VECTOR_BYTES or out.data_ptr() % VECTOR_BYTES:
        raise ValueError("dma_copy kernel: arrays must be 16-byte aligned")
    launch("dma_copy", "jg_dma_copy", _ARGTYPES, x.device, x.data_ptr(),
           out.data_ptr(), x.shape[0] // chunk_rows,
           chunk_rows * x.shape[1] * x.element_size())
    LAUNCHES["dma_copy"] += 1
    return out


def make_copy(n_rows, row, chunk_rows, dtype, device):
    """The copy of an (n_rows, row) ``dtype`` array on ``device`` in chunks
    of ``chunk_rows`` rows: ``run(x)`` returns a new tensor equal to x."""
    device = torch.device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if min(n_rows, row, chunk_rows) <= 0 or n_rows % chunk_rows:
        raise ValueError(f"make_copy: n_rows = {n_rows} must be a positive "
                         f"multiple of chunk_rows = {chunk_rows}")
    if row * itemsize % VECTOR_BYTES:
        raise ValueError(f"make_copy: a row of {row} x {itemsize} bytes is "
                         f"not a multiple of {VECTOR_BYTES} bytes")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"make_copy: unsupported device {device}")

    def run(x):
        if (tuple(x.shape) != (n_rows, row) or x.dtype != dtype
                or x.device.type != device.type or not x.is_contiguous()):
            raise ValueError(f"make_copy: expected a contiguous ({n_rows}, "
                             f"{row}) {dtype} tensor on {device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        if x.device.type == "cpu":
            return copy_reference(x, chunk_rows)
        return _launch(x, chunk_rows, torch.empty_like(x))

    return run
