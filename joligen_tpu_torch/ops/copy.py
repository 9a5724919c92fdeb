"""Exact chunked copy: the port of kernel P3, ``tools/bw_probe3.py``'s
``make_copy`` (Pallas, TPU), in ``csrc/dma_copy.cu``.

``make_copy(n_rows, row, chunk_rows, dtype, device)`` returns a callable that
copies an (n_rows, row) array exactly, chunk by chunk. The TPU kernel walks
the chunks in order on one core and DMAs each whole chunk into one of two
VMEM slots. On the card the work is cut into items: tiles of ``TILE_BYTES``
of one chunk (``copy_tiles``), a chunk's last tile shorter where its bytes
are not a multiple of the tile. A persistent grid (blocks on every SM, never
more than items) walks them, each block with one thread issuing TMA bulk
copies through a ring of shared-memory stages (an ``mbarrier`` a stage); a
stage is refilled only after its outgoing copy has read it out, as the TPU
kernel waits for a slot's outgoing DMA. ``launch_plan`` reports the grid,
stages and shared memory of a launch.

- On a CUDA tensor the callable launches the kernel or raises. There is no
  fallback to ``Tensor.copy_``.
- On a CPU tensor it runs the plain version ``copy_reference``, which copies
  the same items, one tile of every chunk at a time.
- It refuses what the kernel does not take: ``n_rows`` not a multiple of
  ``chunk_rows`` (the TPU kernel silently drops the remainder rows), rows
  whose bytes are not a multiple of 16 (TMA's unit), and inputs of another
  shape, dtype or device.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import launch, load_library

ALIGN_BYTES = 16                    # TMA bulk copies' unit
# csrc/dma_copy.cu's TILE_BYTES: one work item at most
TILE_BYTES = 4096
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]

LAUNCHES = {"dma_copy": 0}
_PLAN = {}                          # jg_dma_copy_plan, bound on first use


def copy_tiles(chunk_bytes):
    """The tiles of one chunk, ``(offset in the chunk, bytes)``: ``TILE_BYTES``
    each, the last one shorter where ``chunk_bytes`` is not a multiple of the
    tile. The kernel's work item i is tile ``i % len(tiles)`` of chunk
    ``i // len(tiles)``."""
    return [(t, min(TILE_BYTES, chunk_bytes - t))
            for t in range(0, chunk_bytes, TILE_BYTES)]


def copy_reference(x, chunk_rows):
    """Plain version: a new tensor equal to the contiguous ``x``, filled by
    the kernel's work items over chunks of ``chunk_rows`` rows, one tile of
    every chunk at a time."""
    if not x.is_contiguous():
        raise ValueError("copy_reference: x must be contiguous")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n_chunks = x.shape[0] // chunk_rows
    src = x.view(-1).view(torch.uint8).view(n_chunks, -1)
    dst = y.view(-1).view(torch.uint8).view(n_chunks, -1)
    for off, n in copy_tiles(src.shape[1]):
        dst[:, off:off + n] = src[:, off:off + n]
    return y


def random_bits(shape, dtype, generator):
    """A tensor of random bits in ``dtype`` (every NaN and denormal pattern
    included) on ``generator``'s device, and the integer type of its width,
    through which two such tensors compare bit for bit: the input on which
    the copy is checked."""
    bits = {4: torch.int32, 2: torch.int16}[
        torch.empty((), dtype=dtype).element_size()]
    info = torch.iinfo(bits)
    return torch.randint(info.min, info.max, shape, generator=generator,
                         device=generator.device, dtype=bits).view(dtype), bits


def launch_plan(n_chunks, chunk_bytes, device):
    """What the kernel launches with on CUDA ``device`` for ``n_chunks``
    chunks of ``chunk_bytes``: grid, stages, shared memory bytes a block,
    tile bytes and work items."""
    fn = _PLAN.get("fn")
    if fn is None:
        fn = load_library("dma_copy").jg_dma_copy_plan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_longlong)]
        _PLAN["fn"] = fn
    plan = (ctypes.c_longlong * 5)()
    with torch.cuda.device(device):
        err = fn(n_chunks, chunk_bytes, plan)
    if err != 0:
        raise RuntimeError(f"jg_dma_copy_plan failed ({err})")
    return dict(zip(("grid", "stages", "smem_bytes", "tile_bytes", "items"),
                    plan))


def _launch(x, chunk_rows, out):
    if not (out.is_contiguous() and out.shape == x.shape
            and out.dtype == x.dtype and out.device == x.device):
        raise ValueError("dma_copy kernel: bad preallocated output")
    if x.data_ptr() % ALIGN_BYTES or out.data_ptr() % ALIGN_BYTES:
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
    if row * itemsize % ALIGN_BYTES:
        raise ValueError(f"make_copy: a row of {row} x {itemsize} bytes is "
                         f"not a multiple of {ALIGN_BYTES} bytes")
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
