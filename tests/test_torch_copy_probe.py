"""Kernel P3 of the port (``ops/copy.py``, the chunked copy through TMA bulk
copies) and the port of the copy-rate probe
(``joligen_tpu_torch/tools/bw_probe3.py``): the kernel's work items
(``copy_tiles``), and the plain version and the CPU path of ``make_copy``,
which walk those items, against the Pallas ``make_copy`` of
``tools/bw_probe3.py`` run in TPU interpret mode, bit for bit. The CUDA
kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu_torch.ops import copy as dma
from joligen_tpu_torch.tools import bw_probe3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, ROW = 4096, 1024


@pytest.fixture(scope="module")
def jax_bw():
    """tools/bw_probe3.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_bw_probe3", os.path.join(ROOT, "tools", "bw_probe3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def _bits_np(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


def _bits_torch(t):
    return _bits_np(t.view(torch.int32 if t.element_size() == 4
                           else torch.int16).numpy())


@pytest.mark.parametrize("chunk_rows", [256, 1024, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_matches_pallas_copy_bit_for_bit(jax_bw, interpret, dtype,
                                              chunk_rows):
    # the probe's position-dependent content (bw_probe3.py:96-99)
    src = (np.arange(N_ROWS, dtype=np.float32)[:, None] % 997.0) * np.ones(
        (1, ROW), np.float32)
    jx = jnp.asarray(src, getattr(jnp, dtype))
    tx = torch.from_numpy(src).to(getattr(torch, dtype))
    want = _bits_np(jax_bw.make_copy(N_ROWS, ROW, chunk_rows,
                                     getattr(jnp, dtype))(jx))
    np.testing.assert_array_equal(want, _bits_np(jx))
    assert np.array_equal(_bits_torch(tx), want)
    before = dict(dma.LAUNCHES)
    run = dma.make_copy(N_ROWS, ROW, chunk_rows, getattr(torch, dtype), "cpu")
    for got in (run(tx), dma.copy_reference(tx, chunk_rows)):
        assert got.dtype == tx.dtype and got.data_ptr() != tx.data_ptr()
        np.testing.assert_array_equal(_bits_torch(got), want)
    assert dma.LAUNCHES == before       # CPU tensors launch nothing


# chunks whose bytes are not a multiple of the 4 KiB tile: 6 KiB (a whole
# tile and a short one), 20000 bytes (four whole and a short one), one
# 4000-byte row and 576 bytes (one short tile each)
@pytest.mark.parametrize("n_rows,row,chunk_rows,dtype", [
    (240, 1024, 3, "bfloat16"), (240, 1000, 5, "float32"),
    (240, 1000, 1, "float32"), (240, 24, 12, "bfloat16")])
def test_copy_matches_pallas_copy_at_ragged_tiles(jax_bw, interpret, n_rows,
                                                  row, chunk_rows, dtype):
    chunk_bytes = chunk_rows * row * (4 if dtype == "float32" else 2)
    assert chunk_bytes % dma.TILE_BYTES
    src = np.random.default_rng(row + chunk_rows).standard_normal(
        (n_rows, row)).astype(np.float32)
    jx = jnp.asarray(src, getattr(jnp, dtype))
    tx = torch.from_numpy(src).to(getattr(torch, dtype))
    want = _bits_np(jax_bw.make_copy(n_rows, row, chunk_rows,
                                     getattr(jnp, dtype))(jx))
    np.testing.assert_array_equal(want, _bits_np(jx))
    assert np.array_equal(_bits_torch(tx), want)
    run = dma.make_copy(n_rows, row, chunk_rows, getattr(torch, dtype), "cpu")
    for got in (run(tx), dma.copy_reference(tx, chunk_rows)):
        np.testing.assert_array_equal(_bits_torch(got), want)


@pytest.mark.parametrize("n_chunks,chunk_bytes", [
    (1, 16), (3, 24576), (5, 49152), (2, 81920), (4, 2**20),
    (7, dma.TILE_BYTES + 16), (64, 4096)])
def test_copy_tiles_cover_every_byte_once_within_its_chunk(n_chunks,
                                                           chunk_bytes):
    tiles = dma.copy_tiles(chunk_bytes)
    assert len(tiles) == -(-chunk_bytes // dma.TILE_BYTES)
    # the kernel's items: item i is tile i % len(tiles) of chunk
    # i // len(tiles)
    items = [(c * chunk_bytes + off, n) for c in range(n_chunks)
             for off, n in tiles]
    covered = np.zeros(n_chunks * chunk_bytes, np.int32)
    for off, n in items:
        assert 0 < n <= dma.TILE_BYTES and off % 16 == 0 and n % 16 == 0
        assert off // chunk_bytes == (off + n - 1) // chunk_bytes
        covered[off:off + n] += 1
    assert (covered == 1).all()
    # in order, each chunk's last tile the only short one
    assert [off for off, _ in items] == sorted(off for off, _ in items)
    assert all(n == dma.TILE_BYTES for _, n in tiles[:-1])


def test_copy_kernel_tiles_like_the_plain_version():
    with open(os.path.join(ROOT, "joligen_tpu_torch", "csrc",
                           "dma_copy.cu")) as f:
        src = f.read()
    # the kernel's tile is the plain version's; one mbarrier phase counts
    # at most 2^20 - 1 bytes of transactions
    tile = re.search(r"constexpr long long TILE_BYTES = (\d+);", src)
    assert tile and int(tile.group(1)) == dma.TILE_BYTES
    assert dma.TILE_BYTES < 2**20 and dma.TILE_BYTES % 16 == 0


@pytest.mark.parametrize("view", ["transposed", "strided"])
def test_copy_reference_refuses_a_non_contiguous_input(view):
    x = torch.arange(64 * 32, dtype=torch.float32).view(64, 32)
    x = x.t() if view == "transposed" else x[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        dma.copy_reference(x, 8)


def test_probe_source_matches_the_jax_probe_content():
    x = bw_probe3.source(3000, 8, torch.bfloat16, torch.device("cpu"))
    want = jnp.asarray((np.arange(3000, dtype=np.float32) % 997.0)[:, None],
                       jnp.bfloat16) * jnp.ones((1, 8), jnp.bfloat16)
    np.testing.assert_array_equal(_bits_torch(x), _bits_np(want))


def test_make_copy_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of chunk_rows"):
        dma.make_copy(1000, 1024, 256, torch.float32, "cpu")
    with pytest.raises(ValueError, match="multiple of chunk_rows"):
        dma.make_copy(1024, 1024, 0, torch.float32, "cpu")
    with pytest.raises(ValueError, match="16 bytes"):
        dma.make_copy(1024, 6, 256, torch.bfloat16, "cpu")
    run = dma.make_copy(512, 8, 256, torch.float32, "cpu")
    for bad in (torch.zeros(512, 16), torch.zeros(512, 8, dtype=torch.int32),
                torch.zeros(8, 512).t()):
        with pytest.raises(ValueError, match="expected a contiguous"):
            run(bad)


def test_probe_runs_on_the_cpu(capsys):
    before = dict(dma.LAUNCHES)
    records = bw_probe3.run_cases(mib=4, cpu=True)
    assert dma.LAUNCHES == before
    kinds = [(r["kind"], r["dtype"]) for r in records]
    assert kinds == [("dma_copy", "float32")] * 3 + [("copy_", "float32")] \
        + [("dma_copy", "bfloat16")] * 3 + [("copy_", "bfloat16")]
    assert all(r["exact"] and r["gb_per_s"] > 0 for r in records)
    assert [r["chunk_rows"] for r in records[:3]] == [256, 1024, 1024]
    out = capsys.readouterr().out
    assert out.count(" ok\n") == 6 and out.count("copy_ ") == 2


def test_probe_raises_without_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bw_probe3.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bw_probe3.run_cases(mib=1)
