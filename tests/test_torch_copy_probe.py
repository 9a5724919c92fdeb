"""Kernel P3 of the port (``ops/copy.py``, the double-buffered copy) and the
port of the copy-rate probe (``joligen_tpu_torch/tools/bw_probe3.py``): the
plain version and the CPU path of ``make_copy`` against the Pallas
``make_copy`` of ``tools/bw_probe3.py`` run in TPU interpret mode, bit for
bit. The CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

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
