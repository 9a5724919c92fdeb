"""Kernels P1 and P2 of the port (``ops/conv3x3.py``, the 3×3 tap conv) and
the port of the conv probe
(``joligen_tpu_torch/tools/fused_resblock_probe.py``): the plain versions
against the Pallas kernels of ``tools/fused_resblock_probe.py`` run in TPU
interpret mode, the library conv and ResBlock chain against their XLA
counterparts, and stage A end to end on the CPU. The CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu_torch.ops import conv3x3
from joligen_tpu_torch.tools import fused_resblock_probe as probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "bfloat16": 8e-3}    # relative to max |y|


@pytest.fixture(scope="module")
def jax_probe():
    """tools/fused_resblock_probe.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_fused_resblock_probe",
        os.path.join(ROOT, "tools", "fused_resblock_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call traced in the test runs in TPU interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def _inputs(seed, shape=(1, 128, 128, 128), co=128):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co))
         / np.sqrt(9 * shape[-1])).astype(np.float32)
    return x, w


def _both(a, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_p1_plain_version_matches_pallas_kernel(jax_probe, interpret, dtype):
    x, w = _inputs(1)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    want = np.asarray(jax_probe.conv_pallas(jx, jw), np.float32)
    got = conv3x3.conv3x3_taps(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (1, 128, 128, 128)
    assert torch.equal(got, conv3x3.conv3x3_taps_reference(tx, tw))
    assert _rel_err(got.float().numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("s2", [8, 16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_p2_plain_version_matches_pallas_kernel(jax_probe, interpret, dtype,
                                                s2):
    x, w = _inputs(2 + s2)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    want = np.asarray(jax_probe.conv_pallas_v2(jx, jw, s2=s2), np.float32)
    got = conv3x3.conv3x3_taps_v2(tx, tw, s2=s2)
    assert got.dtype == tx.dtype and got.shape == (1, 128, 128, 128)
    assert torch.equal(got, conv3x3.conv3x3_taps_v2_reference(tx, tw))
    assert _rel_err(got.float().numpy(), want) <= TOL[dtype]


def test_p2_weight_repack_matches_jax(jax_probe):
    _, w = _inputs(3, shape=(1, 4, 4, 16), co=16)
    want = jnp.transpose(jnp.asarray(w), (1, 0, 2, 3)).reshape(3, 48, 16)
    got = conv3x3.repack_v2(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _numpy_conv(x, w):
    """3×3 SAME conv in float64, NHWC by HWIO."""
    b, h, wd, _ = x.shape
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    y = np.zeros((b, h, wd, w.shape[-1]))
    for dy in range(3):
        for dx in range(3):
            y += xp[:, dy:dy + h, dx:dx + wd] @ w[dy, dx].astype(np.float64)
    return y


def test_plain_versions_match_numpy_conv_at_ragged_shape():
    # H and W not multiples of any tile, C and Co not of the block's 64: the
    # borders are where a halo fault shows
    x, w = _inputs(4, shape=(2, 13, 21, 16), co=24)
    want = _numpy_conv(x, w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(conv3x3.LAUNCHES)
    for got in (conv3x3.conv3x3_taps(tx, tw),
                conv3x3.conv3x3_taps_v2(tx, tw, s2=8),
                conv3x3.conv3x3_taps_v2(tx, tw, s2=32)):
        assert got.shape == (2, 13, 21, 24) and got.dtype == torch.float32
        assert _rel_err(got.numpy(), want) <= 1e-5
    assert conv3x3.LAUNCHES == before      # CPU tensors launch nothing


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 8, 16)
    for bad_w, match in ((torch.zeros(3, 3, 16, 12), "multiples of 8"),
                         (torch.zeros(3, 3, 8, 16), "must be"),
                         (torch.zeros(3, 3, 16, 16, dtype=torch.float64),
                          "dtype")):
        for fn in (conv3x3.conv3x3_taps, conv3x3.conv3x3_taps_v2):
            with pytest.raises(ValueError, match=match):
                fn(x, bad_w)
    x12 = torch.zeros(1, 8, 8, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3.conv3x3_taps(x12, torch.zeros(3, 3, 12, 16))
    h = torch.zeros(1, 8, 8, 16, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        conv3x3.conv3x3_taps(h, torch.zeros(3, 3, 16, 16,
                                            dtype=torch.float16))
    with pytest.raises(ValueError, match="s2"):
        conv3x3.conv3x3_taps_v2(x, torch.zeros(3, 3, 16, 16), s2=4)


def test_routes_put_bf16_on_wgmma_and_fp32_on_fmas():
    assert conv3x3.ROUTES == {
        name: {"float32": "fma", "bfloat16": "wgmma"}
        for name in ("conv3x3_taps", "conv3x3_taps_v2")}
    assert set(conv3x3.ROUTES) == set(conv3x3.LAUNCHES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_taps_follow_each_kernels_order_and_route(dtype):
    # tap j of P1 is w[j // 3, j % 3], of P2 w[j % 3, j // 3] (dx outer);
    # the fp32 kernel reads it as (C, Co), the bf16 one transposed (Co, C)
    _, w = _inputs(12, shape=(1, 4, 4, 16), co=24)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    for v2 in (False, True):
        taps = conv3x3.kernel_taps(tw, v2=v2)
        assert taps.is_contiguous() and taps.dtype == tw.dtype
        for j in range(9):
            dy, dx = (j % 3, j // 3) if v2 else (j // 3, j % 3)
            want = tw[dy, dx] if dtype == "float32" else tw[dy, dx].T
            assert torch.equal(taps[j], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co", [((1, 13, 16, 8), 8),
                                      ((3, 21, 65, 24), 16)])
def test_wrappers_take_channels_in_eights(shape, co, dtype):
    # C = 8 and 24 fill part of the wgmma route's 64-channel K step (and
    # half a k16 slice); the wrappers take them, as they did on FMAs
    x, w = _inputs(9 + shape[-1], shape=shape, co=co)
    want = _numpy_conv(x, w)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    for got in (conv3x3.conv3x3_taps(tx, tw),
                *(conv3x3.conv3x3_taps_v2(tx, tw, s2=s2)
                  for s2 in conv3x3.STRIPS)):
        assert got.shape == (*shape[:3], co) and got.dtype == tx.dtype
        assert _rel_err(got.float().numpy(), want) <= TOL[dtype]


def test_library_conv_matches_xla_conv(jax_probe):
    x, w = _inputs(5)
    (jx, tx), (jw, tw) = _both(x, "bfloat16"), _both(w, "bfloat16")
    want = np.asarray(jax_probe.conv_xla(jx, jw), np.float32)
    got = probe.conv_library(tx, tw)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 128, 128, 128)
    assert _rel_err(got.float().numpy(), want) <= 3e-2


def test_library_chain_matches_xla_chain(jax_probe):
    b = 2
    x, w1 = _inputs(6, shape=(b, 32, 32, 128))
    _, w2 = _inputs(7, shape=(1, 1, 1, 128))
    rng = np.random.default_rng(8)
    vecs = [rng.uniform(0.5, 1.5, 128), rng.standard_normal(128) * 0.1,
            rng.standard_normal(128) * 0.1, rng.uniform(0.8, 1.2, (b, 128)),
            rng.standard_normal((b, 128)) * 0.1,
            rng.standard_normal(128) * 0.1]
    g1, b1, cb1, sc, sh, cb2 = (v.astype(np.float32) for v in vecs)
    args = (x, g1, b1, w1, cb1, sc, sh, w2, cb2)
    want = np.asarray(jax_probe.chain_xla(*map(jnp.asarray, args)))
    got = probe.chain_library(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_stage_a_runs_on_the_cpu():
    before = dict(conv3x3.LAUNCHES)
    r = probe.stage_a(iters=1, batch=2, cpu=True)
    assert conv3x3.LAUNCHES == before
    assert r["device"].startswith("cpu") and r["batch"] == 2
    assert r["rel_err_v1"] < 3e-2
    assert set(r["rel_err_v2"]) == set(conv3x3.STRIPS)
    assert max(r["rel_err_v2"].values()) < 3e-2
    times = [r["library_s"], r["v1_s"], r["chain_s"], *r["v2_s"].values()]
    assert all(np.isfinite(t) and t > 0 for t in times)
    assert r["best_tap_s"] == min(r["v1_s"], *r["v2_s"].values())


def test_probe_raises_without_a_card_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--stage", "b"], ["--iters", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe.main(argv)
    with pytest.raises(SystemExit, match="PERF.md"):
        probe.main(["--stage", "b", "--cpu"])
    assert "device: cpu" in capsys.readouterr().out
