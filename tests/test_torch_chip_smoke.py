"""The build gates of ``chip_smoke.py``, on ptxas log lines: a spill and a
``warpgroup.wait`` that ptxas injected (C7517) are each found in the
function they name, and clean lines find nothing. The smoke itself needs a
card; this file reads only its parsers."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLEAN = """\
ptxas info    : Compiling entry function '_Z20conv3x3_wgmma_kernelILi8ELb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z20conv3x3_wgmma_kernelILi8ELb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 99840 bytes smem
"""
INJECTED = """\
ptxas info    : (C7517) warpgroup.wait is injected in around line 20630 by compiler to allow use of registers defined by GMMA in function '_Z20conv3x3_wgmma_kernelILi16ELb1EEvv'
"""
SPILLED = """\
ptxas info    : Compiling entry function '_Z19flash_bwd_dq_kernelILi32EfEvv' for 'sm_90a'
ptxas info    : Function properties for _Z19flash_bwd_dq_kernelILi32EfEvv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
"""


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("log,waits,spills", [
    (CLEAN, [], []),
    (CLEAN + INJECTED, ["_Z20conv3x3_wgmma_kernelILi16ELb1EEvv"], []),
    (CLEAN + SPILLED, [], ["_Z19flash_bwd_dq_kernelILi32EfEvv"])])
def test_build_gates_find_what_ptxas_reports(smoke, log, waits, spills):
    assert sorted(smoke.ptxas_injected_waits(log)) == waits
    assert sorted(smoke.ptxas_spills(log)) == spills
