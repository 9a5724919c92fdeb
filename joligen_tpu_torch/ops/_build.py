"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` into a shared library under ``build/joligen_tpu_torch/`` at
the repository root (listed in ``.gitignore``), then loaded with ``ctypes``;
``launch`` calls an entry point on PyTorch's current stream.
The library's file name carries a hash of its source, the shared headers and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "joligen_tpu_torch")
# --split-compile=0: nvcc's device-code optimizer runs on every core. The
# attention backward's 45 kernels (five head dims, two routes, two tilings)
# made its build the smoke's longest; this cuts it to about a third.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0"]

_LOADED: dict = {}
_FUNCTIONS: dict = {}


def _nvcc():
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def library_path(name):
    """The library of ``csrc/<name>.cu``; its name hashes that source, every
    ``csrc/*.cuh`` header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names):
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: (seconds, ptxas log)}``
    for the kernels compiled by this call; raises if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, out, tmp, time.perf_counter())
    done, failed = {}, []
    for name, (proc, out, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load_library(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built if needed
    (once per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    return lib


def launch(name, symbol, argtypes, device, *args):
    """Call the entry point ``symbol`` of ``csrc/<name>.cu`` (built and
    loaded on first use; ``argtypes`` its ctypes signature, the stream last)
    with ``args`` and the current stream of ``device``. Every entry point
    returns its launch's ``cudaError_t``; raise if that is not 0."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FUNCTIONS[(name, symbol)] = fn
    # the raw current stream, as torch's own kernel launchers read it; the
    # device switch only where the tensors are not on the current device
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        estr = load_library(name).jg_cuda_error_string
        estr.restype = ctypes.c_char_p
        estr.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{symbol} kernel launch failed: "
                           f"{estr(err).decode()} ({err})")
