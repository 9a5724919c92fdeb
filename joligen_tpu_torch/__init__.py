"""joliGEN-TPU ported to PyTorch and CUDA: palette DDPM/DDIM inpainting
served on an NVIDIA H100.

The JAX package ``joligen_tpu`` is the reference; this package imports none
of it (nor jax, flax or msgpack) and keeps its own copies of what it needs.

Device policy: entry points run on ``cuda``. The CPU is used only when the
caller asks for it (``--cpu`` on the scripts, ``device="cpu"`` in tests);
without a card and without that request they raise.

Dtype policy (``tpu_bf16``, as ``joligen_tpu/models/modules/unet_mha.py``):
conv and dense layers compute in bf16 over fp32 master parameters; GroupNorm
statistics are fp32 with compute-dtype output; attention takes bf16 inputs
and accumulates in fp32; the network output is cast to fp32; the samplers
run in fp32.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(cpu: bool = False, device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU. No silent fallback:
    without a card and without ``cpu=True`` (or an explicit ``device``)
    this raises."""
    if device is not None:
        return torch.device(device)
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "joligen_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass --cpu (or device='cpu') to run on the CPU explicitly")
    return torch.device("cuda")


def compute_dtype(opt) -> torch.dtype:
    """Conv/dense compute dtype from ``tpu_bf16`` (options/registry.py)."""
    return torch.bfloat16 if getattr(opt, "tpu_bf16", True) else torch.float32
