"""Base model, the subset serving needs (``joligen_tpu/models/base.py``):
the device and the seeded generator, the host->device put with its uint8
wire step, and the ``{prefix}_net_{name}.pth`` / ``_ema.pth`` checkpoints in
flax's msgpack layout (no optimizer state).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from .. import compute_dtype, resolve_device
from ..utils import checkpoint_io
from .convert import flax_to_torch, torch_to_flax


def quantize_batch(batch, float_keys=(), int_keys=()):
    """Host-side wire compression (``parallel/mesh.py:113-130``): float32
    [-1,1] images -> uint8, int label masks -> uint8."""
    out = dict(batch)
    for k in float_keys:
        v = out.get(k)
        if v is not None and getattr(v, "dtype", None) == np.float32:
            out[k] = ((np.asarray(v) + 1.0) * 127.5).round().clip(
                0, 255).astype(np.uint8)
    for k in int_keys:
        v = out.get(k)
        if v is not None and np.issubdtype(getattr(v, "dtype", np.int64),
                                           np.integer):
            out[k] = np.asarray(v).clip(0, 255).astype(np.uint8)
    return out


def dequantize(x, kind="image"):
    """Inverse of ``quantize_batch`` on the device (``mesh.py:133-140``);
    no-op for non-uint8 input."""
    if x is None or x.dtype != torch.uint8:
        return x
    if kind == "image":
        return x.to(torch.float32) / 127.5 - 1.0
    return x.to(torch.int32)


class BaseModel:
    def __init__(self, opt, device=None, cpu=False):
        self.opt = opt
        self.device = resolve_device(cpu=cpu, device=device)
        self.device_dtype = compute_dtype(opt)
        self.seed = int(getattr(opt, "seed", 0) or 0)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.nets = {}       # name -> module holding the trained params
        self.ema_nets = {}   # name -> module holding the EMA params
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)

    def add_net(self, name, net, use_ema=False):
        net = net.to(self.device).eval().requires_grad_(False)
        self.nets[name] = net
        if use_ema:
            self.ema_nets[name] = copy.deepcopy(net)

    def put_batch(self, batch):
        """Host numpy batch -> device tensors (numpy entries only)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    # ---------------- checkpoint contract ----------------
    def _net_path(self, prefix, name, ema=False):
        suffix = "_ema" if ema else ""
        return os.path.join(self.save_dir, f"{prefix}_net_{name}{suffix}.pth")

    def save_networks(self, prefix):
        """``{prefix}_net_{name}.pth`` (+ ``_ema``) in flax's msgpack
        layout, loadable by the JAX package's ``load_networks``."""
        os.makedirs(self.save_dir, exist_ok=True)
        for name, net in self.nets.items():
            checkpoint_io.save(self._net_path(prefix, name),
                               torch_to_flax(net.state_dict()))
            if name in self.ema_nets:
                checkpoint_io.save(self._net_path(prefix, name, ema=True),
                                   torch_to_flax(self.ema_nets[name]
                                                 .state_dict()))

    def load_networks(self, prefix, strict=True):
        """Load params and, where the file exists, EMA params (as the JAX
        package: a missing EMA file leaves the EMA copy as it was)."""
        if getattr(self.opt, "model_load_no_strictness", False):
            strict = False
        for name, net in self.nets.items():
            path = self._net_path(prefix, name)
            if not os.path.exists(path):
                if strict and not getattr(self.opt, "train_finetune", False):
                    raise FileNotFoundError(path)
                continue
            net.load_state_dict(flax_to_torch(checkpoint_io.load(path)),
                                strict=strict)
            epath = self._net_path(prefix, name, ema=True)
            if name in self.ema_nets and os.path.exists(epath):
                self.ema_nets[name].load_state_dict(
                    flax_to_torch(checkpoint_io.load(epath)), strict=strict)

    def param_count(self):
        return {n: sum(p.numel() for p in net.parameters())
                for n, net in self.nets.items()}
