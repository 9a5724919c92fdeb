"""Base model (``joligen_tpu/models/base.py``): the mesh options checked
against the one device, the device and the seeded generator, the host->device put with its uint8 wire step, the networks of
phase ``test`` (frozen) or ``train`` (each with a ``NetState``: optimizer,
EMA, step), the losses, and the checkpoints: ``{prefix}_net_{name}.pth`` /
``_ema.pth`` in flax's msgpack layout, and ``{prefix}_optim.pkl``, a pickle
of plain dicts of ints and numpy arrays written and read by the port.
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch

from .. import compute_dtype, resolve_device
from ..utils import checkpoint_io
from .convert import flax_to_torch, torch_to_flax
from .train_state import NetState, make_optimizer


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


def check_mesh(opt):
    """The ``tpu_mesh_*`` options against the port's one device, as the JAX
    ``make_mesh`` asserts them against its devices (``parallel/mesh.py:
    30-44``): data (-1: the devices left) x fsdp x tensor x seq must be 1.
    Any axis above 1 raises."""
    fsdp = getattr(opt, "tpu_mesh_fsdp", 1)
    tensor = getattr(opt, "tpu_mesh_tensor", 1)
    seq = getattr(opt, "tpu_mesh_seq", 1)
    data = getattr(opt, "tpu_mesh_data", -1)
    if data == -1:
        data = 1 // (fsdp * tensor * seq)
    if data * fsdp * tensor * seq != 1:
        raise NotImplementedError(
            f"mesh {data}x{fsdp}x{tensor}x{seq} (tpu_mesh_data, _fsdp, "
            "_tensor, _seq) != 1 device: the port runs on one card; "
            "sharding over several is not ported (ROADMAP Queue 1 item 15, "
            "multi-GPU)")


class _PlainUnpickler(pickle.Unpickler):
    """Reads the port's ``_optim.pkl`` (dicts, ints, numpy arrays) and
    refuses any other class: the JAX package's file holds optax state
    classes, which the port cannot read."""

    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise NotImplementedError(
            f"optimizer state file holds {module}.{name}: reading the JAX "
            "package's optax _optim.pkl is not ported (ROADMAP Queue 1 item "
            "6, training state, the rest); resume without it (load_optim=False, as "
            "--train_continue_from does)")


class BaseModel:
    def __init__(self, opt, phase="test", device=None, cpu=False):
        check_mesh(opt)
        self.opt = opt
        self.phase = phase
        self.is_train = phase == "train"
        self.device = resolve_device(cpu=cpu, device=device)
        self.device_dtype = compute_dtype(opt)
        self.seed = int(getattr(opt, "seed", 0) or 0)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.nets = {}       # name -> module holding the trained params
        self.ema_nets = {}   # name -> module holding the EMA params
        self.states = {}     # name -> NetState (phase train)
        self.loss_log = {}
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        if self.is_train:
            os.makedirs(self.save_dir, exist_ok=True)

    def add_net(self, name, net, use_ema=False, lr=None):
        """Put ``net`` on the device; with ``use_ema`` keep a frozen EMA
        copy. Phase ``train`` trains it with the configured optimizer at
        learning rate ``lr``; phase ``test`` freezes it."""
        net = net.to(self.device).requires_grad_(self.is_train)
        self.nets[name] = net
        if use_ema:
            self.ema_nets[name] = copy.deepcopy(net).requires_grad_(False)
        if self.is_train:
            tx = make_optimizer(self.opt, lr, dict(net.named_parameters()))
            self.states[name] = NetState(net, self.ema_nets.get(name), tx)

    def put_batch(self, batch):
        """Host numpy batch -> device tensors (numpy entries only)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    # ---------------- training ----------------
    def optimize_parameters(self, batch):
        """One training step over all networks. Returns the loss dict."""
        raise NotImplementedError

    def get_current_losses(self):
        return dict(self.loss_log)

    def update_learning_rate(self):
        # LR schedules are step-driven (train_state.make_lr_schedule);
        # nothing to do per epoch
        pass

    # ---------------- checkpoint contract ----------------
    def _net_path(self, prefix, name, ema=False):
        suffix = "_ema" if ema else ""
        return os.path.join(self.save_dir, f"{prefix}_net_{name}{suffix}.pth")

    def _optim_path(self, prefix):
        return os.path.join(self.save_dir, f"{prefix}_optim.pkl")

    def save_networks(self, prefix):
        """``{prefix}_net_{name}.pth`` (+ ``_ema``) in flax's msgpack
        layout, loadable by the JAX package's ``load_networks``; in phase
        train also ``{prefix}_optim.pkl`` with each optimizer's state."""
        os.makedirs(self.save_dir, exist_ok=True)
        for name, net in self.nets.items():
            wl = getattr(net, "flax_weight_leaves", False)
            checkpoint_io.save(self._net_path(prefix, name),
                               torch_to_flax(net.state_dict(), wl))
            if name in self.ema_nets:
                checkpoint_io.save(self._net_path(prefix, name, ema=True),
                                   torch_to_flax(self.ema_nets[name]
                                                 .state_dict(), wl))
        if self.states:
            with open(self._optim_path(prefix), "wb") as f:
                pickle.dump({n: s.tx.state_dict()
                             for n, s in self.states.items()}, f)

    def load_networks(self, prefix, load_optim=True, strict=True):
        """Load params and, where the file exists, EMA params (as the JAX
        package: a missing EMA file leaves the EMA copy as it was), and in
        phase train the optimizer state of ``{prefix}_optim.pkl`` when
        ``load_optim`` and the file exists."""
        if getattr(self.opt, "model_load_no_strictness", False):
            strict = False
        for name, net in self.nets.items():
            path = self._net_path(prefix, name)
            if not os.path.exists(path):
                if strict and not getattr(self.opt, "train_finetune", False):
                    raise FileNotFoundError(path)
                continue
            wl = getattr(net, "flax_weight_leaves", False)
            net.load_state_dict(flax_to_torch(checkpoint_io.load(path), wl),
                                strict=strict)
            epath = self._net_path(prefix, name, ema=True)
            if name in self.ema_nets and os.path.exists(epath):
                self.ema_nets[name].load_state_dict(
                    flax_to_torch(checkpoint_io.load(epath), wl),
                    strict=strict)
        opt_path = self._optim_path(prefix)
        if self.states and load_optim and os.path.exists(opt_path):
            with open(opt_path, "rb") as f:
                saved = _PlainUnpickler(f).load()
            for name, state in saved.items():
                if name in self.states:
                    self.states[name].tx.load_state_dict(state)

    def param_count(self):
        return {n: sum(p.numel() for p in net.parameters())
                for n, net in self.nets.items()}
