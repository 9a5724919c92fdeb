"""Base model (``joligen_tpu/models/base.py``): the mesh options checked
against the one device, the device and the seeded generator, the host->device put with its uint8 wire step, the networks of
phase ``test`` (frozen) or ``train`` (each with a ``NetState``: optimizer,
EMA, step), the losses, and the checkpoints: ``{prefix}_net_{name}.pth`` /
``_ema.pth`` in flax's msgpack layout (a net with its own tree, as the LoRA
adapters, gives it by ``flax_tree`` / ``load_flax_tree``), and
``{prefix}_optim.pkl``, a pickle of plain dicts of ints and numpy arrays
written and read by the port; the perceptual training terms
(``perceptual_terms``: LPIPS and DISTS over the frozen VGG16 trunk) and the
train-time metrics (``init_metrics``, ``compute_metrics_test``) of every
model.
"""

from __future__ import annotations

import collections
import copy
import os
import pickle

import numpy as np
import torch

from .. import compute_dtype, resolve_device
from ..utils import checkpoint_io
from .convert import flax_to_torch, optax_state_to_torch, torch_to_flax
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


# the optax state classes of the JAX package's ``_optim.pkl`` (optax 0.2.6),
# read as named tuples of the same fields
_OPTAX_STATES = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByLionState": ("count", "mu"),
    "MuonState": ("count", "mu", "ns_coeffs"),
    "ScaleByScheduleState": ("count",),
    "EmptyState": (),
    "MaskedNode": (),
    "MaskedState": ("inner_state",),
    "PartitionState": ("inner_states",),
    "MultiStepsState": ("mini_step", "gradient_step", "inner_opt_state",
                        "acc_grads", "skip_state"),
}
_OPTAX_CLASSES = {name: collections.namedtuple(name, fields)
                  for name, fields in _OPTAX_STATES.items()}


class _BF16Array(np.ndarray):
    """An array as numpy unpickles it; ``bf16`` marks the raw 16-bit words
    of an ``ml_dtypes.bfloat16`` array."""

    bf16 = False

    def __setstate__(self, state):
        dtype = state[2]
        marked = getattr(dtype, "names", None) == ("bfloat16",)
        if marked:
            state = state[:2] + (np.dtype("<u2"),) + state[3:]
        super().__setstate__(state)
        self.bf16 = marked


def _reconstruct(cls, shape, dtype):
    return np.ndarray.__new__(_BF16Array, shape, dtype)


def _bf16_dtype(obj, *args):
    """``numpy.dtype``; for the bfloat16 stand-in a fresh marked 2-byte
    dtype (its pickled state is then applied to that copy alone)."""
    if obj is _BFloat16:
        return np.dtype([("bfloat16", "<u2")])
    return np.dtype(obj, *args)


class _BFloat16:
    """Stand-in for ``ml_dtypes.bfloat16``."""


def _plain(obj):
    """Unpickled state -> numpy arrays (a bf16 one widened to fp32 bit for
    bit), named tuples, dicts, lists and scalars."""
    if isinstance(obj, _BF16Array):
        a = np.asarray(obj).view(np.ndarray)
        if obj.bf16:
            return (a.astype(np.uint32) << 16).view(np.float32)
        return np.array(a)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_plain(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


class _PlainUnpickler(pickle.Unpickler):
    """Reads an ``_optim.pkl``: the port's (dicts, ints, numpy arrays) or
    the JAX package's (optax's state classes, ``_OPTAX_STATES``, read as
    named tuples; ``ml_dtypes.bfloat16`` arrays widened to fp32), without
    importing optax or ml_dtypes. Any other class is refused."""

    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return _BFloat16
        if (module.startswith("numpy") and name == "_reconstruct"):
            return _reconstruct
        if module == "numpy" and name == "dtype":
            return _bf16_dtype
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module.startswith("optax.") and name in _OPTAX_CLASSES:
            return _OPTAX_CLASSES[name]
        raise pickle.UnpicklingError(
            f"optimizer state file holds {module}.{name}, which is neither "
            "the port's state nor an optax state of the JAX package")

    def load(self):
        return _plain(super().load())


def _port_state(state):
    """Whether an unpickled optimizer state is the port's (a dict keyed by
    the port's fields) rather than optax's (named tuples, or the JAX
    madgrad's dict with ``k``)."""
    return isinstance(state, dict) and "k" not in state


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
            tx = make_optimizer(self.opt, lr, dict(net.named_parameters()),
                                as_flax=hasattr(net, "flax_tree"))
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

    def perceptual_terms(self, pred, target, kinds, mean=None, std=None):
        """The LPIPS and DISTS distances of ``pred`` to ``target`` (NHWC or
        (B, F, H, W, C) clips, frames folded into the batch; 1 channel
        tiled to 3) over the frozen VGG16 trunk of ``utils/metrics.py``,
        built on first use (``mean``/``std``: the weights file's input
        normalisation). Returns {"lpips", "dists"} as ``kinds`` names them,
        each the batch mean, with a graph to ``pred`` only."""
        from ..utils.metrics import (dists_from_feats, lpips_from_feats,
                                     vgg_feature_fn)
        a, b = target, pred
        if a.ndim == 5:
            a = a.reshape((-1,) + tuple(a.shape[2:]))
            b = b.reshape((-1,) + tuple(b.shape[2:]))
        if a.shape[-1] == 1:
            a = a.repeat(1, 1, 1, 3)
            b = b.repeat(1, 1, 1, 3)
        if getattr(self, "_perc_feats", None) is None:
            self._perc_feats = vgg_feature_fn(tuple(a.shape[1:]), mean=mean,
                                              std=std, device=self.device)
        with torch.no_grad():
            fa = self._perc_feats(a)
        fb = self._perc_feats(b)
        out = {}
        if "LPIPS" in kinds:
            out["lpips"] = torch.mean(lpips_from_feats(fa, fb))
        if "DISTS" in kinds:
            out["dists"] = torch.mean(dists_from_feats(fa, fb))
        return out

    # ---------------- metrics ----------------
    def init_metrics(self, dataloader_real=None):
        """The FID extractor on the model's device, and the activation
        statistics of the real images (``B``) of ``dataloader_real``, at
        most ``train_nb_img_max_fid`` of them, clips' frames folded."""
        from ..utils.metrics import InceptionV3Features, _cov_mean
        self.metric_extractor = InceptionV3Features(device=self.device)
        self.real_stats = None
        if dataloader_real is None:
            return
        reals = []
        nmax = int(getattr(self.opt, "train_nb_img_max_fid", 10 ** 9))
        for batch in dataloader_real:
            reals.append(np.asarray(batch["B"], np.float32))
            if sum(r.shape[0] for r in reals) >= nmax:
                break
        if reals:
            reals = np.concatenate(reals)[:nmax]
            if reals.ndim == 5:
                reals = reals.reshape((-1,) + reals.shape[2:])
            acts = self.metric_extractor(reals)
            mu, sigma = _cov_mean(acts)
            self.real_stats = (mu, sigma, acts)

    def compute_metrics_test(self, dataloader_test, n_epoch="latest",
                             n_iter=0, save_images=None, test_name="",
                             **infer_kwargs):
        """``inference`` over ``dataloader_test`` (at most
        ``train_nb_img_max_fid`` images; clips' frames folded, the clips
        kept for FVD) and ``train_metrics_list`` over the fakes against the
        ``B`` images, as the JAX method: ``B_label_mask`` restricts PSNR
        under ``alg_<model_type>_metric_mask``; ``save_images`` (default
        ``train_metrics_save_images``) writes the first 8 pairs under
        ``metrics_imgs_<test_name or test>``. Keys end in ``_test``."""
        from ..utils.metrics import (VideoFeatures, compute_metrics, fvd,
                                     metric_key)
        if save_images is None:
            save_images = bool(getattr(self.opt, "train_metrics_save_images",
                                       False))
        metrics_list = list(getattr(self.opt, "train_metrics_list", ["FID"])
                            or ["FID"])
        nmax = int(getattr(self.opt, "train_nb_img_max_fid", 10 ** 9))
        fakes, reals, masks = [], [], []
        fake_clips, real_clips = [], []
        for batch in dataloader_test:
            fake = self.inference(batch, **infer_kwargs)
            real = np.asarray(batch["B"], np.float32)
            if fake.ndim == 5:
                fake_clips.append(fake)
                real_clips.append(real)
                fake = fake.reshape((-1,) + fake.shape[2:])
                real = real.reshape((-1,) + real.shape[2:])
            base = sum(f.shape[0] for f in fakes)
            if save_images and base < 8:
                self._save_metric_images(fake, real, base, n_epoch,
                                         test_name)
            fakes.append(fake)
            reals.append(real)
            m = batch.get("B_label_mask")
            if m is not None:
                m = np.asarray(m, np.float32)
                if m.ndim == 5:
                    m = m.reshape((-1,) + m.shape[2:])
                masks.append(m)
            if sum(f.shape[0] for f in fakes) >= nmax:
                break
        if not fakes:
            return {}
        fakes = np.concatenate(fakes)[:nmax]
        reals = np.concatenate(reals)[:nmax]
        mask = np.concatenate(masks)[:nmax] if masks else None
        use_mask = bool(getattr(self.opt,
                                f"alg_{self.opt.model_type}_metric_mask",
                                False))
        out = compute_metrics(
            fakes, reals, [m for m in metrics_list if m != "FVD"],
            extractor=getattr(self, "metric_extractor", None),
            real_stats=getattr(self, "real_stats", None),
            mask=mask if use_mask else None, device=self.device)
        if "FVD" in metrics_list and fake_clips:
            vf = VideoFeatures(device=self.device)
            out[metric_key("FVD", vf.is_fallback)] = fvd(
                np.concatenate(real_clips), np.concatenate(fake_clips),
                extractor=vf)
        return {f"{k}_test": v for k, v in out.items()}

    def _save_metric_images(self, fake, real, base, n_epoch, test_name):
        """PNGs of the pairs ``base`` onwards, up to 8 in all."""
        from PIL import Image

        from ..utils.visualizer import tensor2im
        d = os.path.join(self.save_dir, f"metrics_imgs_{test_name or 'test'}")
        os.makedirs(d, exist_ok=True)
        for j in range(min(fake.shape[0], 8 - base)):
            Image.fromarray(tensor2im(fake[j])).save(
                os.path.join(d, f"{n_epoch}_{base + j}_fake.png"))
            Image.fromarray(tensor2im(real[j])).save(
                os.path.join(d, f"{n_epoch}_{base + j}_real.png"))

    def inference(self, batch, **kwargs):
        raise NotImplementedError

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
            if hasattr(net, "flax_tree"):
                checkpoint_io.save(self._net_path(prefix, name),
                                   net.flax_tree())
                continue
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
            if hasattr(net, "load_flax_tree"):
                net.load_flax_tree(checkpoint_io.load(path), strict=strict)
                continue
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
                if name not in self.states:
                    continue
                if not _port_state(state):    # the JAX package's optax state
                    net = self.nets[name]
                    if hasattr(net, "flax_tree"):
                        raise NotImplementedError(
                            f"{name}: reading an optax state of an adapter "
                            "tree is not ported")
                    state = optax_state_to_torch(
                        state, getattr(net, "flax_weight_leaves", False))
                self.states[name].tx.load_state_dict(state)

    def param_count(self):
        return {n: sum(p.numel() for p in net.parameters())
                for n, net in self.nets.items()}
