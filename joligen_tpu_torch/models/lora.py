"""LoRA finetuning in parameter space (``joligen_tpu/models/lora.py``): the
denoiser's modules stay as they are and the adapters change the weights
they are called with.

- ``lora_sites``: the Dense weights whose flax path has a target
  (``normalize_targets``: the last component of each name, ``w12`` read as
  ``w1`` and ``w2``) as an exact component, so ``proj`` hits the attention
  ``proj`` but not ``patch_proj`` or ``final_proj``. The blocks of an
  ``nn.scan`` stack (``blocks_pre.0`` ... in the port) make one site, as
  their stacked kernel is one leaf in the JAX package.
- ``LoRAAdapters``: for each site A (``lead + (d_in, r)``, drawn from
  N(0, 1/d_in)) and B (``lead + (r, d_out)``, zeros), ``lead`` the stack's
  depth or nothing, ``r = min(rank, d_in, d_out)``: the flax layout, so the
  merged weights start at the base ones.
- ``merge_deltas``: each site's (α/r)·A·B, with inverted dropout on whole
  input rows of A (``keep`` masks, fed or drawn from an explicit
  generator), transposed once to the torch layout (out, in) and added to
  the base weights; the product is summed over r in a fixed order, so the
  card and the CPU agree bit for bit.
- ``merged_weights``: a context in which the adapted modules compute with
  the merged weights (their parameters are shadowed, not replaced), for a
  forward and its backward, or a sampler.

The adapter tree is a checkpoint of its own (``{prefix}_net_G_lora.pth``),
keyed by flax path (``models/convert.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from .convert import flax_kernel_path, lora_from_flax, lora_to_flax
from .modules.unet_mha import Dense

DEFAULT_TARGETS = ("qkv", "proj", "w1", "w2", "w3", "kv", "q")


def normalize_targets(targets):
    """Torch module paths of the reference ('attn.qkv', 'mlp.w12') -> the
    component names matched here ('qkv', 'w1' and 'w2')."""
    out = []
    for t in targets:
        leaf = t.split(".")[-1]
        out += ["w1", "w2"] if leaf == "w12" else [leaf]
    return tuple(out)


def lora_sites(net, targets=DEFAULT_TARGETS):
    """{flax kernel path: [torch weight names, in stack order]}, sorted by
    path, for the Dense weights ``targets`` match."""
    targets = normalize_targets(targets)
    sites = {}
    for name, module in net.named_modules():
        if not isinstance(module, Dense):
            continue
        path, index = flax_kernel_path(name + ".weight")
        if any(t in path[:-1] for t in targets):
            sites.setdefault(path, {})[index] = name + ".weight"
    if not sites:
        raise ValueError(f"no Dense weight matched the LoRA targets "
                         f"{targets}")
    return {path: [names[i] for i in sorted(names, key=lambda i: i or 0)]
            for path, names in sorted(sites.items())}


class LoRAAdapters(nn.Module):
    """The A and B factors of every site (``a{i}``, ``b{i}``, the sites in
    path order), fp32."""

    def __init__(self, net, rank=8, targets=DEFAULT_TARGETS, generator=None):
        super().__init__()
        self.sites = lora_sites(net, targets)
        self.paths = list(self.sites)
        weights = dict(net.named_parameters())
        for i, (path, names) in enumerate(self.sites.items()):
            d_out, d_in = weights[names[0]].shape
            stacked = flax_kernel_path(names[0])[1] is not None
            lead = (len(names),) if stacked else ()
            r = min(rank, d_in, d_out)
            a = torch.randn(lead + (d_in, r), generator=generator) \
                * (1.0 / d_in ** 0.5)
            self.register_parameter(f"a{i}", nn.Parameter(a))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros(lead + (r, d_out))))

    def factors(self):
        """[(path, A, B)] in path order."""
        return [(p, getattr(self, f"a{i}"), getattr(self, f"b{i}"))
                for i, p in enumerate(self.paths)]

    def flax_tree(self):
        """The adapter tree as the JAX package saves it."""
        return lora_to_flax({p: (a, b) for p, a, b in self.factors()})

    def load_flax_tree(self, tree, strict=True):
        """Load an adapter tree (``flax_tree``'s layout); ``strict``: its
        paths must be this module's."""
        loaded = lora_from_flax(tree)
        if strict and set(loaded) != set(self.paths):
            raise KeyError(f"adapter paths {sorted(loaded)} != "
                           f"{self.paths}")
        with torch.no_grad():
            for p, a, b in self.factors():
                if p in loaded:
                    a.copy_(loaded[p][0])
                    b.copy_(loaded[p][1])

    def keep_masks(self, dropout, generator):
        """One inverted-dropout draw: per site a keep mask over the rows of
        A (``A.shape[:-1] + (1,)``), 1 with probability 1 - ``dropout``."""
        return [torch.rand(a.shape[:-1] + (1,), generator=generator,
                           device=a.device) >= dropout
                for _, a, _ in self.factors()]

    def count(self):
        return sum(p.numel() for p in self.parameters())


def _product(a, b):
    """a @ b over the last two axes, summed over r in order (a fixed
    rounding on every device)."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def merge_deltas(net, adapters, alpha=16.0, rank=8, dropout=0.0,
                 keep=None, generator=None):
    """{torch weight name: base weight + transposed delta} for every site.
    With ``dropout`` > 0 and ``keep`` (fed masks) or ``generator`` (drawn
    here), A's kept rows are scaled by 1 / (1 - dropout) and the others
    zeroed."""
    scale = alpha / max(1, rank)
    weights = dict(net.named_parameters())
    if dropout and dropout > 0.0 and keep is None and generator is not None:
        keep = adapters.keep_masks(dropout, generator)
    out = {}
    for i, (path, a, b) in enumerate(adapters.factors()):
        if dropout and dropout > 0.0 and keep is not None:
            a = a * keep[i].to(a.dtype) / (1.0 - dropout)
        delta = _product(a, b) * scale
        names = adapters.sites[path]
        deltas = delta.unbind(0) if delta.ndim == 3 else [delta]
        for name, dlt in zip(names, deltas):
            w = weights[name]
            out[name] = w + dlt.transpose(0, 1).to(w.dtype)
    return out


@contextlib.contextmanager
def merged_weights(net, merged):
    """``net``'s modules compute with ``merged`` ({weight name: tensor})
    inside the context: each tensor shadows its parameter as an instance
    attribute, so the state dict and the parameters are untouched."""
    shadowed = []
    try:
        for name, t in merged.items():
            module_name, leaf = name.rsplit(".", 1)
            module = net.get_submodule(module_name)
            module.__dict__[leaf] = t
            shadowed.append((module, leaf))
        yield net
    finally:
        for module, leaf in shadowed:
            del module.__dict__[leaf]


@torch.no_grad()
def merge_into(net, adapters, alpha=16.0, rank=8):
    """Fold the adapters into ``net``'s parameters in place."""
    params = dict(net.named_parameters())
    for name, w in merge_deltas(net, adapters, alpha, rank).items():
        params[name].copy_(w)
