"""I3D (Inflated Inception-V1), the FVD clip detector
(``joligen_tpu/utils/i3d.py``): batchnorm folded into every conv, 400
logits of the spatio-temporally averaged features. (N, T, H, W, 3) in
[-1, 1] in.

Padding is TF's ``SAME``, as flax's: at stride s an axis of n pads
max((ceil(n / s) - 1) s + k - n, 0) in all, the smaller half before (the
7x7x7 stride-2 stem pads 2 before and 3 after an even axis); the convs pad
with zeros, the max pools with -inf. The flax tree names each conv unit
``<name>`` or ``<block>.<branch>`` (one key with a dot), which is the
port's state-dict key of the branch in its block's ``ModuleDict``:
``models/convert.py`` maps the tree as it is, and ``flax_tree`` joins the
block and branch names again on the way back.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# Inception branch widths: name -> (b0, b1a, b1b, b2a, b2b, b3b)
_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def same_pads(sizes, kernel, stride):
    """F.pad's list (last axis first, before/after) of TF ``SAME`` padding
    for the trailing axes ``sizes``."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


class Unit(nn.Conv3d):
    """A 3-D conv with ``SAME`` padding (bias: the folded batchnorm), then
    ReLU; NCDHW."""

    def __init__(self, cin, ch, kernel, stride=(1, 1, 1)):
        super().__init__(cin, ch, tuple(kernel), stride=tuple(stride))

    def forward(self, x):
        x = F.pad(x, same_pads(x.shape[2:], self.kernel_size, self.stride))
        return F.relu(super().forward(x))


def maxpool(x, kernel, stride):
    """A ``SAME`` max pool (the padding -inf); NCDHW."""
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class I3D(nn.Module):
    def __init__(self, num_classes=400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit(64, 64, (1, 1, 1))
        self.Conv3d_2c_3x3 = Unit(64, 192, (3, 3, 3))
        cin = 192
        for name, (b0, b1a, b1b, b2a, b2b, b3b) in _MIXED.items():
            self.add_module(name, nn.ModuleDict({
                "b0": Unit(cin, b0, (1, 1, 1)),
                "b1a": Unit(cin, b1a, (1, 1, 1)),
                "b1b": Unit(b1a, b1b, (3, 3, 3)),
                "b2a": Unit(cin, b2a, (1, 1, 1)),
                "b2b": Unit(b2a, b2b, (3, 3, 3)),
                "b3b": Unit(cin, b3b, (1, 1, 1))}))
            cin = b0 + b1b + b2b + b3b
        self.Logits = nn.Linear(cin, num_classes)

    def forward(self, x):
        """x: (N, T, H, W, 3) in [-1, 1] -> (N, num_classes) logits."""
        h = self.Conv3d_1a_7x7(x.permute(0, 4, 1, 2, 3))
        h = maxpool(h, (1, 3, 3), (1, 2, 2))
        h = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(h))
        h = maxpool(h, (1, 3, 3), (1, 2, 2))
        for name in _MIXED:
            if name == "Mixed_4b":
                h = maxpool(h, (3, 3, 3), (2, 2, 2))
            if name == "Mixed_5b":
                h = maxpool(h, (2, 2, 2), (2, 2, 2))
            u = getattr(self, name)
            h = torch.cat([u["b0"](h), u["b1b"](u["b1a"](h)),
                           u["b2b"](u["b2a"](h)),
                           u["b3b"](maxpool(h, (3, 3, 3), (1, 1, 1)))],
                          dim=1)
        return self.Logits(h.mean(dim=(2, 3, 4)))

    def flax_tree(self):
        """The JAX ``I3D``'s tree ``{"params": ...}`` (numpy) of these
        weights: ``<unit>`` and ``<block>.<branch>`` -> {kernel, bias}."""
        from ..models.convert import torch_to_flax
        out = {}
        for name, node in torch_to_flax(self.state_dict())["params"].items():
            if name in _MIXED:
                out.update({f"{name}.{b}": leaves
                            for b, leaves in node.items()})
            else:
                out[name] = node
        return {"params": out}


def load_i3d_params(npz_path):
    """The flax tree ``{"params": ...}`` (numpy) of an ``i3d_fvd.npz`` in
    the JAX package's contract: ``<unit>.kernel`` (t, h, w, in, out) and
    ``<unit>.bias`` for every conv unit, ``Logits.kernel`` (in, out) and
    ``Logits.bias``. ``models/convert.py`` maps it to the port's modules
    (a ``<block>.<branch>`` key is the branch of the block's
    ``ModuleDict``)."""
    z = np.load(npz_path)
    params = {}
    for k in z.files:
        name, leaf = k.rsplit(".", 1)
        params.setdefault(name, {})[leaf] = z[k]
    return {"params": params}
