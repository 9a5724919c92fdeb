"""Projected-GAN discriminator (``joligen_tpu/models/modules/projected_d.py``):
a frozen EfficientNet-lite trunk (or, with ``network_type="segformer"``, a
frozen MiT-B0 backbone, ``segformer.py``), frozen random projections (CCM
1×1 per scale, CSM top-down mixing), and one trainable ``DownBlockPatch``
per scale, whose logits are concatenated.

Freezing is what the JAX package does: the trunk's and the projections'
*outputs* are detached (``stop_gradient`` at ``projected_d.py:156,213``),
so their parameters get a zero gradient, and no gradient reaches the
discriminator's input either. A generator therefore learns nothing from
this discriminator's logits; its loss still counts them.

Where the JAX package relies on flax or ``jax.image``, the port keeps its
rule: TF ``"SAME"`` padding (asymmetric at stride 2, ``Conv(padding=
"SAME")``), the nearest resize with half-pixel centres and the antialiased
bilinear resize (``ops/resize.py``), and flax ``GroupNorm`` (E[x²] − E[x]²,
eps 1e-6, fp32).

torch builds its layers with their sizes, so the discriminator is made for
one input size (``size``: ``interp`` when set, else the crop), which fixes
how many stride-2 steps each ``DownBlockPatch`` takes.

Pretrained trunk weights load from ``$JOLIGEN_TPU_WEIGHTS_DIR/
efficientnet_lite0.npz`` when that file exists (``load_efficientnet_trunk``);
otherwise the trunk keeps its seeded random init.

``TemporalProjectedDiscriminator`` (``D_netDs temporal``) judges clips: the
same frozen trunk and projections on every frame, an LSTM cell over the
frames at each location of each scale, the patch heads on its last state.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear, resize_nearest
from .resnet_generator import Conv
from .unet_mha import GroupNorm


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class MBConv(nn.Module):
    """Mobile inverted bottleneck, EfficientNet-lite flavour: no SE, relu6,
    TF SAME padding, BatchNorm folded into the conv biases."""

    def __init__(self, cin, out_ch, kernel=3, stride=1, expand=6,
                 dtype=torch.float32):
        super().__init__()
        mid = cin * expand
        if expand != 1:
            self.expand = Conv(cin, mid, 1, dtype=dtype)
        self.has_expand = expand != 1
        self.dw = Conv(mid, mid, kernel, stride, "SAME", groups=mid,
                       dtype=dtype)
        self.project = Conv(mid, out_ch, 1, dtype=dtype)
        self.residual = stride == 1 and cin == out_ch

    def forward(self, x):
        h = _relu6(self.expand(x)) if self.has_expand else x
        h = self.project(_relu6(self.dw(h)))
        return h + x if self.residual else h


# tf_efficientnet_lite stages: (out_ch, kernel, stride, repeats, expand)
_LITE0_STAGES = ((16, 3, 1, 1, 1), (24, 3, 2, 2, 6), (40, 5, 2, 2, 6),
                 (80, 3, 2, 3, 6), (112, 5, 1, 3, 6), (192, 5, 2, 4, 6),
                 (320, 3, 1, 1, 6))
_LITE3_STAGES = ((24, 3, 1, 1, 1), (32, 3, 2, 3, 6), (48, 5, 2, 3, 6),
                 (96, 3, 2, 5, 6), (136, 5, 1, 5, 6), (232, 5, 2, 6, 6),
                 (384, 3, 1, 1, 6))
# feature taps after these stages: strides 4, 8, 16, 32
_LITE_TAPS = (1, 2, 4, 6)


class EfficientNetLiteTrunk(nn.Module):
    """tf_efficientnet_lite topology; returns the NCHW features of strides
    4, 8, 16, 32."""

    def __init__(self, stages=_LITE0_STAGES, dtype=torch.float32):
        super().__init__()
        self.stem = Conv(3, 32, 3, 2, "SAME", dtype=dtype)
        self.order = []
        cin = 32
        for si, (out_ch, k, s, reps, e) in enumerate(stages):
            for ri in range(reps):
                name = f"b{si}_{ri}"
                self.add_module(name, MBConv(cin, out_ch, k,
                                             s if ri == 0 else 1, e,
                                             dtype=dtype))
                self.order.append((si, name))
                cin = out_ch
        self.stages = stages
        self.tap_channels = [stages[i][0] for i in _LITE_TAPS]

    def forward(self, x):
        h = _relu6(self.stem(x))
        feats = []
        for i, (si, name) in enumerate(self.order):
            h = getattr(self, name)(h)
            last = i + 1 == len(self.order) or self.order[i + 1][0] != si
            if last and si in _LITE_TAPS:
                feats.append(h)
        return feats


def load_efficientnet_trunk(trunk):
    """Copy ``$JOLIGEN_TPU_WEIGHTS_DIR/efficientnet_lite0.npz`` (keys
    ``stem.kernel``, ``b1_0.expand.bias``...: flax leaves) into ``trunk``
    when the variable is set and the file exists. Returns whether it did."""
    root = os.environ.get("JOLIGEN_TPU_WEIGHTS_DIR")
    path = os.path.join(root or "", "efficientnet_lite0.npz")
    if not root or not os.path.exists(path):
        return False
    from ..convert import flax_to_torch
    z = np.load(path)
    tree = {}
    for key in z.files:
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    trunk.load_state_dict(flax_to_torch(tree))
    return True


class FRandomProj(nn.Module):
    """Frozen random projections: CCM 1×1 per scale, then CSM top-down
    (nearest 2× up of the deeper map, a 3×3 conv, a sum), deepest first.
    Outputs detached."""

    def __init__(self, in_channels, out_ch=64, dtype=torch.float32):
        super().__init__()
        chans = [out_ch * 2 ** i for i in range(len(in_channels))]
        for i, (cin, c) in enumerate(zip(in_channels, chans)):
            self.add_module(f"ccm{i}", Conv(cin, c, 1, bias=False,
                                            dtype=dtype))
        for i in range(len(chans) - 1):
            self.add_module(f"csm{i}", Conv(chans[i + 1], chans[i], 3, 1, 1,
                                            bias=False, dtype=dtype))
        self.channels = chans

    def forward(self, feats):
        ccm = [getattr(self, f"ccm{i}")(f) for i, f in enumerate(feats)]
        out = [None] * len(ccm)
        prev = out[-1] = ccm[-1]
        for i in range(len(ccm) - 2, -1, -1):
            up = resize_nearest(prev, ccm[i].shape[2:])
            prev = ccm[i] + getattr(self, f"csm{i}")(up)
            out[i] = prev
        return [o.detach() for o in out]


class DownBlockPatch(nn.Module):
    """Per-scale patch head: stride-2 4×4 convs (no bias) with GroupNorm
    and LeakyReLU while the map is larger than 4 px (at most 4), then a 4×4
    conv to one logit map."""

    def __init__(self, cin, size, channels=64, dtype=torch.float32):
        super().__init__()
        ch, steps = channels, 0
        while size > 4 and steps < 4:
            self.add_module(f"down{steps}", Conv(cin, ch, 4, 2, 1, bias=False,
                                                 dtype=dtype))
            self.add_module(f"GroupNorm_{steps}",
                            GroupNorm(min(8, ch), ch, eps=1e-6))
            cin, ch = ch, min(ch * 2, 512)
            size = (size + 2 - 4) // 2 + 1
            steps += 1
        self.steps = steps
        self.out = Conv(cin, 1, 4, 1, 1, dtype=dtype)

    def forward(self, x):
        h = x
        for i in range(self.steps):
            h = getattr(self, f"down{i}")(h)
            h = getattr(self, f"GroupNorm_{i}")(h.float()).to(h.dtype)
            h = F.leaky_relu(h, 0.2)
        if min(h.shape[2:]) + 2 < 4:
            # the padded map is smaller than the kernel: no logits at this
            # scale, as XLA's empty convolution gives
            return h.new_zeros((h.shape[0], 1, 0, 0), dtype=self.out.dtype)
        return self.out(h)


def trunk_sizes(size, stages=_LITE0_STAGES):
    """Spatial sizes of the trunk's four taps for a ``size``² input."""
    s = -(-size // 2)
    out = []
    for si, (_, _, stride, _, _) in enumerate(stages):
        s = -(-s // stride)
        if si in _LITE_TAPS:
            out.append(s)
    return out


class ProjectedDiscriminator(nn.Module):
    """Frozen trunk + frozen projections + trainable patch heads.
    ``forward(x)``: NHWC in [-1, 1] -> (B, total patches) fp32 logits."""

    def __init__(self, size, interp=-1, proj_ch=64, trunk_stages=_LITE0_STAGES,
                 network_type="efficientnet", dtype=torch.float32):
        super().__init__()
        self.interp = interp
        self.mit = network_type == "segformer"
        size = interp if interp and interp > 0 else size
        if self.mit:
            from .segformer import MiTBackbone, mit_tap_sizes
            self.feature_network = MiTBackbone(dtype=dtype)
            sizes = mit_tap_sizes(size)
        else:
            self.feature_network = EfficientNetLiteTrunk(trunk_stages, dtype)
            sizes = trunk_sizes(size, trunk_stages)
        self.proj = FRandomProj(self.feature_network.tap_channels, proj_ch,
                                dtype)
        for i, (c, s) in enumerate(zip(self.proj.channels, sizes)):
            self.add_module(f"disc{i}", DownBlockPatch(c, s, proj_ch, dtype))
        self.n_scales = len(self.proj.channels)

    def frozen_parameters(self):
        """The trunk's and projections' parameters (zero gradient)."""
        return list(self.feature_network.parameters()) + list(
            self.proj.parameters())

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        if self.interp and self.interp > 0 and x.shape[2] != self.interp:
            x = resize_bilinear(x, (self.interp, self.interp))
        # the frozen part needs no graph: its outputs are detached
        with torch.no_grad():
            if self.mit:        # the MiT takes and gives NHWC
                feats = [f.permute(0, 3, 1, 2) for f in
                         self.feature_network(x.permute(0, 2, 3, 1))]
            else:
                feats = self.feature_network(x)
            feats = [f.detach() for f in feats]
            projs = self.proj(feats)
        logits = [getattr(self, f"disc{i}")(p) for i, p in enumerate(projs)]
        return torch.cat([li.reshape(li.shape[0], -1) for li in logits],
                         dim=1).float()


class TemporalProjectedDiscriminator(nn.Module):
    """The video D (``projected_d.py:223-283``): the frozen trunk and
    projections on every frame, an LSTM cell at each spatial location of
    each scale over the frames, the patch head on the last hidden state.
    ``forward(x)``: (B, F, H, W, C) clips in [-1, 1] -> (B, total patches)
    fp32 logits.

    The cell of scale i holds ``lstm_w{i}`` (2c, 4c), applied as
    ``[h, x] @ W``, and ``lstm_b{i}`` (4c); gate order [i, f, g, o], h and
    c from zeros, in the compute dtype. This is the JAX package's design,
    not the torch reference's ``MultiScaleLSTM``, which flattens each scale
    to (B, F, c·r·r) under a hidden size of 16 and holds only where c·r·r
    = 16. Only the LSTM cells and the patch heads train: the trunk's and
    projections' outputs are detached, as in ``ProjectedDiscriminator``."""

    def __init__(self, size, interp=-1, proj_ch=64, dtype=torch.float32):
        super().__init__()
        self.interp = interp
        self.mit = False
        size = interp if interp and interp > 0 else size
        self.feature_network = EfficientNetLiteTrunk(_LITE0_STAGES, dtype)
        self.proj = FRandomProj(self.feature_network.tap_channels, proj_ch,
                                dtype)
        sizes = trunk_sizes(size)
        for i, (c, s) in enumerate(zip(self.proj.channels, sizes)):
            self.register_parameter(f"lstm_w{i}", nn.Parameter(
                torch.zeros(2 * c, 4 * c)))
            self.register_parameter(f"lstm_b{i}", nn.Parameter(
                torch.zeros(4 * c)))
            self.add_module(f"disc{i}", DownBlockPatch(c, s, proj_ch, dtype))
        self.n_scales = len(self.proj.channels)

    def frozen_parameters(self):
        """The trunk's and projections' parameters (zero gradient)."""
        return list(self.feature_network.parameters()) + list(
            self.proj.parameters())

    def _lstm(self, i, seq):
        """(F, N, h, w, c) -> h after the last frame (N, h, w, c)."""
        w = getattr(self, f"lstm_w{i}").to(seq.dtype)
        b = getattr(self, f"lstm_b{i}").to(seq.dtype)
        h = c = torch.zeros_like(seq[0])
        for xt in seq:
            gates = torch.cat([h, xt], dim=-1) @ w + b
            ig, fg, gg, og = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(gg)
            h = torch.sigmoid(og) * torch.tanh(c)
        return h

    def forward(self, x):
        b, f = x.shape[:2]
        flat = x.reshape((b * f,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
        if flat.shape[1] == 1:
            flat = flat.repeat(1, 3, 1, 1)
        if self.interp and self.interp > 0 and flat.shape[2] != self.interp:
            flat = resize_bilinear(flat, (self.interp, self.interp))
        with torch.no_grad():
            feats = [ft.detach() for ft in self.feature_network(flat)]
            projs = self.proj(feats)
        logits = []
        for i, p in enumerate(projs):
            # (B*F, c, h, w) -> (F, B, h, w, c)
            seq = p.reshape((b, f) + tuple(p.shape[1:])).permute(1, 0, 3, 4,
                                                                  2)
            h_last = self._lstm(i, seq).permute(0, 3, 1, 2)
            li = getattr(self, f"disc{i}")(h_last)
            logits.append(li.reshape(b, -1))
        return torch.cat(logits, dim=1).float()
