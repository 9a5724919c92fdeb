"""Segformer (``joligen_tpu/models/modules/segformer.py``): the MiT backbone,
the all-MLP decode head, the f_s segmenter and the attention-decoder
generator ``segformer_attn_conv``.

Modules and attributes carry the flax names (``embed0/proj``, ``s0b1/attn/
sr``, ``s2b0/ffn/dw``, ``norm3``, ``neck/proj2``, ``content_out``...), so
the converter maps every leaf. NHWC at every boundary, as in the JAX
package; the convs run NCHW inside.

Numerics kept from flax and JAX:

- LayerNorm: eps 1e-6, fp32 statistics with the variance E[x²] − E[x]²
  (``utils/vit_layers.LayerNorm``), cast back to the compute dtype;
- the spatial-reduction conv ``sr`` (kernel = stride = sr ratio) pads by
  flax's default ``"SAME"`` rule, which pads a side whose size is not a
  multiple of the stride, more at the bottom and right;
- the attention is ``jax.nn.dot_product_attention``'s: fp32 logits (q and
  k upcast before the product), scaled by 1/√hd, an fp32 softmax, the
  probabilities cast to k's dtype before P·V. Plain torch ops: the JAX
  package runs no kernel here;
- the MixFFN takes the exact GELU, the decode head and the generator's neck
  flax's default, the tanh approximation;
- the bilinear resizes are ``jax.image.resize``'s (``ops/resize.py``);
- the generator's ×4 pixel shuffle keeps the NHWC channel order
  [dy][dx][c], which is not ``F.pixel_shuffle``'s [c][dy][dx].

``load_mit_backbone`` copies ``$JOLIGEN_TPU_WEIGHTS_DIR/segformer_mit_b0.npz``
(flax leaf paths joined by ``/``) into a backbone when the file exists; the
nets otherwise keep their seeded init.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from ...utils.vit_layers import LayerNorm
from .resnet_generator import Conv
from .unet_mha import Dense

B0_WIDTHS = (32, 64, 160, 256)
B0_DEPTHS = (2, 2, 2, 2)
B0_SR_RATIOS = (8, 4, 2, 1)
LN_EPS = 1e-6


def _conv_nhwc(conv, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _ln(norm, x, dtype):
    """A flax ``LayerNorm(dtype=float32)`` then ``.astype(dtype)``."""
    return norm(x.float()).to(dtype)


def mit_heads(width):
    """The B0 head rule (``segformer.py:118-121``): width // 32 heads,
    lowered until it divides the width."""
    heads = max(1, width // 32)
    while width % heads:
        heads -= 1
    return heads


def mit_tap_sizes(size):
    """Spatial sizes of the backbone's stage features for a ``size``²
    input: a 7×7 stride-4 embedding, then 3×3 stride-2 ones, each padded
    by half its kernel."""
    out, s = [], size
    for si in range(4):
        patch, stride = (7, 4) if si == 0 else (3, 2)
        s = (s + 2 * (patch // 2) - patch) // stride + 1
        out.append(s)
    return out


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin, features, patch=7, stride=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = Conv(cin, features, patch, stride, patch // 2,
                         dtype=dtype)
        self.norm = LayerNorm(features, LN_EPS)

    def forward(self, x):
        return _ln(self.norm, _conv_nhwc(self.proj, x), self.dtype)


class EfficientAttention(nn.Module):
    """Self-attention with spatial reduction of K and V (MiT)."""

    def __init__(self, channels, num_heads, sr_ratio=1, dtype=torch.float32):
        super().__init__()
        self.heads, self.sr_ratio, self.dtype = num_heads, sr_ratio, dtype
        c = channels
        self.q = Dense(c, c, dtype=dtype)
        if sr_ratio > 1:
            self.sr = Conv(c, c, sr_ratio, sr_ratio, "SAME", dtype=dtype)
            self.sr_norm = LayerNorm(c, LN_EPS)
        self.kv = Dense(c, 2 * c, dtype=dtype)
        self.proj = Dense(c, c, dtype=dtype)

    def forward(self, x):
        n, h, w, c = x.shape
        heads, hd = self.heads, c // self.heads
        q = self.q(x).reshape(n, h * w, heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = _ln(self.sr_norm, _conv_nhwc(self.sr, x), self.dtype)
        kv = self.kv(kv_in).reshape(n, -1, 2 * c)
        k, v = (t.reshape(n, -1, heads, hd).transpose(1, 2)
                for t in torch.split(kv, c, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = F.softmax(logits * (1.0 / math.sqrt(hd)), dim=-1).to(k.dtype)
        a = torch.matmul(probs, v).transpose(1, 2).reshape(n, h, w, c)
        return self.proj(a)


class MixFFN(nn.Module):
    """fc1, a 3×3 depthwise conv, the exact GELU, fc2."""

    def __init__(self, channels, expand=4, dtype=torch.float32):
        super().__init__()
        hidden = channels * expand
        self.fc1 = Dense(channels, hidden, dtype=dtype)
        self.dw = Conv(hidden, hidden, 3, 1, 1, groups=hidden, dtype=dtype)
        self.fc2 = Dense(hidden, channels, dtype=dtype)

    def forward(self, x):
        h = _conv_nhwc(self.dw, self.fc1(x))
        return self.fc2(F.gelu(h, approximate="none"))


class MiTBlock(nn.Module):
    """Pre-LN residual attention and MixFFN."""

    def __init__(self, channels, num_heads, sr_ratio, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(channels, LN_EPS)
        self.attn = EfficientAttention(channels, num_heads, sr_ratio, dtype)
        self.ln2 = LayerNorm(channels, LN_EPS)
        self.ffn = MixFFN(channels, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(_ln(self.ln1, x, self.dtype))
        return x + self.ffn(_ln(self.ln2, x, self.dtype))


class MiTBackbone(nn.Module):
    """Four stages; ``forward`` returns the NHWC stage features at 1/4,
    1/8, 1/16 and 1/32 (rounded up)."""

    def __init__(self, in_channels=3, widths=B0_WIDTHS, depths=B0_DEPTHS,
                 sr_ratios=B0_SR_RATIOS, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        self.tap_channels = list(widths)
        cin = in_channels
        for si in range(4):
            patch, stride = (7, 4) if si == 0 else (3, 2)
            nh = mit_heads(widths[si])
            self.add_module(f"embed{si}", OverlapPatchEmbed(
                cin, widths[si], patch, stride, dtype))
            for bi in range(depths[si]):
                self.add_module(f"s{si}b{bi}", MiTBlock(
                    widths[si], nh, sr_ratios[si], dtype))
            self.add_module(f"norm{si}", LayerNorm(widths[si], LN_EPS))
            cin = widths[si]

    def forward(self, x):
        feats, h = [], x
        for si in range(4):
            h = getattr(self, f"embed{si}")(h)
            for bi in range(self.depths[si]):
                h = getattr(self, f"s{si}b{bi}")(h)
            h = _ln(getattr(self, f"norm{si}"), h, self.dtype)
            feats.append(h)
        return feats


class SegformerHead(nn.Module):
    """All-MLP decode head: a Dense per stage, bilinear up to the first
    stage's grid, concatenated deepest first, ``fuse``, the tanh GELU,
    ``cls``. NHWC logits at 1/4 in the compute dtype."""

    def __init__(self, in_channels, num_classes, embed_dim=256,
                 dtype=torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"proj{i}", Dense(c, embed_dim, dtype=dtype))
        self.fuse = Dense(embed_dim * len(in_channels), embed_dim,
                          dtype=dtype)
        self.cls = Dense(embed_dim, num_classes, dtype=dtype)

    def forward(self, feats):
        th, tw = feats[0].shape[1], feats[0].shape[2]
        ups = []
        for i, f in enumerate(feats):
            p = getattr(self, f"proj{i}")(f)
            if p.shape[1] != th:
                p = resize_bilinear(p.permute(0, 3, 1, 2),
                                    (th, tw)).permute(0, 2, 3, 1)
            ups.append(p)
        h = self.fuse(torch.cat(ups[::-1], dim=-1))
        return self.cls(F.gelu(h, approximate="tanh"))


class SegformerSegmenter(nn.Module):
    """f_s ``segformer``: (B, H, W, C) -> (B, H, W, num_classes) fp32
    logits, the head's 1/4 logits resized bilinearly to H × W."""

    def __init__(self, in_channels=3, num_classes=2, widths=B0_WIDTHS,
                 depths=B0_DEPTHS, dtype=torch.float32):
        super().__init__()
        self.backbone = MiTBackbone(in_channels, widths, depths, dtype=dtype)
        self.head = SegformerHead(widths, num_classes, dtype=dtype)

    def forward(self, x):
        logits = self.head(self.backbone(x)).float()
        return resize_bilinear(logits.permute(0, 3, 1, 2),
                               x.shape[1:3]).permute(0, 2, 3, 1)


def _unshuffle4(t, n, h4, w4):
    """(n, h4, w4, 16·C) with channels [dy][dx][c] -> (n, 4·h4, 4·w4, C)."""
    c = t.shape[-1] // 16
    t = t.reshape(n, h4, w4, 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(n, 4 * h4, 4 * w4, c)


class SegformerGeneratorAttn(nn.Module):
    """``segformer_attn_conv``: the MiT encoder, a width-256 neck (a decode
    head) and the tanh GELU, then Dense layers to ×4 pixel-shuffled content
    images and softmax masks, blended as resnet_attn blends them: content
    × mask for the first ``nb_mask_attn − nb_mask_input`` masks, the input
    × mask for the rest. fp32 NHWC out. ``G_ngf`` and ``G_nblocks`` are not
    read, as in the JAX package."""

    def __init__(self, in_channels=3, out_channels=3, nb_mask_attn=10,
                 nb_mask_input=1, widths=B0_WIDTHS, depths=B0_DEPTHS,
                 dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.nb_mask_attn, self.nb_mask_input = nb_mask_attn, nb_mask_input
        n_content = nb_mask_attn - nb_mask_input
        self.backbone = MiTBackbone(in_channels, widths, depths, dtype=dtype)
        self.neck = SegformerHead(widths, 256, dtype=dtype)
        self.content_out = Dense(256, out_channels * n_content * 16,
                                 dtype=dtype)
        self.attn_out = Dense(256, nb_mask_attn * 16, dtype=dtype)

    def layer_channels(self, layer_ids):
        """The channels of the NCE taps ``layer_ids`` (the stages)."""
        return [self.backbone.tap_channels[i] for i in layer_ids]

    def forward(self, x, extract_layer_ids=None, with_features=None):
        """NHWC in. Returns the NHWC output; with ``extract_layer_ids``
        only the stage features (as JAX), and with ``with_features`` (stage
        ids) the pair (output, features) of one backbone pass."""
        feats = self.backbone(x)
        if extract_layer_ids is not None:
            return [feats[i] for i in extract_layer_ids]
        n, H, W, _ = x.shape
        fused = F.gelu(self.neck(feats), approximate="tanh")
        h4, w4 = fused.shape[1], fused.shape[2]
        contents = torch.tanh(_unshuffle4(self.content_out(fused), n, h4,
                                          w4))
        attn = _unshuffle4(self.attn_out(fused), n, h4, w4)
        attn = F.softmax(attn.float(), dim=-1).to(x.dtype)
        inp = x[..., :self.out_channels]
        oc, out = self.out_channels, 0.0
        n_content = self.nb_mask_attn - self.nb_mask_input
        for i in range(n_content):
            out = out + contents[..., i * oc:(i + 1) * oc] * attn[..., i:i + 1]
        for i in range(n_content, self.nb_mask_attn):
            out = out + inp * attn[..., i:i + 1]
        out = out.float()
        if with_features is None:
            return out
        return out, [feats[i] for i in with_features]


def load_mit_backbone(net, node_name="backbone"):
    """Copy ``$JOLIGEN_TPU_WEIGHTS_DIR/segformer_mit_b0.npz`` (keys: flax
    leaf paths under the backbone, ``embed0/proj/kernel``...) into
    ``net.<node_name>`` when the variable is set and the file exists, as
    the JAX package swaps the ``node_name`` subtree. The backbone stays
    trainable: this is an init. Returns whether it loaded."""
    root = os.environ.get("JOLIGEN_TPU_WEIGHTS_DIR")
    path = os.path.join(root or "", "segformer_mit_b0.npz")
    if not root or not os.path.exists(path) or not hasattr(net, node_name):
        return False
    from ..convert import flax_to_torch
    z = np.load(path)
    tree = {}
    for key in z.files:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    getattr(net, node_name).load_state_dict(flax_to_torch(tree))
    return True
