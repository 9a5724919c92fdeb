"""ITTR, the transformer image-to-image generator of ``G_netG: ittr``
(``joligen_tpu/models/modules/ittr.py``).

A 7×7 stem and two stride-2 convs (each InstanceNorm, exact GELU), then
``n_blocks`` hybrid perception blocks (``HPB``: the dual-pruned
self-attention ``DPSA`` beside a depthwise 3×3, fused by the 1×1
``combine`` with a residual, then the conv FFN whose output replaces the
block's), then two ``TorchConvTranspose`` ups, a 7×7 and a tanh.

``DPSA`` reproduces the reference's axis relabelling, as the JAX package
does: after the head fold, (B·heads, dim_head, H, W) is read as (b, h, w,
d), so the features are the W axis, the tokens (channel, row) pairs,
"height" pruning keeps the ``height_top_k`` channels and "width" pruning
the ``width_top_k`` rows whose summed keys score highest against the summed
queries (``torch.topk``, sorted as ``jax.lax.top_k``). It is shape-
consistent because the generator sets dim_head to the stem's output side
(``img_size / 4``). Attention is plain torch ops (fp32 logits and softmax):
the JAX package reaches no kernel here.

Modules carry the flax names (``stem0``, ``hpb3.attn.to_qkv``,
``dec_up1``...); ``ChanLayerNorm``'s ``g`` and ``b`` are raw leaves
(``models/convert.py``). Tensors are NCHW inside; ``ITTRGenerator.forward``
takes and returns NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet_generator import Conv, InstanceNorm, TorchConvTranspose, _pad


def l2norm(t, dim=-1, eps=1e-12):
    """``F.normalize``: t / max(‖t‖, eps)."""
    n = torch.sqrt((t * t).sum(dim=dim, keepdim=True))
    return t / torch.clamp(n, min=eps)


class ChanLayerNorm(nn.Module):
    """Affine LayerNorm over the channels of NCHW input: fp32 statistics,
    biased variance, eps inside the square root (``ittr.py:29-41``)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(channels))
        self.b = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        f32 = x.float()
        mean = f32.mean(dim=1, keepdim=True)
        var = f32.var(dim=1, keepdim=True, correction=0)
        y = (f32 - mean) / torch.sqrt(var + self.eps)
        return (y * self.g[:, None, None] + self.b[:, None, None]).to(x.dtype)


class DPSA(nn.Module):
    """Dual-pruned self-attention (``ittr.py:44-112``; see the module
    doc)."""

    def __init__(self, channels, height_top_k=16, width_top_k=16,
                 dim_head=32, heads=8, dtype=torch.float32):
        super().__init__()
        self.height_top_k, self.width_top_k = height_top_k, width_top_k
        self.dim_head, self.heads = dim_head, heads
        self.dtype = dtype
        inner = heads * dim_head
        self.norm = ChanLayerNorm(channels)
        self.to_qkv = Conv(channels, 3 * inner, 1, bias=False, dtype=dtype)
        self.to_out = Conv(inner, channels, 1, dtype=dtype)

    def forward(self, x):
        b, _, h, w = x.shape
        bh = b * self.heads
        qkv = self.to_qkv(self.norm(x).to(self.dtype))
        q, k, v = (t.reshape(bh, self.dim_head, h, w)
                   for t in torch.chunk(qkv, 3, dim=1))
        q, k = l2norm(q), l2norm(k)           # over the W axis
        q_probe = q.sum(dim=(1, 2))           # (bh, W)
        if self.height_top_k < h:
            scores = torch.einsum("bd,bhd->bh", q_probe, k.sum(dim=2))
            idx = torch.topk(scores, self.height_top_k, dim=-1)[1]
            idx = idx[:, :, None, None].expand(-1, -1, k.shape[2], w)
            k, v = torch.gather(k, 1, idx), torch.gather(v, 1, idx)
        if self.width_top_k < w:
            scores = torch.einsum("bd,bwd->bw", q_probe, k.sum(dim=1))
            idx = torch.topk(scores, self.width_top_k, dim=-1)[1]
            idx = idx[:, None, :, None].expand(-1, k.shape[1], -1, w)
            k, v = torch.gather(k, 2, idx), torch.gather(v, 2, idx)
        qf, kf, vf = (t.reshape(bh, -1, w) for t in (q, k, v))
        sim = torch.bmm(qf, kf.transpose(1, 2)).float()
        out = torch.bmm(torch.softmax(sim, dim=-1).to(vf.dtype), vf)
        # "(b h) (x y) d -> b (h d) x y": tokens read as the pixel grid
        out = out.reshape(b, self.heads, h, w, w).permute(0, 1, 4, 2, 3)
        return self.to_out(out.reshape(b, self.heads * w, h, w))


class HPB(nn.Module):
    """Hybrid perception block (``ittr.py:115-148``)."""

    def __init__(self, channels, dim_head=32, heads=8, ff_mult=4,
                 height_top_k=16, width_top_k=16, dtype=torch.float32):
        super().__init__()
        c, inner = channels, channels * ff_mult
        self.attn = DPSA(c, height_top_k, width_top_k, dim_head, heads,
                         dtype=dtype)
        self.dwconv = Conv(c, c, 3, padding=1, groups=c, dtype=dtype)
        self.combine = Conv(2 * c, c, 1, dtype=dtype)
        self.ff_in = Conv(c, inner, 1, dtype=dtype)
        self.ff_dw = Conv(inner, inner, 3, padding=1, groups=inner,
                          dtype=dtype)
        self.ff_out = Conv(inner, c, 1, dtype=dtype)
        self.norm = InstanceNorm()

    def forward(self, x):
        combined = torch.cat([self.attn(x), self.dwconv(x)], dim=1)
        h = self.combine(combined) + x
        y = F.gelu(self.norm(self.ff_in(h)))
        y = y + F.gelu(self.norm(self.ff_dw(y)))
        return self.norm(self.ff_out(y))


class ITTRGenerator(nn.Module):
    """``forward(x NHWC in [-1, 1])`` -> NHWC tanh output (fp32);
    ``extract_layer_ids``: the NHWC outputs of those HPBs (CUT's NCE
    taps), ``with_features``: the pair (output, taps)."""

    def __init__(self, in_channels=3, out_channels=3, ngf=64, n_blocks=9,
                 img_size=256, height_top_k=16, width_top_k=16,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = n_blocks
        self.channels = ngf * 4
        self.norm = InstanceNorm()
        self.stem0 = Conv(in_channels, ngf, 7, dtype=dtype)
        for i in range(2):
            mult = 2 ** i
            setattr(self, f"stem_down{i}", Conv(
                ngf * mult, ngf * mult * 2, 3, 2, 1, dtype=dtype))
        # dim_head is the stem's output side (ittr.py:171-173)
        for i in range(n_blocks):
            setattr(self, f"hpb{i}", HPB(
                self.channels, dim_head=img_size // 4,
                height_top_k=height_top_k, width_top_k=width_top_k,
                dtype=dtype))
        for i in range(2):
            mult = 2 ** (2 - i)
            setattr(self, f"dec_up{i}", TorchConvTranspose(
                ngf * mult, ngf * mult // 2, dtype=dtype))
        self.dec_out = Conv(ngf, out_channels, 7, dtype=dtype)

    def layer_channels(self, layer_ids):
        return [self.channels for i in range(self.n_blocks)
                if i in layer_ids]

    def forward(self, x, extract_layer_ids=None, with_features=None):
        taps = extract_layer_ids if extract_layer_ids is not None \
            else with_features
        h = _pad(x.to(self.dtype).permute(0, 3, 1, 2), 3)
        h = F.gelu(self.norm(self.stem0(h)))
        for i in range(2):
            h = F.gelu(self.norm(getattr(self, f"stem_down{i}")(h)))
        feats = []
        for i in range(self.n_blocks):
            h = getattr(self, f"hpb{i}")(h)
            if taps is not None and i in taps:
                feats.append(h.permute(0, 2, 3, 1))
        if extract_layer_ids is not None:
            return feats
        for i in range(2):
            h = F.gelu(self.norm(getattr(self, f"dec_up{i}")(h)))
        out = torch.tanh(self.dec_out(_pad(h, 3))).float().permute(0, 2, 3, 1)
        return (out, feats) if with_features is not None else out
