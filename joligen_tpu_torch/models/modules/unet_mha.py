"""The ``unet_mha`` denoiser in PyTorch (``joligen_tpu/models/modules/unet_mha.py``).

Modules and attributes carry the flax auto-names (``ResBlock_5``,
``GroupNorm32_1/GroupNorm_0``, ``AttentionBlock_0/qkv``...), so a parameter's
state-dict key is its flax tree path (``models/convert.py``). Internally the
network is NCHW for cuDNN; ``UNetMHA.forward`` keeps the JAX layout (NHWC in,
NHWC out). The submodules below take and return NCHW.

Dtype policy: conv and dense layers keep fp32 parameters and compute in
``dtype`` (bf16 under ``tpu_bf16``); GroupNorm takes fp32 statistics and
returns the input dtype; the network output is fp32.

Remat (``tpu_remat``, ``unet_mha.py:383-397``): each ResBlock and
AttentionBlock call runs under ``torch.utils.checkpoint``. Modules are not
wrapped, so parameter names, and checkpoints, are the same with and without
it. ``remat_policy="full"`` recomputes the whole block in the backward;
``"conv"`` keeps the outputs of the matrix units (``REMAT_SAVE``: the convs,
the dense layers and K1) and recomputes the norm, FiLM and SiLU chains
between them.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...ops.flash_attention import flash_attention
from ...ops.resize import nearest_up2


# The ops whose outputs ``remat_policy="conv"`` keeps (the JAX package's
# ``REMAT_SAVE`` names: conv outputs, the qkv projection and attention).
# ``Dense`` always reaches ``addmm``: a saved output must not be changed in
# place later, as ``matmul`` followed by an in-place bias add would.
REMAT_SAVE = (torch.ops.aten.convolution.default,
              torch.ops.aten.addmm.default,
              torch.ops.joligen_tpu_torch.flash_attention_fwd.default)


def _save_mxu_outputs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in REMAT_SAVE
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXTS = {
    "full": {},
    "conv": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_mxu_outputs)},
}


class Conv(nn.Module):
    """flax ``nn.Conv`` with fp32 params computing in ``dtype``; kernel OIHW."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=None,
                 dtype=torch.float32, zero_init=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.dtype = dtype
        self.zero_init = zero_init

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), self.stride, self.padding)


class Dense(nn.Module):
    """flax ``nn.Dense`` with fp32 params computing in ``dtype``; weight
    (out, in); no bias with ``use_bias=False``."""

    def __init__(self, cin, cout, dtype=torch.float32, zero_init=False,
                 use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.dtype = dtype
        self.zero_init = zero_init

    def forward(self, x):
        # one 2-D product with the bias fused (addmm) whatever x's rank and
        # strides
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.linear(x.reshape(-1, x.shape[-1]).to(self.dtype),
                     self.weight.to(self.dtype), bias)
        return y.reshape(x.shape[:-1] + y.shape[-1:])


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW (or (N, C, L)) input: fp32 statistics
    with flax's variance E[x^2] - E[x]^2 clipped at 0, output in x.dtype."""

    def __init__(self, num_groups, channels, eps=1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c = x.shape[:2]
        g = self.num_groups
        xf = x.float().reshape(n, g, -1)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1)
        mul = mul * self.weight.float()[None, :, None]
        y = (xf - mean).reshape(n, c, -1) * mul + self.bias.float()[None, :, None]
        return y.reshape(x.shape).to(x.dtype)


class GroupNorm32(nn.Module):
    """GroupNorm with the group-clipping rule of ``unet_mha.py:49-51``."""

    def __init__(self, num_groups, channels):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.GroupNorm_0 = GroupNorm(groups, channels)

    def forward(self, x):
        return self.GroupNorm_0(x)


def _norm(kind, group_size, channels):
    if "groupnorm" in kind:
        return GroupNorm32(group_size, channels)
    if kind == "instancenorm":
        return GroupNorm32(10 ** 9, channels)   # clipped to C groups
    if kind == "layernorm":
        return GroupNorm32(1, channels)
    return GroupNorm32(group_size, channels)


def _up2(x):
    return nearest_up2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _down2(x):
    return F.avg_pool2d(x, 2, 2)


class Upsample(nn.Module):
    """Nearest 2x upsample then a 3x3 conv (``unet_mha.py:82-96``)."""

    def __init__(self, channels, out_channel, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(channels, out_channel, 3, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(_up2(x))


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``unet_mha.py:99-114``)."""

    def __init__(self, channels, out_channel, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(channels, out_channel, 3, stride=2, padding=1,
                           dtype=dtype)

    def forward(self, x):
        return self.Conv_0(x)


class ResBlock(nn.Module):
    """FiLM-conditioned residual block (``unet_mha.py:117-175``)."""

    def __init__(self, channels, out_channel, emb_dim, norm="groupnorm",
                 group_size=32, use_scale_shift_norm=True, up=False,
                 down=False, dtype=torch.float32):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.GroupNorm32_0 = _norm(norm, group_size, channels)
        self.in_conv = Conv(channels, out_channel, 3, dtype=dtype)
        self.emb_proj = Dense(
            emb_dim, 2 * out_channel if use_scale_shift_norm else out_channel,
            dtype=dtype)
        self.GroupNorm32_1 = _norm(norm, group_size, out_channel)
        self.out_conv = Conv(out_channel, out_channel, 3, dtype=dtype,
                             zero_init=True)
        if channels != out_channel:
            self.skip = Conv(channels, out_channel, 1, dtype=dtype)

    def forward(self, x, emb):
        h = F.silu(self.GroupNorm32_0(x))
        if self.up:
            h, x = _up2(h), _up2(x)
        elif self.down:
            h, x = _down2(h), _down2(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            # jnp.split order: scale first, then shift
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = self.GroupNorm32_1(h) * (1 + scale) + shift
        else:
            h = self.GroupNorm32_1(h + emb_out)
        h = self.out_conv(F.silu(h))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


def instance_norm_tokens(seq):
    """The reference's parameterless InstanceNorm1d over the tokens of
    ``seq`` (B, N, C): per-channel fp32 statistics, population variance,
    eps 1e-5; output in ``seq``'s dtype."""
    f32 = seq.float()
    mu = f32.mean(dim=1, keepdim=True)
    var = f32.var(dim=1, keepdim=True, correction=0)
    return ((f32 - mu) / torch.sqrt(var + 1e-5)).to(seq.dtype)


class AttentionBlock(nn.Module):
    """Spatial self-attention (``unet_mha.py:178-217``) through the
    flash-attention kernel. ``norm_kind="instance"`` is the reference's
    parameterless InstanceNorm1d over tokens."""

    def __init__(self, channels, num_heads=1, num_head_channels=-1,
                 norm_kind="group", dtype=torch.float32):
        super().__init__()
        self.heads = (num_heads if num_head_channels == -1
                      else max(1, channels // num_head_channels))
        self.norm_kind = norm_kind
        if norm_kind != "instance":
            self.GroupNorm32_0 = GroupNorm32(32, channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype, zero_init=True)

    def forward(self, x):
        n, c, hh, ww = x.shape
        heads = self.heads
        hd = c // heads
        if self.norm_kind == "instance":
            y = instance_norm_tokens(x.flatten(2).transpose(1, 2))
        else:
            y = self.GroupNorm32_0(x).flatten(2).transpose(1, 2)
        qkv = self.qkv(y)                                 # (n, hw, 3c)
        q, k, v = (t.reshape(n, hh * ww, heads, hd)
                   for t in torch.split(qkv, c, dim=-1))
        a = flash_attention(q, k, v).reshape(n, hh * ww, c)
        a = self.proj_out(a)
        return x + a.transpose(1, 2).reshape(n, c, hh, ww)


class UNetMHA(nn.Module):
    """The unet_mha denoiser, non-UViT and pixel-space
    (``unet_mha.py:324-498``), without the GAN variant's tanh head.
    ``forward``: x (B, H, W, in_channel) NHWC, emb (B, cond_embed_dim) ->
    (B, H, W, out) fp32."""

    def __init__(self, in_channel, out_channel, inner_channel, cond_embed_dim,
                 res_blocks: Sequence[int] = (2, 2, 2, 2),
                 attn_res: Sequence[int] = (16,),
                 channel_mults: Sequence[int] = (1, 2, 4, 8),
                 num_heads=1, num_head_channels=32, norm="groupnorm",
                 group_size=32, use_scale_shift_norm=True,
                 resblock_updown=True, transformer_blocks=0,
                 attn_norm="group", freq_space=False, remat=False,
                 remat_policy="conv", dtype=torch.float32):
        super().__init__()
        if remat and remat_policy not in _REMAT_CONTEXTS:
            raise ValueError(f"tpu_remat_policy {remat_policy!r} not in "
                             f"{tuple(_REMAT_CONTEXTS)}")
        self.remat = remat
        self.remat_policy = remat_policy
        if transformer_blocks > 0:
            raise NotImplementedError(
                "UViT transformer middle stack (ROADMAP Queue 1 item 9, ref "
                "conditioning, UViT and frequency space)")
        if freq_space:
            raise NotImplementedError(
                "freq_space / train_feat_wavelet (ROADMAP Queue 1 item 9, ref "
                "conditioning, UViT and frequency space)")
        self.dtype = dtype
        counters = {}

        def add(kind, module):
            i = counters.get(kind, 0)
            counters[kind] = i + 1
            name = f"{kind}_{i}"
            self.add_module(name, module)
            return name

        blk = dict(emb_dim=cond_embed_dim, norm=norm, group_size=group_size,
                   use_scale_shift_norm=use_scale_shift_norm, dtype=dtype)
        attn = dict(num_heads=num_heads, num_head_channels=num_head_channels,
                    norm_kind=attn_norm, dtype=dtype)

        ch = int(channel_mults[0] * inner_channel)
        self.in_conv = Conv(in_channel, ch, 3, dtype=dtype)
        chans = [ch]
        ds = 1
        # encoder plan: (block, attention or None, block is a Downsample)
        self._enc = []
        for level, mult in enumerate(channel_mults):
            for _ in range(res_blocks[level]):
                out = int(mult * inner_channel)
                r = add("ResBlock", ResBlock(ch, out, **blk))
                ch = out
                a = (add("AttentionBlock", AttentionBlock(ch, **attn))
                     if ds in attn_res else None)
                self._enc.append((r, a, False))
                chans.append(ch)
            if level != len(channel_mults) - 1:
                if resblock_updown:
                    r = add("ResBlock", ResBlock(ch, ch, down=True, **blk))
                    self._enc.append((r, None, False))
                else:
                    d = add("Downsample", Downsample(ch, ch, dtype=dtype))
                    self._enc.append((d, None, True))
                chans.append(ch)
                ds *= 2

        self._mid = (add("ResBlock", ResBlock(ch, ch, **blk)),
                     add("AttentionBlock", AttentionBlock(ch, **attn)),
                     add("ResBlock", ResBlock(ch, ch, **blk)))

        # decoder plan: (block, attention or None, resample or None,
        # resample is an Upsample)
        self._dec = []
        for level, mult in reversed(list(enumerate(channel_mults))):
            for i in range(res_blocks[level] + 1):
                out = int(mult * inner_channel)
                r = add("ResBlock", ResBlock(ch + chans.pop(), out, **blk))
                ch = out
                a = (add("AttentionBlock", AttentionBlock(ch, **attn))
                     if ds in attn_res else None)
                up, plain = None, False
                if level and i == res_blocks[level]:
                    if resblock_updown:
                        up = add("ResBlock", ResBlock(ch, ch, up=True, **blk))
                    else:
                        up, plain = add("Upsample",
                                        Upsample(ch, ch, dtype=dtype)), True
                    ds //= 2
                self._dec.append((r, a, up, plain))

        self.GroupNorm32_0 = _norm(norm, group_size, ch)
        self.out_proj = Conv(ch, out_channel, 3, dtype=dtype, zero_init=True)

    def _block(self, name, *args):
        """Call block ``name``, under activation checkpointing with
        ``remat`` when a gradient is being taken."""
        m = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return m(*args)
        return checkpoint(m, *args, use_reentrant=False,
                          **_REMAT_CONTEXTS[self.remat_policy])

    def forward(self, x, emb):
        emb = emb.to(self.dtype)
        h = self.in_conv(x.to(self.dtype).permute(0, 3, 1, 2))
        hs = [h]
        for r, a, plain in self._enc:
            h = getattr(self, r)(h) if plain else self._block(r, h, emb)
            if a is not None:
                h = self._block(a, h)
            hs.append(h)
        r0, a0, r1 = self._mid
        h = self._block(r1, self._block(a0, self._block(r0, h, emb)), emb)
        for r, a, up, plain in self._dec:
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            h = self._block(r, h, emb)
            if a is not None:
                h = self._block(a, h)
            if up is not None:
                h = getattr(self, up)(h) if plain else self._block(up, h, emb)
        out = self.out_proj(F.silu(self.GroupNorm32_0(h)))
        return out.float().permute(0, 2, 3, 1)
