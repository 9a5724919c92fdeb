"""The ``unet_mha`` denoiser in PyTorch (``joligen_tpu/models/modules/unet_mha.py``).

Modules and attributes carry the flax auto-names (``ResBlock_5``,
``GroupNorm32_1/GroupNorm_0``, ``AttentionBlock_0/qkv``...), so a parameter's
state-dict key is its flax tree path (``models/convert.py``). Internally the
network is NCHW for cuDNN; ``UNetMHA.forward`` keeps the JAX layout (NHWC in,
NHWC out). The submodules below take and return NCHW.

Dtype policy: conv and dense layers keep fp32 parameters and compute in
``dtype`` (bf16 under ``tpu_bf16``); GroupNorm takes fp32 statistics and
returns the input dtype; the network output is fp32.

The GAN generator (``tanh=True``, ``gan_networks.py``: ``unet_mha``,
``uvit``, ``unet_256``, ``unet_128``) takes no embedding (a ones vector of
``cond_embed_dim``) and ends in a 3x3 ``out_proj`` (no SiLU, not
zero-initialised) and a tanh. ``freq_space`` (``train_feat_wavelet``) runs
the trunk on the Haar bands of the input: the first conv takes 4x the
input channels, every resampling goes through pixel space, ``out_proj``
has 4x the output channels, and the tanh (GAN) comes before the inverse
transform. ``transformer_blocks`` > 0 is UViT (``unet_mha.py:220-321,
440-452``): no attention in the encoder and decoder, plain conv
resampling, and a middle of ``TransformerBlock``s over the NCHW buffer read
as (B, H*W, C) tokens (a reshape of its memory, not a transpose); its
attention is the reference's ``QKVAttentionLegacy`` in plain torch ops
(``legacy_attention``, shared with ``unet_ref_attn.py``), which reaches no kernel in the JAX
package either.

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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...ops.flash_attention import flash_attention
from ...ops.resize import nearest_up2
from ...ops.upfirdn2d import haar_transform, inverse_haar_transform


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


def _to_pixel(x, freq_space):
    return inverse_haar_transform(x) if freq_space else x


def _to_freq(x, freq_space):
    return haar_transform(x) if freq_space else x


def _resample(x, up, freq_space):
    """Nearest 2x up or 2x2 mean down, in pixel space (``unet_mha.py:
    130-141``)."""
    x = _to_pixel(x, freq_space)
    return _to_freq(_up2(x) if up else _down2(x), freq_space)


class Upsample(nn.Module):
    """Nearest 2x upsample then a 3x3 conv (``unet_mha.py:82-96``); in
    ``freq_space`` both in pixel space, at a quarter of the channels."""

    def __init__(self, channels, out_channel, freq_space=False,
                 dtype=torch.float32):
        super().__init__()
        q = 4 if freq_space else 1
        self.freq_space = freq_space
        self.Conv_0 = Conv(channels // q, out_channel // q, 3, dtype=dtype)

    def forward(self, x):
        x = _up2(_to_pixel(x, self.freq_space))
        return _to_freq(self.Conv_0(x), self.freq_space)


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``unet_mha.py:99-114``); in ``freq_space`` in
    pixel space, at a quarter of the channels."""

    def __init__(self, channels, out_channel, freq_space=False,
                 dtype=torch.float32):
        super().__init__()
        q = 4 if freq_space else 1
        self.freq_space = freq_space
        self.Conv_0 = Conv(channels // q, out_channel // q, 3, stride=2,
                           padding=1, dtype=dtype)

    def forward(self, x):
        x = self.Conv_0(_to_pixel(x, self.freq_space))
        return _to_freq(x, self.freq_space)


class ResBlock(nn.Module):
    """FiLM-conditioned residual block (``unet_mha.py:117-175``)."""

    def __init__(self, channels, out_channel, emb_dim, norm="groupnorm",
                 group_size=32, use_scale_shift_norm=True, up=False,
                 down=False, freq_space=False, dtype=torch.float32):
        super().__init__()
        self.up, self.down = up, down
        self.freq_space = freq_space
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
        if self.up or self.down:
            h = _resample(h, self.up, self.freq_space)
            x = _resample(x, self.up, self.freq_space)
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


def legacy_attention(qkv, heads):
    """``QKVAttentionLegacy`` over (B, 3C, N) rows read head-major; returns
    (B, C, N)."""
    b, w, n = qkv.shape
    ch = w // (3 * heads)
    q, k, v = torch.split(qkv.reshape(b * heads, 3 * ch, n), ch, dim=1)
    scale = 1.0 / torch.sqrt(torch.sqrt(torch.tensor(float(ch),
                                                     device=qkv.device)))
    wgt = torch.bmm((q.float() * scale).transpose(1, 2), k.float() * scale)
    wgt = F.softmax(wgt, dim=-1).to(v.dtype)
    a = torch.bmm(v, wgt.transpose(1, 2))            # (b·heads, ch, n)
    return a.reshape(b, heads * ch, n)


def sinu_pos_encoding_1d(n, channels):
    """The interleaved [sin f0, cos f0, sin f1, ...] table of ``n``
    positions (``unet_mha.py:220-229``), (n, channels) fp32."""
    ch = int(np.ceil(channels / 2) * 2)
    inv = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))
    sin_inp = np.arange(n, dtype=np.float64)[:, None] * inv[None]
    emb = np.stack([np.sin(sin_inp), np.cos(sin_inp)], -1).reshape(n, ch)
    return torch.from_numpy(emb[:, :channels].astype(np.float32))


def uvit_layernorm(x):
    """LayerNorm without affine over the last dim: fp32 statistics, rsqrt
    of the variance clamped at 1e-5 (not var + eps), output in x.dtype
    (``unet_mha.py:232-240``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(torch.clamp(var, min=1e-5))).to(
        x.dtype)


class UViTFeedForward(nn.Module):
    """The non-residual token MLP (``unet_mha.py:243-263``): LayerNorm,
    bias-free ``proj_in`` to 4C, SiLU, FiLM of the hidden units from the
    embedding (``to_scale_shift``, zero-initialised), bias-free
    ``proj_out``; its output replaces the input."""

    def __init__(self, channels, emb_dim, dtype=torch.float32):
        super().__init__()
        self.proj_in = Dense(channels, 4 * channels, dtype=dtype,
                             use_bias=False)
        self.to_scale_shift = Dense(emb_dim, 8 * channels, dtype=dtype,
                                    zero_init=True)
        self.proj_out = Dense(4 * channels, channels, dtype=dtype,
                              use_bias=False)

    def forward(self, x, emb):
        h = F.silu(self.proj_in(uvit_layernorm(x)))
        scale, shift = torch.chunk(self.to_scale_shift(F.silu(emb))[:, None],
                                   2, dim=-1)
        return self.proj_out(h * (scale + 1) + shift)


class UViTAttention(nn.Module):
    """UViT's middle attention (``unet_mha.py:266-306``): the (B, N, C)
    tokens read as (B, C, N) (a reshape), InstanceNorm1d per channel, the
    raw (3C, C) ``qkv_kernel`` and (C, C) ``proj_kernel`` (out, in) with
    their biases, ``legacy_attention``, the residual, read back as (B, N,
    C). ``proj_kernel`` and ``proj_bias`` are zero-initialised in flax."""

    def __init__(self, channels, num_heads=1, num_head_channels=-1,
                 dtype=torch.float32):
        super().__init__()
        self.heads = (num_heads if num_head_channels == -1
                      else max(1, channels // num_head_channels))
        self.dtype = dtype
        self.qkv_kernel = nn.Parameter(torch.zeros(3 * channels, channels))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * channels))
        self.proj_kernel = nn.Parameter(torch.zeros(channels, channels))
        self.proj_bias = nn.Parameter(torch.zeros(channels))

    def forward(self, z):
        b, n, c = z.shape
        za = z.reshape(b, c, n)
        zn = instance_norm_tokens(za.transpose(1, 2)).transpose(1, 2)
        zn = zn.to(self.dtype)
        qkv = torch.matmul(self.qkv_kernel.to(self.dtype), zn) \
            + self.qkv_bias.to(self.dtype)[None, :, None]
        a = legacy_attention(qkv, self.heads)
        a = torch.matmul(self.proj_kernel.to(self.dtype), a) \
            + self.proj_bias.to(self.dtype)[None, :, None]
        return (za + a).reshape(b, n, c)


class TransformerBlock(nn.Module):
    """One UViT middle entry: ``ff`` then ``attn`` (``unet_mha.py:
    309-321``)."""

    def __init__(self, channels, emb_dim, num_heads=1, num_head_channels=-1,
                 dtype=torch.float32):
        super().__init__()
        self.ff = UViTFeedForward(channels, emb_dim, dtype=dtype)
        self.attn = UViTAttention(channels, num_heads, num_head_channels,
                                  dtype=dtype)

    def forward(self, z, emb):
        return self.attn(self.ff(z, emb))


class UNetMHA(nn.Module):
    """The unet_mha denoiser and GAN generator (``unet_mha.py:324-498``).
    ``forward``: x (B, H, W, in_channel) NHWC, emb (B, cond_embed_dim) or
    None (GAN mode: ones) -> (B, H, W, out) fp32; with
    ``extract_layer_ids`` the NHWC encoder features at those indices of
    [in_conv, each encoder block and resample] (CUT's NCE taps), and with
    ``with_features`` (tap ids) the pair (output, taps)."""

    def __init__(self, in_channel, out_channel, inner_channel, cond_embed_dim,
                 res_blocks: Sequence[int] = (2, 2, 2, 2),
                 attn_res: Sequence[int] = (16,),
                 channel_mults: Sequence[int] = (1, 2, 4, 8),
                 num_heads=1, num_head_channels=32, norm="groupnorm",
                 group_size=32, tanh=False, use_scale_shift_norm=True,
                 resblock_updown=True, transformer_blocks=0,
                 attn_norm="group", freq_space=False, remat=False,
                 remat_policy="conv", dtype=torch.float32):
        super().__init__()
        if remat and remat_policy not in _REMAT_CONTEXTS:
            raise ValueError(f"tpu_remat_policy {remat_policy!r} not in "
                             f"{tuple(_REMAT_CONTEXTS)}")
        self.remat = remat
        self.remat_policy = remat_policy
        self.dtype = dtype
        self.tanh = tanh
        self.freq_space = freq_space
        self.cond_embed_dim = cond_embed_dim
        # UViT: no encoder/decoder attention, plain conv resampling
        is_uvit = transformer_blocks > 0
        q = 4 if freq_space else 1
        counters = {}

        def add(kind, module):
            i = counters.get(kind, 0)
            counters[kind] = i + 1
            name = f"{kind}_{i}"
            self.add_module(name, module)
            return name

        blk = dict(emb_dim=cond_embed_dim, norm=norm, group_size=group_size,
                   use_scale_shift_norm=use_scale_shift_norm,
                   freq_space=freq_space, dtype=dtype)
        attn = dict(num_heads=num_heads, num_head_channels=num_head_channels,
                    norm_kind=attn_norm, dtype=dtype)
        res = dict(freq_space=freq_space, dtype=dtype)
        updown = resblock_updown and not is_uvit

        ch = int(channel_mults[0] * inner_channel)
        self.in_conv = Conv(in_channel * q, ch, 3, dtype=dtype)
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
                     if ds in attn_res and not is_uvit else None)
                self._enc.append((r, a, False))
                chans.append(ch)
            if level != len(channel_mults) - 1:
                if updown:
                    r = add("ResBlock", ResBlock(ch, ch, down=True, **blk))
                    self._enc.append((r, None, False))
                else:
                    d = add("Downsample", Downsample(ch, ch, **res))
                    self._enc.append((d, None, True))
                chans.append(ch)
                ds *= 2
        self._enc_channels = list(chans)

        if is_uvit:
            self._mid = None
            self._uvit = [f"mid_t{ti}" for ti in range(transformer_blocks)]
            for name in self._uvit:
                self.add_module(name, TransformerBlock(
                    ch, cond_embed_dim, num_heads, num_head_channels,
                    dtype=dtype))
        else:
            self._uvit = []
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
                     if ds in attn_res and not is_uvit else None)
                up, plain = None, False
                if level and i == res_blocks[level]:
                    if updown:
                        up = add("ResBlock", ResBlock(ch, ch, up=True, **blk))
                    else:
                        up, plain = add("Upsample",
                                        Upsample(ch, ch, **res)), True
                    ds //= 2
                self._dec.append((r, a, up, plain))

        self.GroupNorm32_0 = _norm(norm, group_size, ch)
        # the GAN head is not zero-initialised in flax
        self.out_proj = Conv(ch, out_channel * q, 3, dtype=dtype,
                             zero_init=not tanh)

    def layer_channels(self, layer_ids):
        """Channels of the encoder taps ``layer_ids`` (PatchSampleF's
        inputs); an index past the taps raises, as the JAX list does."""
        n = len(self._enc_channels)
        bad = [i for i in layer_ids if not -n <= i < n]
        if bad:
            raise IndexError(f"NCE taps {bad} past the {n} encoder features "
                             "of this UNet (alg_cut_nce_layers follows "
                             "G_nblocks for unet generators)")
        return [self._enc_channels[i] for i in layer_ids]

    def _block(self, name, *args):
        """Call block ``name``, under activation checkpointing with
        ``remat`` when a gradient is being taken."""
        m = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return m(*args)
        return checkpoint(m, *args, use_reentrant=False,
                          **_REMAT_CONTEXTS[self.remat_policy])

    def forward(self, x, emb=None, extract_layer_ids=None,
                with_features=None):
        if emb is None:
            emb = torch.ones(x.shape[0], self.cond_embed_dim, device=x.device)
        emb = emb.to(self.dtype)
        x = _to_freq(x.to(self.dtype).permute(0, 3, 1, 2), self.freq_space)
        h = self.in_conv(x)
        hs = [h]
        for r, a, plain in self._enc:
            h = getattr(self, r)(h) if plain else self._block(r, h, emb)
            if a is not None:
                h = self._block(a, h)
            hs.append(h)
        taps = extract_layer_ids if extract_layer_ids is not None \
            else with_features
        if taps is not None:
            self.layer_channels(taps)
            feats = [hs[i].permute(0, 2, 3, 1) for i in taps]
            if extract_layer_ids is not None:
                return feats
        if self._mid is None:
            # the NCHW buffer read as (B, H*W, C) tokens (unet_mha.py:
            # 440-452), plus the 1-D sinusoidal table
            n, c, hh, ww = h.shape
            z = h.reshape(n, hh * ww, c)
            z = z + sinu_pos_encoding_1d(hh * ww, c).to(z.device, z.dtype)
            for name in self._uvit:
                z = self._block(name, z, emb)
            h = z.reshape(n, c, hh, ww)
        else:
            r0, a0, r1 = self._mid
            h = self._block(r1, self._block(a0, self._block(r0, h, emb)),
                            emb)
        for r, a, up, plain in self._dec:
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            h = self._block(r, h, emb)
            if a is not None:
                h = self._block(a, h)
            if up is not None:
                h = getattr(self, up)(h) if plain else self._block(up, h, emb)
        h = self.GroupNorm32_0(h)
        if self.tanh:
            out = torch.tanh(self.out_proj(h))
        else:
            out = self.out_proj(F.silu(h))
        out = _to_pixel(out, self.freq_space).float().permute(0, 2, 3, 1)
        return (out, feats) if with_features is not None else out
