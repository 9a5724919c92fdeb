"""The ``unet_vid`` denoiser (``joligen_tpu/models/modules/unet_vid.py``):
``unet_mha``'s spatial graph with a ``MotionModule`` after every encoder and
decoder ResBlock (and its attention), none in the middle block
(``unet_vid.py:124-132``).

Frames fold into the batch for every spatial block ((B*F, C, H, W), NCHW
inside as in ``UNetMHA``); the per-sequence embedding is repeated per frame
with ``repeat_interleave``. Names as in flax: ``in_conv``, ``ResBlock_{i}``
(pinned), ``AttentionBlock_{i}``, ``motion_enc{i}``, ``motion_dec{i}`` (the
decoder's count restarts at 0), ``GroupNorm32_0``, ``out_proj``. With
``remat`` each ResBlock call runs under ``torch.utils.checkpoint``, as the
JAX package wraps ``ResBlock`` alone in ``nn.remat``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .motion import MotionModule
from .unet_mha import (AttentionBlock, Conv, Downsample, ResBlock, Upsample,
                       _norm)


class UNetVid(nn.Module):
    """``forward``: x (B, F, H, W, in_channel), emb (B, cond_embed_dim) ->
    (B, F, H, W, out_channel) fp32."""

    def __init__(self, in_channel, out_channel, inner_channel, cond_embed_dim,
                 res_blocks: Sequence[int] = (2, 2, 2, 2),
                 attn_res: Sequence[int] = (16,),
                 channel_mults: Sequence[int] = (1, 2, 4, 8),
                 num_heads=1, num_head_channels=32, norm="groupnorm",
                 group_size=32, use_scale_shift_norm=True,
                 resblock_updown=True, max_sequence_length=25,
                 motion_num_heads=8, motion_num_transformer_blocks=2,
                 attn_norm="group", remat=False, dtype=torch.float32):
        super().__init__()
        self.remat = remat
        self.dtype = dtype
        counters = {}

        def add(kind, module):
            i = counters.get(kind, 0)
            counters[kind] = i + 1
            name = f"{kind}_{i}"
            self.add_module(name, module)
            return name

        def add_motion(name, ch):
            self.add_module(name, MotionModule(ch, **motion))
            return name

        blk = dict(emb_dim=cond_embed_dim, norm=norm, group_size=group_size,
                   use_scale_shift_norm=use_scale_shift_norm, dtype=dtype)
        attn = dict(num_heads=num_heads, num_head_channels=num_head_channels,
                    norm_kind=attn_norm, dtype=dtype)
        motion = dict(num_heads=motion_num_heads,
                      num_transformer_blocks=motion_num_transformer_blocks,
                      max_len=max_sequence_length, dtype=dtype)

        ch = int(channel_mults[0] * inner_channel)
        self.in_conv = Conv(in_channel, ch, 3, dtype=dtype)
        chans = [ch]
        ds = 1
        # encoder plan: (block, attention or None, motion module or None,
        # block is a Downsample)
        self._enc = []
        mm = 0
        for level, mult in enumerate(channel_mults):
            for _ in range(res_blocks[level]):
                out = int(mult * inner_channel)
                r = add("ResBlock", ResBlock(ch, out, **blk))
                ch = out
                a = (add("AttentionBlock", AttentionBlock(ch, **attn))
                     if ds in attn_res else None)
                m = add_motion(f"motion_enc{mm}", ch)
                mm += 1
                self._enc.append((r, a, m, False))
                chans.append(ch)
            if level != len(channel_mults) - 1:
                if resblock_updown:
                    r = add("ResBlock", ResBlock(ch, ch, down=True, **blk))
                    self._enc.append((r, None, None, False))
                else:
                    d = add("Downsample", Downsample(ch, ch, dtype=dtype))
                    self._enc.append((d, None, None, True))
                chans.append(ch)
                ds *= 2

        # middle: ResBlock, attention, ResBlock, no motion module
        self._mid = (add("ResBlock", ResBlock(ch, ch, **blk)),
                     add("AttentionBlock", AttentionBlock(ch, **attn)),
                     add("ResBlock", ResBlock(ch, ch, **blk)))

        # decoder plan: (block, attention or None, motion module, resample or
        # None, resample is an Upsample)
        self._dec = []
        mm = 0
        for level, mult in reversed(list(enumerate(channel_mults))):
            for i in range(res_blocks[level] + 1):
                out = int(mult * inner_channel)
                r = add("ResBlock", ResBlock(ch + chans.pop(), out, **blk))
                ch = out
                a = (add("AttentionBlock", AttentionBlock(ch, **attn))
                     if ds in attn_res else None)
                m = add_motion(f"motion_dec{mm}", ch)
                mm += 1
                up, plain = None, False
                if level and i == res_blocks[level]:
                    if resblock_updown:
                        up = add("ResBlock", ResBlock(ch, ch, up=True, **blk))
                    else:
                        up, plain = add("Upsample",
                                        Upsample(ch, ch, dtype=dtype)), True
                    ds //= 2
                self._dec.append((r, a, m, up, plain))

        self.GroupNorm32_0 = _norm(norm, group_size, ch)
        self.out_proj = Conv(ch, out_channel, 3, dtype=dtype, zero_init=True)

    def _res(self, name, h, emb):
        """ResBlock ``name``, under activation checkpointing with ``remat``
        when a gradient is being taken."""
        m = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return m(h, emb)
        return checkpoint(m, h, emb, use_reentrant=False)

    def forward(self, x, emb):
        b, f = x.shape[:2]
        emb = emb.to(self.dtype).repeat_interleave(f, dim=0)
        h = self.in_conv(x.reshape((b * f,) + x.shape[2:]).to(self.dtype)
                         .permute(0, 3, 1, 2))
        hs = [h]
        for r, a, m, plain in self._enc:
            h = getattr(self, r)(h) if plain else self._res(r, h, emb)
            if a is not None:
                h = getattr(self, a)(h)
            if m is not None:
                h = getattr(self, m)(h, f)
            hs.append(h)
        r0, a0, r1 = self._mid
        h = self._res(r1, getattr(self, a0)(self._res(r0, h, emb)), emb)
        for r, a, m, up, plain in self._dec:
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            h = self._res(r, h, emb)
            if a is not None:
                h = getattr(self, a)(h)
            h = getattr(self, m)(h, f)
            if up is not None:
                h = getattr(self, up)(h) if plain else self._res(up, h, emb)
        out = self.out_proj(F.silu(self.GroupNorm32_0(h)))
        out = out.float().permute(0, 2, 3, 1)
        return out.reshape((b, f) + out.shape[1:])
