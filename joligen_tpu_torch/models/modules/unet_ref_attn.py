"""``unet_mha_ref_attn`` in PyTorch (``joligen_tpu/models/modules/
unet_ref_attn.py``): two unet_mha towers, the second encoding the
reference image. At every attention site the ref tower attends to itself
and exports its qkv; the main tower's ``AttentionBlockRef`` attends with
its own qkv and, a second time, with its queries against the ref tower's
keys and values, and projects the two results, concatenated on channels,
through a zero-initialised 2C→C ``proj_out``. The ref decoder stops at its
terminal site (the first whose next level has no attention), which exports
its qkv and computes nothing else.

Names are the JAX package's: ``in_conv``, ``ref_in_conv``, ``ResBlock_i``
(main tower), ``RefResBlock_i``, ``AttnRef_i``, ``RefAttn_i``,
``GroupNorm32_0`` and ``out_proj``, numbered per tower in call order, so
the converter maps every leaf. The ResBlocks and norms are ``unet_mha``'s;
NCHW inside, NHWC at the boundary.

The attention is the reference's ``QKVAttentionLegacy`` in plain torch ops
(the JAX package runs no kernel here): a parameterless InstanceNorm over
the tokens (fp32 statistics, eps 1e-5, population variance), qkv rows read
head-major ([head][q|k|v][hd]), q and k each scaled by 1/√√hd in fp32, fp32
logits and softmax, the weights cast to v's dtype. The cross branch slices
*thirds* of those head-major rows, ``cat([qkv[:, :C], qkv_ref[:, C:2C],
qkv_ref[:, 2C:]])``, not the semantic q, k and v: a scrambled head pattern
the reference shipped and the JAX package keeps.

With ``remat`` each ResBlock runs under ``torch.utils.checkpoint`` and
keeps nothing (``nn.remat``'s default); the attention blocks are not
rematerialised, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .unet_mha import (Conv, Dense, ResBlock, _norm, instance_norm_tokens,
                       legacy_attention)


class AttentionBlockRef(nn.Module):
    """One attention site. ``forward(x NCHW, qkv_ref)`` -> (features,
    qkv (B, 3C, N)); a ``terminal`` site returns (None, qkv) and has no
    ``proj_out``; a ``use_ref`` site needs the other tower's qkv."""

    def __init__(self, channels, num_heads=1, num_head_channels=-1,
                 use_ref=False, terminal=False, dtype=torch.float32):
        super().__init__()
        self.heads = (num_heads if num_head_channels == -1
                      else max(1, channels // num_head_channels))
        self.use_ref, self.terminal = use_ref, terminal
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        if not terminal:
            self.proj_out = Dense((2 if use_ref else 1) * channels, channels,
                                  dtype=dtype, zero_init=True)

    def forward(self, x, qkv_ref=None):
        n, c, hh, ww = x.shape
        y = instance_norm_tokens(x.flatten(2).transpose(1, 2))
        qkv = self.qkv(y).transpose(1, 2)                 # (n, 3c, hw)
        if self.terminal:
            return None, qkv
        h = legacy_attention(qkv, self.heads)
        if self.use_ref:
            if qkv_ref is None:
                raise ValueError("a use_ref site needs the ref tower's qkv")
            h_ref = legacy_attention(torch.cat(
                [qkv[:, :c], qkv_ref[:, c:2 * c], qkv_ref[:, 2 * c:]], dim=1),
                self.heads)
            h = torch.cat([h, h_ref], dim=1)
        a = self.proj_out(h.transpose(1, 2))
        return x + a.transpose(1, 2).reshape(n, c, hh, ww), qkv


class UNetRefAttn(nn.Module):
    """``forward(x (B,H,W,x_channels), emb (B,D), ref (B,H,W,Cref))`` ->
    (B,H,W,out_channel) fp32. ``in_channel`` is the width the reference is
    channel-duplicated, then zero-padded or cut, to (the denoiser's
    [y_cond, y_t]); ``x_channels`` (default ``in_channel``) is what
    ``in_conv`` takes, the mask embedding included. A missing ``ref`` is
    zeros, a missing ``emb`` ones."""

    def __init__(self, in_channel, out_channel, inner_channel, cond_embed_dim,
                 res_blocks=(2, 2, 2, 2), attn_res=(16,),
                 channel_mults=(1, 2, 4, 8), num_heads=1,
                 num_head_channels=32, norm="groupnorm", group_size=32,
                 use_scale_shift_norm=True, remat=False, x_channels=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_channel, self.cond_embed_dim = in_channel, cond_embed_dim
        self.remat, self.dtype = remat, dtype
        counters = {}
        blk = dict(emb_dim=cond_embed_dim, norm=norm, group_size=group_size,
                   use_scale_shift_norm=use_scale_shift_norm, dtype=dtype)
        attn = dict(num_heads=num_heads, num_head_channels=num_head_channels,
                    dtype=dtype)

        def res(prefix, cin, cout, **kw):
            return self._add(counters, prefix, ResBlock(cin, cout, **kw,
                                                        **blk))

        def site(prefix, ch, **kw):
            return self._add(counters, prefix,
                             AttentionBlockRef(ch, **kw, **attn))

        mults = list(channel_mults)
        last = len(mults) - 1
        # ref tower, encoder and middle: ``ref_in_conv`` gives the
        # bottleneck width (the JAX package's quirk, ``unet_ref_attn.py:
        # 174-178``); the first RefResBlock's skip conv maps it down
        ch = int(mults[-1] * inner_channel)
        self.ref_in_conv = Conv(in_channel, ch, 3, dtype=dtype)
        ref_chans, self._ref_enc = [ch], []
        ds = 1
        for level, mult in enumerate(mults):
            for _ in range(res_blocks[level]):
                out = int(mult * inner_channel)
                r = res("RefResBlock", ch, out)
                ch = out
                a = site("RefAttn", ch) if ds in attn_res else None
                self._ref_enc.append((r, a, True))
                ref_chans.append(ch)
            if level != last:
                self._ref_enc.append((res("RefResBlock", ch, ch, down=True),
                                      None, False))
                ref_chans.append(ch)
                ds *= 2
        self._ref_mid = (res("RefResBlock", ch, ch), site("RefAttn", ch),
                         res("RefResBlock", ch, ch))
        ref_mid_ch = ch

        # main tower, encoder and middle: each encoder site takes the qkv of
        # the ref encoder's block at the same place
        ch = int(mults[0] * inner_channel)
        self.in_conv = Conv(x_channels or in_channel, ch, 3, dtype=dtype)
        chans, self._enc = [ch], []
        ds = 1
        for level, mult in enumerate(mults):
            for _ in range(res_blocks[level]):
                out = int(mult * inner_channel)
                r = res("ResBlock", ch, out)
                ch = out
                a = (site("AttnRef", ch, use_ref=True) if ds in attn_res
                     else None)
                self._enc.append((r, a, True))
                chans.append(ch)
            if level != last:
                self._enc.append((res("ResBlock", ch, ch, down=True), None,
                                  False))
                chans.append(ch)
                ds *= 2
        self._mid = (res("ResBlock", ch, ch),
                     site("AttnRef", ch, use_ref=True),
                     res("ResBlock", ch, ch))

        # ref tower, decoder until its terminal site
        self._ref_dec = []
        ds_ref, rch, done = ds, ref_mid_ch, False
        for level, mult in reversed(list(enumerate(mults))):
            if done:
                break
            for i in range(res_blocks[level] + 1):
                terminal = (i == res_blocks[level]
                            and (ds_ref // 2) not in attn_res)
                out = int(mult * inner_channel)
                r = res("RefResBlock", rch + ref_chans.pop(), out)
                rch = out
                a = (site("RefAttn", rch, terminal=terminal)
                     if ds_ref in attn_res else None)
                up = None
                if level and i == res_blocks[level]:
                    if not terminal:
                        up = res("RefResBlock", rch, rch, up=True)
                    ds_ref //= 2
                self._ref_dec.append((r, a, up))
            done = terminal

        # main tower, decoder: its k-th block takes the ref decoder's k-th
        # qkv
        self._dec = []
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(res_blocks[level] + 1):
                out = int(mult * inner_channel)
                r = res("ResBlock", ch + chans.pop(), out)
                ch = out
                a = (site("AttnRef", ch, use_ref=True) if ds in attn_res
                     else None)
                up = None
                if level and i == res_blocks[level]:
                    up = res("ResBlock", ch, ch, up=True)
                    ds //= 2
                self._dec.append((r, a, up))

        self.GroupNorm32_0 = _norm(norm, group_size, ch)
        self.out_proj = Conv(ch, out_channel, 3, dtype=dtype, zero_init=True)

    def _add(self, counters, prefix, module):
        i = counters.get(prefix, 0)
        counters[prefix] = i + 1
        name = f"{prefix}_{i}"
        self.add_module(name, module)
        return name

    def _res(self, name, h, emb):
        m = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return m(h, emb)
        return checkpoint(m, h, emb, use_reentrant=False)

    def forward(self, x, emb=None, ref=None):
        b = x.shape[0]
        if emb is None:
            emb = torch.ones(b, self.cond_embed_dim, device=x.device)
        emb = emb.to(self.dtype)
        if ref is None:
            ref = torch.zeros(x.shape[:-1] + (self.in_channel // 2,),
                              dtype=x.dtype, device=x.device)
        r = torch.cat([ref, ref], dim=-1).to(self.dtype)
        cdiff = self.in_channel - r.shape[-1]
        if cdiff > 0:
            r = F.pad(r, (0, cdiff))
        elif cdiff < 0:
            r = r[..., :self.in_channel]

        # ref tower: encoder and middle
        hr = self.ref_in_conv(r.permute(0, 3, 1, 2))
        hs_ref, enc_qkv = [hr], []
        for rname, aname, counted in self._ref_enc:
            hr = self._res(rname, hr, emb)
            if counted:
                qkv = None
                if aname is not None:
                    hr, qkv = getattr(self, aname)(hr)
                enc_qkv.append(qkv)
            hs_ref.append(hr)
        r0, a0, r1 = self._ref_mid
        hr, mid_qkv = getattr(self, a0)(self._res(r0, hr, emb))
        hr = self._res(r1, hr, emb)

        # main tower: encoder and middle
        h = self.in_conv(x.to(self.dtype).permute(0, 3, 1, 2))
        hs, qi = [h], 0
        for rname, aname, counted in self._enc:
            h = self._res(rname, h, emb)
            if aname is not None:
                h, _ = getattr(self, aname)(h, enc_qkv[qi])
            qi += counted
            hs.append(h)
        r0, a0, r1 = self._mid
        h, _ = getattr(self, a0)(self._res(r0, h, emb), mid_qkv)
        h = self._res(r1, h, emb)

        # ref tower: decoder until the terminal site
        dec_qkv = []
        for rname, aname, up in self._ref_dec:
            hr = torch.cat([hr, hs_ref.pop().to(hr.dtype)], dim=1)
            hr = self._res(rname, hr, emb)
            qkv = None
            if aname is not None:
                out, qkv = getattr(self, aname)(hr)
                if out is not None:
                    hr = out
            dec_qkv.append(qkv)
            if up is not None:
                hr = self._res(up, hr, emb)

        # main tower: decoder
        for qi, (rname, aname, up) in enumerate(self._dec):
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            h = self._res(rname, h, emb)
            if aname is not None:
                h, _ = getattr(self, aname)(
                    h, dec_qkv[qi] if qi < len(dec_qkv) else None)
            if up is not None:
                h = self._res(up, h, emb)
        out = self.out_proj(F.silu(self.GroupNorm32_0(h)))
        return out.float().permute(0, 2, 3, 1)
