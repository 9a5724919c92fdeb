"""HAT, the hybrid attention transformer of ``G_netG: hat``
(``joligen_tpu/models/modules/hat.py``).

A 3×3 ``conv_first``, ``patch_norm``, then residual hybrid attention groups
(``RHAG``: ``depth`` ``HAB``s, an ``OCAB`` and a 3×3 conv, with the group's
residual), ``norm``, ``conv_after_body`` plus the first conv's output,
``conv_before_upsample`` and a leaky ReLU, a pixel-shuffle upsampler (none
at the factory's ``upscale`` 1) and ``conv_last``. The factory's HAT has
embed_dim 96, 4 groups of 6 blocks of 6 heads, windows of 16 (clamped to
min(H, W) without a shift where the image is no larger, ``hat.py:
335-341``).

- ``HAB``: LayerNorm; the conv branch ``CAB`` (3×3 to C/3, GELU, 3×3,
  channel attention) times ``conv_scale``; window attention with the
  learned relative-position bias ``rpb`` indexed by ``calculate_rpi_sa``,
  on odd blocks over windows shifted by w/2 with the seam mask
  (``calculate_mask``, -100 between regions); then LayerNorm and the MLP.
  Drop path is off: the GAN models call the generator deterministic, as
  in the JAX package.
- ``OCAB``: queries of the w×w windows against keys and values of the
  overlapping (1.5 w)² windows (``F.unfold``, channel-major as the JAX
  package's ``conv_general_dilated_patches``), its own ``rpb`` indexed by
  ``calculate_rpi_oca``; the projection's residual, LayerNorm and the MLP
  at the group's ratio.

``remat`` (``tpu_remat``) runs each group under ``torch.utils.checkpoint``
when a gradient is taken: a graph of the factory's HAT at 256 px holds
~32 GB an image, and a CUT step takes four (G on A and on B, and the NCE
taps of both outputs), so the step fits on one card at batch 1 only with
it. The JAX package's HAT has no remat; the values are the same.

Scores take fp32 (logits, biases, softmax) and probabilities the value's
dtype; attention is plain torch ops, as in the JAX package, which reaches
no kernel here. LayerNorms take fp32 statistics (``vit_layers.
LayerNorm``). Tokens are (B, H·W, C) as in the JAX package; the convs run
NCHW. Modules carry the flax names (``rhag2.hab5.attn.rpb``,
``rhag0.ocab.qkv``...); ``rpb`` is a raw leaf (``models/convert.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...utils.vit_layers import LayerNorm
from .mat import shift_attn_bias_np, window_partition, window_reverse
from .resnet_generator import Conv
from .unet_mha import Dense

# the seam mask of shifted windows and the window partition are MAT's:
# (nW, n, n) of {0, -100}; (B, H, W, C) <-> (B * nW, w * w, C)
calculate_mask = shift_attn_bias_np


def calculate_rpi_sa(wsz):
    """Swin's relative-position index of a w×w window, (n, n) int."""
    coords = np.stack(np.meshgrid(np.arange(wsz), np.arange(wsz),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wsz - 1
    rel[:, :, 1] += wsz - 1
    rel[:, :, 0] *= 2 * wsz - 1
    return rel.sum(-1)


def calculate_rpi_oca(wsz, owsz):
    """The index between a w×w window and its overlapping ow×ow window,
    (w², ow²) int."""
    co = np.stack(np.meshgrid(np.arange(wsz), np.arange(wsz),
                              indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(owsz), np.arange(owsz),
                              indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0)
    rel[:, :, 0] += wsz - owsz + 1
    rel[:, :, 1] += wsz - owsz + 1
    rel[:, :, 0] *= wsz + owsz - 1
    return rel.sum(-1)


def _attend(q, k, v, bias, mask=None):
    """softmax(q kᵀ + bias (+ mask)) v over (B', heads, n, d): fp32 scores,
    probabilities in v's dtype. ``mask`` (nW, n, m) repeats over the
    batch."""
    attn = torch.matmul(q, k.transpose(-1, -2)).float() + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, *attn.shape[1:])
                + mask[None, :, None]).reshape(attn.shape)
    return torch.matmul(torch.softmax(attn, dim=-1).to(v.dtype), v)


def _nchw_conv(conv, x, h, w):
    """A conv over (B, H·W, C) tokens; returns tokens."""
    b, _, c = x.shape
    y = conv(x.transpose(1, 2).reshape(b, c, h, w))
    return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, channels, hidden, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(channels, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, channels, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CAB(nn.Module):
    """Conv block with channel attention (``hat.py:93-113``), NCHW."""

    def __init__(self, channels, compress_ratio=3, squeeze_factor=30,
                 dtype=torch.float32):
        super().__init__()
        c = channels
        self.conv1 = Conv(c, c // compress_ratio, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(c // compress_ratio, c, 3, padding=1, dtype=dtype)
        self.ca1 = Conv(c, max(1, c // squeeze_factor), 1, dtype=dtype)
        self.ca2 = Conv(max(1, c // squeeze_factor), c, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv2(F.gelu(self.conv1(x)))
        s = self.ca2(F.relu(self.ca1(h.mean(dim=(2, 3), keepdim=True))))
        return h * torch.sigmoid(s)


class WindowAttention(nn.Module):
    """W-MSA with the relative-position bias (``hat.py:116-145``) over
    (B·nW, n, C)."""

    def __init__(self, channels, wsz, num_heads, dtype=torch.float32):
        super().__init__()
        self.heads = num_heads
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.rpb = nn.Parameter(torch.zeros((2 * wsz - 1) ** 2, num_heads))
        self.proj = Dense(channels, channels, dtype=dtype)

    def forward(self, x, rpi, mask=None):
        b_, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b_, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (hd ** -0.5), qkv[1], qkv[2]
        bias = self.rpb[rpi.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
        out = _attend(q, k, v, bias, mask)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class HAB(nn.Module):
    """Hybrid attention block (``hat.py:148-200``)."""

    def __init__(self, channels, num_heads, wsz, conv_scale=0.01,
                 compress_ratio=3, squeeze_factor=30, mlp_ratio=4.0,
                 dtype=torch.float32):
        super().__init__()
        self.conv_scale = conv_scale
        self.dtype = dtype
        self.norm1 = LayerNorm(channels, 1e-5)
        self.conv_block = CAB(channels, compress_ratio, squeeze_factor,
                              dtype=dtype)
        self.attn = WindowAttention(channels, wsz, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(channels, 1e-5)
        self.mlp = Mlp(channels, int(channels * mlp_ratio), dtype=dtype)

    def forward(self, x, hw, wsz, shift, rpi, mask):
        h, w = hw
        b, _, c = x.shape
        y = self.norm1(x).to(self.dtype)
        conv_x = self.conv_block(y.transpose(1, 2).reshape(b, c, h, w))
        conv_x = conv_x.flatten(2).transpose(1, 2)
        ys = y.reshape(b, h, w, c)
        if shift > 0:
            ys = torch.roll(ys, (-shift, -shift), dims=(1, 2))
        else:
            mask = None
        wins = self.attn(window_partition(ys, wsz), rpi, mask)
        ys = window_reverse(wins, wsz, h, w)
        if shift > 0:
            ys = torch.roll(ys, (shift, shift), dims=(1, 2))
        x = x + ys.reshape(b, h * w, c) + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x).to(self.dtype))


class OCAB(nn.Module):
    """Overlapping cross-attention block (``hat.py:203-256``)."""

    def __init__(self, channels, num_heads, wsz, overlap_ratio=0.5,
                 mlp_ratio=2.0, dtype=torch.float32):
        super().__init__()
        self.heads, self.dtype = num_heads, dtype
        self.overlap_ratio = overlap_ratio
        owsz = int(wsz * overlap_ratio) + wsz
        self.norm1 = LayerNorm(channels, 1e-5)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.rpb = nn.Parameter(torch.zeros((wsz + owsz - 1) ** 2,
                                            num_heads))
        self.proj = Dense(channels, channels, dtype=dtype)
        self.norm2 = LayerNorm(channels, 1e-5)
        self.mlp = Mlp(channels, int(channels * mlp_ratio), dtype=dtype)

    def forward(self, x, hw, wsz, rpi):
        h, w = hw
        b, _, c = x.shape
        owsz, heads = int(wsz * self.overlap_ratio) + wsz, self.heads
        hd = c // heads
        pad = (owsz - wsz) // 2
        y = self.norm1(x).to(self.dtype).reshape(b, h, w, c)
        q, kk, vv = torch.chunk(self.qkv(y), 3, dim=-1)
        q_wins = window_partition(q, wsz)                    # (b', n, c)
        kv = torch.cat([kk, vv], dim=-1).permute(0, 3, 1, 2)
        patches = F.unfold(kv, owsz, stride=wsz, padding=pad)
        m, nwin = owsz * owsz, patches.shape[-1]
        patches = patches.reshape(b, 2, c, m, nwin).permute(1, 0, 4, 3, 2)
        k_wins, v_wins = patches.reshape(2, b * nwin, m, c)
        b_, nq, _ = q_wins.shape
        qh = q_wins.reshape(b_, nq, heads, hd).transpose(1, 2)
        kh = k_wins.reshape(b_, m, heads, hd).transpose(1, 2)
        vh = v_wins.reshape(b_, m, heads, hd).transpose(1, 2)
        bias = self.rpb[rpi.reshape(-1)].reshape(nq, m, -1).permute(2, 0, 1)
        out = _attend(qh * (hd ** -0.5), kh, vh, bias)
        out = out.transpose(1, 2).reshape(b_, nq, c)
        out = window_reverse(out, wsz, h, w).reshape(b, h * w, c)
        x = self.proj(out) + x
        return x + self.mlp(self.norm2(x).to(self.dtype))


class RHAG(nn.Module):
    """Residual hybrid attention group (``hat.py:259-294``): ``depth`` HABs
    (odd ones shifted where there is a mask), the OCAB at the group's MLP
    ratio, a 3×3 conv, the group's residual."""

    def __init__(self, channels, depth, num_heads, wsz, overlap_ratio=0.5, conv_scale=0.01, compress_ratio=3,
                 squeeze_factor=30, mlp_ratio=4.0, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"hab{i}", HAB(
                channels, num_heads, wsz, conv_scale, compress_ratio,
                squeeze_factor, mlp_ratio, dtype=dtype))
        self.ocab = OCAB(channels, num_heads, wsz, overlap_ratio, mlp_ratio,
                         dtype=dtype)
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x, hw, wsz, shift, rpi_sa, rpi_oca, mask):
        res = x
        for i in range(self.depth):
            x = getattr(self, f"hab{i}")(x, hw, wsz,
                                         0 if i % 2 == 0 else shift,
                                         rpi_sa, mask)
        x = self.ocab(x, hw, wsz, rpi_oca)
        return _nchw_conv(self.conv, x, *hw) + res


def pixel_shuffle(x, r):
    """torch's PixelShuffle on NHWC: (b, h, w, C·r²) -> (b, h·r, w·r, C)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


class HAT(nn.Module):
    """``forward(x NHWC)`` -> NHWC fp32 (see the module doc);
    ``extract_layer_ids``: the NHWC outputs of those groups, all of them
    where an id is out of range (CUT's NCE taps); ``with_features``: the
    pair (output, taps)."""

    def __init__(self, in_channels=3, out_channels=3, img_size=256,
                 embed_dim=96, depths=(6, 6, 6, 6), num_heads=(6, 6, 6, 6),
                 window_size=16, compress_ratio=3, squeeze_factor=30,
                 conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=4.0,
                 upscale=1, num_feat=64, remat=False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.embed_dim, self.window_size = embed_dim, window_size
        self.overlap_ratio = overlap_ratio
        self.n_groups = len(depths)
        self._tables = {}
        self.conv_first = Conv(in_channels, embed_dim, 3, padding=1,
                               dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, 1e-5)
        # the bias tables take the window of an img_size input, as flax
        # sizes them at its init call
        wsz = min(window_size, img_size)
        for gi, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, f"rhag{gi}", RHAG(
                embed_dim, depth, heads, wsz, overlap_ratio, conv_scale,
                compress_ratio, squeeze_factor, mlp_ratio, dtype=dtype))
        self.norm = LayerNorm(embed_dim, 1e-5)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3, padding=1,
                                    dtype=dtype)
        self.conv_before_upsample = Conv(embed_dim, num_feat, 3, padding=1,
                                         dtype=dtype)
        self.ups = []
        s, ui = upscale, 0
        while s > 1:
            r = 3 if s == 3 else 2
            setattr(self, f"up{ui}", Conv(num_feat, num_feat * r * r, 3,
                                          padding=1, dtype=dtype))
            self.ups.append((f"up{ui}", r))
            s //= r
            ui += 1
        self.conv_last = Conv(num_feat, out_channels, 3, padding=1,
                              dtype=dtype)

    def _windows(self, hh, ww, device):
        """(window, shift, rpi_sa, rpi_oca, mask) at an H×W input; the
        window clamps to min(H, W), unshifted, where the image is no
        larger."""
        key = (hh, ww, device)
        if key not in self._tables:
            wsz = self.window_size
            clamped = min(hh, ww) <= wsz
            if clamped:
                wsz = min(hh, ww)
            shift = 0 if clamped else wsz // 2
            owsz = int(wsz * self.overlap_ratio) + wsz

            def index(a):
                return torch.from_numpy(np.asarray(a, np.int64)).to(device)
            mask = (torch.from_numpy(calculate_mask(hh, ww, wsz, shift))
                    .to(device) if shift else None)
            self._tables[key] = (wsz, shift, index(calculate_rpi_sa(wsz)),
                                 index(calculate_rpi_oca(wsz, owsz)), mask)
        return self._tables[key]

    def _taps(self, layer_ids):
        if all(0 <= i < self.n_groups for i in layer_ids):
            return list(layer_ids)
        return list(range(self.n_groups))

    def layer_channels(self, layer_ids):
        return [self.embed_dim for _ in self._taps(layer_ids)]

    def forward(self, x, extract_layer_ids=None, with_features=None):
        b, hh, ww, _ = x.shape
        wsz, shift, rpi_sa, rpi_oca, mask = self._windows(hh, ww, x.device)
        first = self.conv_first(x.to(self.dtype).permute(0, 3, 1, 2))
        h = self.patch_norm(first.flatten(2).transpose(1, 2)).to(self.dtype)
        feats = []
        for gi in range(self.n_groups):
            group = functools.partial(getattr(self, f"rhag{gi}"),
                                      hw=(hh, ww), wsz=wsz, shift=shift,
                                      rpi_sa=rpi_sa, rpi_oca=rpi_oca,
                                      mask=mask)
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(group, h, use_reentrant=False)
            else:
                h = group(h)
            feats.append(h.reshape(b, hh, ww, self.embed_dim))
        taps = extract_layer_ids if extract_layer_ids is not None \
            else with_features
        if taps is not None:
            feats = [feats[i] for i in self._taps(taps)]
            if extract_layer_ids is not None:
                return feats
        h = self.norm(h).to(self.dtype)
        h = _nchw_conv(self.conv_after_body, h, hh, ww)
        h = h.transpose(1, 2).reshape(b, self.embed_dim, hh, ww) + first
        h = F.leaky_relu(self.conv_before_upsample(h), 0.01)
        for name, r in self.ups:
            h = getattr(self, name)(h).permute(0, 2, 3, 1)
            h = pixel_shuffle(h, r).permute(0, 3, 1, 2)
        out = self.conv_last(h).float().permute(0, 2, 3, 1)
        return (out, feats) if with_features is not None else out
