"""MAT, the Mask-Aware Transformer inpainting generator and its two-trunk
StyleGAN2 discriminator (``joligen_tpu/models/modules/mat.py``), image and
video paths.

Layers run NCHW inside; the public edges (``MATGenerator``,
``MATDiscriminator``) take and return NHWC, as the JAX package does. Every
module carries the flax names of the JAX file, so a state-dict key is the
flax path; MAT's flax leaves are named ``weight`` (HWIO convs, (in, out)
dense layers, stored here OIHW and (out, in)) and ``noise_strength`` (0-D),
which ``models/convert.py`` maps with ``weight_leaves`` (each net sets
``flax_weight_leaves``).

Masks follow MAT's convention: 1 = known pixel, 0 = hole.

Random sites take their values as tensors (``MATGenerator.draw_noise``,
``draw_mix``, or fed draws): the first stage's and the bottleneck's
``mul_map`` and the decoder's noise (``noise``: None draws nothing, the
maps are then 0.5), and style mixing's second latent, coin and crossover
(``mix``).

Window attention is plain torch (bf16 products, fp32 softmax): its -100
soft key bias and head dim 30 fit no flash kernel, so no kernel of the
port runs on the image path.

Video MAT (``alg_mat_motion``: ``frames`` > 1 and a 5-D clip (B, F, H, W,
C)): the first stage and the encoder run on every frame (the frames folded
into the batch, one z a clip), a ``motion.MotionModule`` (``motion``) mixes
the 16 x 16 bottleneck over the frames, and only the last frame is
decoded, with the skips and the stage-1 output of the last frame and the
w of frame 0; the history frames come back as they went in. The motion
module's temporal attention runs through the flash-attention kernels (K1,
K2/K3 in the backward): (B * 256, F, heads, 512 / heads) at base 64, head
dim 64 at the options' 8 heads, 128 at 4. A 4-D batch takes the image path
whatever ``frames`` is, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import nearest_up2, resize_bilinear
from ...ops.upfirdn2d import setup_filter, upfirdn2d

SQRT2 = math.sqrt(2.0)
_FIR = setup_filter([1, 3, 3, 1])
_FIR_CACHE = {}
_BIAS_CACHE = {}


def lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


def nf(stage, base=64, div=1):
    """Channel table: min(32768 / 2^stage, 512) scaled by base / 64 and an
    optional divisor (the stg1 D trunk runs at half width)."""
    return max(int(min(32768 // (2 ** stage), 512)) * base // (64 * div), 8)


def _fir(x):
    """The [1, 3, 3, 1] FIR table on ``x``'s device and dtype."""
    key = (x.device, x.dtype)
    if key not in _FIR_CACHE:
        _FIR_CACHE[key] = _FIR.to(device=x.device, dtype=x.dtype)
    return _FIR_CACHE[key]


def blur_up(x):
    """Antialiased 2x upsample (a constant image stays constant)."""
    return upfirdn2d(x, _fir(x), up=2, padding=(2, 1, 2, 1))


def blur_down(x):
    return upfirdn2d(x, _fir(x), down=2, padding=(1, 1, 1, 1))


# The resampling convs keep the JAX op order, boundary pixels included:
#   down, k > 1: the FIR at full resolution (pad k//2 + 1), then a stride-2
#                VALID conv; k = 1: decimate first;
#   up,   k > 1: the zero-stuffed (2H - 1) input padded by k - 1 under the
#                unflipped kernel, which is conv_transpose2d over the
#                flipped, in/out-swapped kernel with no padding; then the
#                FIR with gain 4 and pads (k//2 + 2 - (k-1), k//2 + 1 -
#                (k-2)); k = 1: conv first, then the blur.

def _conv_plain(x, w, k):
    return F.conv2d(x, w, padding=k // 2)


def _conv_down2(x, w, k):
    if k == 1:
        return _conv_plain(blur_down(x), w, k)
    p = k // 2 + 1
    return F.conv2d(upfirdn2d(x, _fir(x), padding=(p, p, p, p)), w,
                    stride=2)


def _conv_up2(x, w, k):
    if k == 1:
        return blur_up(_conv_plain(x, w, k))
    y = F.conv_transpose2d(x, w.transpose(0, 1).flip(2, 3), stride=2)
    p0, p1 = k // 2 + 2 - (k - 1), k // 2 + 1 - (k - 2)
    return upfirdn2d(y, _fir(y), padding=(p0, p1, p0, p1), gain=4.0)


def _resample(x, w, k, up, down):
    if up:
        return _conv_up2(x, w, k)
    if down:
        return _conv_down2(x, w, k)
    return _conv_plain(x, w, k)


class EqualDense(nn.Module):
    """Equalized-lr dense: the fp32 weight scaled by lr_mul / sqrt(in),
    then cast to the input's dtype. Init: N(0, 1 / lr_mul), bias
    ``bias_init``."""

    def __init__(self, in_f, features, lr_mul=1.0, bias_init=0.0, act=False):
        super().__init__()
        self.in_f, self.lr_mul, self.bias_init = in_f, lr_mul, bias_init
        self.act = act
        self.weight = nn.Parameter(torch.empty(features, in_f))
        self.bias = nn.Parameter(torch.empty(features))

    def reset(self, g):
        self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=g)
        self.bias.fill_(self.bias_init)

    def forward(self, x):
        w = (self.weight * (self.lr_mul / math.sqrt(self.in_f))).to(x.dtype)
        y = F.linear(x, w, (self.bias * self.lr_mul).to(x.dtype))
        return lrelu(y) if self.act else y


class MappingNet(nn.Module):
    """z -> w: normalised z through 8 equalized dense layers at lr_mul
    0.01, in fp32."""

    def __init__(self, z_dim=512, w_dim=512, num_layers=8):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", EqualDense(z_dim if i == 0 else w_dim,
                                                 w_dim, lr_mul=0.01,
                                                 act=True))

    def forward(self, z):
        x = z * torch.rsqrt(torch.mean(z ** 2, dim=-1, keepdim=True) + 1e-8)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        return x


class ModulatedConv(nn.Module):
    """StyleGAN2 modulated conv: the inputs scaled by the style (one shared
    kernel), demodulated in fp32 from the fp32 weight,
    rsqrt(s^2 @ sum(w^2) + 1e-8). The affine's bias starts at 1."""

    def __init__(self, cin, features, style_dim, kernel=3, demodulate=True,
                 up=False, down=False):
        super().__init__()
        self.k, self.cin = kernel, cin
        self.demodulate, self.up, self.down = demodulate, up, down
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.affine = EqualDense(style_dim, cin, bias_init=1.0)
        self.bias = nn.Parameter(torch.empty(features))

    def reset(self, g):
        self.weight.normal_(0.0, 1.0, generator=g)
        self.bias.zero_()

    def forward(self, x, style):
        weight = self.weight / math.sqrt(self.k * self.k * self.cin)
        s = self.affine(style)                                  # (N, cin)
        xs = x * s[:, :, None, None].to(x.dtype)
        y = _resample(xs, weight.to(x.dtype), self.k, self.up, self.down)
        if self.demodulate:
            wsq = torch.sum(weight.float() ** 2, dim=(2, 3))     # (out, in)
            d = torch.rsqrt((s.float() ** 2) @ wsq.t() + 1e-8)
            y = y * d[:, :, None, None].to(y.dtype)
        return y + self.bias.to(y.dtype)[None, :, None, None]


class NoiseInject(nn.Module):
    """x + noise * strength; ``noise`` (N, 1, H, W) or None (no noise)."""

    def __init__(self):
        super().__init__()
        self.noise_strength = nn.Parameter(torch.empty(()))

    def reset(self, g):
        self.noise_strength.zero_()

    def forward(self, x, noise=None):
        if noise is None:
            return x
        return x + noise.to(x.dtype) * self.noise_strength.to(x.dtype)


class StyleConv(nn.Module):
    """Modulated conv, optional noise, lrelu."""

    def __init__(self, cin, features, style_dim, up=False, use_noise=True):
        super().__init__()
        self.use_noise = use_noise
        self.conv = ModulatedConv(cin, features, style_dim, up=up)
        if use_noise:
            self.noise = NoiseInject()

    def forward(self, x, style, noise=None):
        y = self.conv(x, style)
        if self.use_noise:
            y = self.noise(y, noise)
        return lrelu(y)


class ToRGB(nn.Module):
    def __init__(self, cin, channels, style_dim):
        super().__init__()
        self.conv = ModulatedConv(cin, channels, style_dim, kernel=1,
                                  demodulate=False)

    def forward(self, x, style, img=None):
        y = self.conv(x, style)
        if img is not None:
            y = y + blur_up(img)
        return y


class EqualConv(nn.Module):
    """Equalized-lr conv with optional blur-resampling, bias, lrelu and a
    post-activation gain. Init: N(0, 1), bias 0."""

    def __init__(self, cin, features, kernel=3, down=False, up=False,
                 act=True, use_bias=True, gain=1.0):
        super().__init__()
        self.k, self.cin = kernel, cin
        self.down, self.up, self.act, self.gain = down, up, act, gain
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset(self, g):
        self.weight.normal_(0.0, 1.0, generator=g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        w = (self.weight / math.sqrt(self.k * self.k * self.cin)).to(x.dtype)
        y = _resample(x, w, self.k, self.up, self.down)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        y = lrelu(y) if self.act else y
        return y * self.gain if self.gain != 1.0 else y


class PartialConv(nn.Module):
    """Mask-aware conv: the input convolved unmasked, the output scaled by
    k^2 / coverage * clamp01(coverage) after the activation; the new mask
    is clamp01(coverage). The coverage is a k x k box sum of the (nearest
    upsampled, for ``up``) mask at the conv's stride. Odd kernels only."""

    def __init__(self, cin, features, kernel=3, down=False, up=False):
        super().__init__()
        assert kernel % 2 == 1, "PartialConv requires an odd kernel"
        self.k, self.down, self.up = kernel, down, up
        self.conv = EqualConv(cin, features, kernel, down=down, up=up)

    def forward(self, x, mask=None):
        """x (N, C, H, W); mask (N, 1, H, W) or None."""
        if mask is None:
            return self.conv(x), None
        k = self.k
        m = mask.to(x.dtype)
        if self.up:
            m = nearest_up2(m.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        ones = torch.ones(1, 1, k, k, dtype=x.dtype, device=x.device)
        cov = F.conv2d(m, ones, stride=2 if self.down else 1, padding=k // 2)
        ratio = (k * k) / (cov + 1e-8)
        new_mask = torch.clamp(cov, 0.0, 1.0)
        y = self.conv(x)
        return y * (ratio * new_mask).to(y.dtype), new_mask


# --------------------------------------------------------------------------
# The first stage's Swin token pyramid
# --------------------------------------------------------------------------

def window_partition(x, ws):
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x, ws, h, w):
    """(B * nW, ws * ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_attn_bias_np(h, w, ws, shift):
    """(nW, N, N) 0 / -100 bias between the regions of shifted windows."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _shift_attn_bias(h, w, ws, shift, device):
    key = (h, w, ws, shift, device)
    if key not in _BIAS_CACHE:
        _BIAS_CACHE[key] = torch.from_numpy(
            shift_attn_bias_np(h, w, ws, shift)).to(device)
    return _BIAS_CACHE[key]


class WindowAttention(nn.Module):
    """Windowed MSA: q and k over tokens L2-normalised by rsqrt(sum + 1e-12)
    in fp32 (a hole token is exactly zero, where x / |x| has a NaN
    gradient); logits in the compute dtype over sqrt(hd), the shift bias
    and the -100 bias of invalid keys added in that dtype; softmax in fp32.
    A window with any valid token becomes valid."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, EqualDense(dim, dim))

    def forward(self, xw, mask_windows=None, attn_bias=None, n_windows=1):
        bw, n, c = xw.shape
        nh = self.num_heads
        hd = c // nh
        xf = xw.float()
        sq = torch.sum(xf ** 2, dim=-1, keepdim=True)
        norm_x = (xf * torch.rsqrt(sq + 1e-12)).to(xw.dtype)

        def heads(t):
            return t.reshape(bw, n, nh, hd).transpose(1, 2)
        q, k, v = heads(self.q(norm_x)), heads(self.k(norm_x)), heads(
            self.v(xw))
        logits = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        if attn_bias is not None:
            logits = (logits.reshape(bw // n_windows, n_windows, nh, n, n)
                      + attn_bias[None, :, None].to(logits.dtype))
            logits = logits.reshape(bw, nh, n, n)
        new_mask = None
        if mask_windows is not None:
            keyb = torch.where(mask_windows[..., 0] > 0, 0.0, -100.0)
            logits = logits + keyb[:, None, None, :].to(logits.dtype)
            new_mask = torch.clamp(torch.sum(mask_windows, dim=1,
                                             keepdim=True), 0.0, 1.0) \
                * torch.ones_like(mask_windows)
        p = torch.softmax(logits.float(), dim=-1).to(xw.dtype)
        out = (p @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out), new_mask


class SwinBlock(nn.Module):
    """[Shifted-]window attention, fuse = lrelu(dense([shortcut, attn])),
    then a 2x MLP; no norm and no residual. Shifts (by ``roll``) only when
    the window is smaller than the grid."""

    def __init__(self, dim, num_heads, h, w, window_size, shift_size):
        super().__init__()
        self.h, self.w = h, w
        self.ws = min(window_size, h, w)
        self.shift = shift_size if self.ws < min(h, w) else 0
        self.attn = WindowAttention(dim, num_heads)
        self.fuse = EqualDense(2 * dim, dim, act=True)
        self.mlp_fc1 = EqualDense(dim, 2 * dim, act=True)
        self.mlp_fc2 = EqualDense(2 * dim, dim)

    def forward(self, x, mask=None):
        """x (B, H*W, C) tokens; mask (B, H*W, 1), 1 = valid, or None."""
        b, L, c = x.shape
        h, w, ws, shift = self.h, self.w, self.ws, self.shift
        shortcut = x
        xg = x.reshape(b, h, w, c)
        mg = mask.reshape(b, h, w, 1) if mask is not None else None
        if shift > 0:
            xg = torch.roll(xg, (-shift, -shift), dims=(1, 2))
            if mg is not None:
                mg = torch.roll(mg, (-shift, -shift), dims=(1, 2))
        xw = window_partition(xg, ws)
        mw = window_partition(mg, ws) if mg is not None else None
        bias = (_shift_attn_bias(h, w, ws, shift, x.device) if shift > 0
                else None)
        aw, mw = self.attn(xw, mask_windows=mw, attn_bias=bias,
                           n_windows=(h // ws) * (w // ws))
        xg = window_reverse(aw, ws, h, w)
        if mw is not None:
            mg = window_reverse(mw, ws, h, w)
        if shift > 0:
            xg = torch.roll(xg, (shift, shift), dims=(1, 2))
            if mg is not None:
                mg = torch.roll(mg, (shift, shift), dims=(1, 2))
        x = xg.reshape(b, L, c)
        new_mask = mg.reshape(b, L, 1) if mg is not None else None
        x = self.fuse(torch.cat([shortcut, x], dim=-1))
        return self.mlp_fc2(self.mlp_fc1(x)), new_mask


def _nchw(t, h, w):
    """(B, H*W, C) tokens -> (B, C, H, W)."""
    return t.reshape(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2)


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


class BasicLayerMAT(nn.Module):
    """One pyramid stage: an optional partial-conv merge (down) or upsample
    (up), ``depth`` Swin blocks with alternating shift, then a partial conv
    plus the identity. ``h``, ``w``: the grid before the resample."""

    def __init__(self, dim, depth, num_heads, h, w, window_size,
                 resample=""):
        super().__init__()
        self.dim, self.depth, self.resample = dim, depth, resample
        self.h_in, self.w_in = h, w
        if resample:
            self.merge = PartialConv(dim, dim, down=resample == "down",
                                     up=resample == "up")
            f = 2 if resample == "up" else 0.5
            h, w = int(h * f), int(w * f)
        self.h, self.w = h, w
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(
                dim, num_heads, h, w, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2))
        self.conv = PartialConv(dim, dim)

    def forward(self, x, mask=None):
        if self.resample:
            feat = _nchw(x, self.h_in, self.w_in)
            mfeat = (_nchw(mask, self.h_in, self.w_in) if mask is not None
                     else None)
            feat, mfeat = self.merge(feat, mfeat)
            x = _tokens(feat)
            mask = _tokens(mfeat) if mfeat is not None else None
        identity = x
        for i in range(self.depth):
            x, mask = getattr(self, f"block{i}")(x, mask)
        mfeat = _nchw(mask, self.h, self.w) if mask is not None else None
        feat, mfeat = self.conv(_nchw(x, self.h, self.w), mfeat)
        x = _tokens(feat) + identity
        mask = _tokens(mfeat) if mfeat is not None else None
        return x, (self.h, self.w), mask


class FirstStage(nn.Module):
    """Coarse inpainting stage: partial-conv encoder to the coarse grid
    (min(64, size)), the 5-stage Swin token pyramid (r, r/2, r/4, r/2, r
    with token skips; the mask through the contracting half), style fusion
    at the bottleneck (w-derived spatial code blended by ``mul_map``,
    ToStyle by conv-pooling), a style-modulated decoder to the input size
    (or one ToRGB where coarse is the input size), the known pixels
    composed back and clamped."""

    DEPTHS = (2, 3, 4, 3, 2)
    RATIOS = (1, 0.5, 0.5, 2, 2)

    def __init__(self, size, cin, channels, w_dim=512, dim=180, num_heads=6,
                 window_sizes=(8, 16, 16, 16, 8)):
        super().__init__()
        self.dim = dim
        self.coarse = min(64, size)
        self.down_time = int(math.log2(size // self.coarse))
        self.conv_first = PartialConv(cin, dim)
        for i in range(self.down_time):
            self.add_module(f"enc_conv{i}", PartialConv(dim, dim, down=True))
        self.mid = len(self.DEPTHS) // 2
        res = self.coarse
        for i, depth in enumerate(self.DEPTHS):
            r = self.RATIOS[i]
            resample = "down" if r < 1 else "up" if r > 1 else ""
            self.add_module(f"tran{i}", BasicLayerMAT(
                dim, depth, num_heads, res, res,
                min(window_sizes[i], int(res * r)), resample=resample))
            res = int(res * r)
            if i == self.mid:
                self.mid_res = res
                self.ws_style = EqualDense(w_dim, dim, act=True)
                self.to_square = EqualDense(dim, res * res, act=True)
                self.n_down = int(math.log2(res))
                for j in range(self.n_down):
                    self.add_module(f"down_conv{j}",
                                    EqualConv(dim, dim, down=True))
                self.to_style = EqualDense(dim, 2 * dim, act=True)
        style_dim = 3 * dim
        for i in range(self.down_time):
            self.add_module(f"dec{i}a", StyleConv(dim, dim, style_dim, up=True,
                                                  use_noise=False))
            self.add_module(f"dec{i}b", StyleConv(dim, dim, style_dim,
                                                  use_noise=False))
            self.add_module(f"dec{i}rgb", ToRGB(dim, channels, style_dim))
        if self.down_time == 0:
            self.to_rgb = ToRGB(dim, channels, style_dim)

    def forward(self, img, mask, w, mul_map=None, mask_class=None):
        """img (B, C, H, W) and mask (B, 1, H, W) in the compute dtype; w
        (B, w_dim) fp32; ``mul_map`` (B, L, dim) at the bottleneck, or None
        (0.5)."""
        b, dim = img.shape[0], self.dim
        parts = [mask.to(img.dtype) - 0.5, img * mask]
        if mask_class is not None:
            parts.append(mask_class.to(img.dtype))
        x = torch.cat(parts, dim=1)
        conv_skips = []
        h, m = self.conv_first(x, mask)
        conv_skips.append(h)
        for i in range(self.down_time):
            h, m = getattr(self, f"enc_conv{i}")(h, m)
            if i != self.down_time - 1:
                conv_skips.append(h)
        t, tm = _tokens(h), _tokens(m)
        token_skips, style, res = [], None, self.coarse
        for i in range(len(self.DEPTHS)):
            layer = getattr(self, f"tran{i}")
            if i < self.mid:
                t, (res, _), tm = layer(t, tm)
                token_skips.append(t)
            elif i == self.mid:
                t, (res, _), tm = layer(t, None)
                ws_s = self.ws_style(w)
                add_n = self.to_square(ws_s)[:, :, None].to(t.dtype)
                if mul_map is None:
                    mul_map = torch.full_like(t, 0.5)
                mul_map = mul_map.to(t.dtype)
                t = t * mul_map + add_n * (1 - mul_map)
                g = _nchw(t, res, res)
                for j in range(self.n_down):
                    g = getattr(self, f"down_conv{j}")(g)
                gs = self.to_style(torch.mean(g, dim=(2, 3)))
                dt = torch.promote_types(gs.dtype, ws_s.dtype)
                style = torch.cat([gs.to(dt), ws_s.to(dt)], dim=-1)
            else:
                t, (res, _), tm = layer(t, None)
                t = t + token_skips[self.mid - i]
        h = _nchw(t, res, res)
        img_out = None
        for i in range(self.down_time):
            h = getattr(self, f"dec{i}a")(h, style)
            h = h + conv_skips[self.down_time - 1 - i]
            h = getattr(self, f"dec{i}b")(h, style)
            img_out = getattr(self, f"dec{i}rgb")(h, style, img_out)
        if img_out is None:
            img_out = self.to_rgb(h, style)
        out = img_out * (1 - mask) + img * mask
        return torch.clamp(out, -1.0, 1.0)


# --------------------------------------------------------------------------
# The second stage
# --------------------------------------------------------------------------

class Encoder(nn.Module):
    """1x1 + 3x3 at the input size, then a 3x3 down + 3x3 per octave to the
    16 px bottleneck (an input below 16 px stops at its own size). Returns
    (bottleneck, {res_log2: feature})."""

    def __init__(self, size, cin, base=64):
        super().__init__()
        self.res_log2 = int(math.log2(size))
        self.bottom = min(4, self.res_log2)
        prev = cin
        for i in range(self.res_log2, self.bottom - 1, -1):
            ch = nf(i, base)
            if i == self.res_log2:
                c0 = EqualConv(prev, ch, kernel=1)
            else:
                c0 = EqualConv(prev, ch, down=True)
            self.add_module(f"enc{i}_c0", c0)
            self.add_module(f"enc{i}_c1", EqualConv(ch, ch))
            prev = ch

    def forward(self, x):
        feats, h = {}, x
        for i in range(self.res_log2, self.bottom - 1, -1):
            h = getattr(self, f"enc{i}_c0")(h)
            h = getattr(self, f"enc{i}_c1")(h)
            feats[i] = h
        return h, feats


class ToStyle(nn.Module):
    """Global style: up to three 3x3 down convs, a mean, a dense layer."""

    def __init__(self, cin, features, res):
        super().__init__()
        self.n_down = 0
        for j in range(3):
            if res > 1:
                self.add_module(f"down{j}", EqualConv(cin, cin, down=True))
                self.n_down += 1
                res //= 2
        self.fc = EqualDense(cin, features, act=True)

    def forward(self, x):
        for j in range(self.n_down):
            x = getattr(self, f"down{j}")(x)
        return self.fc(torch.mean(x, dim=(2, 3)))


class DecBlockFirst(nn.Module):
    """Bottleneck block: 3x3 conv, + the encoder skip, StyleConv, ToRGB."""

    def __init__(self, cin, features, channels, style_dim):
        super().__init__()
        self.conv0 = EqualConv(cin, cin)
        self.conv1 = StyleConv(cin, features, style_dim)
        self.rgb = ToRGB(features, channels, style_dim)

    def forward(self, x, skip, style0, style1, noise=None):
        h = self.conv0(x) + skip
        h = self.conv1(h, style0, noise)
        return h, self.rgb(h, style1)


class DecBlockRef(nn.Module):
    """Upsampling block: StyleConv up, + the skip, StyleConv, RGB
    accumulation."""

    def __init__(self, cin, features, channels, style_dim):
        super().__init__()
        self.conv0 = StyleConv(cin, features, style_dim, up=True)
        self.conv1 = StyleConv(features, features, style_dim)
        self.rgb = ToRGB(features, channels, style_dim)

    def forward(self, x, img, skip, styles, noises):
        h = self.conv0(x, styles[0], noises[0]) + skip
        h = self.conv1(h, styles[1], noises[1])
        return h, self.rgb(h, styles[2], img)


class Decoder(nn.Module):
    """The bottleneck block, then one block per octave. Style indices: the
    bottleneck block takes 0 and 1, the block d octaves up 2d - 1, 2d and
    2d + 1 (neighbours share one)."""

    def __init__(self, size, base, channels, style_dim):
        super().__init__()
        self.res_log2 = int(math.log2(size))
        self.bottom = min(4, self.res_log2)
        self.add_module(f"dec{self.bottom}", DecBlockFirst(
            nf(self.bottom, base), nf(self.bottom, base), channels,
            style_dim))
        for res in range(self.bottom + 1, self.res_log2 + 1):
            self.add_module(f"dec{res}", DecBlockRef(
                nf(res - 1, base), nf(res, base), channels, style_dim))

    def forward(self, h, feats, style, noise=None):
        """``style(i)``: layer i's style; ``noise``: the list of the noise
        layers' (N, 1, H, W) draws in order, or None."""
        n_up = self.res_log2 - self.bottom
        noise = noise if noise is not None else [None] * (1 + 2 * n_up)
        h, img = getattr(self, f"dec{self.bottom}")(
            h, feats[self.bottom], style(0), style(1), noise[0])
        for j, res in enumerate(range(self.bottom + 1, self.res_log2 + 1)):
            d = res - self.bottom
            h, img = getattr(self, f"dec{res}")(
                h, img, feats[res],
                (style(2 * d - 1), style(2 * d), style(2 * d + 1)),
                (noise[1 + 2 * j], noise[2 + 2 * j]))
        return img


class MATGenerator(nn.Module):
    """The MAT generator, image path: ``forward(img, mask, z)`` with NHWC
    img (B, H, W, C) and mask (B, H, W, 1), 1 = known. The first stage,
    then the encoder over [mask - 0.5, composed, img * mask (, mask
    class)], the latent injection at the 16 px bottleneck (``mul_map``
    blend), the global style, the decoder with styles [w(i), gs]; the
    output composed in fp32 against the original input (known pixels pass
    through exactly) and clamped. Parameters fp32, compute ``dtype``;
    the mapping runs in fp32."""

    flax_weight_leaves = True

    def __init__(self, size, channels=3, base=64, w_dim=512, z_dim=512,
                 mask_class=False, style_mixing_prob=0.0, stage1_dim=180,
                 frames=1, motion_heads=4, motion_blocks=1,
                 motion_max_frames=25, dtype=torch.float32):
        super().__init__()
        self.size, self.channels = size, channels
        self.z_dim, self.w_dim = z_dim, w_dim
        self.frames = frames
        self.mask_class = mask_class
        self.style_mixing_prob = style_mixing_prob
        self.dtype = dtype
        extra = 1 if mask_class else 0
        self.mapping = MappingNet(z_dim, w_dim)
        self.first_stage = FirstStage(size, 1 + channels + extra, channels,
                                      w_dim, stage1_dim)
        self.encoder = Encoder(size, 1 + 2 * channels + extra, base)
        self.bottom = self.encoder.bottom
        self.bottom_ch = nf(self.bottom, base)
        self.to_square = EqualDense(w_dim, 16 * 16, act=True)
        self.to_style = ToStyle(self.bottom_ch, nf(2, base) * 2,
                                2 ** self.bottom)
        self.decoder = Decoder(size, base, channels,
                               w_dim + nf(2, base) * 2)
        self.n_style_layers = 2 * (self.encoder.res_log2 - self.bottom) + 2
        if frames > 1:
            from .motion import MotionModule
            self.motion = MotionModule(
                self.bottom_ch, num_heads=motion_heads,
                num_transformer_blocks=motion_blocks,
                max_len=motion_max_frames, dtype=dtype)

    def noise_shapes(self, batch, frames=1):
        """The random sites' shapes: the first stage's mul_map (tokens;
        every frame of a clip of ``frames``), the bottleneck's (NCHW) and
        each decoder noise layer's (the decoded frame alone)."""
        fs = self.first_stage
        noise = [(batch, 1, 2 ** self.bottom, 2 ** self.bottom)]
        for res in range(self.bottom + 1, self.encoder.res_log2 + 1):
            noise += [(batch, 1, 2 ** res, 2 ** res)] * 2
        return {"stage1_mul_map": (batch * frames, fs.mid_res ** 2, fs.dim),
                "inj_mul_map": (batch, self.bottom_ch, 2 ** self.bottom,
                                2 ** self.bottom),
                "noise": noise}

    def draw_noise(self, generator, batch, frames=1):
        """The ``noise`` draws from ``generator`` (on its device): both
        mul_maps 0 or 1 with probability 0.5, the noise N(0, 1) in the
        compute dtype."""
        dev, shapes = generator.device, self.noise_shapes(batch, frames)

        def coin(shape):
            return (torch.rand(shape, generator=generator, device=dev)
                    < 0.5).to(self.dtype)
        return {"stage1_mul_map": coin(shapes["stage1_mul_map"]),
                "inj_mul_map": coin(shapes["inj_mul_map"]),
                "noise": [torch.randn(s, generator=generator, device=dev,
                                      dtype=self.dtype)
                          for s in shapes["noise"]]}

    def draw_mix(self, generator, batch):
        """Style mixing's draws: the second latent, the coin (uniform) and
        the crossover layer in [1, n_style_layers)."""
        dev = generator.device
        return {"z2": torch.randn((batch, self.z_dim), generator=generator,
                                  device=dev),
                "u": torch.rand((), generator=generator, device=dev),
                "cut": torch.randint(1, self.n_style_layers, (),
                                     generator=generator, device=dev)}

    def forward(self, img, mask, z, noise=None, mix=None, mask_class=None,
                truncation_psi=1.0, w_avg=None, return_stg1=False,
                return_w=False):
        video = img.ndim == 5
        if video and self.frames <= 1:
            raise ValueError("5D input requires frames > 1 (motion mode)")
        dt = self.dtype
        img_raw = img.float()
        if video:
            # the frames folded into the batch, one latent a clip
            b, f = img.shape[:2]
            img, mask = img.flatten(0, 1), mask.flatten(0, 1)
            if mask_class is not None:
                mask_class = mask_class.flatten(0, 1)
            z = z.repeat_interleave(f, dim=0)
        x_img = img.to(dt).permute(0, 3, 1, 2)
        mask_c = torch.clamp(mask.to(dt), 0.0, 1.0).permute(0, 3, 1, 2)
        mc = (mask_class.permute(0, 3, 1, 2)
              if mask_class is not None else None)
        w = self.mapping(z.float())
        if w_avg is not None and truncation_psi != 1.0:
            w = w_avg[None].to(w.dtype) + truncation_psi * (
                w - w_avg[None].to(w.dtype))
        stg1 = self.first_stage(
            x_img, mask_c, w,
            mul_map=noise["stage1_mul_map"] if noise is not None else None,
            mask_class=mc if self.mask_class else None)
        parts = [mask_c - 0.5, x_img * mask_c + stg1 * (1 - mask_c),
                 x_img * mask_c]
        if self.mask_class:
            parts.append((mc if mc is not None
                          else torch.zeros_like(mask_c)).to(dt))
        h, feats = self.encoder(torch.cat(parts, dim=1))
        if video:
            # the bottleneck mixed over the frames, then the last frame
            # alone (JAX ``mat.py:742-761``)
            def last(t):
                return t.reshape((b, f) + t.shape[1:])[:, -1]
            h = last(self.motion(h, f))
            feats = {k: last(v) for k, v in feats.items()}
            mask_c, stg1 = last(mask_c), last(stg1)
            w = w.reshape(b, f, -1)[:, 0]
        add_n = self.to_square(w).reshape(-1, 1, 16, 16)
        if add_n.shape[-1] != h.shape[-1]:
            add_n = resize_bilinear(add_n, h.shape[-2:])
        add_n = add_n.to(h.dtype)
        if noise is not None:
            mul_map = noise["inj_mul_map"].to(h.dtype)
        else:
            mul_map = torch.full_like(h, 0.5)
        h = h * mul_map + add_n * (1 - mul_map)
        feats = dict(feats)
        feats[self.bottom] = h
        gs = self.to_style(h)

        ws2 = mix_from = None
        if self.style_mixing_prob > 0 and mix is not None:
            ws2 = self.mapping(mix["z2"].float())
            mix_from = torch.where(
                mix["u"] < self.style_mixing_prob, mix["cut"],
                torch.full_like(mix["cut"], self.n_style_layers))

        def w_at(i):
            if ws2 is None:
                return w
            return torch.where(i >= mix_from, ws2, w)

        def style(i):
            wi = w_at(i)
            return torch.cat([wi, gs.to(wi.dtype)], dim=-1)

        out = self.decoder(h, feats, style,
                           noise["noise"] if noise is not None else None)
        mask_f = mask_c.float().permute(0, 2, 3, 1)
        img_keep = img_raw[:, -1] if video else img_raw
        out = out.float().permute(0, 2, 3, 1) * (1 - mask_f) \
            + img_keep * mask_f
        out = torch.clamp(out, -1.0, 1.0)
        if video:
            # the clip again: the history frames as they came in
            out = torch.cat([img_raw[:, :-1], out[:, None]], dim=1)
        extra = ()
        if return_stg1:
            stg1 = stg1.float().permute(0, 2, 3, 1)
            if video:
                stg1 = torch.cat([img_raw[:, :-1], stg1[:, None]], dim=1)
            extra += (stg1,)
        if return_w:
            extra += (w,)
        return (out,) + extra if extra else out


# --------------------------------------------------------------------------
# The discriminator
# --------------------------------------------------------------------------

class DisBlock(nn.Module):
    """Residual D block: 3x3 conv, 3x3 down conv with gain sqrt(0.5), and a
    biasless 1x1 down skip at the same gain."""

    def __init__(self, cin, features):
        super().__init__()
        g = math.sqrt(0.5)
        self.skip = EqualConv(cin, features, kernel=1, down=True, act=False,
                              use_bias=False, gain=g)
        self.conv0 = EqualConv(cin, cin)
        self.conv1 = EqualConv(cin, features, down=True, gain=g)

    def forward(self, x):
        return self.skip(x) + self.conv1(self.conv0(x))


def minibatch_std(x, group_size=4):
    """Grouped minibatch-stddev channel over (N, C, H, W): the group size
    shrinks until it divides N, sample i is in group i mod N/g, statistics
    in fp32."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    while n % g:
        g -= 1
    y = x.float().reshape(g, n // g, c, h, w)
    y = y - y.mean(dim=0)
    y = torch.sqrt(torch.mean(y * y, dim=0) + 1e-8)      # (n/g, c, h, w)
    y = y.mean(dim=(1, 2, 3)).repeat(g)                    # (n,)
    sd = y[:, None, None, None].expand(n, 1, h, w)
    return torch.cat([x, sd.to(x.dtype)], dim=1)


class MATDiscriminator(nn.Module):
    """StyleGAN2 D over ([mask - 0.5, img], [mask - 0.5, stg1]): two
    residual trunks to 4 x 4 (the stg1 trunk at half width), minibatch
    stddev, a 3x3 conv, the map flattened in NHWC order, two dense layers.
    NHWC inputs; returns fp32 (logits, logits_stg1)."""

    flax_weight_leaves = True

    def __init__(self, size, channels=3, base=64, dtype=torch.float32,
                 mbstd_group=4):
        super().__init__()
        self.dtype, self.mbstd_group = dtype, mbstd_group
        self.res_log2 = int(math.log2(size))
        self.bottom = min(2, self.res_log2 - 1)
        for prefix, div in (("main", 1), ("stg1", 2)):
            self.add_module(f"{prefix}_from_rgb", EqualConv(
                1 + channels, nf(self.res_log2, base, div), kernel=1))
            for res in range(self.res_log2, self.bottom, -1):
                self.add_module(f"{prefix}_b{res}", DisBlock(
                    nf(res, base, div), nf(res - 1, base, div)))
            cb = nf(self.bottom, base, div)
            self.add_module(f"{prefix}_final", EqualConv(cb + 1, cb))
            self.add_module(f"{prefix}_fc0", EqualDense(
                cb * (2 ** self.bottom) ** 2, cb, act=True))
            self.add_module(f"{prefix}_fc1", EqualDense(cb, 1))

    def _trunk(self, x, prefix):
        h = getattr(self, f"{prefix}_from_rgb")(x)
        for res in range(self.res_log2, self.bottom, -1):
            h = getattr(self, f"{prefix}_b{res}")(h)
        h = minibatch_std(h, self.mbstd_group)
        h = getattr(self, f"{prefix}_final")(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return getattr(self, f"{prefix}_fc1")(
            getattr(self, f"{prefix}_fc0")(h))

    def forward(self, img, mask, stg1):
        dt = self.dtype
        m = torch.clamp(mask, 0.0, 1.0).to(dt).permute(0, 3, 1, 2) - 0.5
        img = img.to(dt).permute(0, 3, 1, 2)
        stg1 = stg1.to(dt).permute(0, 3, 1, 2)
        logits = self._trunk(torch.cat([m, img], dim=1), "main")
        logits_stg1 = self._trunk(torch.cat([m, stg1], dim=1), "stg1")
        return logits.float(), logits_stg1.float()


@torch.no_grad()
def init_mat(net, generator):
    """MAT's init of ``net`` (on the CPU), drawn from ``generator``:
    equalized weights N(0, 1) (dense N(0, 1 / lr_mul)), biases 0 (the
    modulation affines 1), noise strengths 0. The JAX package draws from its
    own keys: the two agree in law, not in value."""
    for mod in net.modules():
        if hasattr(mod, "reset"):
            mod.reset(generator)
    motion = getattr(net, "motion", None)
    if motion is not None:
        # flax's defaults (lecun-normal kernels; proj_out zero), as the
        # video denoisers' motion modules
        from ..diffusion_networks import init_weights
        init_weights(motion, generator)
    return net
