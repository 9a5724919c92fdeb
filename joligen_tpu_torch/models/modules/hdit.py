"""HDiT, the hourglass diffusion transformer of ``G_netG: hdit`` under
palette (``joligen_tpu/models/modules/hdit.py``).

``HDiT.forward(x (B, H, W, C), t (B,) in [0, 1]) -> (B, H, W,
out_channels)`` fp32:

1. ``patch_in``: the patches (``patch_size``²) to the first width, no bias;
2. c: t × 1000 through the 256-wide sinusoidal embedding, ``t_0``, SiLU,
   ``t_1`` (the deepest width), plus a ``y_embed`` row with classes, then
   the ``mapping`` network (RMSNorm, ``mapping_depth`` × [RMSNorm, GEGLU
   of 3 × width, zero-init down projection, residual], RMSNorm);
3. the encoder levels: ``depths[i]`` ``HDiTBlock``s of shifted-window
   attention (window 8, shift window / 2 on odd layer indices), then a 2×2
   token merge and ``merge{i}``; the middle: ``depths[-1]`` blocks of global
   attention; the decoder levels: ``split{i}``, the 2×2 token split, the
   skip's lerp (``lerp{i}``, init 0.5), blocks whose layer index continues
   from the encoder's (``bi + depths[i]``);
4. ``final_norm``, the zero-init ``patch_out`` back to pixels.

``HDiTBlock``: AdaRMSNorm (x · rsqrt(mean x² + 1e-6) · (1 + ``lin``(c)),
``lin`` zero-init and bias-free, fp32 statistics), the bias-free ``qkv``,
q and k L2-normalised per head and scaled by the square root of the
learnable per-head ``attn_scale`` (init 10, fp32 statistics), axial RoPE on
half of each head (per-head log-spaced frequencies from π to 10π over the
pixel centres of the aspect-corrected [-1, 1] box at the level's grid,
which are the 2×2 means of the finer level's), attention at scale 1.0 with
the math of ``jax.nn.dot_product_attention`` (fp32 logits, fp32 softmax,
probabilities in the value's dtype), the zero-init ``proj``; then
AdaRMSNorm, the GEGLU ``ff_in`` (exact GELU), the zero-init ``ff_out``.
Windows are the port's MAT helpers (``window_partition`` /
``window_reverse``); RoPE tables and seam masks are built once per grid
and device. As in the JAX package, the grid rolls by +shift before
the partition and by -shift after it, and the seam mask
(``shifted_window_mask``) keeps each wrapped group to itself.

Attention here is plain torch ops: the JAX package reaches no Pallas kernel
in HDiT. The middle level's dropout (``mid_dropout``) is inactive under
palette, whose denoiser call is deterministic, and is not ported. The GAN
use of ``hdit`` (``gan_networks.py``) raises (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.schedules import timestep_embedding
from .mat import window_partition, window_reverse
from .unet_mha import Dense


def make_axial_pos(h, w):
    """Pixel-centre positions over the aspect-corrected [-1, 1] box, (h * w,
    2) float32 numpy (y, x)."""
    ar = w / h
    y_min, y_max, x_min, x_max = -1.0, 1.0, -1.0, 1.0
    if ar > 1:
        y_min, y_max = -1 / ar, 1 / ar
    elif ar < 1:
        x_min, x_max = -ar, ar

    def centers(a, b, n):
        edges = np.linspace(a, b, n + 1, dtype=np.float64)
        return (edges[:-1] + edges[1:]) / 2

    grid = np.stack(np.meshgrid(centers(y_min, y_max, h),
                                centers(x_min, x_max, w), indexing="ij"),
                    axis=-1)
    return grid.reshape(h * w, 2).astype(np.float32)


def rope_theta(pos, d_head, n_heads):
    """(T, 2) positions -> (T, n_heads, d_head // 4) angles: the first half
    rotate with y, the second with x, at per-head log-spaced frequencies."""
    n = n_heads * (d_head // 8)
    freqs = np.exp(np.linspace(math.log(math.pi), math.log(10 * math.pi),
                               n + 1, dtype=np.float64))[:-1]
    freqs = freqs.reshape(d_head // 8, n_heads).T.astype(np.float32)
    th_y = pos[:, None, 0:1] * freqs[None]
    th_x = pos[:, None, 1:2] * freqs[None]
    return np.concatenate([th_y, th_x], axis=-1)


def apply_rope(x, cos, sin):
    """x (B, H, T, D); cos and sin (1, H, T, d) of the angles: the first 2d
    channels rotate pairwise (channel i with i + d), the rest pass."""
    d = cos.shape[-1]
    x1, x2, rest = x[..., :d], x[..., d:2 * d], x[..., 2 * d:]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest],
                     dim=-1)


def shifted_window_mask(nwh, nww, wsz, shift):
    """Boolean allow-mask (nwh * nww, wsz², wsz²): after the roll, tokens at
    row or column < shift in the top or left windows are wrapped and attend
    only within their wrap group."""
    ph, pw, qh, qw, kh, kw = np.meshgrid(
        np.arange(nwh), np.arange(nww), np.arange(wsz), np.arange(wsz),
        np.arange(wsz), np.arange(wsz), indexing="ij")
    top, left = ph == 0, pw == 0
    same_row = (qh < shift) == (kh < shift)
    same_col = (qw < shift) == (kw < shift)
    m = ((left & top & same_col & same_row) | (left & ~top & same_col)
         | (~left & top & same_row) | (~left & ~top))
    return m.reshape(nwh * nww, wsz * wsz, wsz * wsz)


def rms_norm(x, scale, eps=1e-6):
    """x · scale · rsqrt(mean x² + eps), the statistics and the factor in
    fp32, applied in x's dtype."""
    f32 = x.float()
    s = scale.float() * torch.rsqrt(torch.mean(f32 * f32, dim=-1,
                                               keepdim=True) + eps)
    return x * s.to(x.dtype)


def scale_for_cosine_sim(q, k, scale, eps=1e-6):
    """q and k (B, H, T, D) L2-normalised per head, each times
    sqrt(``scale`` (H,)), the factors in fp32."""
    root = torch.sqrt(scale.float())[None, :, None, None]
    qs = root * torch.rsqrt(torch.sum(q.float() ** 2, -1, keepdim=True)
                            + eps)
    ks = root * torch.rsqrt(torch.sum(k.float() ** 2, -1, keepdim=True)
                            + eps)
    return q * qs.to(q.dtype), k * ks.to(k.dtype)


def dot_product_attention(q, k, v, allow=None):
    """``jax.nn.dot_product_attention`` at scale 1.0 over (N, T, H, D):
    fp32 logits, -inf where ``allow`` (N, T, T) is false, fp32 softmax,
    probabilities in v's dtype."""
    logits = torch.einsum("nthd,nshd->nhts", q.float(), k.float())
    if allow is not None:
        logits = logits.masked_fill(~allow[:, None], float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhts,nshd->nthd", p, v)


class RMSNorm(nn.Module):
    """``rms_norm`` with a learnable scale (flax ``scale``, torch
    ``weight``)."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight)


class AdaRMSNorm(nn.Module):
    """``rms_norm(x, 1 + lin(c))``, ``lin`` bias-free and zero-init."""

    def __init__(self, dim, cond_dim, dtype=torch.float32):
        super().__init__()
        self.lin = Dense(cond_dim, dim, dtype=dtype, zero_init=True,
                         use_bias=False)

    def forward(self, x, c):
        return rms_norm(x, 1.0 + self.lin(c)[:, None, :])


class HDiTBlock(nn.Module):
    """One layer (see the module doc): windowed (``window`` < the grid)
    or global attention (``window`` 0), then the GEGLU feed-forward.
    ``forward(x (B, T, d), c (B, cond_dim), grid (gh, gw))``."""

    def __init__(self, dim, cond_dim, num_heads, window=0, shift=0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.shift = shift
        self.attn_norm = AdaRMSNorm(dim, cond_dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, use_bias=False)
        self.attn_scale = nn.Parameter(torch.full((num_heads,), 10.0))
        self.proj = Dense(dim, dim, dtype=dtype, zero_init=True,
                          use_bias=False)
        self.ff_norm = AdaRMSNorm(dim, cond_dim, dtype=dtype)
        self.ff_in = Dense(dim, 6 * dim, dtype=dtype, use_bias=False)
        self.ff_out = Dense(3 * dim, dim, dtype=dtype, zero_init=True,
                            use_bias=False)
        self._tables = {}

    def _block_tables(self, grid, hd, windowed, device):
        """(cos, sin) of the RoPE angles, (1, H, T, hd / 4), and the seam
        mask of a shifted window partition (or None), on ``device``,
        built once per grid."""
        key = (grid, windowed, str(device))
        if key not in self._tables:
            nh = self.num_heads
            theta = torch.from_numpy(rope_theta(make_axial_pos(*grid), hd,
                                                nh))
            theta = theta.permute(1, 0, 2)[None].to(device)
            allow = None
            if windowed and self.shift:
                w = self.window
                allow = torch.from_numpy(shifted_window_mask(
                    grid[0] // w, grid[1] // w, w, self.shift)).to(device)
            self._tables[key] = (torch.cos(theta), torch.sin(theta), allow)
        return self._tables[key]

    def _attention(self, q, k, v, grid, windowed, allow):
        """q, k, v (B, T, H, hd) -> (B, T, H * hd)."""
        b, t, nh, hd = q.shape
        if not windowed:
            return dot_product_attention(q, k, v).reshape(b, t, nh * hd)
        gh, gw = grid
        w, s = self.window, self.shift

        def to_windows(z):
            z = z.reshape(b, gh, gw, nh * hd)
            if s:
                z = torch.roll(z, (s, s), dims=(1, 2))
            return window_partition(z, w).reshape(-1, w * w, nh, hd)
        a = dot_product_attention(*map(to_windows, (q, k, v)),
                                  allow.repeat(b, 1, 1) if s else None)
        a = window_reverse(a.reshape(-1, w * w, nh * hd), w, gh, gw)
        if s:
            a = torch.roll(a, (-s, -s), dims=(1, 2))
        return a.reshape(b, t, nh * hd)

    def forward(self, x, c, grid):
        b, t, d = x.shape
        nh = self.num_heads
        hd = d // nh
        windowed = bool(self.window) and self.window < min(grid)
        cos, sin, allow = self._block_tables(tuple(grid), hd, windowed,
                                             x.device)
        q, k, v = torch.chunk(self.qkv(self.attn_norm(x, c)), 3, dim=-1)
        q, k, v = (z.reshape(b, t, nh, hd).transpose(1, 2) for z in (q, k, v))
        q, k = scale_for_cosine_sim(q, k, self.attn_scale)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        a = self._attention(*(z.transpose(1, 2) for z in (q, k, v)), grid,
                            windowed, allow)
        x = x + self.proj(a)
        u, gate = torch.chunk(self.ff_in(self.ff_norm(x, c)), 2, dim=-1)
        return x + self.ff_out(u * F.gelu(gate))


class MappingNetwork(nn.Module):
    """RMSNorm, ``depth`` × [RMSNorm, GEGLU (3 × width), zero-init down,
    residual], RMSNorm."""

    def __init__(self, width, depth=2, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        self.in_norm = RMSNorm(width)
        for i in range(depth):
            self.add_module(f"norm{i}", RMSNorm(width))
            self.add_module(f"up{i}", Dense(width, 6 * width, dtype=dtype,
                                            use_bias=False))
            self.add_module(f"down{i}", Dense(3 * width, width, dtype=dtype,
                                              zero_init=True,
                                              use_bias=False))
        self.out_norm = RMSNorm(width)

    def forward(self, x):
        x = self.in_norm(x)
        for i in range(self.depth):
            u, gate = torch.chunk(getattr(self, f"up{i}")(
                getattr(self, f"norm{i}")(x)), 2, dim=-1)
            x = x + getattr(self, f"down{i}")(u * F.gelu(gate))
        return self.out_norm(x)


def token_merge(x, gh, gw):
    """(B, gh * gw, D) -> (B, gh / 2 * gw / 2, 4D): space to depth."""
    b, _, d = x.shape
    x = x.reshape(b, gh // 2, 2, gw // 2, 2, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (gh // 2) * (gw // 2), 4 * d)


def token_split(x, gh, gw):
    """(B, gh * gw, D) -> (B, 4 gh gw, D / 4): depth to space."""
    b, _, d = x.shape
    x = x.reshape(b, gh, gw, 2, 2, d // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw * 4, d // 4)


class HDiT(nn.Module):
    """The hourglass denoiser (see the module doc) over ``in_channels``
    input channels."""

    def __init__(self, in_channels, patch_size=4,
                 widths=(192, 384, 768), depths=(2, 2, 4), d_head=64,
                 window=8, num_classes=1, out_channels=3, mapping_depth=2,
                 dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.widths = tuple(widths)
        self.depths = tuple(depths)
        self.num_classes = num_classes
        self.out_channels = out_channels
        self.dtype = dtype
        mw = self.widths[-1]
        n_levels = len(self.widths)

        def heads(width):
            return max(1, width // d_head)

        def shift(index):
            return window // 2 if index % 2 == 1 else 0

        self.patch_in = Dense(patch_size * patch_size * in_channels,
                              self.widths[0], dtype=dtype, use_bias=False)
        self.t_0 = Dense(256, mw, dtype=dtype)
        self.t_1 = Dense(mw, mw, dtype=dtype)
        if num_classes > 1:
            self.y_embed = nn.Parameter(torch.zeros(num_classes + 1, mw))
        self.mapping = MappingNetwork(mw, mapping_depth, dtype=dtype)
        for li in range(n_levels - 1):
            w = self.widths[li]
            for bi in range(self.depths[li]):
                self.add_module(f"enc{li}_{bi}", HDiTBlock(
                    w, mw, heads(w), window, shift(bi), dtype))
            self.add_module(f"merge{li}", Dense(
                4 * w, self.widths[li + 1], dtype=dtype, use_bias=False))
        for bi in range(self.depths[-1]):
            self.add_module(f"mid_{bi}", HDiTBlock(
                mw, mw, heads(mw), 0, 0, dtype))
        for li in reversed(range(n_levels - 1)):
            w = self.widths[li]
            self.add_module(f"split{li}", Dense(
                self.widths[li + 1], 4 * w, dtype=dtype, use_bias=False))
            self.register_parameter(f"lerp{li}",
                                    nn.Parameter(torch.tensor(0.5)))
            for bi in range(self.depths[li]):
                self.add_module(f"dec{li}_{bi}", HDiTBlock(
                    w, mw, heads(w), window, shift(bi + self.depths[li]),
                    dtype))
        self.final_norm = RMSNorm(self.widths[0])
        self.patch_out = Dense(self.widths[0], patch_size * patch_size
                               * out_channels, dtype=dtype, zero_init=True,
                               use_bias=False)

    @classmethod
    def from_opt(cls, opt, in_channels, dtype=torch.float32):
        """The factory's HDiT (``diffusion_networks.py:98-105``): the
        ``G_hdit_*`` widths, depths and patch, the other settings their
        defaults."""
        return cls(in_channels,
                   patch_size=getattr(opt, "G_hdit_patch_size", 4) or 4,
                   widths=tuple(getattr(opt, "G_hdit_widths", None)
                                or (192, 384, 768)),
                   depths=tuple(getattr(opt, "G_hdit_depths", None)
                                or (2, 2, 4)),
                   out_channels=opt.model_output_nc, dtype=dtype)

    def forward(self, x, t, y=None):
        b, hh, ww, cin = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        n_levels = len(self.widths)
        patches = x.reshape(b, gh, p, gw, p, cin).permute(
            0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * cin)
        h = self.patch_in(patches.to(self.dtype))

        t = torch.as_tensor(t, device=x.device).reshape(b)
        c = self.t_0(timestep_embedding(t * 1000.0, 256))
        c = self.t_1(F.silu(c))
        if self.num_classes > 1 and y is not None:
            c = c + self.y_embed[y.long()].to(c.dtype)
        c = self.mapping(c)

        skips = []
        for li in range(n_levels - 1):
            for bi in range(self.depths[li]):
                h = getattr(self, f"enc{li}_{bi}")(h, c, (gh, gw))
            skips.append(h)
            h = getattr(self, f"merge{li}")(token_merge(h, gh, gw))
            gh, gw = gh // 2, gw // 2
        for bi in range(self.depths[-1]):
            h = getattr(self, f"mid_{bi}")(h, c, (gh, gw))
        for li in reversed(range(n_levels - 1)):
            h = token_split(getattr(self, f"split{li}")(h), gh, gw)
            gh, gw = gh * 2, gw * 2
            lerp = getattr(self, f"lerp{li}").to(h.dtype)
            h = lerp * h + (1 - lerp) * skips.pop()
            for bi in range(self.depths[li]):
                h = getattr(self, f"dec{li}_{bi}")(h, c, (gh, gw))

        h = self.patch_out(self.final_norm(h))
        p, oc = self.patch_size, self.out_channels
        h = h.reshape(b, gh, gw, p, p, oc).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(b, hh, ww, oc).float()
