"""JiT (``joligen_tpu/models/modules/jit.py``): the 2-D sin-cos position
table, axial RoPE, RMSNorm, the SwiGLU feed-forward, AdaLN modulation,
``JiTBlock`` (also the block of the video denoiser ``vit_vid``,
``models/modules/vit_vid.py``) and ``JiT``, the image x-prediction
denoiser of ``G_netG: vit`` (and ``dit``) under b2b and palette.

Modules carry the flax names (``adaLN``, ``norm1``, ``qkv``, ``q_norm``,
``k_norm``, ``proj``, ``norm2``, ``mlp/w1``, ``mlp/w3``, ``mlp/w2``). Dense
layers keep fp32 parameters and compute in ``dtype`` (bf16 under
``tpu_bf16``); RMSNorm takes fp32 statistics and returns its input's dtype.
Attention is the port's ``flash_attention`` (K1, and K2/K3 in the
backward), at (B, N, heads, head dim).

``JiT.forward(x (B, H, W, C), t (B,) in [0, 1], y, mask_size) -> (B, H, W,
out_channels)`` fp32:

1. the bottleneck patch embedding (bias-free ``patch_bneck``, then
   ``patch_proj``) plus the sin-cos table;
2. c: the raw fractional t (not × 1000) through the 256-wide sinusoidal
   embedding, ``t_0``, SiLU, ``t_1``; plus the row of ``y_embed``
   (``num_classes + 1`` rows, ``y=None`` the null row ``num_classes``);
   with ``mask_size_conditioning`` plus ``ms_1(silu(ms_0(mask_size)))``
   (zeros for an absent descriptor; ``ms_1`` zero-initialised);
3. ``blocks_pre``: the first ``start = clamp(in_context_start, 0, depth)``
   blocks on the image tokens; then, when ``in_context_start < depth`` and
   there are register or in-context tokens, the prefix [registers,
   class embedding + ``in_context_posemb``] before the image tokens, RoPE
   with identity rows for it; ``blocks_post``: the other blocks (the JAX
   package stacks each with ``nn.scan``; the converter splits the stack
   into ``blocks_pre.0`` ...);
4. the prefix dropped; ``final_adaLN`` shift and scale of ``final_norm``,
   ``final_proj`` (both zero-initialised), the patches back to pixels.

JiT-B and JiT-L have head dim 64; JiT-H's 80 (1280 / 16) is not a head
dim of K1, whose wrapper raises on a CUDA tensor there (ROADMAP Queue 2
item 1). ``tpu_remat`` runs each block under ``torch.utils.checkpoint``,
as the JAX package's ``nn.remat`` of the scanned block does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ...ops.flash_attention import flash_attention
from ...ops.schedules import timestep_embedding
from .unet_mha import Dense

JiT_VARIANT_CONFIGS = {
    f"JiT-{size}/{patch}": dict(
        depth={"B": 12, "L": 24, "H": 32}[size],
        hidden_size={"B": 768, "L": 1024, "H": 1280}[size],
        num_heads={"B": 12, "L": 16, "H": 16}[size],
        bottleneck_dim={"B": 128, "L": 128, "H": 256}[size],
        patch_size=patch, in_context_len=32,
        in_context_start={"B": 4, "L": 8, "H": 10}[size])
    for size, patches in (("B", (16, 8, 4, 2, 32)), ("L", (16, 32)),
                          ("H", (16, 32)))
    for patch in patches
}


def sincos_2d_pos_embed(dim, grid_h, grid_w):
    """The fixed 2-D sin-cos table, (grid_h * grid_w, dim) float32 numpy,
    built in float64: the first dim // 2 channels encode the column (w),
    the second half the row (h), as the JAX package's half order."""
    def _1d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64)
                                / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw, gh = np.meshgrid(np.arange(grid_w, dtype=np.float64),
                         np.arange(grid_h, dtype=np.float64))
    return np.concatenate([_1d(dim // 2, gw), _1d(dim // 2, gh)],
                          axis=1).astype(np.float32)


def axial_rope_tables(grid_h, grid_w, head_dim, prefix=0):
    """Axial interleaved RoPE cos/sin tables, (prefix + gh * gw, head_dim)
    float32 numpy: frequencies 10000^(-2i / (hd / 2)), each repeated for a
    pair; the first hd / 2 lanes rotate by the row, the second by the
    column; ``prefix`` identity rows (cos 1, sin 0) for the prefix tokens."""
    dim = head_dim // 2
    if dim % 2:
        raise ValueError("head_dim must be a multiple of 4 for axial RoPE")
    freqs = 1.0 / (10000 ** (np.arange(0, dim, 2)[: dim // 2]
                             .astype(np.float64) / dim))
    fh = np.repeat(np.arange(grid_h)[:, None] * freqs[None], 2, axis=-1)
    fw = np.repeat(np.arange(grid_w)[:, None] * freqs[None], 2, axis=-1)
    full = np.concatenate(
        [np.broadcast_to(fh[:, None, :], (grid_h, grid_w, dim)),
         np.broadcast_to(fw[None, :, :], (grid_h, grid_w, dim))],
        axis=-1).reshape(grid_h * grid_w, head_dim)
    cos, sin = np.cos(full), np.sin(full)
    if prefix:
        cos = np.concatenate([np.ones((prefix, head_dim)), cos], axis=0)
        sin = np.concatenate([np.zeros((prefix, head_dim)), sin], axis=0)
    return cos.astype(np.float32), sin.astype(np.float32)


def rope_rotate(t, cos, sin):
    """t * cos + rotate_half(t) * sin with interleaved pairs: t (B, N,
    heads, hd), tables (N, hd) cast to t's dtype."""
    x = t.reshape(*t.shape[:-1], t.shape[-1] // 2, 2)
    rot = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(t.shape)
    c = cos[None, :, None, :].to(t.dtype)
    s = sin[None, :, None, :].to(t.dtype)
    return t * c + rot * s


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x²) + eps) in fp32, times the fp32 scale, cast back to
    x's dtype."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                              + self.eps)
        return (n * self.weight).to(x.dtype)


class SwiGLUFFN(nn.Module):
    """w2(silu(w1 x) * w3 x), biased, hidden int(2/3 * ``hidden``)."""

    def __init__(self, dim, hidden, dtype=torch.float32):
        super().__init__()
        h = int(hidden * 2 / 3)
        self.w1 = Dense(dim, h, dtype=dtype)
        self.w3 = Dense(dim, h, dtype=dtype)
        self.w2 = Dense(h, dim, dtype=dtype)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class JiTBlock(nn.Module):
    """AdaLN-modulated pre-norm block: RMSNorm, qkv, q/k RMSNorm, RoPE,
    attention, projection, gated residual; then RMSNorm, SwiGLU, gated
    residual. ``adaLN`` (6 modulations from c) is zero-initialised, so a
    new block is the identity. ``forward(x (B, N, d), c (B, d), cos,
    sin)``, the tables (N, head dim)."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.adaLN = Dense(dim, 6 * dim, dtype=dtype, zero_init=True)
        self.norm1 = RMSNorm(dim)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.q_norm = RMSNorm(hd)
        self.k_norm = RMSNorm(hd)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = RMSNorm(dim)
        self.mlp = SwiGLUFFN(dim, 4 * dim, dtype=dtype)

    def forward(self, x, c, rope_cos, rope_sin):
        b, n, d = x.shape
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = torch.chunk(
            self.adaLN(F.silu(c)), 6, dim=-1)
        h = modulate(self.norm1(x), s_msa, sc_msa)
        q, k, v = torch.chunk(self.qkv(h), 3, dim=-1)
        shape = (b, n, self.num_heads, d // self.num_heads)
        q = rope_rotate(self.q_norm(q.reshape(shape)), rope_cos, rope_sin)
        k = rope_rotate(self.k_norm(k.reshape(shape)), rope_cos, rope_sin)
        a = flash_attention(q, k, v.reshape(shape)).reshape(b, n, d)
        x = x + g_msa[:, None, :] * self.proj(a)
        h = modulate(self.norm2(x), s_mlp, sc_mlp)
        return x + g_mlp[:, None, :] * self.mlp(h)


def cached_tables(cache, key, make, device):
    """The numpy arrays ``make()`` returns, as tensors on ``device``, built
    once per ``key`` and device into ``cache``."""
    full = key + (str(device),)
    if full not in cache:
        cache[full] = tuple(torch.from_numpy(a).to(device) for a in make())
    return cache[full]


def jit_config(opt, variant=None):
    """The variant table entry of ``variant`` (default ``G_vit_variant``,
    else JiT-B/16; an unknown name is JiT-B/16), overridden by the
    explicit ``G_vit_*`` options; with ``G_vit_disable_bottleneck`` the
    bottleneck is the hidden width."""
    variant = variant or getattr(opt, "G_vit_variant", "") or "JiT-B/16"
    cfg = dict(JiT_VARIANT_CONFIGS.get(variant,
                                       JiT_VARIANT_CONFIGS["JiT-B/16"]))
    for key in ("depth", "hidden_size", "num_heads", "patch_size",
                "bottleneck_dim", "in_context_len", "in_context_start"):
        v = getattr(opt, f"G_vit_{key}", None)
        if v is not None:
            cfg[key] = v
    if getattr(opt, "G_vit_disable_bottleneck", False):
        cfg["bottleneck_dim"] = cfg["hidden_size"]
    return cfg


class JiT(nn.Module):
    """The image JiT denoiser (see the module doc)."""

    def __init__(self, in_channels, patch_size=16, hidden_size=768, depth=12,
                 num_heads=12, bottleneck_dim=128, num_classes=1,
                 num_register_tokens=0, in_context_len=32,
                 in_context_start=4, out_channels=None,
                 mask_size_conditioning=False, remat=False,
                 dtype=torch.float32):
        super().__init__()
        d = hidden_size
        self.patch_size = patch_size
        self.hidden_size = d
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.num_register_tokens = num_register_tokens
        self.in_context_len = in_context_len
        self.out_channels = out_channels or in_channels
        self.mask_size_conditioning = mask_size_conditioning
        self.remat = remat
        self.dtype = dtype
        self._tables = {}
        self.start = max(0, min(in_context_start, depth))
        self.insert_prefix = in_context_start < depth and (
            num_register_tokens > 0 or in_context_len > 0)

        self.patch_bneck = Dense(patch_size * patch_size * in_channels,
                                 bottleneck_dim, dtype=dtype, use_bias=False)
        self.patch_proj = Dense(bottleneck_dim, d, dtype=dtype)
        self.t_0 = Dense(256, d, dtype=dtype)
        self.t_1 = Dense(d, d, dtype=dtype)
        # the class table with its null row (the last): N(0, 0.02)
        self.y_embed = nn.Parameter(torch.zeros(num_classes + 1, d))
        if mask_size_conditioning:
            self.ms_0 = Dense(6, d, dtype=dtype)
            self.ms_1 = Dense(d, d, dtype=dtype, zero_init=True)
        if self.start > 0:
            self.blocks_pre = nn.ModuleList(
                JiTBlock(d, num_heads, dtype=dtype)
                for _ in range(self.start))
        if self.insert_prefix and num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, d))
        if self.insert_prefix and in_context_len > 0:
            self.in_context_posemb = nn.Parameter(
                torch.zeros(1, in_context_len, d))
        if self.start < depth:
            self.blocks_post = nn.ModuleList(
                JiTBlock(d, num_heads, dtype=dtype)
                for _ in range(depth - self.start))
        self.final_adaLN = Dense(d, 2 * d, dtype=dtype, zero_init=True)
        self.final_norm = RMSNorm(d)
        self.final_proj = Dense(d, patch_size * patch_size
                                * self.out_channels, dtype=dtype,
                                zero_init=True)

    @classmethod
    def from_opt(cls, opt, in_channels, dtype=torch.float32):
        """The JAX ``JiT.from_opt``: ``jit_config``, the class count, the
        registers, mask-size conditioning and remat from the options."""
        cfg = jit_config(opt)
        return cls(
            in_channels, patch_size=cfg["patch_size"],
            hidden_size=cfg["hidden_size"], depth=cfg["depth"],
            num_heads=cfg["num_heads"], bottleneck_dim=cfg["bottleneck_dim"],
            num_classes=max(1, getattr(opt, "G_vit_num_classes", 1)),
            num_register_tokens=getattr(opt, "G_vit_num_register_tokens", 0),
            in_context_len=cfg.get("in_context_len", 32),
            in_context_start=cfg.get("in_context_start", 4),
            out_channels=opt.model_output_nc,
            mask_size_conditioning=bool(getattr(
                opt, "alg_b2b_mask_size_conditioning", False)),
            remat=bool(getattr(opt, "tpu_remat", False)), dtype=dtype)

    def _blocks(self, blocks, h, c, rc, rs):
        for block in blocks:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, c, rc, rs, use_reentrant=False)
            else:
                h = block(h, c, rc, rs)
        return h

    def forward(self, x, t, y=None, mask_size=None):
        b, hh, ww, cin = x.shape
        p, d = self.patch_size, self.hidden_size
        gh, gw = hh // p, ww // p
        hd = d // self.num_heads
        dev = x.device

        patches = x.reshape(b, gh, p, gw, p, cin).permute(
            0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * cin)
        h = self.patch_proj(self.patch_bneck(patches.to(self.dtype)))
        (pos,) = cached_tables(self._tables, ("pos", gh, gw),
                               lambda: (sincos_2d_pos_embed(d, gh, gw),), dev)
        h = h + pos.to(h.dtype)[None]

        t = torch.as_tensor(t, device=dev).reshape(b)
        c = self.t_1(F.silu(self.t_0(timestep_embedding(t, 256))))
        if y is None:
            y = torch.full((b,), self.num_classes, dtype=torch.long,
                           device=dev)
        y_emb = self.y_embed[y.long()].to(c.dtype)
        c = c + y_emb
        if self.mask_size_conditioning:
            if mask_size is None:
                mask_size = torch.zeros(b, 6, device=dev)
            c = c + self.ms_1(F.silu(self.ms_0(mask_size.to(self.dtype))))

        if self.start > 0:
            cos0, sin0 = cached_tables(
                self._tables, ("rope", gh, gw, hd, 0),
                lambda: axial_rope_tables(gh, gw, hd), dev)
            h = self._blocks(self.blocks_pre, h, c, cos0, sin0)
        n_prefix = 0
        if self.insert_prefix:
            prefix = []
            if self.num_register_tokens > 0:
                prefix.append(self.register_tokens.to(h.dtype).expand(
                    b, -1, -1))
            if self.in_context_len > 0:
                prefix.append(y_emb[:, None, :]
                              + self.in_context_posemb.to(h.dtype))
            n_prefix = self.num_register_tokens + self.in_context_len
            h = torch.cat(prefix + [h], dim=1)
        if self.start < self.depth:
            cos1, sin1 = cached_tables(
                self._tables, ("rope", gh, gw, hd, n_prefix),
                lambda: axial_rope_tables(gh, gw, hd, prefix=n_prefix), dev)
            h = self._blocks(self.blocks_post, h, c, cos1, sin1)
        if n_prefix:
            h = h[:, n_prefix:]

        shift, scale = torch.chunk(self.final_adaLN(F.silu(c)), 2, dim=-1)
        h = self.final_proj(modulate(self.final_norm(h), shift, scale))
        oc = self.out_channels
        h = h.reshape(b, gh, gw, p, p, oc).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(b, hh, ww, oc).float()

    def embedding_params(self):
        """The parameters flax draws from N(0, 0.02): the class table, the
        register tokens and the in-context position table."""
        return [getattr(self, n) for n in ("y_embed", "register_tokens",
                                           "in_context_posemb")
                if hasattr(self, n)]
