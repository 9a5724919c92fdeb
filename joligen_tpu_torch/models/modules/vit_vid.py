"""JiTViD, the video JiT denoiser of ``G_netG: vit_vid``
(``joligen_tpu/models/modules/vit_vid.py``): per-frame JiT blocks with the
frames folded into the batch, and a temporal motion module over the frame
axis of the patch tokens.

``forward(x (B, F, H, W, C), t (B,) or (B, F) in [0, 1], y, mask_size,
temporal_frame_step) -> (B, F, H, W, out_channels)`` fp32:

1. ``x_embed``: a bottleneck patch embedding per frame (bias-free
   ``proj1``, then ``proj2``), plus the fixed 2-D sin-cos table;
2. the conditioning vector c per (clip, frame): the raw fractional t
   (not × 1000) through the 256-wide sinusoidal embedding, ``t_0``, SiLU,
   ``t_1``; the class row of ``y_embed`` (its last row the CFG null class);
   the 6-d mask-bbox descriptor (``ms_0``, SiLU, zero-init ``ms_1``); the
   temporal frame step (sinusoidal, ``fs_0``, SiLU, zero-init ``fs_1``);
3. the blocks in segments (``_segments``): ``blocks{i}`` holds the
   ``JiTBlock``s of segment i (the JAX package stacks each segment with
   ``nn.scan``; the converter splits the stack into the per-block modules
   ``blocks{i}.{j}``), split at the block ``in_context_start``, where the
   register tokens and the in-context class tokens (the class embedding
   plus ``in_context_posemb``) are prepended and RoPE gets identity rows
   for them, and after each motion insert. ``motion_every`` 0 puts one
   shared module, ``motion``, after the last block; else ``motion{i}``
   after every ``motion_every`` blocks and the last;
4. the final layer: zero-init ``final_adaLN`` shift and scale of
   ``final_norm``, zero-init ``final_proj`` to the patch pixels.

``TokenMotionModule``: GroupNorm over the channels (32 groups, eps 1e-6,
flax's E[x²] − E[x]² variance), ``proj_in``, 2 ``TemporalTransformerBlock``s
of the port's ``motion.py`` over (B * T, F, d) sequences, zero-init
``proj_out``, residual. At JiT-B/16 that is 8 heads of 96 channels: K1 (and
K2/K3) at head dim 96, the packed tiling over F = 8 frames.

``tpu_remat`` runs each block under ``torch.utils.checkpoint``, as
``nn.remat`` does; names and checkpoints are the same.

The global context (``alg_b2b_global_context_mode``): a masked image of the
whole frame (B, h, w, 3), repeated over the frames, or one a frame (B, F,
h, w, 3). ``adaln``: ``GlobalContextEncoder`` (``gc_enc``) adds its vector
to c, when a context is given. ``tokens``: the image through ``gc_embed``
(a bottleneck patch embedding), plus ``gc_posemb`` and ``gc_type``, joins
the prefix; a zero image stands in when none is given. The object
references (``alg_b2b_object_ref_paths``, N of them): (B, N, s, s, 3)
through ``oref_embed`` plus ``oref_posemb`` and ``oref_type``, shared by
every frame of a clip (zeros when none are given). The prefix is
[registers, global context, object references, in-context] at the block
``in_context_start``; JiT-B/16 in ``tokens`` mode with one reference of 64
px at 128 px runs its blocks 4-11 at S = 64 + 64 + 16 + 32 = 176.
``alg_b2b_global_context_conditioning`` is read by nothing, as in the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.schedules import timestep_embedding
from .jit import (JiTBlock, RMSNorm, axial_rope_tables, cached_tables,
                  jit_config, modulate, sincos_2d_pos_embed)
from .motion import TemporalTransformerBlock
from .unet_mha import Conv, Dense, GroupNorm


class TokenMotionModule(nn.Module):
    """Temporal transformer over the frames of patch tokens: (B, F, T, d)
    in and out, the identity while ``proj_out`` is zero."""

    def __init__(self, dim, num_heads=8, num_layers=2, max_len=25,
                 dtype=torch.float32):
        super().__init__()
        groups = 32
        while dim % groups:
            groups -= 1
        self.dtype = dtype
        self.num_layers = num_layers
        self.norm = GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = Dense(dim, dim, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"block{i}", TemporalTransformerBlock(
                dim, num_heads, max_len=max_len, dtype=dtype))
        self.proj_out = Dense(dim, dim, dtype=dtype, zero_init=True)

    def forward(self, x):
        b, f, t, d = x.shape
        # statistics per (clip, frame) over (tokens, channels of a group)
        y = self.norm(x.reshape(b * f, t, d).to(self.dtype).transpose(1, 2))
        y = self.proj_in(y.transpose(1, 2))
        y = y.reshape(b, f, t, d).transpose(1, 2).reshape(b * t, f, d)
        for i in range(self.num_layers):
            y = getattr(self, f"block{i}")(y)
        y = y.reshape(b, t, f, d).transpose(1, 2)
        return x + self.proj_out(y)


class GlobalContextEncoder(nn.Module):
    """The masked global-context image (N, h, w, 3) -> (N, hidden): four
    3×3 stride-2 convs of 64, 128, 256 and 256 channels, each with
    GroupNorm(min(32, ch)) (flax's eps 1e-6) and SiLU, the spatial mean,
    ``proj0``, SiLU and the zero-initialised ``proj1`` (a no-op on c at
    init)."""

    CHANNELS = (64, 128, 256, 256)

    def __init__(self, hidden_size, dtype=torch.float32):
        super().__init__()
        cin = 3
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv{i}", Conv(cin, ch, 3, 2, 1, dtype=dtype))
            self.add_module(f"gn{i}", GroupNorm(min(32, ch), ch, eps=1e-6))
            cin = ch
        self.proj0 = Dense(cin, hidden_size, dtype=dtype)
        self.proj1 = Dense(hidden_size, hidden_size, dtype=dtype,
                           zero_init=True)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.CHANNELS)):
            h = getattr(self, f"conv{i}")(h)
            h = F.silu(getattr(self, f"gn{i}")(h))
        return self.proj1(F.silu(self.proj0(h.mean(dim=(2, 3)))))


class BottleneckPatchEmbed(nn.Module):
    """(N, H, W, C) -> (N, T, hidden): patches, bias-free ``proj1`` to the
    bottleneck, ``proj2``."""

    def __init__(self, in_channels, bottleneck_dim, hidden_size, patch_size,
                 dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj1 = Dense(patch_size * patch_size * in_channels,
                           bottleneck_dim, dtype=dtype, use_bias=False)
        self.proj2 = Dense(bottleneck_dim, hidden_size, dtype=dtype)

    def forward(self, x):
        n, hh, ww, c = x.shape
        p = self.patch_size
        patches = x.reshape(n, hh // p, p, ww // p, p, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, (hh // p) * (ww // p), p * p * c)
        return self.proj2(self.proj1(patches.to(self.dtype)))


class JiTViD(nn.Module):
    """The video JiT denoiser (see the module doc)."""

    def __init__(self, in_channels, patch_size=16, hidden_size=768, depth=12,
                 num_heads=12, bottleneck_dim=128, num_classes=1,
                 num_register_tokens=0, in_context_len=32,
                 in_context_start=4, out_channels=None,
                 mask_size_conditioning=False,
                 temporal_frame_step_conditioning=False,
                 global_context_mode="none", global_context_size=128,
                 object_ref_num_images=0, object_ref_size=64, motion_every=0,
                 motion_num_heads=8, motion_num_layers=2, max_frames=25,
                 remat=False, dtype=torch.float32):
        super().__init__()
        d = hidden_size
        self.patch_size = patch_size
        self.hidden_size = d
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.num_register_tokens = num_register_tokens
        self.in_context_len = in_context_len
        self.in_context_start = in_context_start
        self.out_channels = out_channels or in_channels
        self.mask_size_conditioning = mask_size_conditioning
        self.frame_step_conditioning = temporal_frame_step_conditioning
        self.global_context_mode = global_context_mode
        self.global_context_size = global_context_size
        self.object_ref_num_images = object_ref_num_images
        self.object_ref_size = object_ref_size
        self.motion_every = motion_every
        self.remat = remat
        self.dtype = dtype
        self._tables = {}

        self.x_embed = BottleneckPatchEmbed(in_channels, bottleneck_dim, d,
                                            patch_size, dtype=dtype)
        self.t_0 = Dense(256, d, dtype=dtype)
        self.t_1 = Dense(d, d, dtype=dtype)
        # the class table with its null row (the last): N(0, 0.02)
        self.y_embed = nn.Parameter(torch.zeros(num_classes + 1, d))
        if mask_size_conditioning:
            self.ms_0 = Dense(6, d, dtype=dtype)
            self.ms_1 = Dense(d, d, dtype=dtype, zero_init=True)
        if temporal_frame_step_conditioning:
            self.fs_0 = Dense(256, d, dtype=dtype)
            self.fs_1 = Dense(d, d, dtype=dtype, zero_init=True)
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, d))
        if global_context_mode == "adaln":
            self.gc_enc = GlobalContextEncoder(d, dtype=dtype)
        elif global_context_mode == "tokens":
            self.gc_embed = BottleneckPatchEmbed(3, bottleneck_dim, d,
                                                 patch_size, dtype=dtype)
            n_gc = (global_context_size // patch_size) ** 2
            self.gc_posemb = nn.Parameter(torch.zeros(1, n_gc, d))
            self.gc_type = nn.Parameter(torch.zeros(1, 1, d))
        if object_ref_num_images > 0:
            self.oref_embed = BottleneckPatchEmbed(3, bottleneck_dim, d,
                                                   patch_size, dtype=dtype)
            n_oref = object_ref_num_images * (object_ref_size
                                              // patch_size) ** 2
            self.oref_posemb = nn.Parameter(torch.zeros(1, n_oref, d))
            self.oref_type = nn.Parameter(torch.zeros(1, 1, d))
        if in_context_len > 0:
            self.in_context_posemb = nn.Parameter(
                torch.zeros(1, in_context_len, d))
        self.would_insert = (num_register_tokens > 0 or in_context_len > 0
                             or global_context_mode == "tokens"
                             or object_ref_num_images > 0)
        self.split_at = in_context_start if self.would_insert else depth
        share_motion = motion_every <= 0
        for si, (a, b, has_motion) in enumerate(self._segments()):
            self.add_module(f"blocks{si}", nn.ModuleList(
                JiTBlock(d, num_heads, dtype=dtype) for _ in range(b - a)))
            if has_motion:
                self.add_module("motion" if share_motion else f"motion{si}",
                                TokenMotionModule(d, motion_num_heads,
                                                  motion_num_layers,
                                                  max_len=max_frames,
                                                  dtype=dtype))
        self.final_adaLN = Dense(d, 2 * d, dtype=dtype, zero_init=True)
        self.final_norm = RMSNorm(d)
        self.final_proj = Dense(d, patch_size * patch_size
                                * self.out_channels, dtype=dtype,
                                zero_init=True)

    @classmethod
    def from_opt(cls, opt, in_channels, dtype=torch.float32):
        """The JAX ``JiTViD.from_opt``: ``jit_config`` (the ``JiTVid-*``
        variants are the ``JiT-*`` ones), the motion, mask-size,
        frame-step, global-context and object-reference settings from the
        options (the references by their count)."""
        variant = getattr(opt, "G_vit_variant", "") or "JiT-B/16"
        cfg = jit_config(opt, variant.replace("JiTVid-", "JiT-", 1))
        return cls(
            in_channels, patch_size=cfg["patch_size"],
            hidden_size=cfg["hidden_size"], depth=cfg["depth"],
            num_heads=cfg["num_heads"], bottleneck_dim=cfg["bottleneck_dim"],
            num_classes=max(1, getattr(opt, "G_vit_num_classes", 1)),
            num_register_tokens=getattr(opt, "G_vit_num_register_tokens", 0),
            in_context_len=cfg.get("in_context_len", 32),
            in_context_start=cfg.get("in_context_start", 4),
            out_channels=opt.model_output_nc,
            mask_size_conditioning=getattr(
                opt, "alg_b2b_mask_size_conditioning", False),
            temporal_frame_step_conditioning=getattr(
                opt, "alg_b2b_temporal_frame_step_conditioning", False),
            global_context_mode=(getattr(opt, "alg_b2b_global_context_mode",
                                         "") or "none"),
            global_context_size=getattr(opt, "alg_b2b_global_context_size",
                                        128),
            object_ref_num_images=len(
                getattr(opt, "alg_b2b_object_ref_paths", []) or []),
            object_ref_size=getattr(opt, "alg_b2b_object_ref_size", 64),
            motion_every=getattr(opt, "G_vit_vid_motion_every", 0) or 0,
            max_frames=max(25, getattr(opt, "data_temporal_number_frames",
                                       8)),
            remat=bool(getattr(opt, "tpu_remat", False)), dtype=dtype)

    def _segments(self):
        """[(start, end, has_motion_after)]: blocks [start, end) form one
        segment; the depth splits after each motion insert and at the
        prefix-insertion block."""
        if self.motion_every <= 0:
            motion_after = {self.depth - 1}
        else:
            motion_after = {i for i in range(self.depth)
                            if (i + 1) % self.motion_every == 0}
            motion_after.add(self.depth - 1)
        bounds = {0, self.depth}
        bounds |= {i + 1 for i in motion_after if i + 1 < self.depth}
        if 0 < self.split_at < self.depth:
            bounds.add(self.split_at)
        bounds = sorted(bounds)
        return [(a, b, (b - 1) in motion_after)
                for a, b in zip(bounds[:-1], bounds[1:])]

    def _block(self, block, h, c, rc, rs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, h, c, rc, rs, use_reentrant=False)
        return block(h, c, rc, rs)

    def _per_frame(self, v, b, f, bf):
        """(B,) or (1,) or (B*F,) values -> (B*F,)."""
        v = v.reshape(-1)
        if v.shape[0] == b:
            return v.repeat_interleave(f)
        if v.shape[0] == 1:
            return v.expand(bf)
        return v

    def _per_frame_images(self, img, f, bf):
        """(B, h, w, 3) images repeated over the frames, or (B, F, h, w, 3)
        ones folded: (B*F, h, w, 3)."""
        if img.ndim == 4:
            return img.repeat_interleave(f, dim=0)
        return img.reshape((bf,) + tuple(img.shape[2:]))

    def _prefix(self, y_emb, global_context, object_ref, b, f, bf, dtype):
        """The prefix tokens, [registers, global context, object
        references, in-context], and their count."""
        dev = y_emb.device
        prefix = []
        if self.num_register_tokens > 0:
            prefix.append(self.register_tokens.to(dtype).expand(bf, -1, -1))
        if self.global_context_mode == "tokens":
            s = self.global_context_size
            gc = (torch.zeros(bf, s, s, 3, device=dev)
                  if global_context is None
                  else self._per_frame_images(global_context, f, bf))
            tok = self.gc_embed(gc)
            prefix.append(tok + self.gc_posemb.to(tok.dtype)
                          + self.gc_type.to(tok.dtype))
        if self.object_ref_num_images > 0:
            if object_ref is None:
                s = self.object_ref_size
                object_ref = torch.zeros(b, self.object_ref_num_images, s, s,
                                         3, device=dev)
            tok = self.oref_embed(object_ref.reshape(
                (-1,) + tuple(object_ref.shape[2:])))
            tok = tok.reshape(b, -1, tok.shape[-1])
            tok = (tok + self.oref_posemb.to(tok.dtype)
                   + self.oref_type.to(tok.dtype))
            prefix.append(tok.repeat_interleave(f, dim=0))
        if self.in_context_len > 0:
            prefix.append(y_emb[:, None, :]
                          + self.in_context_posemb.to(dtype))
        return prefix, sum(t.shape[1] for t in prefix)

    def forward(self, x, t, y=None, mask_size=None, temporal_frame_step=None,
                global_context=None, object_ref=None):
        b, f, hh, ww, cin = x.shape
        p, d = self.patch_size, self.hidden_size
        gh, gw = hh // p, ww // p
        hd = d // self.num_heads
        bf = b * f
        dev = x.device

        h = self.x_embed(x.reshape(bf, hh, ww, cin))
        (pos,) = cached_tables(self._tables, ("pos", gh, gw),
                               lambda: (sincos_2d_pos_embed(d, gh, gw),), dev)
        h = h + pos.to(h.dtype)[None]

        t = torch.as_tensor(t, device=dev)
        t = t.repeat_interleave(f) if t.ndim == 1 else t.reshape(bf)
        c = self.t_1(F.silu(self.t_0(timestep_embedding(t, 256))))
        if y is None:
            y = torch.full((b,), self.num_classes, dtype=torch.long,
                           device=dev)
        yf = y.repeat_interleave(f) if y.shape[0] == b else y
        y_emb = self.y_embed[yf.long()].to(c.dtype)
        c = c + y_emb
        if self.mask_size_conditioning:
            if mask_size is None:
                mask_size = torch.zeros(bf, 6, device=dev)
            elif mask_size.ndim == 2 and mask_size.shape[0] == b:
                mask_size = mask_size.repeat_interleave(f, dim=0)
            elif mask_size.ndim == 3:
                mask_size = mask_size.reshape(bf, -1)
            ms = self.ms_0(mask_size.to(self.dtype))
            c = c + self.ms_1(F.silu(ms))
        if self.frame_step_conditioning:
            fs = (torch.zeros(bf, device=dev) if temporal_frame_step is None
                  else self._per_frame(torch.as_tensor(
                      temporal_frame_step, device=dev).float(), b, f, bf))
            fs_emb = self.fs_0(timestep_embedding(fs, 256))
            c = c + self.fs_1(F.silu(fs_emb))
        if self.global_context_mode == "adaln" and global_context is not None:
            c = c + self.gc_enc(self._per_frame_images(global_context, f,
                                                       bf))

        cos0, sin0 = cached_tables(self._tables, ("rope", gh, gw, hd, 0),
                                   lambda: axial_rope_tables(gh, gw, hd), dev)
        cos1 = sin1 = None
        share_motion = self.motion_every <= 0
        n_prefix = 0
        for si, (a, b2, has_motion) in enumerate(self._segments()):
            if a == self.split_at and a < self.depth and self.would_insert:
                prefix, n_prefix = self._prefix(y_emb, global_context,
                                                object_ref, b, f, bf,
                                                h.dtype)
                h = torch.cat(prefix + [h], dim=1)
                cos1, sin1 = cached_tables(
                    self._tables, ("rope", gh, gw, hd, n_prefix),
                    lambda: axial_rope_tables(gh, gw, hd, prefix=n_prefix),
                    dev)
            rc, rs = ((cos1, sin1) if (a >= self.split_at and n_prefix)
                      else (cos0, sin0))
            for block in getattr(self, f"blocks{si}"):
                h = self._block(block, h, c, rc, rs)
            if has_motion:
                motion = getattr(self, "motion" if share_motion
                                 else f"motion{si}")
                tok = motion(h[:, n_prefix:].reshape(b, f, gh * gw, d))
                tok = tok.reshape(bf, gh * gw, d)
                h = torch.cat([h[:, :n_prefix], tok], dim=1) if n_prefix \
                    else tok

        if n_prefix:
            h = h[:, n_prefix:]
        shift, scale = torch.chunk(self.final_adaLN(F.silu(c)), 2, dim=-1)
        h = self.final_proj(modulate(self.final_norm(h), shift, scale))
        oc = self.out_channels
        h = h.reshape(bf, gh, gw, p, p, oc).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(b, f, hh, ww, oc).float()

    def embedding_params(self):
        """The parameters flax draws from N(0, 0.02): the class table, the
        register tokens, the global context's and the object references'
        position tables and type rows, and the in-context position
        table."""
        return [getattr(self, n) for n in (
            "y_embed", "register_tokens", "gc_posemb", "gc_type",
            "oref_posemb", "oref_type", "in_context_posemb")
            if hasattr(self, n)]
