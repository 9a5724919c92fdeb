"""Diffusion denoiser factory: the ``unet_mha``, ``unet_vid``,
``unet_mha_ref_attn``, ``hdit``, ``vit``/``dit`` and ``vit_vid`` branches of
``joligen_tpu/models/diffusion_networks.py:20-45,57-112,119-134``, plus the
seeded flax-style weight init. torch layers need their input channel count,
which flax infers lazily: palette's trunk takes ``[y_cond, y_t]`` and, with
mask conditioning, the mask embedding's ``cond_embed_dim`` channels, or
under a ``RAW_T_NETGS`` trunk (which embeds t itself) the one clipped mask
channel; b2b, the consistency and shortcut denoisers pass their own
``in_channel``. ``tpu_remat`` and ``tpu_remat_policy`` reach ``UNetMHA`` as
in ``diffusion_networks.py:42-43``, ``tpu_remat`` the JiT blocks."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import compute_dtype
from .modules.cm import NoiseLevelEmbedding
from .modules.hdit import HDiT
from .modules.jit import JiT
from .modules.palette_diffusion import LabelEmbedder, PaletteDenoiser
from .modules.unet_mha import Conv, Dense, GroupNorm, UNetMHA
from .modules.unet_ref_attn import UNetRefAttn
from .modules.unet_vid import UNetVid
from .modules.vit_vid import JiTViD

# the denoisers over (B, F, H, W, C) clips (diffusion_networks.py:116)
VIDEO_NETGS = ("unet_vid", "vit_vid")
# the trunks that take raw t in [0, 1] (diffusion_networks.py:130)
RAW_T_NETGS = ("vit", "dit", "hdit", "vit_vid")


def define_inner_G(opt, in_channel=None):
    """The trunk; ``in_channel`` (default: palette's) is its first conv's
    input channel count. ``G_unet_vid_cross_attention_dim`` is read by
    neither package."""
    netG = opt.G_netG
    if netG not in ("unet_mha", "unet_mha_ref_attn", "unet_vid", "vit_vid",
                    "vit", "dit", "hdit"):
        raise NotImplementedError(
            f"diffusion generator {netG}: only unet_mha, unet_vid, "
            "unet_mha_ref_attn, hdit, vit (dit) and vit_vid are ported "
            "(ROADMAP Queue 1 items 9 to 13, the model families after the "
            "main path: uvit is item 9, the resnet_attn denoisers item 10)")
    if netG == "vit_vid":
        if in_channel is None:
            raise ValueError("vit_vid takes its input channel count from "
                             "its model (b2b)")
        return JiTViD.from_opt(opt, in_channel, dtype=compute_dtype(opt))
    if in_channel is None:
        cond = getattr(opt, "alg_diffusion_cond_embed", "") or ""
        extra = 0
        if "mask" in cond:
            extra = (1 if netG in RAW_T_NETGS
                     else opt.alg_diffusion_cond_embed_dim)
        in_channel = opt.model_input_nc + opt.model_output_nc + extra
    if netG in ("vit", "dit"):
        return JiT.from_opt(opt, in_channel, dtype=compute_dtype(opt))
    if netG == "hdit":
        return HDiT.from_opt(opt, in_channel, dtype=compute_dtype(opt))
    if netG == "unet_vid":
        return UNetVid(
            in_channel=in_channel,
            out_channel=opt.model_output_nc,
            inner_channel=opt.G_ngf,
            cond_embed_dim=opt.alg_diffusion_cond_embed_dim,
            res_blocks=tuple(opt.G_unet_mha_res_blocks),
            attn_res=tuple(opt.G_unet_mha_attn_res),
            channel_mults=tuple(opt.G_unet_mha_channel_mults),
            num_heads=opt.G_unet_mha_num_heads,
            num_head_channels=opt.G_unet_mha_num_head_channels,
            norm=opt.G_unet_mha_norm_layer,
            group_size=opt.G_unet_mha_group_norm_size,
            max_sequence_length=getattr(
                opt, "G_unet_vid_max_sequence_length", 25),
            motion_num_heads=getattr(opt, "G_unet_vid_num_attention_heads",
                                     8),
            motion_num_transformer_blocks=getattr(
                opt, "G_unet_vid_num_transformer_blocks", 2),
            attn_norm=getattr(opt, "G_unet_mha_attn_norm", "group"),
            remat=bool(getattr(opt, "tpu_remat", False)),
            dtype=compute_dtype(opt))
    if netG == "unet_mha_ref_attn":
        return UNetRefAttn(
            in_channel=opt.model_input_nc + opt.model_output_nc,
            x_channels=in_channel,
            out_channel=opt.model_output_nc,
            inner_channel=opt.G_ngf,
            cond_embed_dim=opt.alg_diffusion_cond_embed_dim,
            res_blocks=tuple(opt.G_unet_mha_res_blocks),
            attn_res=tuple(opt.G_unet_mha_attn_res),
            channel_mults=tuple(opt.G_unet_mha_channel_mults),
            num_heads=opt.G_unet_mha_num_heads,
            num_head_channels=opt.G_unet_mha_num_head_channels,
            norm=opt.G_unet_mha_norm_layer,
            group_size=opt.G_unet_mha_group_norm_size,
            remat=bool(getattr(opt, "tpu_remat", False)),
            dtype=compute_dtype(opt))
    return UNetMHA(
        in_channel=in_channel,
        out_channel=opt.model_output_nc,
        inner_channel=opt.G_ngf,
        cond_embed_dim=opt.alg_diffusion_cond_embed_dim,
        res_blocks=tuple(opt.G_unet_mha_res_blocks),
        attn_res=tuple(opt.G_unet_mha_attn_res),
        channel_mults=tuple(opt.G_unet_mha_channel_mults),
        num_heads=opt.G_unet_mha_num_heads,
        num_head_channels=opt.G_unet_mha_num_head_channels,
        norm=opt.G_unet_mha_norm_layer,
        group_size=opt.G_unet_mha_group_norm_size,
        attn_norm=getattr(opt, "G_unet_mha_attn_norm", "group"),
        freq_space=getattr(opt, "train_feat_wavelet", False),
        remat=bool(getattr(opt, "tpu_remat", False)),
        remat_policy=getattr(opt, "tpu_remat_policy", "conv") or "conv",
        dtype=compute_dtype(opt),
    )


def define_G(opt):
    """Full conditioned denoiser: (x, gammas, cls, mask, ref) -> eps_hat;
    a ``RAW_T_NETGS`` trunk takes the gammas as its t. Palette with the
    video JiT is not ported: vit_vid runs under b2b."""
    if opt.G_netG == "vit_vid":
        raise NotImplementedError(
            "palette with the vit_vid denoiser is not ported; b2b runs it "
            "(ROADMAP Queue 1 item 11, video diffusion)")
    conditioning = getattr(opt, "alg_diffusion_cond_embed", "") or ""
    nclasses = max(getattr(opt, "f_s_semantic_nclasses", 2),
                   getattr(opt, "cls_semantic_nclasses", 2))
    ref_embed_net = getattr(opt, "alg_diffusion_ref_embed_net", "") or ""
    return PaletteDenoiser(
        inner=define_inner_G(opt),
        cond_embed_dim=opt.alg_diffusion_cond_embed_dim,
        conditioning=conditioning,
        nclasses=nclasses,
        raw_t=opt.G_netG in RAW_T_NETGS,
        ref_embed_net=(ref_embed_net
                       if ref_embed_net in ("clip", "imagebind") else ""),
        ref_channels=opt.model_input_nc,
        dtype=compute_dtype(opt),
    )


def init_weights(module, generator, zero_init_std=0.0):
    """Seeded flax-style init: lecun-normal (truncated) conv and dense
    kernels, zero biases, unit norm scales, N(0, 0.02) embedding tables,
    N(0, scale) Fourier features of a ``NoiseLevelEmbedding``.
    JiT's and JiTViD's class tables, register tokens and in-context
    positions N(0, 0.02); HDiT's attention scales (10) and skip lerps (0.5)
    keep their construction values.
    Layers that flax zero-initialises (``out_conv``, ``proj_out``,
    ``out_proj``, JiT's ``adaLN``, ``final_adaLN``, ``final_proj``, ``ms_1``,
    ``fs_1``, HDiT's ``lin``, ``proj``, ``ff_out``, ``down{i}`` and
    ``patch_out``) stay zero unless ``zero_init_std`` > 0, which gives them a
    small seeded N(0, zero_init_std) value instead. ``generator`` is a CPU
    generator: values are drawn on the CPU and copied, so they do not depend
    on the module's device."""

    def fill(p, draw):
        t = torch.empty(p.shape, dtype=torch.float32)
        draw(t)
        p.copy_(t)

    def normal(std):
        return lambda t: t.normal_(0.0, std, generator=generator)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, Dense)):
                biases = [] if m.bias is None else [m.bias]
                if m.zero_init:
                    for p in [m.weight, *biases]:
                        if zero_init_std > 0:
                            fill(p, normal(zero_init_std))
                        else:
                            p.zero_()
                    continue
                fan_in = m.weight[0].numel()
                # flax lecun_normal: truncated at 2 std, std corrected for
                # the truncation (variance_scaling "truncated_normal")
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                fill(m.weight, lambda t: nn.init.trunc_normal_(
                    t, 0.0, std, -2 * std, 2 * std, generator=generator))
                for p in biases:
                    p.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LabelEmbedder):
                fill(m.weight, normal(0.02))
            elif isinstance(m, NoiseLevelEmbedding):
                fill(m.W, normal(m.scale))
            elif isinstance(m, (JiT, JiTViD)):
                for p in m.embedding_params():
                    fill(p, normal(0.02))
        # the frozen CLIP ref encoder: flax's default init, then its
        # weights file where it exists (palette_model.py:75-80)
        clip = getattr(module, "freezenet_clip", None)
        if clip is not None:
            from ..utils.clip_vit import load_clip_ref_encoder
            from .gan_networks import flax_default_init
            flax_default_init(clip, generator)
            load_clip_ref_encoder(module)
    return module
