"""Diffusion denoiser factory: the ``unet_mha`` branch of
``joligen_tpu/models/diffusion_networks.py:20-45,119-134``, plus the seeded
flax-style weight init. torch convs need their input channel count, so the
mask embedding's ``cond_embed_dim`` channels are added to ``in_channel``
here (flax infers it lazily). ``tpu_remat`` and ``tpu_remat_policy`` reach
``UNetMHA`` as in ``diffusion_networks.py:42-43``."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import compute_dtype
from .modules.palette_diffusion import LabelEmbedder, PaletteDenoiser
from .modules.unet_mha import Conv, Dense, GroupNorm, UNetMHA


def define_inner_G(opt):
    netG = opt.G_netG
    if netG != "unet_mha":
        raise NotImplementedError(
            f"diffusion generator {netG}: only unet_mha is ported "
            "(ROADMAP Queue 1 items 8 to 13, the model families after the "
            "main path)")
    cond = getattr(opt, "alg_diffusion_cond_embed", "") or ""
    extra = opt.alg_diffusion_cond_embed_dim if "mask" in cond else 0
    return UNetMHA(
        in_channel=opt.model_input_nc + opt.model_output_nc + extra,
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
    """Full conditioned denoiser: (x, gammas, cls, mask) -> eps_hat."""
    conditioning = getattr(opt, "alg_diffusion_cond_embed", "") or ""
    nclasses = max(getattr(opt, "f_s_semantic_nclasses", 2),
                   getattr(opt, "cls_semantic_nclasses", 2))
    return PaletteDenoiser(
        inner=define_inner_G(opt),
        cond_embed_dim=opt.alg_diffusion_cond_embed_dim,
        conditioning=conditioning,
        nclasses=nclasses,
        dtype=compute_dtype(opt),
    )


def init_weights(module, generator, zero_init_std=0.0):
    """Seeded flax-style init: lecun-normal (truncated) conv and dense
    kernels, zero biases, unit norm scales, N(0, 0.02) embedding tables.
    Layers that flax zero-initialises (``out_conv``, ``proj_out``,
    ``out_proj``) stay zero unless ``zero_init_std`` > 0, which gives them a
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
                if m.zero_init:
                    if zero_init_std > 0:
                        fill(m.weight, normal(zero_init_std))
                        fill(m.bias, normal(zero_init_std))
                    else:
                        m.weight.zero_()
                        m.bias.zero_()
                    continue
                fan_in = m.weight[0].numel()
                # flax lecun_normal: truncated at 2 std, std corrected for
                # the truncation (variance_scaling "truncated_normal")
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                fill(m.weight, lambda t: nn.init.trunc_normal_(
                    t, 0.0, std, -2 * std, 2 * std, generator=generator))
                m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LabelEmbedder):
                fill(m.weight, normal(0.02))
    return module
