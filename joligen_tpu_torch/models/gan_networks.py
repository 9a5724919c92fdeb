"""GAN network factories (``joligen_tpu/models/gan_networks.py``): every
generator of the JAX package (resnet, resnet_attn and their mobile
variants, unet_mha, uvit, unet_256/128, segformer, hdit, hat, ittr), the
``basic`` / ``n_layers`` / ``pixel`` / ``projected_d`` / ``temporal`` /
``vision_aided`` discriminators, the gumbel ``mask`` D (a PatchGAN over the one-hot masks
of ``f_s_semantic_nclasses`` channels) and the ResNet-template Ds
(``resnet18``, ``resnet34``, ``resnet50``: one logit an image, fp32), and
the ``PatchSampleF`` projector. A generator name the JAX package refuses
raises as there; any other discriminator raises, naming its ROADMAP item.

torch layers need their input sizes, which flax infers: the factories take
them from the options (``model_input_nc``, ``model_output_nc``, the crop)
and ``define_F`` from the generator's encoder taps.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from .. import compute_dtype
from .modules.cut_networks import PatchSampleF
from .modules.discriminators import NLayerDiscriminator, PixelDiscriminator
from .modules.resnet_generator import ResnetGenerator, ResnetGeneratorAttn
from .modules.semantic_networks import RESNET_CFG, ResNetTemplate

_ROADMAP_ZOO = "ROADMAP Queue 1 item 13, rest of the zoo"
UNPORTED_D = {"depth": _ROADMAP_ZOO, "sam": _ROADMAP_ZOO}


def define_G(opt):
    netG = opt.G_netG
    dtype = compute_dtype(opt)
    common = dict(
        in_channels=opt.model_input_nc, out_channels=opt.model_output_nc,
        ngf=opt.G_ngf, n_blocks=opt.G_nblocks, norm=opt.G_norm,
        padding_type=opt.G_padding_type, mobile="mobile" in netG,
        freq_space=getattr(opt, "train_feat_wavelet", False),
        use_spectral=getattr(opt, "G_spectral", False),
        up_mode=getattr(opt, "G_resnet_up_mode", "resize"), dtype=dtype)
    if netG in ("resnet", "mobile_resnet", "resnet_9blocks", "resnet_6blocks"):
        return ResnetGenerator(dropout=0.5 if opt.G_dropout else 0.0,
                               **common)
    if netG in ("resnet_attn", "mobile_resnet_attn"):
        return ResnetGeneratorAttn(
            nb_mask_attn=opt.G_attn_nb_mask_attn,
            nb_mask_input=opt.G_attn_nb_mask_input, **common)
    if "segformer" in netG:     # segformer_attn_conv, segformer_conv
        from .modules.segformer import SegformerGeneratorAttn
        return SegformerGeneratorAttn(
            in_channels=opt.model_input_nc, out_channels=opt.model_output_nc,
            nb_mask_attn=opt.G_attn_nb_mask_attn,
            nb_mask_input=opt.G_attn_nb_mask_input, dtype=dtype)
    if netG in ("unet_mha", "uvit", "unet_256", "unet_128"):
        from .modules.unet_mha import UNetMHA
        unet = dict(in_channel=opt.model_input_nc,
                    out_channel=opt.model_output_nc, inner_channel=opt.G_ngf,
                    cond_embed_dim=opt.G_ngf * 4, tanh=True, dtype=dtype)
        if netG in ("unet_256", "unet_128"):
            # the pix2pix unet as the attention-free unet_mha (its middle
            # block keeps its attention)
            return UNetMHA(res_blocks=(1, 1, 1, 1), attn_res=(),
                           channel_mults=(1, 2, 4, 8), **unet)
        return UNetMHA(
            transformer_blocks=(getattr(opt, "G_uvit_num_transformer_blocks",
                                        6) if netG == "uvit" else 0),
            res_blocks=tuple(opt.G_unet_mha_res_blocks),
            attn_res=tuple(opt.G_unet_mha_attn_res),
            channel_mults=tuple(opt.G_unet_mha_channel_mults),
            num_heads=opt.G_unet_mha_num_heads,
            num_head_channels=opt.G_unet_mha_num_head_channels,
            norm=opt.G_unet_mha_norm_layer,
            group_size=opt.G_unet_mha_group_norm_size,
            freq_space=getattr(opt, "train_feat_wavelet", False), **unet)
    if netG == "hdit":
        from .modules.hdit import HDiT
        return HDiT.gan_from_opt(opt, dtype=dtype)
    if netG == "hat":
        from .modules.hat import HAT
        # window 16, upscale 1 (gan_networks.py:77-83); its bias tables
        # take the crop's window, as flax sizes them at init
        return HAT(in_channels=opt.model_input_nc,
                   out_channels=opt.model_output_nc,
                   img_size=opt.data_crop_size, window_size=16, upscale=1,
                   remat=bool(getattr(opt, "tpu_remat", False)),
                   dtype=dtype)
    if netG == "ittr":
        from .modules.ittr import ITTRGenerator
        return ITTRGenerator(
            in_channels=opt.model_input_nc, out_channels=opt.model_output_nc,
            ngf=opt.G_ngf, n_blocks=opt.G_nblocks,
            img_size=opt.data_crop_size, dtype=dtype)
    raise NotImplementedError(f"GAN generator {netG}")


def define_P(opt):
    """ReCUT's and ReCycleGAN's frame predictor P (``cut_model.py:294-300``,
    ``cycle_gan_model.py:104-110``): the generator ``alg_re_netP``
    (resnet_9blocks, resnet_6blocks, resnet_attn, unet_256 or unet_128; the
    rest of the options as G's) from the channel stack of
    ``alg_re_nuplet_size`` - 1 frames to the next frame. flax infers P's
    input width from that stack; here it comes from a copy of the options
    with ``model_input_nc`` set to it. Of those five nets only the input
    layer reads ``model_input_nc``; resnet_attn blends the stack's first 3
    channels, the oldest frame, as the JAX net does."""
    popt = copy.copy(opt)
    popt.G_netG = getattr(opt, "alg_re_netP", "unet_128") or "unet_128"
    nuplet = int(getattr(opt, "alg_re_nuplet_size", 3) or 3)
    popt.model_input_nc = (nuplet - 1) * opt.model_input_nc
    return define_G(popt)


def init_raw_leaves(module, generator):
    """flax's init of the raw leaves that neither the init schemes nor
    ``init_weights`` draw: UViT's ``qkv_kernel`` lecun-normal (flax reads
    its first axis, 3C, as the fan-in), HAT's bias tables ``rpb``
    N(0, 0.02) truncated at 2 std; drawn from the CPU ``generator``. The
    zero-initialised ones (``proj_kernel``, ``proj_bias``) stay zero, the
    constants (ITTR's ``g`` and ``b``, HDiT's scales) as constructed."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "qkv_kernel":
                std = math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
            elif leaf == "rpb":
                std = 0.02
            else:
                continue
            t = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            p.copy_(t)
    return module


def define_D(opt, names=None):
    """name -> discriminator, one per ``D_netDs`` entry, named ``D_B_<entry>``
    as in the JAX package."""
    dtype = compute_dtype(opt)
    names = names if names is not None else list(opt.D_netDs)
    cin = opt.model_output_nc
    ds = {}
    for name in names:
        if name in ("basic", "n_layers"):
            ds["D_B_" + name] = NLayerDiscriminator(
                in_channels=cin, ndf=opt.D_ndf, n_layers=opt.D_n_layers,
                norm=opt.D_norm,
                antialias=not getattr(opt, "D_no_antialias", False),
                use_dropout=getattr(opt, "D_dropout", False),
                use_spectral=getattr(opt, "D_spectral", False),
                freq_space=getattr(opt, "train_feat_wavelet", False),
                dtype=dtype)
        elif name == "pixel":
            ds["D_B_" + name] = PixelDiscriminator(
                in_channels=cin, ndf=opt.D_ndf, norm=opt.D_norm, dtype=dtype)
        elif name == "projected_d":
            from .modules.projected_d import (_LITE0_STAGES, _LITE3_STAGES,
                                              ProjectedDiscriminator)
            ptype = getattr(opt, "D_proj_network_type",
                            "efficientnet") or "efficientnet"
            if ptype in ("vitbase", "vitsmall", "vitclip16", "siglip",
                         "dinov2_vitb14"):
                raise NotImplementedError(
                    f"D_proj_network_type={ptype}: ViT-feature "
                    f"discriminators are not ported ({_ROADMAP_ZOO})")
            ds["D_B_" + name] = ProjectedDiscriminator(
                size=opt.data_crop_size,
                interp=getattr(opt, "D_proj_interp", -1),
                network_type=ptype,
                trunk_stages=(_LITE3_STAGES if ptype == "depth"
                              else _LITE0_STAGES), dtype=dtype)
        elif name == "temporal":
            # judges clips (gan_networks.py:141-144): the EfficientNet
            # trunk whatever D_proj_network_type
            from .modules.projected_d import TemporalProjectedDiscriminator
            ds["D_B_" + name] = TemporalProjectedDiscriminator(
                size=opt.data_crop_size,
                interp=getattr(opt, "D_proj_interp", -1), dtype=dtype)
        elif name == "vision_aided":
            from ..utils.clip_vit import clip_weights_path
            from .modules.vision_aided_d import VisionAidedDiscriminator
            bks = vision_aided_backbones(opt)
            if clip_weights_path() is None and "clip" in bks:
                print("vision_aided D: clip_vitb16.npz not found in "
                      "JOLIGEN_TPU_WEIGHTS_DIR — using frozen random CLIP "
                      "features")
            ds["D_B_" + name] = VisionAidedDiscriminator(backbones=bks,
                                                         dtype=dtype)
        elif name == "mask":
            # judges one-hot masks (gan_networks.py:190-198): no freq_space
            ds["D_B_" + name] = NLayerDiscriminator(
                in_channels=opt.f_s_semantic_nclasses, ndf=opt.D_ndf,
                n_layers=opt.D_n_layers, norm=opt.D_norm,
                antialias=not getattr(opt, "D_no_antialias", False),
                use_dropout=getattr(opt, "D_dropout", False),
                use_spectral=getattr(opt, "D_spectral", False), dtype=dtype)
        elif name in RESNET_CFG:
            # the template without a dtype: fp32 (gan_networks.py:199-207)
            ds["D_B_" + name] = ResNetTemplate(nclasses=1, variant=name)
        else:
            where = UNPORTED_D.get(name, _ROADMAP_ZOO)
            raise NotImplementedError(
                f"discriminator {name} is not ported ({where})")
    return ds


def vision_aided_backbones(opt):
    """The towers of ``D_vision_aided_backbones`` (``gan_networks.py:
    145-168``): ``clip*`` is clip, ``dino*`` dino, any other name is skipped
    with a notice (swin is not ported in the JAX package either); none left
    falls back to clip."""
    spec = (getattr(opt, "D_vision_aided_backbones", "clip+dino+swin")
            or "clip").lower()
    bks = []
    for tok in spec.split("+"):
        tok = tok.strip()
        if tok.startswith("clip"):
            bks.append("clip")
        elif tok.startswith("dino"):
            bks.append("dino")
        elif tok:
            print(f"vision_aided D: backbone '{tok}' not ported — skipped "
                  "(available: clip, dino)")
    return tuple(dict.fromkeys(bks)) or ("clip",)


def define_F(opt, in_channels):
    """``PatchSampleF`` over taps of ``in_channels`` channels."""
    netF = getattr(opt, "alg_cut_netF", "mlp_sample")
    return PatchSampleF(in_channels, nc=opt.alg_cut_netF_nc,
                        use_mlp="mlp" in netF, dtype=compute_dtype(opt))


# parameters flax initialises to zeros (the ViT towers' embeddings and
# CLIP's output projection)
ZERO_INIT = ("class_embedding", "positional_embedding", "proj", "cls_token",
             "pos_embed")


def flax_default_init(module, generator):
    """flax's default init: lecun-normal (truncated at 2 std) kernels, zero
    biases and ``ZERO_INIT`` tables, unit norm scales (and LayerScales);
    drawn from the CPU ``generator``. A ``DenseGeneral`` kernel (flax's
    layout) divides by its ``fan_in``."""
    with torch.no_grad():
        for mod in module.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                _flax_init(mod, leaf, p, generator)
    return module


def _flax_init(mod, leaf, p, generator):
    # the temporal D's LSTM cells: lecun-normal over the first axis of
    # lstm_w{i} (2c, 4c), zero lstm_b{i}
    if leaf == "bias" or leaf in ZERO_INIT or leaf.startswith("lstm_b"):
        p.zero_()
    elif p.ndim == 1:
        p.fill_(1.0)
    else:
        fan_in = (p.shape[0] if leaf.startswith("lstm_w")
                  else getattr(mod, "fan_in", None) or p[0].numel())
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        t = torch.empty(p.shape, dtype=torch.float32)
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        p.copy_(t)
