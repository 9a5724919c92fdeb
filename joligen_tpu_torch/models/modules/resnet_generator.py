"""ResNet generators of the CycleGAN/CUT family
(``joligen_tpu/models/modules/resnet_generator.py``): a 7×7 stem, two
stride-2 downs, ``n_blocks`` residual blocks, two ups and a 7×7 head (tanh);
``ResnetGeneratorAttn`` blends ``nb_mask_attn - nb_mask_input`` content
images and the input under a softmax over ``nb_mask_attn`` masks; ``mobile``
variants use separable convs.

Modules carry the flax names (``encoder.stem``, ``encoder.res3.conv1``,
``content_decoder.up0``...), so a state-dict key is the flax tree path. The
networks' ``forward`` takes and returns NHWC, as the JAX modules do; inside,
and in every submodule, tensors are NCHW. Encoder taps for the NCE losses
(``extract_layer_ids``) index the flat list [input, stem, down0, down1,
res0, ...], clamped to its end, as ``ResnetEncoder`` does.

Dtype policy (``tpu_bf16``): convs keep fp32 parameters and compute in
``dtype``; ``InstanceNorm`` takes fp32 statistics as E[x²] − E[x]² and
normalises in the input dtype; the decoders return fp32.

``ResnetGeneratorAttnDiff`` is ``resnet_attn`` as palette's denoiser: a
FiLM from the noise-level embedding at the bottleneck, no tanh.

``_pad``'s custom VJP in the JAX package is an HLO workaround; here
``F.pad``'s autograd is the transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.upfirdn2d import haar_transform, inverse_haar_transform
from .unet_mha import Dense, GroupNorm

PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
             "zeros": "constant"}


def _pad(x, p, mode="reflect"):
    """Spatial pad of an NCHW tensor (reflect, replicate or zeros)."""
    if p == 0:
        return x
    return F.pad(x, (p, p, p, p), mode=PAD_MODES[mode])


def same_pads(size, kernel, stride):
    """TF/flax ``"SAME"`` padding of one axis: (low, high). At stride 2 on
    an even size it is one more high than low."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv``: fp32 parameters, computed in ``dtype``; weight
    OIHW (I = 1 for a depthwise conv). ``padding`` is an int (both sides),
    ``"VALID"`` or ``"SAME"`` (TF rule, asymmetric where it must be)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1,
                 bias=True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel, self.stride, self.groups = kernel, stride, groups
        self.padding = 0 if padding == "VALID" else padding
        self.dtype = dtype

    def forward(self, x):
        pad = self.padding
        if pad == "SAME":
            (t, b), (l, r) = (same_pads(x.shape[2], self.kernel, self.stride),
                              same_pads(x.shape[3], self.kernel, self.stride))
            x = F.pad(x, (l, r, t, b))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, pad, groups=self.groups)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation without affine
    (``resnet_generator.py:89-113``)."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=(2, 3), keepdim=True)
        mean2 = (x32 * x32).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps).to(x.dtype)
        return (x - mean.to(x.dtype)) * scale


def make_norm(kind, channels):
    """``instance``, ``batch`` (flax GroupNorm with one channel a group,
    eps 1e-6) or none."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return GroupNorm(channels, channels, eps=1e-6)
    return nn.Identity()


def _add_norm(parent, kind, channels, index):
    """The norm module under its flax auto-name (``GroupNorm_<index>`` for
    ``batch``); returns it and the next index."""
    norm = make_norm(kind, channels)
    if kind == "batch":
        parent.add_module(f"GroupNorm_{index}", norm)
        return norm, index + 1
    return norm, index


class SeparableConv(nn.Module):
    """Depthwise (VALID) conv, InstanceNorm, pointwise 1×1."""

    def __init__(self, cin, cout, kernel=3, stride=1, dtype=torch.float32):
        super().__init__()
        self.depthwise = Conv(cin, cin, kernel, stride, "VALID", groups=cin,
                              dtype=dtype)
        self.norm = InstanceNorm()
        self.pointwise = Conv(cin, cout, 1, dtype=dtype)

    def forward(self, x):
        return self.pointwise(self.norm(self.depthwise(x)))


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1) with torch's tap
    alignment (``resnet_generator.py:142-172``). The JAX package stores the
    kernel as the HWIO kernel of the equivalent stride-1 conv over the
    zero-stuffed input, already flipped; ``weight`` is that kernel in OIHW,
    so the converter only transposes it. ``conv_transpose2d`` takes it
    flipped back and with in/out swapped."""

    def __init__(self, cin, cout, kernel=3, stride=2, pad=1,
                 output_padding=1, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.pad, self.output_padding = stride, pad, output_padding
        self.dtype = dtype

    def forward(self, x):
        w = torch.flip(self.weight, (2, 3)).transpose(0, 1)
        return F.conv_transpose2d(
            x.to(self.dtype), w.to(self.dtype), self.bias.to(self.dtype),
            self.stride, self.pad, self.output_padding)


def _conv(cin, cout, kernel, stride, padding, spectral, dtype):
    if spectral:
        from .spectral import SNConv
        return SNConv(cin, cout, kernel, stride,
                      0 if padding == "VALID" else padding, dtype=dtype)
    return Conv(cin, cout, kernel, stride, padding, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, dim, norm="instance", padding_type="reflect",
                 dropout=0.0, mobile=False, use_spectral=False,
                 dtype=torch.float32):
        super().__init__()
        for name in ("conv1", "conv2"):
            # the reference's separable blocks are not spectral-normed
            setattr(self, name, SeparableConv(dim, dim, dtype=dtype) if mobile
                    else _conv(dim, dim, 3, 1, "VALID", use_spectral, dtype))
        norm1, i = _add_norm(self, norm, dim, 0)
        norm2, _ = _add_norm(self, norm, dim, i)
        self._norms = [norm1, norm2]
        self.padding_type = padding_type

    def forward(self, x):
        # G_dropout's Dropout is deterministic: the JAX models apply G
        # without a dropout rng
        h = self.conv1(_pad(x, 1, self.padding_type))
        h = F.relu(self._norms[0](h))
        h = self.conv2(_pad(h, 1, self.padding_type))
        return x + self._norms[1](h)


class ResnetEncoder(nn.Module):
    def __init__(self, in_channels, ngf=64, n_blocks=6, n_downsampling=2,
                 norm="instance", padding_type="reflect", dropout=0.0,
                 mobile=False, use_spectral=False, spectral_blocks=True,
                 dtype=torch.float32):
        super().__init__()
        self.padding_type = padding_type
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        self.stem = _conv(in_channels, ngf, 7, 1, "VALID", use_spectral, dtype)
        norms, k = [], 0
        norm_mod, k = _add_norm(self, norm, ngf, k)
        norms.append(norm_mod)
        channels = [in_channels, ngf]
        mult = 1
        for i in range(n_downsampling):
            mult *= 2
            setattr(self, f"down{i}", _conv(ngf * mult // 2, ngf * mult, 3, 2,
                                            1, use_spectral, dtype))
            norm_mod, k = _add_norm(self, norm, ngf * mult, k)
            norms.append(norm_mod)
            channels.append(ngf * mult)
        self._norms = norms
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResnetBlock(
                ngf * mult, norm, padding_type, dropout, mobile,
                use_spectral=use_spectral and spectral_blocks, dtype=dtype))
            channels.append(ngf * mult)
        self.feature_channels = channels
        self.out_channels = ngf * mult

    def forward(self, x, extract_layer_ids=None):
        """Returns (h, feats): all taps, or those of ``extract_layer_ids``
        (NCHW)."""
        feats = [x]
        h = self.stem(_pad(x, 3, self.padding_type))
        h = F.relu(self._norms[0](h))
        feats.append(h)
        for i in range(self.n_downsampling):
            h = getattr(self, f"down{i}")(h)
            h = F.relu(self._norms[i + 1](h))
            feats.append(h)
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
            feats.append(h)
        if extract_layer_ids is not None:
            return h, [feats[min(i, len(feats) - 1)]
                       for i in extract_layer_ids]
        return h, feats

    def layer_channels(self, layer_ids):
        """Channels of the taps ``layer_ids`` (PatchSampleF's inputs)."""
        n = len(self.feature_channels)
        return [self.feature_channels[min(i, n - 1)] for i in layer_ids]


class ResnetDecoder(nn.Module):
    def __init__(self, out_channels=3, ngf=64, n_downsampling=2,
                 norm="instance", padding_type="reflect", tanh=True,
                 freq_space=False, use_spectral=False, up_mode="resize",
                 dtype=torch.float32):
        super().__init__()
        self.padding_type, self.tanh, self.freq_space = (padding_type, tanh,
                                                         freq_space)
        self.up_mode = up_mode
        self.n_downsampling = n_downsampling
        mult = 2 ** n_downsampling
        norms, k = [], 0
        cin = ngf * mult
        for i in range(n_downsampling):
            feat = ngf * mult // (2 ** (i + 1))
            setattr(self, f"up{i}", TorchConvTranspose(cin, feat, dtype=dtype)
                    if up_mode == "convtranspose"
                    else _conv(cin, feat, 3, 1, 1, use_spectral, dtype))
            norm_mod, k = _add_norm(self, norm, feat, k)
            norms.append(norm_mod)
            cin = feat
        self._norms = norms
        if freq_space:
            cin //= 4
        self.head = _conv(cin, out_channels, 7, 1, "VALID", use_spectral,
                          dtype)

    def forward(self, h):
        for i in range(self.n_downsampling):
            if self.up_mode != "convtranspose":
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, f"up{i}")(h)
            h = F.relu(self._norms[i](h))
        if self.freq_space:
            h = inverse_haar_transform(h.float()).to(h.dtype)
        h = self.head(_pad(h, 3, self.padding_type))
        if self.tanh:
            h = torch.tanh(h)
        return h.float()


def _freq_in(channels, freq_space):
    return channels * 4 if freq_space else channels


class ResnetGenerator(nn.Module):
    """``resnet`` / ``mobile_resnet``."""

    def __init__(self, in_channels=3, out_channels=3, ngf=64, n_blocks=9,
                 norm="instance", padding_type="reflect", dropout=0.0,
                 mobile=False, freq_space=False, use_spectral=False,
                 up_mode="resize", dtype=torch.float32):
        super().__init__()
        self.freq_space = freq_space
        self.encoder = ResnetEncoder(
            _freq_in(in_channels, freq_space), ngf, n_blocks, 2, norm,
            padding_type, dropout, mobile, use_spectral=use_spectral,
            dtype=dtype)
        self.decoder = ResnetDecoder(
            out_channels, ngf, 2, norm, padding_type,
            tanh=True, freq_space=freq_space, use_spectral=use_spectral,
            up_mode=up_mode, dtype=dtype)

    def layer_channels(self, layer_ids):
        return self.encoder.layer_channels(layer_ids)

    def forward(self, x, extract_layer_ids=None, with_features=None):
        """NHWC in. Returns the NHWC output; with ``extract_layer_ids``
        only the NHWC encoder taps (as JAX), and with ``with_features``
        (tap ids) the pair (output, taps)."""
        x = x.permute(0, 3, 1, 2)
        if self.freq_space:
            x = haar_transform(x)
        if extract_layer_ids is not None:
            _, feats = self.encoder(x, extract_layer_ids)
            return _nhwc(feats)
        h, feats = self.encoder(x, with_features)
        out = self.decoder(h).permute(0, 2, 3, 1)
        return (out, _nhwc(feats)) if with_features is not None else out


def _nhwc(feats):
    return [f.permute(0, 2, 3, 1) for f in feats]


class ResnetGeneratorAttn(nn.Module):
    """``resnet_attn`` (``resnet_generator.py:348-408``)."""

    def __init__(self, in_channels=3, out_channels=3, nb_mask_attn=10,
                 nb_mask_input=1, ngf=64, n_blocks=9, norm="instance",
                 padding_type="reflect", mobile=False, freq_space=False,
                 use_spectral=False, up_mode="resize", dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.nb_mask_attn, self.nb_mask_input = nb_mask_attn, nb_mask_input
        self.freq_space = freq_space
        self.encoder = ResnetEncoder(
            _freq_in(in_channels, freq_space), ngf, n_blocks, 2, norm,
            padding_type, 0.0, mobile, use_spectral=use_spectral,
            spectral_blocks=False, dtype=dtype)
        n_content = nb_mask_attn - nb_mask_input
        kw = dict(freq_space=freq_space, use_spectral=use_spectral,
                  up_mode=up_mode, dtype=dtype)
        self.content_decoder = ResnetDecoder(
            out_channels * n_content, ngf, 2, norm, padding_type, tanh=True,
            **kw)
        self.attn_decoder = ResnetDecoder(
            nb_mask_attn, ngf, 2, norm, padding_type, tanh=False, **kw)

    def layer_channels(self, layer_ids):
        return self.encoder.layer_channels(layer_ids)

    def forward(self, x, extract_layer_ids=None, return_attention=False,
                with_features=None):
        """As ``ResnetGenerator.forward``; ``return_attention`` adds the
        (N, H, W, nb_mask_attn) softmax masks."""
        x_pix = x.permute(0, 3, 1, 2)
        x = haar_transform(x_pix) if self.freq_space else x_pix
        if extract_layer_ids is not None:
            _, feats = self.encoder(x, extract_layer_ids)
            return _nhwc(feats)
        h, feats = self.encoder(x, with_features)
        n_content = self.nb_mask_attn - self.nb_mask_input
        contents = self.content_decoder(h)
        att = torch.softmax(self.attn_decoder(h), dim=1)
        inp = x_pix[:, :3]
        oc = self.out_channels
        out = 0.0
        for i in range(n_content):
            out = out + contents[:, i * oc:(i + 1) * oc] * att[:, i:i + 1]
        for i in range(n_content, self.nb_mask_attn):
            out = out + inp * att[:, i:i + 1]
        out = out.float().permute(0, 2, 3, 1)
        if return_attention:
            return out, att.float().permute(0, 2, 3, 1)
        return (out, _nhwc(feats)) if with_features is not None else out


class ResnetGeneratorAttnDiff(nn.Module):
    """``resnet_attn`` as palette's denoiser (``resnet_generator.py:
    411-475``): the encoder, a FiLM of its output from the embedding
    (``film``, zero-initialised: scale then shift), a content decoder and an
    attention decoder without tanh; the softmax (fp32, cast to the input's
    dtype) over ``nb_mask_attn`` masks blends the contents and the input's
    first ``out_channels`` channels. With ``freq_space`` the trunk runs on
    the Haar bands and the blend in pixel space. ``forward(x NHWC, emb (B,
    cond_embed_dim) or None: ones)`` -> NHWC fp32."""

    def __init__(self, in_channels, out_channels=3, nb_mask_attn=10,
                 nb_mask_input=1, ngf=64, n_blocks=9, cond_embed_dim=256,
                 norm="instance", padding_type="reflect", freq_space=False,
                 dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.nb_mask_attn, self.nb_mask_input = nb_mask_attn, nb_mask_input
        self.cond_embed_dim = cond_embed_dim
        self.freq_space = freq_space
        self.dtype = dtype
        self.encoder = ResnetEncoder(
            _freq_in(in_channels, freq_space), ngf, n_blocks, 2, norm,
            padding_type, 0.0, False, dtype=dtype)
        c = self.encoder.out_channels
        self.film = Dense(cond_embed_dim, 2 * c, dtype=dtype, zero_init=True)
        n_content = nb_mask_attn - nb_mask_input
        kw = dict(tanh=False, freq_space=freq_space, dtype=dtype)
        self.content_decoder = ResnetDecoder(
            out_channels * n_content, ngf, 2, norm, padding_type, **kw)
        self.attn_decoder = ResnetDecoder(
            nb_mask_attn, ngf, 2, norm, padding_type, **kw)

    def forward(self, x, emb=None):
        x_pix = x.permute(0, 3, 1, 2)
        x = haar_transform(x_pix) if self.freq_space else x_pix
        h, _ = self.encoder(x)
        if emb is None:
            emb = torch.ones(x.shape[0], self.cond_embed_dim,
                             device=x.device)
        film = self.film(F.silu(emb.to(self.dtype)))[:, :, None, None]
        scale, shift = torch.chunk(film, 2, dim=1)
        h = h * (1 + scale) + shift
        n_content = self.nb_mask_attn - self.nb_mask_input
        contents = self.content_decoder(h)
        att = torch.softmax(self.attn_decoder(h).float(), dim=1).to(x.dtype)
        inp = x_pix[:, :self.out_channels]
        oc = self.out_channels
        out = 0.0
        for i in range(n_content):
            out = out + contents[:, i * oc:(i + 1) * oc] * att[:, i:i + 1]
        for i in range(n_content, self.nb_mask_attn):
            out = out + inp * att[:, i:i + 1]
        return out.float().permute(0, 2, 3, 1)
