"""The semantic networks (``joligen_tpu/models/modules/semantic_networks.py``):
the segmenter f_s (``define_f``: ``unet``, ``segformer`` and ``vgg``) and
the classifier C (``define_C``: ``basic`` and the ResNet templates).

Every net takes NHWC at its boundary and returns fp32 logits, and keeps the
flax names, so that a state-dict key is the flax tree path:

- ``UNetSegmenter`` (``unet``): ``Conv_0``…``Conv_7`` and
  ``GroupNorm_0``…``GroupNorm_2`` (8 groups, eps 1e-6, fp32 statistics with
  flax's variance, compute-dtype output). Three levels of conv, GroupNorm,
  ReLU and 2×2 average pool; a bottleneck conv; three levels of nearest 2×
  upsampling, conv, ReLU and the skip concatenated after; a 1×1 conv to the
  class logits. ``segformer`` is the MiT-B0 ``SegformerSegmenter``
  (``segformer.py``).
- ``VGG16FCN8s`` (``vgg``): convs ``b{block}c{conv}``, ``fc6``, ``fc7``,
  ``score`` and the zero-initialised skips ``score_pool4`` and
  ``score_pool3``, which take 0.01 · pool4 and 1e-4 · pool3. The pools are
  ceil-mode (odd sizes padded with −inf). ``f_s_vgg_pad`` ``fcn`` pads the
  input by 99, runs ``fc6`` VALID and crops at 5, 9 and 31; ``same`` (the
  option's default) pads nothing, runs ``fc6`` SAME and crops at 0. The
  fixed bilinear upsampling is ``jax.lax.conv_transpose`` (the kernel not
  flipped, stride ``factor``, padding VALID or SAME by lax's rule), here a
  depthwise ``conv_transpose2d`` with lax's padding (``lax_transpose_pads``).
- ``Classifier`` (``basic``): ``max(2, log2(img_size // 8))`` levels of a
  stride-2 3×3 conv (``Conv_i``), a LayerNorm over channels
  (``LayerNorm_i``: eps 1e-6, fp32 statistics with flax's variance,
  compute-dtype output) and leaky ReLU 0.2, widths doubling up to 8·nf;
  then the spatial mean and ``Dense_0``.
- ``ResNetTemplate`` (``resnet18``, ``resnet34``, ``resnet50``): torchvision's
  ResNets with every BatchNorm folded into a per-channel ``_Affine``
  (``scale`` and ``bias``): ``conv1``, ``bn1``, a max pool (−inf padding,
  3×3 stride 2), ``layer{s}_{b}_conv{k}``/``_bn{k}`` (``_down``/``_downbn``
  where the shape changes), the mean and ``fc``. A 1-channel input is tiled
  to 3. ``define_C`` and ``define_D`` build it without a dtype, so it runs
  in fp32 whatever ``tpu_bf16`` says, as in the JAX package.

``load_resnet_template`` and ``load_vgg_fcn8s_trunk`` read the ported
ImageNet weights (``{variant}_tv.npz``, ``vgg16_lpips.npz``) from
``JOLIGEN_TPU_WEIGHTS_DIR`` where they exist, as the JAX loaders do.
``sam`` is not ported: it raises, naming its ROADMAP item.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import compute_dtype
from ...utils.vit_layers import LayerNorm
from .resnet_generator import Conv
from .unet_mha import Dense, GroupNorm

UNPORTED_F_S = {
    "sam": "ROADMAP Queue 1 item 14, metrics and frozen nets (SAM)",
}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class UNetSegmenter(nn.Module):
    def __init__(self, in_channels, nclasses, nf=64, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin, f = in_channels, nf
        for i in range(3):
            self.add_module(f"Conv_{i}", Conv(cin, f, 3, 1, 1, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", GroupNorm(8, f, eps=1e-6))
            cin, f = f, f * 2
        self.Conv_3 = Conv(cin, f, 3, 1, 1, dtype=dtype)
        cin = f
        for i in range(3):
            f //= 2
            self.add_module(f"Conv_{4 + i}", Conv(cin, f, 3, 1, 1,
                                                  dtype=dtype))
            cin = 2 * f          # the upsampled map and its skip
        self.Conv_7 = Conv(cin, nclasses, 1, dtype=dtype)

    def forward(self, x):
        h = _nchw(x).to(self.dtype)
        skips = []
        for i in range(3):
            h = getattr(self, f"Conv_{i}")(h)
            h = F.relu(getattr(self, f"GroupNorm_{i}")(h))
            skips.append(h)
            h = F.avg_pool2d(h, 2)
        h = F.relu(self.Conv_3(h))
        for i in range(3):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = F.relu(getattr(self, f"Conv_{4 + i}")(h))
            h = torch.cat([h, skips.pop()], dim=1)
        return self.Conv_7(h).float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------- VGG16-FCN8s
def bilinear_filter(factor):
    """The (2·factor)² bilinear upsampling filter of ``VGG16FCN8s.
    _bilinear_kernel`` (one channel's diagonal entry)."""
    size = 2 * factor
    f = (size + 1) // 2
    center = f - 1 if size % 2 == 1 else f - 0.5
    og = np.ogrid[:size, :size]
    return ((1 - abs(og[0] - center) / f)
            * (1 - abs(og[1] - center) / f)).astype(np.float32)


def lax_transpose_pads(k, s, padding):
    """(before, after) padding of the dilated input in
    ``jax.lax.conv_transpose`` for kernel ``k``, stride ``s`` and
    ``"SAME"`` or ``"VALID"`` (lax's ``_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def upscore(x, factor, padding):
    """``jax.lax.conv_transpose`` of an NCHW map with the diagonal bilinear
    kernel: the input dilated by ``factor``, padded by lax's rule and
    correlated with the (unflipped) filter; VALID gives (in + 1)·factor,
    SAME in·factor. As a depthwise ``conv_transpose2d`` (which correlates
    with the flipped filter, padded by k − 1 − p): the filter flipped, p =
    k − 1 − before, and the after side's difference as output padding or a
    crop."""
    k = 2 * factor
    lo, hi = lax_transpose_pads(k, factor, padding)
    c = x.shape[1]
    w = torch.from_numpy(bilinear_filter(factor)[::-1, ::-1].copy()).to(
        device=x.device, dtype=x.dtype).expand(c, 1, k, k)
    y = F.conv_transpose2d(x, w, stride=factor, padding=k - 1 - lo,
                           output_padding=max(hi - lo, 0), groups=c)
    if hi < lo:
        y = y[:, :, :y.shape[2] - (lo - hi), :y.shape[3] - (lo - hi)]
    return y


def _ceil_pool(x):
    """2×2 stride-2 max pool in ceil mode: odd sizes padded with −inf at
    the bottom and right (``VGG16FCN8s.ceil_pool``)."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def _crop(a, h, w, offset):
    return a[:, :, offset:offset + h, offset:offset + w]


class VGG16FCN8s(nn.Module):
    WIDTHS = (64, 128, 256, 512, 512)
    # the skips flax initialises to zeros (kernel and bias)
    ZERO_INIT = ("score_pool4", "score_pool3")

    def __init__(self, in_channels, nclasses, dtype=torch.float32,
                 pad="fcn"):
        super().__init__()
        self.dtype, self.pad = dtype, pad
        cin = in_channels
        for bi, w in enumerate(self.WIDTHS):
            for ci in range(2 if bi < 2 else 3):
                self.add_module(f"b{bi}c{ci}", Conv(cin, w, 3, 1, 1,
                                                    dtype=dtype))
                cin = w
        self.fc6 = Conv(512, 4096, 7, 1, "VALID" if pad == "fcn" else "SAME",
                        dtype=dtype)
        self.fc7 = Conv(4096, 4096, 1, dtype=dtype)
        self.score = Conv(4096, nclasses, 1, dtype=dtype)
        self.score_pool4 = Conv(512, nclasses, 1, dtype=dtype)
        self.score_pool3 = Conv(256, nclasses, 1, dtype=dtype)

    def forward(self, x):
        H, W = x.shape[1], x.shape[2]
        fcn = self.pad == "fcn"
        h = _nchw(x).to(self.dtype)
        if fcn:
            h = F.pad(h, (99, 99, 99, 99))
        pools = []
        for bi in range(len(self.WIDTHS)):
            for ci in range(2 if bi < 2 else 3):
                h = F.relu(getattr(self, f"b{bi}c{ci}")(h))
            h = _ceil_pool(h)
            pools.append(h)
        h = F.relu(self.fc6(h))
        h = F.relu(self.fc7(h))
        h = self.score(h)
        mode = "VALID" if fcn else "SAME"
        up2 = upscore(h, 2, mode)
        sp4 = self.score_pool4(0.01 * pools[3])
        if fcn:
            fuse4 = up2 + _crop(sp4, up2.shape[2], up2.shape[3], 5)
        else:
            fuse4 = _crop(up2, sp4.shape[2], sp4.shape[3], 0) + sp4
        up4 = upscore(fuse4, 2, mode)
        sp3 = self.score_pool3(0.0001 * pools[2])
        if fcn:
            fuse3 = up4 + _crop(sp3, up4.shape[2], up4.shape[3], 9)
        else:
            fuse3 = _crop(up4, sp3.shape[2], sp3.shape[3], 0) + sp3
        up8 = upscore(fuse3, 8, mode)
        out = _crop(up8, H, W, 31 if fcn else 0)
        return out.float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------- classifiers
class Classifier(nn.Module):
    def __init__(self, in_channels, nclasses, nf=64, img_size=128,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_levels = max(2, int(math.log2(max(1, img_size // 8))))
        cin, f = in_channels, nf
        for i in range(self.n_levels):
            self.add_module(f"Conv_{i}", Conv(cin, f, 3, 2, 1, dtype=dtype))
            self.add_module(f"LayerNorm_{i}", LayerNorm(f, 1e-6))
            cin, f = f, min(f * 2, nf * 8)
        self.Dense_0 = Dense(cin, nclasses, dtype=dtype)

    def forward(self, x):
        h = x.to(self.dtype)
        for i in range(self.n_levels):
            h = getattr(self, f"Conv_{i}")(_nchw(h)).permute(0, 2, 3, 1)
            h = F.leaky_relu(getattr(self, f"LayerNorm_{i}")(h), 0.2)
        return self.Dense_0(h.mean(dim=(1, 2))).float()


class _Affine(nn.Module):
    """A folded BatchNorm over NCHW: x · scale + bias per channel (flax
    ``scale`` is the state dict's ``weight``)."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.weight[:, None, None] + self.bias[:, None, None]


RESNET_CFG = {"resnet18": ((2, 2, 2, 2), False),
              "resnet34": ((3, 4, 6, 3), False),
              "resnet50": ((3, 4, 6, 3), True)}


class ResNetTemplate(nn.Module):
    def __init__(self, nclasses, variant="resnet18", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        blocks, self.bottleneck = RESNET_CFG[variant]
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = _Affine(64)
        self.blocks = []          # (name, stride, has a projection)
        cin, width = 64, 64
        for si, n in enumerate(blocks):
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                out_w = width * (4 if self.bottleneck else 1)
                name = f"layer{si + 1}_{bi}"
                down = stride != 1 or cin != out_w
                if down:
                    self.add_module(f"{name}_down", Conv(
                        cin, out_w, 1, stride, bias=False, dtype=dtype))
                    self.add_module(f"{name}_downbn", _Affine(out_w))
                if self.bottleneck:
                    convs = ((cin, width, 1, 1, 0),
                             (width, width, 3, stride, 1),
                             (width, out_w, 1, 1, 0))
                else:
                    convs = ((cin, width, 3, stride, 1),
                             (width, width, 3, 1, 1))
                for k, (ci, co, ks, st, pd) in enumerate(convs, 1):
                    self.add_module(f"{name}_conv{k}", Conv(
                        ci, co, ks, st, pd, bias=False, dtype=dtype))
                    self.add_module(f"{name}_bn{k}", _Affine(co))
                self.blocks.append((name, len(convs), down))
                cin = out_w
            width *= 2
        self.fc = Dense(cin, nclasses, dtype=dtype)

    def forward(self, x):
        h = _nchw(x).to(self.dtype)
        if h.shape[1] == 1:
            h = h.repeat(1, 3, 1, 1)
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=float("-inf")), 3, 2)
        for name, n_convs, down in self.blocks:
            identity = h
            if down:
                identity = getattr(self, f"{name}_downbn")(
                    getattr(self, f"{name}_down")(h))
            y = h
            for k in range(1, n_convs + 1):
                y = getattr(self, f"{name}_bn{k}")(
                    getattr(self, f"{name}_conv{k}")(y))
                if k < n_convs:
                    y = F.relu(y)
            h = F.relu(y + identity)
        return self.fc(h.mean(dim=(2, 3))).float()


# ---------------------------------------------------------------- weights
def _weights_file(name):
    root = os.environ.get("JOLIGEN_TPU_WEIGHTS_DIR", "")
    path = os.path.join(root, name)
    return path if root and os.path.exists(path) else None


def _swap_children(net, raw, take):
    """Replace each top-level child of ``net`` whose flax leaves ``take(name,
    leaves)`` accepts by the arrays of ``raw`` (flax layout, keys
    ``<child>/<leaf>``). Returns the names swapped."""
    from ..convert import flax_to_torch, torch_to_flax
    tree = torch_to_flax({k: v.cpu() for k, v in net.state_dict().items()})
    swapped = {}
    for name, leaves in tree["params"].items():
        if take(name, leaves):
            swapped[name] = {leaf: raw[f"{name}/{leaf}"] for leaf in leaves}
    if swapped:
        with torch.no_grad():
            for key, t in flax_to_torch(swapped).items():
                net.get_parameter(key).copy_(t)
    return sorted(swapped)


def load_resnet_template(net, variant):
    """ImageNet weights from ``{variant}_tv.npz`` into a ``ResNetTemplate``
    where the file exists (``semantic_networks.py:258-288``): every module
    but ``fc`` (a fresh head, as the reference's new nclasses Linear) whose
    leaves the file holds. Returns the modules swapped ([] without the
    file)."""
    path = _weights_file(f"{variant}_tv.npz")
    if path is None:
        return []
    raw = np.load(path)
    return _swap_children(net, raw, lambda name, leaves: name != "fc" and {
        f"{name}/{leaf}" for leaf in leaves} <= set(raw.files))


def load_vgg_fcn8s_trunk(net):
    """ImageNet weights from ``vgg16_lpips.npz`` into a ``VGG16FCN8s``
    where the file exists (``semantic_networks.py:291-319``): each conv
    whose kernel the file holds at the same shape takes its kernel and
    bias. Returns the convs swapped ([] without the file)."""
    path = _weights_file("vgg16_lpips.npz")
    if path is None:
        return []
    raw = np.load(path)
    return _swap_children(net, raw, lambda name, leaves: (
        "kernel" in leaves and f"{name}/kernel" in raw.files
        and raw[f"{name}/kernel"].shape == leaves["kernel"].shape))


def init_segmenter(net, generator):
    """flax's default init of an f_s (``gan_networks.flax_default_init``),
    VGG16-FCN8s's skips at zero as flax initialises them."""
    from ..gan_networks import flax_default_init
    flax_default_init(net, generator)
    with torch.no_grad():
        for name in getattr(net, "ZERO_INIT", ()):
            for p in getattr(net, name).parameters():
                p.zero_()
    return net


# ---------------------------------------------------------------- factories
def define_C(opt):
    """C for ``train_sem_cls_template`` (``semantic_networks.py:327-340``):
    ``basic``, or a ResNet template in fp32; any other name raises as in
    the JAX package."""
    template = getattr(opt, "train_sem_cls_template", "basic") or "basic"
    if template != "basic":
        if template not in RESNET_CFG:
            raise NotImplementedError(
                f"cls template '{template}' — supported: basic, "
                f"{', '.join(sorted(RESNET_CFG))} (the reference's "
                "torch_model rewires a 512-wide fc, i.e. resnet18/34)")
        return ResNetTemplate(opt.cls_semantic_nclasses, variant=template)
    return Classifier(opt.model_input_nc, opt.cls_semantic_nclasses,
                      nf=opt.cls_nf, img_size=opt.data_crop_size,
                      dtype=compute_dtype(opt))


def check_f_s_net(opt):
    """Raise for an ``f_s_net`` that is not ported (``sam``)."""
    net = getattr(opt, "f_s_net", "unet") or "unet"
    if net in UNPORTED_F_S:
        raise NotImplementedError(
            f"f_s_net {net} is not ported ({UNPORTED_F_S[net]})")


def define_f(opt):
    """f_s for ``f_s_net``: ``segformer``, ``vgg`` (``f_s_vgg_pad``, default
    ``same``), else ``unet`` (the JAX factory's fallback); ``sam`` raises."""
    check_f_s_net(opt)
    net = getattr(opt, "f_s_net", "unet") or "unet"
    dtype = compute_dtype(opt)
    if net == "segformer":
        from .segformer import SegformerSegmenter
        return SegformerSegmenter(opt.model_input_nc,
                                  opt.f_s_semantic_nclasses, dtype=dtype)
    if net == "vgg":
        return VGG16FCN8s(opt.model_input_nc, opt.f_s_semantic_nclasses,
                          dtype=dtype,
                          pad=getattr(opt, "f_s_vgg_pad", "same") or "same")
    return UNetSegmenter(opt.model_input_nc, opt.f_s_semantic_nclasses,
                         nf=opt.f_s_nf, dtype=dtype)
