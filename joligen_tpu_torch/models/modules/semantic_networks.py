"""The semantic segmenter f_s (``joligen_tpu/models/modules/semantic_networks.py``):
``UNetSegmenter`` and ``define_f`` for ``f_s_net: unet``, and for
``f_s_net: segformer`` the MiT-B0 ``SegformerSegmenter`` (``segformer.py``).

``UNetSegmenter`` keeps flax's auto-names: ``Conv_0``…``Conv_7`` and
``GroupNorm_0``…``GroupNorm_2`` (8 groups, eps 1e-6, fp32 statistics with
flax's variance, compute-dtype output). Three levels of conv, GroupNorm,
ReLU and 2×2 average pool; a bottleneck conv; three levels of nearest 2×
upsampling, conv, ReLU and the skip concatenated after; a 1×1 conv to the
class logits. NHWC at its boundary, fp32 logits.

The other segmenters (``vgg``, ``sam``) and the classifier
``define_C`` are not ported; they raise, naming their ROADMAP items.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import compute_dtype
from .resnet_generator import Conv
from .unet_mha import GroupNorm

UNPORTED_F_S = {
    "vgg": "ROADMAP Queue 1 item 10, what is left of the GAN families "
           "(the vgg segmenter)",
    "sam": "ROADMAP Queue 1 item 14, metrics and frozen nets (SAM)",
}


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
        h = x.permute(0, 3, 1, 2).to(self.dtype)
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


PORTED_F_S = ("unet", "segformer")


def check_f_s_net(opt):
    """Raise unless ``f_s_net`` is ``unet`` (the JAX factory's default when
    unset) or ``segformer``."""
    net = getattr(opt, "f_s_net", "unet") or "unet"
    if net not in PORTED_F_S:
        where = UNPORTED_F_S.get(net, "ROADMAP Queue 1 item 10")
        raise NotImplementedError(f"f_s_net {net} is not ported ({where})")


def define_f(opt):
    """f_s for ``f_s_net``; the segmenters other than ``unet`` and
    ``segformer`` raise."""
    check_f_s_net(opt)
    if (getattr(opt, "f_s_net", "unet") or "unet") == "segformer":
        from .segformer import SegformerSegmenter
        return SegformerSegmenter(opt.model_input_nc,
                                  opt.f_s_semantic_nclasses,
                                  dtype=compute_dtype(opt))
    return UNetSegmenter(opt.model_input_nc, opt.f_s_semantic_nclasses,
                         nf=opt.f_s_nf, dtype=compute_dtype(opt))
