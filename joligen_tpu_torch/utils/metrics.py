"""The perceptual trunk of ``joligen_tpu/utils/metrics.py`` (``_VGGish``),
which MAT's perceptual loss runs. The rest of that file (FID, KID, LPIPS,
the frozen-net metrics) is not ported (ROADMAP Queue 1 item 14)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

WIDTHS = (64, 128, 256, 512, 512)


class _VGGish(nn.Module):
    """VGG16 topology: 5 stages of 3x3 convs (2, 2, 3, 3, 3) with ReLU, a
    2x2 max pool after each; returns the 5 stages' features (after their
    ReLU, before their pool), NHWC, from an NHWC input. ``generator``
    (CPU) draws flax's default init: lecun-normal kernels truncated at 2
    std, zero biases. No weights file is read, as in the JAX model."""

    def __init__(self, in_channels=3, generator=None):
        super().__init__()
        cin = in_channels
        for bi, w in enumerate(WIDTHS):
            for ci in range(2 if bi < 2 else 3):
                self.add_module(f"b{bi}c{ci}", nn.Conv2d(cin, w, 3,
                                                         padding=1))
                cin = w
        with torch.no_grad():
            for conv in self.children():
                fan_in = conv.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                conv.bias.zero_()

    def forward(self, x):
        feats = []
        h = x.permute(0, 3, 1, 2)
        for bi in range(len(WIDTHS)):
            for ci in range(2 if bi < 2 else 3):
                h = F.relu(getattr(self, f"b{bi}c{ci}")(h))
            feats.append(h.permute(0, 2, 3, 1))
            if bi < len(WIDTHS) - 1:
                h = F.max_pool2d(h, 2)
        return feats
