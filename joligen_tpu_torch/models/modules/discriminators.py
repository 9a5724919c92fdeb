"""PatchGAN discriminators (``joligen_tpu/models/modules/discriminators.py``):
``NLayerDiscriminator`` (``basic`` / ``n_layers``; blur-pool striding by
default, ``D_dropout``, ``D_spectral``, ``freq_space``) and
``PixelDiscriminator``. ``forward`` takes NHWC and returns the NHWC logit
map in fp32; inside, NCHW. Convs carry the flax auto-names (``Conv_0``...,
or ``SNConv_0``... when spectral).

``D_dropout``: each LeakyReLU is followed by Dropout(0.5). ``forward``'s
``dropout`` is None (deterministic), a ``torch.Generator`` (masks drawn
per layer) or a list of keep masks in layer order (fed draws).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.upfirdn2d import haar_transform, setup_filter, upfirdn2d
from .resnet_generator import Conv, _add_norm


def blur_pool(x, stride=2):
    """Antialiased downsample of an NCHW tensor (``discriminators.py:
    15-21``): the [1,3,3,1] FIR, then the stride."""
    f = setup_filter([1, 3, 3, 1])
    p = f.shape[0] - stride
    return upfirdn2d(x, f, down=stride,
                     padding=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2))


def dropout_keep(h, dropout, index):
    """The keep mask of dropout layer ``index`` (see the module doc)."""
    if isinstance(dropout, torch.Generator):
        return torch.rand(h.shape, generator=dropout, device=h.device) < 0.5
    return dropout[index]


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_channels=3, ndf=64, n_layers=3, norm="instance",
                 antialias=True, use_dropout=False, use_spectral=False,
                 freq_space=False, dtype=torch.float32):
        super().__init__()
        self.antialias, self.use_dropout = antialias, use_dropout
        self.freq_space, self.n_layers = freq_space, n_layers
        convs = []

        def conv(cin, cout, stride=1):
            name = f"{'SNConv' if use_spectral else 'Conv'}_{len(convs)}"
            if use_spectral:
                from .spectral import SNConv
                m = SNConv(cin, cout, 4, stride, 1, dtype=dtype)
            else:
                m = Conv(cin, cout, 4, stride, 1, dtype=dtype)
            self.add_module(name, m)
            convs.append(m)

        cin = in_channels * 4 if freq_space else in_channels
        conv(cin, ndf, 1 if antialias else 2)
        norms, k = [], 0
        prev = ndf
        for n in range(1, n_layers):
            mult = min(2 ** n, 8)
            conv(prev, ndf * mult, 1 if antialias else 2)
            norm_mod, k = _add_norm(self, norm, ndf * mult, k)
            norms.append(norm_mod)
            prev = ndf * mult
        mult = min(2 ** n_layers, 8)
        conv(prev, ndf * mult)
        norm_mod, k = _add_norm(self, norm, ndf * mult, k)
        norms.append(norm_mod)
        conv(ndf * mult, 1)
        self._convs, self._norms = convs, norms

    def forward(self, x, dropout=None):
        x = x.permute(0, 3, 1, 2)
        if self.freq_space:
            x = haar_transform(x)
        n_drop = [0]

        def drop(h):
            if self.use_dropout and dropout is not None:
                keep = dropout_keep(h, dropout, n_drop[0])
                h = torch.where(keep, h / 0.5, torch.zeros_like(h))
            n_drop[0] += 1
            return h

        h = drop(F.leaky_relu(self._convs[0](x), 0.2))
        if self.antialias:
            h = blur_pool(h)
        for n in range(1, self.n_layers):
            h = self._norms[n - 1](self._convs[n](h))
            h = drop(F.leaky_relu(h, 0.2))
            if self.antialias:
                h = blur_pool(h)
        h = self._norms[-1](self._convs[self.n_layers](h))
        h = drop(F.leaky_relu(h, 0.2))
        out = self._convs[-1](h)
        assert 0 not in out.shape, (
            f"NLayerDiscriminator(n_layers={self.n_layers}) collapsed a "
            f"{x.shape[2]}px input to empty output; lower D_n_layers or "
            "raise data_crop_size")
        return out.float().permute(0, 2, 3, 1)


class PixelDiscriminator(nn.Module):
    """1×1 PatchGAN."""

    def __init__(self, in_channels=3, ndf=64, norm="instance",
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_channels, ndf, 1, dtype=dtype)
        self.Conv_1 = Conv(ndf, ndf * 2, 1, dtype=dtype)
        self._norms = [_add_norm(self, norm, ndf * 2, 0)[0]]
        self.Conv_2 = Conv(ndf * 2, 1, 1, dtype=dtype)

    def forward(self, x):
        h = F.leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2)), 0.2)
        h = F.leaky_relu(self._norms[0](self.Conv_1(h)), 0.2)
        return self.Conv_2(h).float().permute(0, 2, 3, 1)
