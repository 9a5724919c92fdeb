"""InceptionV3, the FID variant (``joligen_tpu/utils/inception.py``): the
pool3 2048-d features of the pytorch-fid / torchvision graph, with each
batchnorm folded into its conv (an inference-only network). NHWC in; the
modules carry flax's names, so ``load_inception_params`` reads the JAX
package's flat ``inception_v3_fid.npz`` (``name/conv/kernel`` HWIO,
``name/conv/bias``) and ``models/convert.py`` maps it.

Padding as flax's: ``SAME`` at stride 1 pads (k - 1) / 2 on each side (every
kernel is odd); ``VALID`` pads nothing, so the stride-2 convs and max pools
keep their exact output sizes (299 -> 149 -> 147 -> 73 -> 71 -> 35 -> 17
-> 8). The 3x3 SAME average pools divide by 9 at the border too (flax's
``avg_pool`` counts the padded cells), and Mixed_7b/7c pool by average.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Module):
    """A conv with folded batchnorm (its bias), then ReLU; NCHW."""

    def __init__(self, cin, features, kernel=(3, 3), strides=(1, 1),
                 padding="SAME"):
        super().__init__()
        pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2) \
            if padding == "SAME" else (0, 0)
        self.conv = nn.Conv2d(cin, features, tuple(kernel),
                              stride=tuple(strides), padding=pad)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avg3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, (1, 1))
        self.branch5x5_1 = ConvBN(cin, 48, (1, 1))
        self.branch5x5_2 = ConvBN(48, 64, (5, 5))
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3))
        self.branch_pool = ConvBN(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, (3, 3), (2, 2), "VALID")
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, (1, 1))
        self.branch7x7_1 = ConvBN(cin, c7, (1, 1))
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1))
        self.branch7x7dbl_1 = ConvBN(cin, c7, (1, 1))
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7))
        self.branch_pool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, (1, 1))
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), (2, 2), "VALID")
        self.branch7x7x3_1 = ConvBN(cin, 192, (1, 1))
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1))
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool_op`` "avg" (the FID variant's Mixed_7b and 7c) or "max" (a
    3x3 stride-1 SAME max pool)."""

    def __init__(self, cin, pool_op="avg"):
        super().__init__()
        self.pool_op = pool_op
        self.branch1x1 = ConvBN(cin, 320, (1, 1))
        self.branch3x3_1 = ConvBN(cin, 384, (1, 1))
        self.branch3x3_2a = ConvBN(384, 384, (1, 3))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1))
        self.branch3x3dbl_1 = ConvBN(cin, 448, (1, 1))
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3))
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1))
        self.branch_pool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1)
              if self.pool_op == "max" else _avg3(x))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3FID(nn.Module):
    """(N, H, W, 3) in [-1, 1] (299 px, 75 the least) -> (N, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), (2, 2), "VALID")
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3), padding="VALID")
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3))
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1), padding="VALID")
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3), padding="VALID")
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "avg")

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def load_inception_params(path):
    """The flax tree ``{"params": ...}`` (numpy) of a flat ``name/kernel``,
    ``name/bias`` npz, as the JAX loader builds it."""
    raw = np.load(path)
    tree = {}
    for key in raw.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = raw[key]
    return {"params": tree}
