"""DINOv2 ViT-B/14 image encoder (``joligen_tpu/utils/dinov2.py``): a 14 px
patch embedding (with bias) to 768 channels, a CLS token and a learned
position table of the 37×37 grid the model was trained at, resized
(bilinear, antialiased where it shrinks) to the input's grid, 12 pre-norm
blocks with LayerScale (``ls1``, ``ls2``) on both branches and an exact-GELU
MLP, a final LayerNorm; the CLS embedding L2-normalised. The modules carry
flax's names.

``cls_token`` and ``pos_embed`` start at zero, as in the JAX package.
Ported weights load from ``$JOLIGEN_TPU_WEIGHTS_DIR/dinov2_vitb14.npz``
(``load_dinov2_params`` reads the JAX package's key contract).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.modules.resnet_generator import Conv
from ..models.modules.unet_mha import Dense
from ..ops.resize import resize_bilinear
from .clip_vit import _attn_from_torch, _norm, load_into, n_blocks
from .vit_layers import LayerNorm, MultiHeadDotProductAttention

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMAGE_SIZE = 224


class _Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = MultiHeadDotProductAttention(dim, heads)
        self.ls1 = nn.Parameter(torch.ones(dim))
        self.norm2 = LayerNorm(dim, 1e-6)
        self.fc1 = Dense(dim, dim * 4)
        self.fc2 = Dense(dim * 4, dim)
        self.ls2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + h * self.ls2


class DINOv2ViT(nn.Module):
    """``forward(x)``: (N, H, W, 3) ImageNet-normalised -> L2-normalised CLS
    embeddings (N, dim); with ``return_tokens`` also the (N, gh, gw, dim)
    patch tokens."""

    def __init__(self, dim=768, depth=12, heads=12, patch=14, native_grid=37,
                 return_tokens=False):
        super().__init__()
        self.dim, self.depth, self.patch = dim, depth, patch
        self.native_grid, self.return_tokens = native_grid, return_tokens
        self.patch_embed = Conv(3, dim, patch, patch, "VALID")
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, native_grid ** 2 + 1,
                                                  dim))
        for i in range(depth):
            self.add_module(f"block{i}", _Block(dim, heads))
        self.norm = LayerNorm(dim, 1e-6)

    def forward(self, x):
        n, h, w, _ = x.shape
        gh, gw, g = h // self.patch, w // self.patch, self.native_grid
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        grid = self.pos_embed[:, 1:].reshape(1, g, g, self.dim)
        grid = resize_bilinear(grid.permute(0, 3, 1, 2), (gh, gw))
        x = x + grid.flatten(2).transpose(1, 2)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(n, 1, self.dim)
        x = torch.cat([cls, x], dim=1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x)
        cls_out = x[:, 0]
        cls_out = cls_out / torch.linalg.vector_norm(cls_out, dim=-1,
                                                     keepdim=True)
        if self.return_tokens:
            return cls_out, x[:, 1:].reshape(n, gh, gw, self.dim)
        return cls_out


def preprocess(x):
    """[-1, 1] (N, H, W, C) -> 224 px ImageNet-normalised RGB (the first 3
    channels of more, 1 channel tiled), the resize antialiased where it
    shrinks."""
    x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    elif x.shape[-1] > 3:
        x = x[..., :3]
    if tuple(x.shape[1:3]) != (IMAGE_SIZE, IMAGE_SIZE):
        x = resize_bilinear(x.permute(0, 3, 1, 2),
                            (IMAGE_SIZE, IMAGE_SIZE)).permute(0, 2, 3, 1)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std


def load_dinov2_params(npz_path):
    """The flax tree ``{"params": ...}`` of numpy arrays from an npz in the
    JAX package's contract (``tools/port_dinov2_weights.py``): ``cls_token``
    (1, 1, D), ``pos_embed`` (1, 1370, D), ``patch_embed.{kernel,bias}``,
    ``block{i}.{norm1,norm2}.{scale,bias}``, ``block{i}.attn.{qkv_w,qkv_b,
    proj_w,proj_b}`` (torch layout), ``block{i}.{ls1,ls2}``,
    ``block{i}.{fc1,fc2}.{kernel,bias}``, ``norm.{scale,bias}``."""
    z = np.load(npz_path)
    d = int(z["cls_token"].shape[-1])
    heads = 12 if d == 768 else max(6, d // 64)
    params = {
        "cls_token": z["cls_token"], "pos_embed": z["pos_embed"],
        "patch_embed": {"kernel": z["patch_embed.kernel"],
                        "bias": z["patch_embed.bias"]},
        "norm": _norm(z, "norm"),
    }
    for i in range(n_blocks(z)):
        params[f"block{i}"] = {
            "norm1": _norm(z, f"block{i}.norm1"),
            "norm2": _norm(z, f"block{i}.norm2"),
            "attn": _attn_from_torch(z, i, d, heads),
            "ls1": z[f"block{i}.ls1"], "ls2": z[f"block{i}.ls2"],
            "fc1": {"kernel": z[f"block{i}.fc1.kernel"],
                    "bias": z[f"block{i}.fc1.bias"]},
            "fc2": {"kernel": z[f"block{i}.fc2.kernel"],
                    "bias": z[f"block{i}.fc2.bias"]},
        }
    return {"params": params}


def dino_weights_path():
    path = os.path.join(os.environ.get("JOLIGEN_TPU_WEIGHTS_DIR", ""),
                        "dinov2_vitb14.npz")
    return path if os.path.exists(path) else None


def load_dino_into(module, node_name="freezenet_dino"):
    """Swap the ported DINOv2 weights into every ``node_name`` submodule when
    ``dinov2_vitb14.npz`` exists (else the module keeps its frozen random
    init). Returns whether it did."""
    path = dino_weights_path()
    if path is None:
        return False
    return load_into(module, node_name,
                     load_dinov2_params(path)["params"]) > 0
