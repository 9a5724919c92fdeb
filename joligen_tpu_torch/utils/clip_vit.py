"""OpenAI CLIP visual encoder, ViT-B/16 (``joligen_tpu/utils/clip_vit.py``):
a 16 px patch conv (no bias), class embedding and learned positional
embedding, ``ln_pre``, 12 pre-norm blocks with quickGELU MLPs, ``ln_post``
and a 768→512 output projection ``proj``, a raw matrix applied as
``out @ proj``. The modules carry flax's names.

``class_embedding``, ``positional_embedding`` and ``proj`` start at zero, as
in the JAX package: without a weights file the tower's embedding is exactly
0. Ported weights load from ``$JOLIGEN_TPU_WEIGHTS_DIR/clip_vitb16.npz``
(``load_clip_params`` reads the JAX package's key contract).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..models.modules.resnet_generator import Conv
from ..models.modules.unet_mha import Dense
from ..ops.resize import resize_bilinear
from .vit_layers import LayerNorm, MultiHeadDotProductAttention

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGE_SIZE = 224


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.ln_1 = LayerNorm(dim, 1e-5)
        self.attn = MultiHeadDotProductAttention(dim, heads)
        self.ln_2 = LayerNorm(dim, 1e-5)
        self.c_fc = Dense(dim, dim * 4)
        self.c_proj = Dense(dim * 4, dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPVisualViT(nn.Module):
    """``forward(x)``: (N, 224, 224, 3) CLIP-normalised -> (N, out_dim)
    embeddings (the CLS token through ``ln_post`` and ``proj``); with
    ``return_tokens`` also the (N, gh, gw, dim) patch tokens. The positional
    table is sized for ``image_size`` px inputs."""

    def __init__(self, dim=768, depth=12, heads=12, patch=16, out_dim=512,
                 return_tokens=False, image_size=IMAGE_SIZE):
        super().__init__()
        self.dim, self.depth, self.patch = dim, depth, patch
        self.out_dim, self.return_tokens = out_dim, return_tokens
        grid = image_size // patch
        self.conv1 = Conv(3, dim, patch, patch, "VALID", bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(dim))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1,
                                                             dim))
        self.ln_pre = LayerNorm(dim, 1e-5)
        for i in range(depth):
            self.add_module(f"block{i}", _Block(dim, heads))
        self.ln_post = LayerNorm(dim, 1e-5)
        self.proj = nn.Parameter(torch.zeros(dim, out_dim))

    def forward(self, x):
        n, H, W, _ = x.shape
        gh, gw = H // self.patch, W // self.patch
        h = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.reshape(1, 1, -1).expand(n, 1, self.dim)
        h = torch.cat([cls.to(h.dtype), h], dim=1) + self.positional_embedding
        h = self.ln_pre(h)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h)
        out = self.ln_post(h[:, 0]) @ self.proj
        if self.return_tokens:
            return out, h[:, 1:].reshape(n, gh, gw, self.dim)
        return out


def preprocess(x):
    """[-1, 1] (N, H, W, C) -> 224 px CLIP-normalised RGB, the resize
    antialiased where it shrinks, as ``jax.image.resize``."""
    x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    if tuple(x.shape[1:3]) != (IMAGE_SIZE, IMAGE_SIZE):
        x = resize_bilinear(x.permute(0, 3, 1, 2),
                            (IMAGE_SIZE, IMAGE_SIZE)).permute(0, 2, 3, 1)
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    return (x - mean) / std


def _attn_from_torch(z, i, d, heads):
    """A torch ``in_proj`` (3D, D) / ``out_proj`` pair -> flax's
    ``query``/``key``/``value``/``out`` DenseGeneral leaves."""
    hd = d // heads
    qkv_w, qkv_b = z[f"block{i}.attn.qkv_w"], z[f"block{i}.attn.qkv_b"]
    out = {}
    for j, name in enumerate(("query", "key", "value")):
        out[name] = {
            "kernel": qkv_w[j * d:(j + 1) * d].T.reshape(d, heads, hd),
            "bias": qkv_b[j * d:(j + 1) * d].reshape(heads, hd)}
    out["out"] = {"kernel": z[f"block{i}.attn.proj_w"].T.reshape(heads, hd, d),
                  "bias": z[f"block{i}.attn.proj_b"]}
    return out


def _norm(z, key):
    return {"scale": z[f"{key}.scale"], "bias": z[f"{key}.bias"]}


def n_blocks(z):
    return len({k.split(".")[0] for k in z.files if k.startswith("block")})


def load_clip_params(npz_path, heads=None):
    """The flax tree ``{"params": ...}`` of numpy arrays from an npz in the
    JAX package's contract (``tools/port_clip_weights.py``):
    ``conv1.kernel`` (HWIO), ``class_embedding``, ``positional_embedding``,
    ``ln_pre``/``ln_post.{scale,bias}``, ``block{i}.{ln_1,ln_2}.{scale,bias}``,
    ``block{i}.attn.{qkv_w,qkv_b,proj_w,proj_b}`` (torch (out, in)),
    ``block{i}.{c_fc,c_proj}.{kernel,bias}``, ``proj``."""
    z = np.load(npz_path)
    d = int(z["class_embedding"].shape[-1])
    heads = heads or d // 64   # 64-dim heads in every released CLIP ViT
    params = {
        "conv1": {"kernel": z["conv1.kernel"]},
        "class_embedding": z["class_embedding"],
        "positional_embedding": z["positional_embedding"],
        "ln_pre": _norm(z, "ln_pre"), "ln_post": _norm(z, "ln_post"),
        "proj": z["proj"],
    }
    for i in range(n_blocks(z)):
        params[f"block{i}"] = {
            "ln_1": _norm(z, f"block{i}.ln_1"),
            "ln_2": _norm(z, f"block{i}.ln_2"),
            "attn": _attn_from_torch(z, i, d, heads),
            "c_fc": {"kernel": z[f"block{i}.c_fc.kernel"],
                     "bias": z[f"block{i}.c_fc.bias"]},
            "c_proj": {"kernel": z[f"block{i}.c_proj.kernel"],
                       "bias": z[f"block{i}.c_proj.bias"]},
        }
    return {"params": params}


def clip_weights_path():
    wd = os.environ.get("JOLIGEN_TPU_WEIGHTS_DIR", "")
    path = os.path.join(wd, "clip_vitb16.npz")
    return path if (wd and os.path.exists(path)) else None


def load_into(module, node_name, tree):
    """Load the flax ``tree`` into every submodule of ``module`` named
    ``node_name``, strictly. Returns how many it loaded."""
    from ..models.convert import flax_to_torch
    state = flax_to_torch(tree)
    hits = 0
    for name, sub in module.named_modules():
        if name.rsplit(".", 1)[-1] == node_name:
            sub.load_state_dict(state, strict=True)
            hits += 1
    return hits


def load_clip_ref_encoder(module, node_name="freezenet_clip"):
    """Swap the ported CLIP weights into every ``node_name`` submodule when
    ``clip_vitb16.npz`` exists (else the module keeps its frozen random
    init). Returns whether it did."""
    path = clip_weights_path()
    if path is None:
        return False
    return load_into(module, node_name,
                     load_clip_params(path)["params"]) > 0
