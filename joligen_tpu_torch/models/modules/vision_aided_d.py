"""Vision-aided discriminator (``joligen_tpu/models/modules/vision_aided_d.py``):
frozen vision towers (CLIP ViT-B/16 ``freezenet_clip``, DINOv2 ViT-B/14
``freezenet_dino``), each with two small trainable heads: a patch conv head
over the tower's token grid and an MLP over its embedding. Their logits are
concatenated, clip's first: (B, 49 + 1 + 64 + 1) = (B, 115) with both
towers, at every input size, since both towers see 224 px.

Freezing is what the JAX package does: the towers' outputs are detached
(``stop_gradient`` at ``vision_aided_d.py:113,120``), so the towers run
without a graph, their parameters get a zero gradient, and no gradient
reaches the discriminator's input. A generator learns nothing from this
discriminator's logits; its loss still counts them.

The towers compute in fp32 (they have no dtype); the heads compute in the
compute dtype, the tokens cast to it. The towers are looked up in their
modules when the discriminator is built, so a test can shrink them there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet_generator import Conv
from .unet_mha import Dense


class VisionAidedDiscriminator(nn.Module):
    """``forward(x)``: NHWC in [-1, 1] -> (B, P) fp32 logits. The heads of
    the dino member carry the ``_dino`` suffix (clip's none, as in the JAX
    package's clip-only checkpoints)."""

    def __init__(self, backbones=("clip",), head_ch=128, dtype=torch.float32):
        super().__init__()
        from ...utils import clip_vit, dinov2
        self.backbones, self.dtype = tuple(backbones), dtype
        self.members = []
        for bk in self.backbones:
            if bk == "clip":
                tower = clip_vit.CLIPVisualViT(return_tokens=True)
                self.freezenet_clip = tower
                self.members.append(("freezenet_clip", clip_vit.preprocess,
                                     ""))
                self._add_head(tower.dim, tower.out_dim, head_ch, "")
            elif bk in ("dino", "dinov2"):
                tower = dinov2.DINOv2ViT(return_tokens=True)
                self.freezenet_dino = tower
                self.members.append(("freezenet_dino", dinov2.preprocess,
                                     "_dino"))
                self._add_head(tower.dim, tower.dim, head_ch, "_dino")

    def _add_head(self, token_ch, emb_dim, head_ch, tag):
        dt = self.dtype
        self.add_module(f"patch0{tag}", Conv(token_ch, head_ch, 3, 1, 1,
                                             dtype=dt))
        self.add_module(f"patch1{tag}", Conv(head_ch, head_ch, 3, 2, 1,
                                             dtype=dt))
        self.add_module(f"patch_out{tag}", Conv(head_ch, 1, 1, dtype=dt))
        self.add_module(f"glob0{tag}", Dense(emb_dim, head_ch, dtype=dt))
        self.add_module(f"glob_out{tag}", Dense(head_ch, 1, dtype=dt))

    def frozen_parameters(self):
        """The towers' parameters (zero gradient)."""
        return [p for name, _, _ in self.members
                for p in getattr(self, name).parameters()]

    def _head(self, emb, tokens, tag):
        m = lambda name: getattr(self, name + tag)  # noqa: E731
        h = tokens.to(self.dtype).permute(0, 3, 1, 2)
        h = F.leaky_relu(m("patch0")(h), 0.2)
        h = F.leaky_relu(m("patch1")(h), 0.2)
        patch_logits = m("patch_out")(h)
        g = F.leaky_relu(m("glob0")(emb.to(self.dtype)), 0.2)
        glob_logit = m("glob_out")(g)
        return torch.cat([patch_logits.reshape(tokens.shape[0], -1),
                          glob_logit], dim=1)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        outs = []
        for name, preprocess, tag in self.members:
            # the towers need no graph: their outputs are detached
            with torch.no_grad():
                emb, tokens = getattr(self, name)(preprocess(x.float()))
            outs.append(self._head(emb.detach(), tokens.detach(), tag))
        return torch.cat(outs, dim=1).float()
