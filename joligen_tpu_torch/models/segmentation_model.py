"""Standalone semantic segmentation (``joligen_tpu/models/
segmentation_model.py``, ``model_type: segmentation``): the segmenter f_s
(``define_f``: ``unet``, ``segformer`` or ``vgg``) trained alone on
(``A``, ``A_label_mask``) with Adam at ``train_sem_lr_f_s``.

f_s starts at flax's default init (VGG16-FCN8s's skips at zero), then the
MiT or VGG16 trunk's weights file where it exists, as the JAX model loads
it. The loss is the mean softmax cross-entropy against the one-hot label:
a label at or above ``f_s_semantic_nclasses`` has an all-zero one-hot and
counts 0, as ``jax.nn.one_hot`` makes it (``F.cross_entropy`` would raise).
The batch goes to the device in float32, as in the JAX model; the loss
(``f_s``) stays on the device.

``inference`` gives the argmax label map, (B, H, W, 1) int32 numpy;
``compute_miou`` the hard mean IoU over the classes whose union is not
empty, a float. The train loop reads ``compute_miou``'s value as a dict of
metrics: with ``train_mask_compute_miou`` it prints ``mIoU failed`` and
trains on, as the JAX loop does with this model.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import BaseModel
from .modules.segformer import load_mit_backbone
from .modules.semantic_networks import (define_f, init_segmenter,
                                        load_vgg_fcn8s_trunk)
from .train_state import apply_updates, param_grads


class SegmentationModel(BaseModel):
    def __init__(self, opt, phase="train", device=None, cpu=False):
        super().__init__(opt, phase=phase, device=device, cpu=cpu)
        net = init_segmenter(define_f(opt),
                             torch.Generator().manual_seed(self.seed))
        net_name = getattr(opt, "f_s_net", "") or ""
        if net_name == "segformer":
            load_mit_backbone(net)
        elif net_name == "vgg":
            load_vgg_fcn8s_trunk(net)
        self.add_net("f_s", net, lr=getattr(opt, "train_sem_lr_f_s", 2e-4))

    def set_input(self, batch):
        return {"img": np.asarray(batch["A"], np.float32),
                "mask": np.asarray(batch["A_label_mask"])}

    def prepare_batch(self, batch):
        return self.put_batch(self.set_input(batch))

    def _loss(self, img, mask):
        logits = self.nets["f_s"](img)
        n = logits.shape[-1]
        onehot = (mask[..., 0, None] == torch.arange(
            n, device=mask.device)).to(logits.dtype)
        return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1).mean()

    def optimize_prepared(self, dev):
        state = self.states["f_s"]
        loss = self._loss(dev["img"], dev["mask"])
        apply_updates(state, param_grads(loss, state.params))
        self.loss_log = {"f_s": loss.detach()}
        return self.loss_log

    def optimize_parameters(self, batch):
        return self.optimize_prepared(self.prepare_batch(batch))

    def inference(self, batch, **kwargs):
        """The predicted label map of ``batch["A"]``, (B, H, W, 1) int32."""
        dev = self.put_batch({"img": np.asarray(batch["A"], np.float32)})
        with torch.inference_mode():
            pred = torch.argmax(self.nets["f_s"](dev["img"]), dim=-1)
        return pred.to(torch.int32).cpu().numpy()[..., None]

    def compute_miou(self, batch, nclasses=None):
        """Hard mean IoU of the predictions against ``A_label_mask`` over
        the classes whose union is not empty (0.0 if none is)."""
        nclasses = nclasses or getattr(self.opt, "f_s_semantic_nclasses", 2)
        pred = self.inference(batch)[..., 0]
        gt = np.asarray(batch["A_label_mask"])[..., 0]
        ious = []
        for c in range(nclasses):
            inter = np.logical_and(pred == c, gt == c).sum()
            union = np.logical_or(pred == c, gt == c).sum()
            if union > 0:
                ious.append(inter / union)
        return float(np.mean(ious)) if ious else 0.0
