"""Inference-only generator (``joligen_tpu/models/test_model.py``,
``model_type: test``): one G, loaded from
``[prefix]_net_G<model_suffix>.pth`` (``_A`` by default), translating
``batch["A"]``. Like the JAX model it keeps no EMA copy."""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseModel
from .gan_networks import define_G, flax_default_init


class TestModel(BaseModel):
    def __init__(self, opt, phase="test", device=None, cpu=False):
        super().__init__(opt, phase="test", device=device, cpu=cpu)
        self.g_name = "G" + (getattr(opt, "model_suffix", "") or "_A")
        self.add_net(self.g_name, flax_default_init(
            define_G(opt), torch.Generator().manual_seed(self.seed)))

    def optimize_parameters(self, batch):
        raise RuntimeError("TestModel is inference-only (model_type test)")

    def inference(self, batch, **kwargs):
        dev = self.put_batch({"A": np.asarray(batch["A"], np.float32)})
        with torch.inference_mode():
            return self.nets[self.g_name](dev["A"]).cpu().numpy()
