"""Model loading and image helpers for the port's inference scripts
(``scripts/common.py``)."""

from __future__ import annotations

import json
import os

import numpy as np


def load_model_from_file(model_in_file, cpu=False):
    """model_in_file: a ``<prefix>_net_<name>.pth`` checkpoint. Rebuilds the
    model from the directory's ``train_config.json`` and loads that prefix
    (EMA weights are used at inference when present). Runs on CUDA unless
    ``cpu``. Returns (model, opt)."""
    from ..models import create_model
    from ..options import TrainOptions

    model_dir = os.path.dirname(os.path.abspath(model_in_file))
    with open(os.path.join(model_dir, "train_config.json")) as f:
        cfg = json.load(f)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 1
    base = os.path.basename(model_in_file)
    prefix = base.split("_net_")[0] if "_net_" in base else "latest"
    model = create_model(opt, phase="test", cpu=cpu)
    model.save_dir = model_dir
    model.load_networks(prefix)
    return model, opt


def load_image_rgb(path):
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def save_image_rgb(path, arr_uint8):
    from PIL import Image
    Image.fromarray(arr_uint8).save(path)


def to_uint8(img):
    return ((np.asarray(img, np.float32) + 1.0) * 127.5).clip(0, 255) \
        .astype(np.uint8)


def to_m1p1(img_uint8):
    return np.asarray(img_uint8, np.float32) / 127.5 - 1.0
