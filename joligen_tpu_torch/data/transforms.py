"""Mask-synchronized image transforms, numpy/PIL host-side: a copy of
``joligen_tpu/data/transforms.py``.

Parity with reference data/base_dataset.py get_transform (:428) and
get_transform_seg (:611): resize -> (random) crop -> flip -> normalize,
with every geometric op applied identically to image and mask. Output is
NHWC float32 in [-1, 1]; masks are (H, W, 1) int32. The uint8 -> [-1, 1]
normalisation is numpy (the JAX package's numpy path; its g++ helper
``native/batch_ops.cpp`` is not ported, ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image


def load_image(path, img_bits=8):
    """8-bit images are normalized to RGB; >8-bit imagery (12/16-bit
    grayscale tiff/png, reference data/utils.py:4-14 +
    base_dataset.py:513-523) keeps its native integer mode so the bit
    depth survives until normalization."""
    if img_bits > 8:
        try:
            with Image.open(path) as img:
                return img.copy()
        except Exception:
            import tifffile  # multi-channel >8-bit (reference data/utils.py:5-9)
            # PIL cannot represent (H,W,3) uint16 — hand the raw array to
            # PairedTransform.image, which has an ndarray path for it
            return tifffile.imread(path)
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def load_mask(path):
    m = Image.open(path)
    if m.mode not in ("L", "I", "P"):
        m = m.convert("L")
    return m


class PairedTransform:
    """One sampled set of geometric params applied to image(s) + mask(s)."""

    def __init__(self, opt, phase="train", grayscale=False):
        self.load_size = getattr(opt, "data_load_size", 286)
        self.crop_size = getattr(opt, "data_crop_size", 256)
        self.preprocess = getattr(opt, "data_preprocess", "resize_and_crop")
        flip_mode = getattr(opt, "dataaug_flip", "horizontal") or "horizontal"
        self.hflip = phase == "train" and flip_mode in ("horizontal", "both")
        self.vflip = phase == "train" and flip_mode in ("vertical", "both")
        self.rotate = phase == "train" and not getattr(opt, "dataaug_no_rotate", True)
        self.train = phase == "train"
        self.grayscale = grayscale
        self.affine_p = float(getattr(opt, "dataaug_affine", 0.0) or 0.0)
        self.affine_scale_min = float(getattr(opt, "dataaug_affine_scale_min",
                                              0.8) or 0.8)
        self.affine_scale_max = float(getattr(opt, "dataaug_affine_scale_max",
                                              1.2) or 1.2)
        self.affine_shear = float(getattr(opt, "dataaug_affine_shear", 0)
                                  or 0.0)
        self.affine_translate = float(getattr(opt, "dataaug_affine_translate",
                                              0.1) or 0.1)
        self.imgaug = bool(getattr(opt, "dataaug_imgaug", False))
        self.image_bits = int(getattr(opt, "data_image_bits", 8) or 8)
        # foreground-vs-background collapse (reference
        # unaligned_labeled_mask_dataset.py:104-105)
        self.mask_all_one = bool(getattr(opt, "f_s_all_classes_as_one",
                                         False))

    def sample_params(self, rng=None):
        rng = rng or random
        p = {
            "hflip": self.hflip and rng.random() < 0.5,
            "vflip": self.vflip and rng.random() < 0.5,
            "rot90": self.rotate and rng.random() < 0.5,
        }
        max_off = max(0, self.load_size - self.crop_size)
        if self.train:
            p["off_x"] = rng.randint(0, max_off) if max_off else 0
            p["off_y"] = rng.randint(0, max_off) if max_off else 0
        else:
            p["off_x"] = p["off_y"] = max_off // 2
        # affine params (reference dataaug_affine, RandomAffine in
        # base_dataset.py; mask-synchronized since both use the same p)
        if self.train and getattr(self, "affine_p", 0.0) > 0 \
                and rng.random() < self.affine_p:
            p["affine"] = {
                "angle": rng.uniform(-10, 10),
                "scale": rng.uniform(self.affine_scale_min,
                                     self.affine_scale_max),
                "shear": rng.uniform(-self.affine_shear, self.affine_shear),
                "tx": rng.uniform(-self.affine_translate,
                                  self.affine_translate),
                "ty": rng.uniform(-self.affine_translate,
                                  self.affine_translate),
            }
        # photometric weather/color aug (reference RandomImgAug, imgaug
        # weather stack, base_dataset.py:1056-1133 — cv2 approximations;
        # IMAGE ONLY, never the mask)
        if self.train and getattr(self, "imgaug", False) \
                and rng.random() < 0.5:
            p["photo"] = {
                "brightness": rng.uniform(-0.15, 0.15),
                "contrast": rng.uniform(0.85, 1.15),
                "blur": rng.random() < 0.2,
                "noise": rng.uniform(0.0, 0.03),
            }
        return p

    def _geo(self, img: Image.Image, params, resample):
        if self.preprocess in ("resize_and_crop",):
            img = img.resize((self.load_size, self.load_size), resample)
        elif self.preprocess == "scale_width":
            w, h = img.size
            nh = max(1, int(round(h * self.load_size / w)))
            img = img.resize((self.load_size, nh), resample)
        elif self.preprocess == "none":
            pass
        if "crop" in self.preprocess:
            x, y = params["off_x"], params["off_y"]
            img = img.crop((x, y, x + self.crop_size, y + self.crop_size))
        if img.size != (self.crop_size, self.crop_size) and self.preprocess != "none":
            img = img.resize((self.crop_size, self.crop_size), resample)
        if params["hflip"]:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if params["vflip"]:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        if params["rot90"]:
            img = img.transpose(Image.ROTATE_90)
        aff = params.get("affine")
        if aff:
            w, h = img.size
            img = img.transform(
                (w, h), Image.AFFINE,
                _affine_coeffs(w, h, aff["angle"], aff["scale"], aff["shear"],
                               aff["tx"] * w, aff["ty"] * h),
                resample=resample)
        return img

    def image(self, img, params):
        if self.image_bits > 8:
            # >8-bit path (reference base_dataset.py:513-523): scale by
            # 2**bits - 1 into [0,1], then normalize to [-1,1]; photometric
            # augs are 8-bit-only upstream too. Multi-channel >8-bit images
            # arrive as raw ndarrays (tiff path) and are geo-transformed
            # per channel through float PIL planes
            if isinstance(img, np.ndarray) and img.ndim == 3:
                planes = []
                for c in range(img.shape[-1]):
                    pl = Image.fromarray(img[..., c].astype(np.float32),
                                         mode="F")
                    planes.append(np.asarray(
                        self._geo(pl, params, Image.BICUBIC), np.float32))
                arr = np.stack(planes, axis=-1)
            else:
                if isinstance(img, np.ndarray):
                    img = Image.fromarray(img)
                if img.mode not in ("I", "F"):
                    img = img.convert("I")
                img = self._geo(img, params, Image.BICUBIC)
                arr = np.asarray(img, dtype=np.float32)
            arr = arr / float(2 ** self.image_bits - 1) * 2.0 - 1.0
            # bicubic overshoot on the float planes can leave values
            # slightly outside [-1,1]; the 8-bit path clips via uint8
            arr = np.clip(arr, -1.0, 1.0)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            return arr
        if self.grayscale and img.mode != "L":
            img = img.convert("L")   # 1-channel configs (model_input_nc=1)
        img = self._geo(img, params, Image.BICUBIC)
        u8 = np.asarray(img, dtype=np.uint8)
        photo = params.get("photo")
        if photo:
            import cv2
            f = u8.astype(np.float32)
            f = (f - 127.5) * photo["contrast"] + 127.5 \
                + photo["brightness"] * 255.0
            if photo["blur"]:
                f = cv2.GaussianBlur(f, (3, 3), 0)
            if photo["noise"] > 0:
                f = f + np.random.randn(*f.shape).astype(np.float32) \
                    * photo["noise"] * 255.0
            u8 = f.clip(0, 255).astype(np.uint8)
        arr = u8.astype(np.float32) / 127.5 - 1.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr  # (H, W, C) in [-1, 1]

    def mask(self, m: Image.Image, params):
        m = self._geo(m, params, Image.NEAREST)
        arr = np.asarray(m, dtype=np.int32)
        if arr.ndim == 3:
            arr = arr[:, :, 0]
        if self.mask_all_one:
            arr = (arr > 0).astype(np.int32)
        return arr[:, :, None]  # (H, W, 1) int32


def _affine_coeffs(w, h, angle, scale, shear, tx, ty):
    """PIL inverse-affine coefficients around the image center."""
    import math as _m
    a = _m.radians(angle)
    sh = _m.radians(shear)
    cx, cy = w / 2.0, h / 2.0
    # forward matrix: rotate*scale*shear then translate
    m00 = _m.cos(a) * scale
    m01 = (-_m.sin(a + sh)) * scale
    m10 = _m.sin(a) * scale
    m11 = _m.cos(a + sh) * scale
    det = m00 * m11 - m01 * m10 or 1e-8
    i00, i01 = m11 / det, -m01 / det
    i10, i11 = -m10 / det, m00 / det
    # inverse maps output pixel -> input pixel, pivoting on the center
    ox = cx + tx
    oy = cy + ty
    c0 = cx - i00 * ox - i01 * oy
    c1 = cy - i10 * ox - i11 * oy
    return (i00, i01, c0, i10, i11, c1)


def fill_mask_with_random(img, mask, cls=-1):
    """Replace pixels of class ``cls`` (-1 = any nonzero) with U[-1,1] noise
    (reference data/online_creation.py:1366-1385)."""
    sel = (mask[..., 0] > 0) if cls == -1 else (mask[..., 0] == cls)
    noise = np.random.uniform(-1.0, 1.0, img.shape).astype(img.dtype)
    out = img.copy()
    out[sel] = noise[sel]
    return out


def fill_mask_with_color(img, mask, colors=None, cls=-1):
    """Replace masked pixels with a flat color (default mid-gray)
    (reference data/online_creation.py:1387-1403)."""
    sel = (mask[..., 0] > 0) if cls == -1 else (mask[..., 0] == cls)
    out = img.copy()
    color = (colors or {}).get(cls, 0.0)
    out[sel] = color
    return out
