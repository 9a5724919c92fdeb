"""Dataset modes (host-side sample producers), copied from
``joligen_tpu/data/datasets.py``: the labeled-mask modes (``:31-227``), the
online bbox-crop modes (``:229-357``), the unaligned mode (``:74-97``), the
four ref modes (``:361-470``: a reference image per sample from
``trainA/conditions.txt``, as ``ref_A``) and the aligned and single modes
(``:663-698``).

Each dataset returns per-sample dicts of numpy arrays with keys matching the
reference contract (data/base_dataset.py:120-195): ``A``, ``B`` (H,W,C float32
in [-1,1]), ``A_label_mask``/``B_label_mask`` (H,W,1 int32),
``A_label_cls``/``B_label_cls`` (int32 scalars), plus path metadata.
"""

from __future__ import annotations

import os
import random

import numpy as np

from .image_folder import (make_dataset, make_labeled_path_dataset,
                           make_ref_path)
from .online_creation import crop_image, sample_rotation_state
from .transforms import (PairedTransform, fill_mask_with_color,
                         fill_mask_with_random, load_image, load_mask)


class BaseDataset:
    def __init__(self, opt, phase, name=""):
        self.opt = opt
        self.phase = phase
        self.name = name
        self.root = opt.dataroot
        suffix = name or ""
        # direction swap (reference base_dataset.py:73-88)
        btoa = getattr(opt, "data_direction", "AtoB") == "BtoA"
        dir_A = "B" if btoa else "A"
        dir_B = "A" if btoa else "B"
        self.dir_A = os.path.join(self.root, phase + dir_A + suffix)
        self.dir_B = os.path.join(self.root, phase + dir_B + suffix)
        self.transform = PairedTransform(
            opt, phase,
            grayscale=(getattr(opt, "model_input_nc", 3) == 1))
        self.use_domain_B = True

    def _load_img(self, p):
        # bound image loader so data_image_bits>8 keeps its depth
        # (reference data/utils.py:4-14, base_dataset.py:92-95)
        return load_image(self._resolve(p),
                          int(getattr(self.opt, "data_image_bits", 8) or 8))

    def _resolve(self, p):
        if getattr(self.opt, "data_relative_paths", False):
            return os.path.join(self.root, p)
        # paths.txt entries are absolute by default (reference contract), but
        # fall back to dataroot-relative instead of failing every sample when
        # the user forgot --data_relative_paths
        if not os.path.isabs(p) and not os.path.exists(p):
            cand = os.path.join(self.root, p)
            if os.path.exists(cand):
                return cand
        return p

    def __len__(self):
        return self.A_size

    def __getitem__(self, index):
        raise NotImplementedError


class UnalignedDataset(BaseDataset):
    """Unpaired A/B: A by index, B at random (from ``random``) or, with
    ``data_serial_batches``, by the same index."""

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.A_img_paths = make_dataset(self.dir_A, opt.data_max_dataset_size)
        self.B_img_paths = make_dataset(self.dir_B, opt.data_max_dataset_size)
        self.A_size = len(self.A_img_paths)
        self.B_size = len(self.B_img_paths)

    def __getitem__(self, index):
        A_path = self.A_img_paths[index % self.A_size]
        if getattr(self.opt, "data_serial_batches", False):
            B_path = self.B_img_paths[index % self.B_size]
        else:
            B_path = self.B_img_paths[random.randint(0, self.B_size - 1)]
        pA = self.transform.sample_params()
        pB = self.transform.sample_params()
        return {
            "A": self.transform.image(self._load_img(A_path), pA),
            "B": self.transform.image(self._load_img(B_path), pB),
            "A_img_paths": A_path,
            "B_img_paths": B_path,
        }


class _LabeledPathsMixin:
    """Parses trainX/paths.txt lines: 'img [cls] [mask]'
    (reference data/image_folder.py:81-104 + unaligned_labeled_* variants)."""

    def _load_side(self, d, with_cls, with_mask):
        if os.path.exists(os.path.join(d, "paths.txt")):
            imgs, labels = make_labeled_path_dataset(
                d, "/paths.txt", self.opt.data_max_dataset_size)
        else:
            imgs, labels = make_labeled_path_dataset(
                self.root, "/paths.txt", self.opt.data_max_dataset_size)
        cls_list, mask_list = [], []
        for lab in labels:
            parts = lab.split()
            if with_cls and with_mask:
                cls_list.append(int(parts[0]) if len(parts) > 1 else 0)
                mask_list.append(parts[-1])
            elif with_mask:
                mask_list.append(parts[-1])
                cls_list.append(0)
            elif with_cls:
                cls_list.append(int(parts[0]))
                mask_list.append(None)
        return imgs, cls_list, mask_list


class UnalignedLabeledMaskDataset(BaseDataset, _LabeledPathsMixin):
    with_cls = False
    with_mask = True

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.A_img_paths, self.A_cls, self.A_mask_paths = self._load_side(
            self.dir_A, self.with_cls, self.with_mask)
        self.A_size = len(self.A_img_paths)
        self.B_img_paths, self.B_cls, self.B_mask_paths = [], [], []
        if self.use_domain_B and os.path.isdir(self.dir_B):
            try:
                self.B_img_paths, self.B_cls, self.B_mask_paths = self._load_side(
                    self.dir_B, self.with_cls, self.with_mask)
            except (AssertionError, FileNotFoundError, ValueError):
                self.B_img_paths = make_dataset(
                    self.dir_B, self.opt.data_max_dataset_size)
                self.B_cls = [0] * len(self.B_img_paths)
                self.B_mask_paths = [None] * len(self.B_img_paths)
        self.B_size = len(self.B_img_paths)

    def get_img(self, A_path, A_mask_path, A_cls, B_path=None, B_mask_path=None,
                B_cls=None):
        p = self.transform.sample_params()
        out = {
            "A": self.transform.image(self._load_img(A_path), p),
            "A_img_paths": A_path,
            "A_label_cls": np.int32(A_cls or 0),
        }
        if A_mask_path:
            out["A_label_mask"] = self.transform.mask(
                load_mask(self._resolve(A_mask_path)), p)
        if B_path is not None:
            pB = self.transform.sample_params()
            out["B"] = self.transform.image(self._load_img(B_path), pB)
            out["B_img_paths"] = B_path
            out["B_label_cls"] = np.int32(B_cls or 0)
            if B_mask_path:
                out["B_label_mask"] = self.transform.mask(
                    load_mask(self._resolve(B_mask_path)), pB)
        return out

    def __getitem__(self, index):
        A_path = self.A_img_paths[index % self.A_size]
        A_mask = self.A_mask_paths[index % self.A_size] if self.with_mask else None
        A_cls = self.A_cls[index % self.A_size] if self.A_cls else 0
        B_path = B_mask = B_cls = None
        if self.B_size:
            j = (index % self.B_size
                 if getattr(self.opt, "data_serial_batches", False)
                 else random.randint(0, self.B_size - 1))
            B_path = self.B_img_paths[j]
            B_mask = self.B_mask_paths[j] if self.with_mask else None
            B_cls = self.B_cls[j] if self.B_cls else 0
        return self.get_img(A_path, A_mask, A_cls, B_path, B_mask, B_cls)


class UnalignedLabeledMaskClsDataset(UnalignedLabeledMaskDataset):
    with_cls = True
    with_mask = True


class SelfSupervisedLabeledMaskDataset(UnalignedLabeledMaskDataset):
    """A = mask-noised copy of the single domain; B = original
    (reference data/self_supervised_labeled_mask_dataset.py:23-60)."""

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.use_domain_B = False

    def __getitem__(self, index):
        A_path = self.A_img_paths[index % self.A_size]
        A_mask = self.A_mask_paths[index % self.A_size]
        A_cls = self.A_cls[index % self.A_size] if self.A_cls else 0
        out = self.get_img(A_path, A_mask, A_cls)
        img, mask = out["A"], out["A_label_mask"]
        if getattr(self.opt, "data_online_creation_rand_mask_A", True):
            noised = fill_mask_with_random(img, mask, -1)
        else:
            # color fill otherwise (reference
            # self_supervised_*_dataset.py:45-53 raises when NEITHER flag is
            # set; defaulting to the color fill keeps default configs
            # trainable instead of failing every sample)
            noised = fill_mask_with_color(img, mask)
        out.update({
            "A": noised,
            "B": img,
            "B_img_paths": out["A_img_paths"],
            "B_label_mask": mask.copy(),
            "B_label_cls": out["A_label_cls"],
        })
        return out


class SelfSupervisedLabeledMaskClsDataset(SelfSupervisedLabeledMaskDataset):
    with_cls = True


class _OnlineMixin:
    """bbox-file-driven online crops (reference
    data/unaligned_labeled_mask_online_dataset.py:81-247)."""

    def _sanitize(self, img_paths, mask_paths):
        """Drop unreadable samples upfront (reference
        data_sanitize_paths, online_creation.py:1405-1488)."""
        if not getattr(self.opt, "data_sanitize_paths", False):
            return img_paths, mask_paths
        from .online_creation import sanitize_paths
        root = self.root if getattr(self.opt, "data_relative_paths",
                                    False) else None
        return sanitize_paths(img_paths, mask_paths, root=root, verbose=True)

    def online_crop(self, img_path, bbox_path, domain="A", rotation_state=None):
        opt = self.opt
        # ratio deltas override pixel deltas when set (reference
        # temporal_labeled_mask_online_dataset.py:141-145)
        ratio = getattr(opt,
                        f"data_online_creation_mask_delta_{domain}_ratio",
                        [[]])
        crop, mask, ref_bbox, cat = crop_image(
            self._resolve(img_path),
            self._resolve(bbox_path),
            mask_delta=getattr(opt, f"data_online_creation_mask_delta_{domain}", [[]]),
            mask_delta_ratio=ratio,
            mask_random_offset=getattr(
                opt, f"data_online_creation_mask_random_offset_{domain}", [0.0]),
            crop_delta=getattr(opt, f"data_online_creation_crop_delta_{domain}", 50),
            mask_square=getattr(opt, f"data_online_creation_mask_square_{domain}", False),
            crop_dim=getattr(opt, f"data_online_creation_crop_size_{domain}", 512),
            output_dim=opt.data_crop_size,
            context_pixels=getattr(opt, "data_online_context_pixels", 0),
            load_size=getattr(opt, f"data_online_creation_load_size_{domain}", []),
            load_size_keep_ratio=getattr(
                opt, f"data_online_creation_load_size_keep_ratio_{domain}", False),
            select_cat=getattr(opt, "data_online_select_category", -1),
            fixed_mask_size=getattr(opt, "data_online_fixed_mask_size", -1),
            fixed_mask_size_model=getattr(
                opt, f"data_online_creation_mask_fixed_size_{domain}", -1),
            fixed_mask_min_unmasked_border_model=getattr(
                opt, f"data_online_creation_mask_min_unmasked_border_{domain}", 4),
            inverted_mask=getattr(opt, "data_inverted_mask", False),
            single_bbox=getattr(opt, "data_online_single_bbox", False),
            random_bbox=getattr(opt, "data_online_random_bbox", False),
            broaden_rect_aug=getattr(
                opt, f"data_online_creation_mask_broaden_rect_aug_{domain}", False),
            rotation_state=rotation_state,
        )
        if getattr(opt, "f_s_all_classes_as_one", False):
            # reference unaligned_labeled_mask_online_dataset.py:146
            mask = (mask > 0).astype(np.int32)
        return crop, mask, ref_bbox, cat


class UnalignedLabeledMaskOnlineDataset(UnalignedLabeledMaskDataset, _OnlineMixin):
    def __init__(self, opt, phase, name=""):
        if getattr(opt, "data_refined_mask", False):
            # raised here, not per sample: the loader would skip every
            # sample whose crop raised
            raise NotImplementedError(
                "data_refined_mask: the SAM-refined object mask needs SAM "
                "weights (ROADMAP Queue 1 item 14, metrics and frozen nets)")
        super().__init__(opt, phase, name)
        self.A_img_paths, self.A_mask_paths = self._sanitize(
            self.A_img_paths, self.A_mask_paths)
        self.A_size = len(self.A_img_paths)
        if self.B_size:
            self.B_img_paths, self.B_mask_paths = self._sanitize(
                self.B_img_paths, self.B_mask_paths)
            self.B_size = len(self.B_img_paths)

    def get_img(self, A_path, A_mask_path, A_cls, B_path=None, B_mask_path=None,
                B_cls=None):
        try:
            A, A_mask, A_ref_bbox, A_cat = self.online_crop(
                A_path, A_mask_path, "A",
                rotation_state=sample_rotation_state(self.opt))
        except Exception as e:  # unreadable sample -> skip (collate filters None)
            print(f"online crop failure {A_path}: {e}")
            return None
        out = {"A": A, "A_label_mask": A_mask, "A_ref_bbox": A_ref_bbox,
               "A_img_paths": A_path,
               "A_label_cls": np.int32(A_cat if self.with_cls else (A_cls or 0))}
        if B_path is not None and B_mask_path:
            try:
                B, B_mask, B_ref_bbox, B_cat = self.online_crop(
                    B_path, B_mask_path, "B",
                    rotation_state=sample_rotation_state(self.opt))
            except Exception as e:
                print(f"online crop failure {B_path}: {e}")
                return None
            out.update({"B": B, "B_label_mask": B_mask, "B_ref_bbox": B_ref_bbox,
                        "B_img_paths": B_path,
                        "B_label_cls": np.int32(B_cat if self.with_cls else (B_cls or 0))})
        return out


class UnalignedLabeledMaskClsOnlineDataset(UnalignedLabeledMaskOnlineDataset):
    with_cls = True


class SelfSupervisedLabeledMaskOnlineDataset(UnalignedLabeledMaskOnlineDataset):
    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.use_domain_B = False

    def __getitem__(self, index):
        A_path = self.A_img_paths[index % self.A_size]
        A_mask = self.A_mask_paths[index % self.A_size]
        A_cls = self.A_cls[index % self.A_size] if self.A_cls else 0
        out = self.get_img(A_path, A_mask, A_cls)
        if out is None:
            return None
        img, mask = out["A"], out["A_label_mask"]
        if getattr(self.opt, "data_online_creation_rand_mask_A", True):
            noised = fill_mask_with_random(img, mask, -1)
        else:
            # color fill otherwise (reference
            # self_supervised_*_dataset.py:45-53 raises when NEITHER flag is
            # set; defaulting to the color fill keeps default configs
            # trainable instead of failing every sample)
            noised = fill_mask_with_color(img, mask)
        out.update({"A": noised, "B": img, "B_img_paths": out["A_img_paths"],
                    "B_label_mask": mask.copy(), "B_label_cls": out["A_label_cls"],
                    "B_ref_bbox": out.get("A_ref_bbox")})
        return out


class SelfSupervisedLabeledMaskClsOnlineDataset(SelfSupervisedLabeledMaskOnlineDataset):
    with_cls = True


def ref_resize(img, size):
    """PIL image -> (size, size, C) float32 in [-1, 1]: a BICUBIC resize and
    nothing else (reference get_transform_ref; ``datasets.py:653-660``)."""
    from PIL import Image
    r = np.asarray(img.resize((size, size), Image.BICUBIC), np.uint8)
    if r.ndim == 2:
        r = r[:, :, None]
    return r.astype(np.float32) / 127.5 - 1.0


class _RefMixin:
    """A reference image per sample: ``trainA/conditions.txt`` maps the A
    image's path to its reference's, read as ``ref_A`` at
    ``alg_diffusion_ref_size`` px (the crop size when unset or <= 0). A
    sample whose reference cannot be read is skipped."""

    def _init_ref(self):
        self.A_img_ref = make_ref_path(self.dir_A, "/conditions.txt")
        self.ref_size = int(getattr(self.opt, "alg_diffusion_ref_size", -1)
                            or -1)
        if self.ref_size <= 0:
            self.ref_size = self.opt.data_crop_size

    def __getitem__(self, index):
        out = super().__getitem__(index)
        if out is None:
            return None
        try:
            ref_path = self.A_img_ref[out["A_img_paths"]]
            out["ref_A"] = ref_resize(self._load_img(ref_path), self.ref_size)
        except Exception as e:
            print(f"ref load failure {out['A_img_paths']}: {e}")
            return None
        return out


class UnalignedLabeledMaskRefDataset(_RefMixin, UnalignedLabeledMaskDataset):
    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self._init_ref()


class UnalignedLabeledMaskOnlineRefDataset(_RefMixin,
                                           UnalignedLabeledMaskOnlineDataset):
    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self._init_ref()


class SelfSupervisedLabeledMaskRefDataset(_RefMixin,
                                          SelfSupervisedLabeledMaskDataset):
    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self._init_ref()


class SelfSupervisedLabeledMaskOnlineRefDataset(
        _RefMixin, SelfSupervisedLabeledMaskOnlineDataset):
    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self._init_ref()


class AlignedDataset(BaseDataset):
    """Paired A/B by sorted order (reference data/aligned_dataset.py)."""

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.A_img_paths = make_dataset(self.dir_A, opt.data_max_dataset_size)
        self.B_img_paths = make_dataset(self.dir_B, opt.data_max_dataset_size)
        self.A_size = len(self.A_img_paths)
        self.B_size = len(self.B_img_paths)

    def __getitem__(self, index):
        p = self.transform.sample_params()
        A_path = self.A_img_paths[index % self.A_size]
        B_path = self.B_img_paths[index % self.B_size]
        return {
            "A": self.transform.image(self._load_img(A_path), p),
            "B": self.transform.image(self._load_img(B_path), p),
            "A_img_paths": A_path, "B_img_paths": B_path,
        }


class SingleDataset(BaseDataset):
    """Single-domain (reference data/single_dataset.py); B = A."""

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.A_img_paths = make_dataset(self.dir_A, opt.data_max_dataset_size)
        self.A_size = len(self.A_img_paths)

    def __getitem__(self, index):
        p = self.transform.sample_params()
        img = self.transform.image(
            self._load_img(self.A_img_paths[index % self.A_size]), p)
        return {"A": img, "B": img,
                "A_img_paths": self.A_img_paths[index % self.A_size]}
