"""Dataset modes (host-side sample producers), copied from
``joligen_tpu/data/datasets.py``: the labeled-mask modes (``:31-227``), the
online bbox-crop modes (``:229-357``), the unaligned mode (``:74-97``), the
four ref modes (``:361-470``: a reference image per sample from
``trainA/conditions.txt``, as ``ref_A``), the aligned and single modes
(``:663-698``), the nuplet mode (``:515-558``: N consecutive frames of
each domain, (N, H, W, C)) and the online video modes (``:705-965``:
clips of ``data_temporal_number_frames`` frames, (F, H, W, C), every frame
cropped with frame 0's window and one rotation draw).

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
from .temporal_sampling import (TemporalFrameStepMixin,
                                build_temporal_series_index,
                                select_temporal_window)
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


class UnalignedLabeledClsDataset(UnalignedLabeledMaskDataset):
    """Class labels without masks (``datasets.py:183-186``): ``paths.txt``
    lines 'img cls'; items carry ``A_label_cls``/``B_label_cls`` and no
    label mask."""
    with_cls = True
    with_mask = False


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


class NupletUnalignedLabeledMaskDataset(UnalignedLabeledMaskDataset):
    """``alg_re_nuplet_size`` consecutive frames of each domain, for ReCUT's
    and ReCycleGAN's frame predictor (``datasets.py:515-558``): A's frames
    from ``index`` on, wrapping at ``A_size``, under one transform draw; B's
    from ``random.randint(0, max(0, B_size - n))`` on, under a draw of its
    own. ``A`` and ``B`` are (N, H, W, C), the label masks (N, H, W, 1)
    where the paths have them."""

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.nuplet = int(getattr(opt, "alg_re_nuplet_size", 3) or 3)

    def _frames(self, start, size, img_paths, mask_paths):
        p = self.transform.sample_params()
        frames, masks = [], []
        for i in range(self.nuplet):
            j = (start + i) % size
            frames.append(self.transform.image(
                self._load_img(img_paths[j]), p))
            if mask_paths and mask_paths[j]:
                masks.append(self.transform.mask(
                    load_mask(self._resolve(mask_paths[j])), p))
        return np.stack(frames), (np.stack(masks) if masks else None)

    def __getitem__(self, index):
        frames, masks = self._frames(index, self.A_size, self.A_img_paths,
                                     self.A_mask_paths)
        out = {"A": frames,
               "A_img_paths": self.A_img_paths[index % self.A_size]}
        if masks is not None:
            out["A_label_mask"] = masks
        if self.B_size:
            j0 = random.randint(0, max(0, self.B_size - self.nuplet))
            frames, masks = self._frames(j0, self.B_size, self.B_img_paths,
                                         self.B_mask_paths)
            out["B"] = frames
            if masks is not None:
                out["B_label_mask"] = masks
        return out


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


def _natural_key(text):
    import re
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


class TemporalLabeledMaskOnlineDataset(BaseDataset, TemporalFrameStepMixin):
    """Video frames with online bbox crops (``datasets.py:705-903``): a
    sample is ``data_temporal_number_frames`` frames ``frame_step`` apart
    (a random step up to ``data_temporal_frame_step_random_max``), from one
    series directory, all cropped with frame 0's window and one rotation
    draw. ``A``/``B`` (F, H, W, C), masks (F, H, W, 1). With
    ``data_temporal_num_common_char`` the frames' names must share that
    many first characters. With the b2b global context
    (``alg_b2b_global_context_mode`` not none) each frame also gives its
    context image (``_global_context_image``), ``A_global_context`` /
    ``B_global_context`` (F, s, s, 3)."""

    crop_center = False

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.A_img_paths, self.A_mask_paths = make_labeled_path_dataset(
            self.dir_A, "/paths.txt")
        self.A_img_paths.sort(key=_natural_key)
        self.A_mask_paths.sort(key=_natural_key)
        if self.use_domain_B and os.path.isdir(self.dir_B):
            self.B_img_paths, self.B_mask_paths = make_labeled_path_dataset(
                self.dir_B, "/paths.txt")
            self.B_img_paths.sort(key=_natural_key)
            self.B_mask_paths.sort(key=_natural_key)
        else:
            self.B_img_paths, self.B_mask_paths = [], []
        mx = opt.data_max_dataset_size
        if mx and mx > 0:
            self.A_img_paths = self.A_img_paths[:mx]
            self.A_mask_paths = self.A_mask_paths[:mx]
            self.B_img_paths = self.B_img_paths[:mx]
            self.B_mask_paths = self.B_mask_paths[:mx]
        self.A_size = len(self.A_img_paths)
        self.B_size = len(self.B_img_paths)
        self._init_temporal_frame_step_sampling(opt)
        self.num_common_char = int(
            getattr(opt, "data_temporal_num_common_char", -1) or -1)

    def __len__(self):
        return max(self.A_size, self.B_size) if self.B_size else self.A_size

    def _common_char_ok(self, paths, indices):
        if self.num_common_char == -1:
            return True
        ref = os.path.basename(paths[indices[0]])[: self.num_common_char]
        return all(os.path.basename(paths[i])[: self.num_common_char] == ref
                   for i in indices)

    def _pick_window_cached(self, img_paths, step):
        """The global indices of one window's frames (the series index is
        built once per path list and step), or None."""
        cache = getattr(self, "_window_cache", None)
        if cache is None:
            cache = self._window_cache = {}
        key = (id(img_paths), step)
        if key not in cache:
            cache[key] = build_temporal_series_index(
                img_paths, self.num_frames, step)
        sel = select_temporal_window(cache[key])
        if sel is None:
            return None
        series_idx, start = sel
        return [series_idx[start + i * step] for i in range(self.num_frames)]

    def _load_clip(self, img_paths, mask_paths, domain):
        """Pick a window, crop every frame with frame 0's window. Returns
        (frames (F,H,W,C), masks (F,H,W,1), ref_bbox, cat, step, the
        global-context images (F,s,s,3) or None) or None."""
        step = self._sample_temporal_frame_step()
        indices = self._pick_window_cached(img_paths, step)
        if indices is None or not self._common_char_ok(img_paths, indices):
            return None
        frames, masks = [], []
        crop_coords = None
        ref_bbox, cat = None, 0
        # centred crops jitter the crop size, once a clip
        # (datasets.py:777-787)
        crop_dim = None
        if self.crop_center:
            base = getattr(self.opt,
                           f"data_online_creation_crop_size_{domain}", 512)
            delta = getattr(self.opt,
                            f"data_online_creation_crop_delta_{domain}", 0)
            crop_dim = random.randint(base - delta, base + delta) \
                if delta > 0 else base
        gc_mode = getattr(self.opt, "alg_b2b_global_context_mode",
                          "none") or "none"
        gc_size = int(getattr(self.opt, "alg_b2b_global_context_size", 128)
                      or 128)
        contexts = []
        # one rotation draw for every frame of the clip
        rotation_state = sample_rotation_state(self.opt)
        for i, gi in enumerate(indices):
            try:
                if i == 0:
                    crop_coords = self._online_crop_kwargs(
                        img_paths[gi], mask_paths[gi], domain,
                        crop_dim_override=crop_dim,
                        get_crop_coordinates=True,
                        rotation_state=rotation_state)
                out = self._online_crop_kwargs(
                    img_paths[gi], mask_paths[gi], domain,
                    crop_dim_override=crop_dim,
                    crop_coordinates=crop_coords,
                    rotation_state=rotation_state)
                if gc_mode != "none":
                    contexts.append(self._global_context_image(
                        img_paths[gi], crop_coords, crop_dim, domain,
                        gc_size))
            except Exception as e:  # an unreadable frame skips the clip
                print(f"temporal crop failure frame {i} {img_paths[gi]}: {e}")
                return None
            img, mask, bbox, c = out
            if i == 0:
                ref_bbox, cat = bbox, c
            frames.append(img)
            masks.append(self._post_mask(mask))
        gc = np.stack(contexts) if contexts else None
        return np.stack(frames), np.stack(masks), ref_bbox, cat, step, gc

    def _global_context_image(self, img_path, crop_coords, crop_dim, domain,
                              gc_size):
        """The whole frame with frame 0's crop window blacked out, PIL
        bicubic to ``gc_size``², in [-1, 1] (``datasets.py:835-852``)."""
        from PIL import Image
        arr = np.asarray(self._load_img(img_path), np.uint8).copy()
        cx0, cy0 = crop_coords[0], crop_coords[1]
        cd = crop_coords[2] if len(crop_coords) >= 3 else crop_dim or getattr(
            self.opt, f"data_online_creation_crop_size_{domain}", 512)
        cd = min(cd, arr.shape[0], arr.shape[1])
        arr[cy0:cy0 + cd, cx0:cx0 + cd] = 0
        small = np.asarray(Image.fromarray(arr).resize(
            (gc_size, gc_size), Image.BICUBIC), np.uint8)
        return small.astype(np.float32) / 127.5 - 1.0

    def _online_crop_kwargs(self, img_path, bbox_path, domain,
                            crop_dim_override=None, **extra):
        opt = self.opt
        return crop_image(
            self._resolve(img_path),
            self._resolve(bbox_path),
            mask_delta=getattr(opt, f"data_online_creation_mask_delta_{domain}",
                               [[]]),
            mask_random_offset=getattr(
                opt, f"data_online_creation_mask_random_offset_{domain}",
                [0.0]),
            crop_delta=(0 if self.crop_center else getattr(
                opt, f"data_online_creation_crop_delta_{domain}", 50)),
            mask_square=getattr(
                opt, f"data_online_creation_mask_square_{domain}", False),
            crop_dim=(crop_dim_override if crop_dim_override is not None
                      else getattr(
                          opt, f"data_online_creation_crop_size_{domain}",
                          512)),
            output_dim=opt.data_crop_size,
            context_pixels=getattr(opt, "data_online_context_pixels", 0),
            load_size=getattr(
                opt, f"data_online_creation_load_size_{domain}", []),
            load_size_keep_ratio=getattr(
                opt, f"data_online_creation_load_size_keep_ratio_{domain}",
                False),
            fixed_mask_size=getattr(opt, "data_online_fixed_mask_size", -1),
            fixed_mask_size_model=getattr(
                opt, f"data_online_creation_mask_fixed_size_{domain}", -1),
            fixed_mask_min_unmasked_border_model=getattr(
                opt, f"data_online_creation_mask_min_unmasked_border_{domain}",
                4),
            inverted_mask=getattr(opt, "data_inverted_mask", False),
            broaden_rect_aug=getattr(
                opt, f"data_online_creation_mask_broaden_rect_aug_{domain}",
                False),
            crop_center=self.crop_center,
            **extra,
        )

    def _post_mask(self, mask):
        if getattr(self.opt, "f_s_all_classes_as_one", False):
            return (np.asarray(mask) > 0).astype(np.int32)
        return mask

    def __getitem__(self, index):
        a = self._load_clip(self.A_img_paths, self.A_mask_paths, "A")
        if a is None:
            return None
        A, A_masks, A_ref_bbox, A_cat, step, A_gc = a
        out = {
            "A": A, "A_label_mask": A_masks,
            "A_ref": A[0], "A_ref_label_mask": A_masks[0],
            "A_ref_bbox": A_ref_bbox, "A_label_cls": np.int32(A_cat),
            "A_img_paths": self.A_img_paths[0],
            "temporal_frame_step": np.int32(step),
        }
        if A_gc is not None:
            out["A_global_context"] = A_gc
        if self.B_size:
            b = self._load_clip(self.B_img_paths, self.B_mask_paths, "B")
            if b is None:
                return None
            B, B_masks, B_ref_bbox, B_cat, _, B_gc = b
            out.update({"B": B, "B_label_mask": B_masks,
                        "B_ref": B[0], "B_ref_label_mask": B_masks[0],
                        "B_ref_bbox": B_ref_bbox,
                        "B_label_cls": np.int32(B_cat),
                        "B_img_paths": self.B_img_paths[0]})
            if B_gc is not None:
                out["B_global_context"] = B_gc
        return out


class SelfSupervisedVidMaskOnlineDataset(TemporalLabeledMaskOnlineDataset):
    """Single-domain video for diffusion inpainting (``datasets.py:
    906-951``): B the clip, A the clip with its masked region filled with
    noise (``data_online_creation_rand_mask_A``) or a colour; centred crops
    (the crop delta jitters the crop size, not the offset)."""

    crop_center = True
    with_cls = False

    def __init__(self, opt, phase, name=""):
        super().__init__(opt, phase, name)
        self.use_domain_B = False
        self.B_img_paths, self.B_mask_paths, self.B_size = [], [], 0

    def __getitem__(self, index):
        a = self._load_clip(self.A_img_paths, self.A_mask_paths, "A")
        if a is None:
            return None
        frames, masks, ref_bbox, cat, step, gc = a
        if getattr(self.opt, "data_online_creation_rand_mask_A", True):
            noised = np.stack([fill_mask_with_random(f, m, -1)
                               for f, m in zip(frames, masks)])
        else:
            noised = np.stack([fill_mask_with_color(f, m)
                               for f, m in zip(frames, masks)])
        cls = np.int32(cat if self.with_cls else 0)
        out = {
            "A": noised, "A_label_mask": masks,
            "A_ref": noised[0], "A_ref_label_mask": masks[0],
            "A_ref_bbox": ref_bbox, "A_label_cls": cls,
            "A_img_paths": self.A_img_paths[0],
            "B": frames, "B_label_mask": masks.copy(),
            "B_ref": frames[0], "B_ref_label_mask": masks[0],
            "B_ref_bbox": ref_bbox, "B_label_cls": cls,
            "B_img_paths": self.A_img_paths[0],
            "temporal_frame_step": np.int32(step),
        }
        if gc is not None:
            out["A_global_context"] = gc
            out["B_global_context"] = gc
        return out


class SelfSupervisedVidLabeledMaskClsOnlineDataset(
        SelfSupervisedVidMaskOnlineDataset):
    with_cls = True
