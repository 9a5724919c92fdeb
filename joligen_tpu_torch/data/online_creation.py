"""Online bbox-crop engine: a copy of ``joligen_tpu/data/online_creation.py``
(numpy and PIL; images load through the port's ``data/transforms.load_image``).

Builds (crop, mask) training samples around annotated objects at load time:
read a bbox .txt (lines ``cat x1 y1 x2 y2``), rasterize every annotated bbox
into the label mask after expanding it by mask_delta (pixels or ratio),
jittering it by mask_random_offset and optionally squaring it, pick one
reference bbox, crop a size-jittered ``crop_dim±crop_delta`` window around it
with ``context_pixels`` margin, resize to ``output_dim`` and emit the
synchronized label mask. Every random draw comes from the ``random`` module
(or the ``rng`` given) in the JAX module's order, so both packages seeded
alike cut the same crop.
"""

from __future__ import annotations

import math
import random

import numpy as np
from PIL import Image

from .transforms import load_image


def rotation_enabled(opt):
    """Pre-crop rotation gate (reference online_creation.py:128-134)."""
    return (
        not getattr(opt, "dataaug_no_rotate", False)
        and bool(getattr(opt, "data_online_creation_rotate_before_crop", False))
        and float(getattr(opt, "data_online_creation_rotate_max_angle", 0.0)) > 0.0
        and "online" in getattr(opt, "data_dataset_mode", "")
    )


def sample_rotation_state(opt, rng=None):
    """One rotation draw per sample (shared across all frames of a clip);
    reference online_creation.py:137-146."""
    if not rotation_enabled(opt):
        return None
    rng = rng or random
    max_angle = float(getattr(opt, "data_online_creation_rotate_max_angle", 0.0))
    return {
        "angle": rng.uniform(-max_angle, max_angle),
        "rebox_mask_after_rotation": bool(
            getattr(opt, "data_online_creation_rotate_rebox_mask_after_rotation",
                    False)
        ),
    }


def _rotate_bboxes_expand(bboxes, width, height, angle):
    """Axis-aligned bounds of each bbox's four corners after rotating the
    image by ``angle`` (PIL CCW) with expand=True. Matches the reference's
    corner math (online_creation.py:149-195): the point transform uses
    -angle because image y points down."""
    a = math.radians(-angle)
    cos_a, sin_a = math.cos(a), math.sin(a)
    cx, cy = width / 2.0, height / 2.0
    # bounds of the rotated image frame (for the expand offset)
    corners = np.array([(0, 0), (width, 0), (width, height), (0, height)],
                       dtype=np.float64) - (cx, cy)
    rot = corners @ np.array([[cos_a, sin_a], [-sin_a, cos_a]])
    min_x, min_y = rot[:, 0].min(), rot[:, 1].min()
    out = np.empty_like(bboxes)
    for i, (x1, y1, x2, y2) in enumerate(bboxes):
        pts = np.array([(x1, y1), (x2, y1), (x2, y2), (x1, y2)],
                       dtype=np.float64) - (cx, cy)
        r = pts @ np.array([[cos_a, sin_a], [-sin_a, cos_a]])
        out[i] = [math.floor(r[:, 0].min() - min_x),
                  math.floor(r[:, 1].min() - min_y),
                  math.ceil(r[:, 0].max() - min_x),
                  math.ceil(r[:, 1].max() - min_y)]
    return out


def read_bbox_file(bbox_path):
    """Lines: 'cat x1 y1 x2 y2' (absolute pixels)."""
    cats, bboxes = [], []
    with open(bbox_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            cats.append(int(float(parts[0])))
            bboxes.append([float(v) for v in parts[1:5]])
    if not bboxes:
        raise ValueError(f"no valid bbox line in {bbox_path}")
    return cats, np.asarray(bboxes, dtype=np.float64)


def _delta_for_cat(mask_delta, cat):
    """mask_delta is a list-per-category of [dx(,dy)] pixel paddings
    (reference common_options: data_online_creation_mask_delta_A)."""
    if not mask_delta:
        return 0.0, 0.0
    entry = mask_delta[min(max(cat - 1, 0), len(mask_delta) - 1)]
    if not entry:
        return 0.0, 0.0
    dx = float(entry[0])
    dy = float(entry[1]) if len(entry) > 1 else dx
    return dx, dy


def _broaden_rect(x1, y1, x2, y2, W, H, rng):
    """Detector-style random rectangle broadening that always contains the
    input bbox (reference online_creation.py:65-111): 20% unchanged, 35%
    per-side expansion up to 0.75×, 25% area scaling up to 4×, 20% aspect
    retargeting in [0.35, 2.85]."""
    w = max(1.0, x2 - x1)
    h = max(1.0, y2 - y1)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    roll = rng.random()
    if roll < 0.20:
        nx1, ny1, nx2, ny2 = x1, y1, x2, y2
    elif roll < 0.55:
        nx1 = x1 - rng.uniform(0.0, 0.75) * w
        nx2 = x2 + rng.uniform(0.0, 0.75) * w
        ny1 = y1 - rng.uniform(0.0, 0.75) * h
        ny2 = y2 + rng.uniform(0.0, 0.75) * h
    elif roll < 0.80:
        s = math.sqrt(rng.uniform(1.0, 4.0))
        nx1, nx2 = cx - w * s / 2.0, cx + w * s / 2.0
        ny1, ny2 = cy - h * s / 2.0, cy + h * s / 2.0
    else:
        target = rng.uniform(0.35, 2.85)
        if target > w / h:
            nw, nh = h * target, h
        else:
            nw, nh = w, w / target
        nx1, nx2 = cx - nw / 2.0, cx + nw / 2.0
        ny1, ny2 = cy - nh / 2.0, cy + nh / 2.0
    nx1 = max(0.0, nx1); ny1 = max(0.0, ny1)
    nx2 = min(float(W), nx2); ny2 = min(float(H), ny2)
    # never shrink below the source bbox
    return min(nx1, x1), min(ny1, y1), max(nx2, x2), max(ny2, y2)


def crop_image(
    img_path,
    bbox_path,
    mask_delta=((),),
    mask_random_offset=(0.0,),
    crop_delta=50,
    mask_square=False,
    crop_dim=512,
    output_dim=256,
    context_pixels=0,
    load_size=(),
    load_size_keep_ratio=False,
    select_cat=-1,
    fixed_mask_size=-1,
    fixed_mask_size_model=-1,
    fixed_mask_min_unmasked_border_model=4,
    inverted_mask=False,
    single_bbox=False,
    bbox_ref_id=-1,
    override_class=-1,
    random_bbox=False,
    min_crop_bbox_ratio=None,
    broaden_rect_aug=False,
    get_crop_coordinates=False,
    crop_coordinates=None,
    crop_center=False,
    mask_delta_ratio=((),),
    rng=None,
    rotation_state=None,
    return_meta=False,
):
    """Returns (crop float32 (D,D,C) in [-1,1], mask int32 (D,D,1),
    ref_bbox [x1,y1,x2,y2] in crop coords, category int) with
    D = output_dim + 2*context_pixels; plus a crop-provenance meta dict
    when ``return_meta`` is set. ``get_crop_coordinates`` instead returns
    the reusable window ``(x0, y0, crop_size)``."""
    rng = rng or random
    img = load_image(img_path)
    src_w, src_h = img.size
    if random_bbox and (bbox_path is None
                        or not str(bbox_path).endswith(".txt")):
        # synthesize one random box in source coordinates (reference
        # online_creation.py:381-391; seeded through ``rng`` here)
        rng = rng or random
        rx1 = rng.randint(0, max(0, src_w - 2))
        ry1 = rng.randint(0, max(0, src_h - 2))
        rx2 = rng.randint(rx1 + 1, max(rx1 + 1, min(rx1 + crop_dim, src_w)))
        ry2 = rng.randint(ry1 + 1, max(ry1 + 1, min(ry1 + crop_dim, src_h)))
        cats = [1]
        bboxes = np.asarray([[rx1, ry1, rx2, ry2]], dtype=np.float64)
    else:
        cats, bboxes = read_bbox_file(bbox_path)

    eff_crop_dim = crop_dim
    eff_crop_delta = crop_delta
    eff_fixed_mask = fixed_mask_size
    eff_mask_delta = [list(m) for m in mask_delta]
    if load_size:
        tw = int(load_size[0])
        th = int(load_size[1]) if len(load_size) > 1 else tw
        if load_size_keep_ratio:
            # aspect-preserving: the largest load_size side becomes the
            # largest image side; every pixel-space parameter scales with
            # it (reference online_creation.py:308-336)
            scale = max(tw, th) / float(max(src_w, src_h))
            tw = max(1, int(round(src_w * scale)))
            th = max(1, int(round(src_h * scale)))
            eff_crop_dim = max(1, int(round(crop_dim * scale)))
            eff_crop_delta = max(0, int(round(crop_delta * scale)))
            if fixed_mask_size > 0:
                eff_fixed_mask = max(1, int(round(fixed_mask_size * scale)))
            eff_mask_delta = [[v * scale for v in m] for m in eff_mask_delta]
        sx, sy = tw / img.size[0], th / img.size[1]
        img = img.resize((tw, th), Image.BICUBIC)
        bboxes = bboxes * np.array([sx, sy, sx, sy])

    # ---- optional pre-crop rotation with bbox reboxing (reference
    # online_creation.py:616-723): rotate the full frame with expand=True,
    # rebox every bbox to the axis-aligned bounds of its rotated corners,
    # and reject crop windows that would include expand-fill pixels.
    valid_arr = None
    angle = float(rotation_state.get("angle", 0.0)) if rotation_state else 0.0
    if abs(angle) > 1e-6:
        rot_w, rot_h = img.size
        fill = 0 if img.mode == "L" else tuple([0] * len(img.getbands()))
        img = img.rotate(angle, Image.BICUBIC, expand=True, fillcolor=fill)
        valid = Image.new("L", (rot_w, rot_h), 255).rotate(
            angle, Image.NEAREST, expand=True, fillcolor=0)
        valid_arr = np.asarray(valid, dtype=np.uint8) > 0
        bboxes = _rotate_bboxes_expand(bboxes, rot_w, rot_h, angle)
        if not rotation_state.get("rebox_mask_after_rotation", False):
            bboxes = bboxes + np.array([-2.0, -2.0, 2.0, 2.0])  # bbox_pad
        bboxes = np.clip(
            bboxes,
            0,
            np.array([img.size[0], img.size[1], img.size[0], img.size[1]],
                     dtype=np.float64))

    W, H = img.size

    # ---- bbox selection: category filter, then optional restriction to a
    # single (random or caller-chosen) bbox
    idx_all = list(range(len(cats)))
    if select_cat != -1:
        idx_all = [i for i in idx_all if cats[i] == select_cat]
        if not idx_all:
            raise ValueError(f"no bbox of category {select_cat} in {bbox_path}")
    if single_bbox and bbox_ref_id == -1:
        bbox_ref_id = rng.randrange(len(idx_all))
    if bbox_ref_id >= 0:
        if bbox_ref_id >= len(idx_all):
            raise ValueError(
                f"bbox_ref_id {bbox_ref_id} out of range for {bbox_path}")
        idx_all = [idx_all[bbox_ref_id]]

    # ---- per-bbox mask geometry: broaden aug, delta expansion, random
    # offset, squaring, fixed source-space size (reference loop
    # online_creation.py:448-614); every surviving bbox lands in the mask
    processed = []
    for i in idx_all:
        cat_i = cats[i] if override_class == -1 else override_class
        x1, y1, x2, y2 = bboxes[i]
        ox1, oy1, ox2, oy2 = x1, y1, x2, y2
        if broaden_rect_aug:
            x1, y1, x2, y2 = _broaden_rect(x1, y1, x2, y2, W, H, rng)
        dx, dy = _delta_for_cat(eff_mask_delta, cats[i])
        rdx, rdy = _delta_for_cat([list(m) for m in mask_delta_ratio], cats[i]) \
            if any(len(m) for m in mask_delta_ratio) else (0.0, 0.0)
        if rdx or rdy:
            dx += rdx * (x2 - x1)
            dy += rdy * (y2 - y1)
        x1, x2 = x1 - dx, x2 + dx
        y1, y2 = y1 - dy, y2 + dy

        off = list(mask_random_offset) or [0.0]
        ox = float(off[0]); oy = float(off[1]) if len(off) > 1 else ox
        if ox > 0:
            jit = (rng.random() * 2 - 1) * ox * (x2 - x1)
            x1, x2 = x1 + jit, x2 + jit
        if oy > 0:
            jit = (rng.random() * 2 - 1) * oy * (y2 - y1)
            y1, y2 = y1 + jit, y2 + jit

        if mask_square:
            side = max(x2 - x1, y2 - y1)
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            x1, x2 = cx - side / 2, cx + side / 2
            y1, y2 = cy - side / 2, cy + side / 2

        if eff_fixed_mask > 0:
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            x1, x2 = cx - eff_fixed_mask / 2, cx + eff_fixed_mask / 2
            y1, y2 = cy - eff_fixed_mask / 2, cy + eff_fixed_mask / 2

        x1 = max(0.0, x1); y1 = max(0.0, y1)
        x2 = min(float(W), x2); y2 = min(float(H), y2)
        processed.append({
            "index": i, "cat": int(cat_i),
            "xmin": x1, "ymin": y1, "xmax": x2, "ymax": y2,
            "original_xmin": float(ox1), "original_ymin": float(oy1),
            "original_xmax": float(ox2), "original_ymax": float(oy2),
        })

    ref_i = 0 if len(processed) == 1 else rng.randrange(len(processed))
    ref = processed[ref_i]
    x1, y1, x2, y2 = ref["xmin"], ref["ymin"], ref["xmax"], ref["ymax"]
    cat = ref["cat"]

    # ---- crop window around the reference mask: size jittered in
    # [crop_dim-delta, crop_dim+delta], floored so the (expanded) ref bbox
    # plus context always fits (reference online_creation.py:1043-1108)
    bw, bh = x2 - x1, y2 - y1
    out_total = output_dim + 2 * context_pixels
    required = max(bw + 2 * context_pixels, bh + 2 * context_pixels, 1.0)
    if min_crop_bbox_ratio:
        required = max(required, round(max(bw, bh) * float(min_crop_bbox_ratio)))
    if fixed_mask_size_model <= 0 and fixed_mask_min_unmasked_border_model > 0:
        # leave at least `border` unmasked model pixels around the ref mask
        # by enlarging the source crop (reference online_creation.py:1084-1097)
        max_mask_out = out_total - 2 * int(fixed_mask_min_unmasked_border_model)
        if max_mask_out < 1:
            raise ValueError(
                f"model mask border {fixed_mask_min_unmasked_border_model} "
                f"is too large for output size {out_total}")
        required = max(required,
                       math.ceil(max(bw, bh) * out_total / max_mask_out))
    crop_min = int(max(required, eff_crop_dim - eff_crop_delta))
    crop_max = int(max(eff_crop_dim + eff_crop_delta, crop_min))
    if crop_coordinates is not None and len(crop_coordinates) >= 3:
        eff_crop = int(crop_coordinates[2])
    elif crop_min >= crop_max or eff_crop_delta <= 0:
        eff_crop = crop_min
    else:
        eff_crop = rng.randint(crop_min, crop_max)
    # our host pipeline clips instead of zero-padding undersized frames
    eff_crop = max(1, min(eff_crop, min(W, H)))

    def _window_valid(wx0, wy0, eff):
        """No expand-fill pixels inside the crop+context window (reference
        online_creation.py:730-746 validate_crop_has_valid_source)."""
        if valid_arr is None:
            return True
        vx0, vy0 = wx0 - context_pixels, wy0 - context_pixels
        vx1, vy1 = wx0 + eff + context_pixels, wy0 + eff + context_pixels
        if vx0 < 0 or vy0 < 0 or vx1 > W or vy1 > H:
            return False
        region = valid_arr[vy0:vy1, vx0:vx1]
        return region.size > 0 and bool(np.all(region))

    def _sample_window(jitter, eff):
        cx_center = (x1 + x2) / 2
        cy_center = (y1 + y2) / 2
        wx0 = cx_center - eff / 2
        wy0 = cy_center - eff / 2
        if jitter and not crop_center and eff_crop_delta > 0:
            # eff_crop_delta: scaled with load_size_keep_ratio like every
            # other pixel-space parameter
            wx0 += rng.randint(-eff_crop_delta, eff_crop_delta)
            wy0 += rng.randint(-eff_crop_delta, eff_crop_delta)
        wx0 = int(np.clip(wx0, 0, W - eff))
        wy0 = int(np.clip(wy0, 0, H - eff))
        # keep the ref bbox inside the crop
        wx0 = int(np.clip(wx0, x2 + context_pixels - eff, x1 - context_pixels))
        wy0 = int(np.clip(wy0, y2 + context_pixels - eff, y1 - context_pixels))
        wx0 = int(np.clip(wx0, 0, W - eff))
        wy0 = int(np.clip(wy0, 0, H - eff))
        return wx0, wy0

    def _pick_window(eff):
        """10 jittered draws, then centered; None if every window hits
        rotation fill pixels."""
        for _ in range(10):
            wx0, wy0 = _sample_window(True, eff)
            if _window_valid(wx0, wy0, eff):
                return wx0, wy0
        wx0, wy0 = _sample_window(False, eff)
        if _window_valid(wx0, wy0, eff):
            return wx0, wy0
        return None

    if crop_coordinates is not None:
        cx0, cy0 = int(crop_coordinates[0]), int(crop_coordinates[1])
    else:
        win = _pick_window(eff_crop)
        if win is None:
            # a jittered-up crop size can exceed the valid (non-fill) area
            # of a rotated frame; retry at the smallest admissible size
            # before rejecting the sample (the reference rejects outright)
            small = max(1, min(crop_min, min(W, H)))
            if small != eff_crop:
                win = _pick_window(small)
                if win is not None:
                    eff_crop = small
        if win is None:
            # reference raises here too; dataset catches -> sample skipped
            raise ValueError(
                f"rotated crop contains fill pixels for {img_path}")
        cx0, cy0 = win

    if get_crop_coordinates:
        return (cx0, cy0, eff_crop)

    crop = img.crop((cx0, cy0, cx0 + eff_crop, cy0 + eff_crop))

    # ---- mask in crop coordinates: every processed bbox is rasterized
    # with its own category (reference online_creation.py:429-431,551-560)
    mask = np.zeros((eff_crop, eff_crop), dtype=np.int32)
    for pb in processed:
        px1 = int(np.clip(pb["xmin"] - cx0, 0, eff_crop))
        py1 = int(np.clip(pb["ymin"] - cy0, 0, eff_crop))
        px2 = int(np.clip(pb["xmax"] - cx0, 0, eff_crop))
        py2 = int(np.clip(pb["ymax"] - cy0, 0, eff_crop))
        mask[py1:py2, px1:px2] = pb["cat"]
    mx1 = int(np.clip(x1 - cx0, 0, eff_crop))
    my1 = int(np.clip(y1 - cy0, 0, eff_crop))
    mx2 = int(np.clip(x2 - cx0, 0, eff_crop))
    my2 = int(np.clip(y2 - cy0, 0, eff_crop))

    # ---- resize to model size
    scale = out_total / eff_crop
    crop = crop.resize((out_total, out_total), Image.BICUBIC)
    if fixed_mask_size_model > 0:
        # output-space fixed square masks, positioned to keep at least
        # `border` unmasked model pixels (reference online_creation.py:1253-1283)
        border = int(fixed_mask_min_unmasked_border_model)
        max_side = out_total - 2 * border
        if max_side < 1:
            raise ValueError(
                f"fixed model mask border {border} is too large for "
                f"output size {out_total}")
        if fixed_mask_size_model > out_total:
            raise ValueError(
                f"fixed model mask size {fixed_mask_size_model} is larger "
                f"than output size {out_total}")
        mask = np.zeros((out_total, out_total), dtype=np.int32)
        ref_square = None
        for pi_, pb in enumerate(processed):
            bx1 = int(round(np.clip(pb["xmin"] - cx0, 0, eff_crop) * scale))
            by1 = int(round(np.clip(pb["ymin"] - cy0, 0, eff_crop) * scale))
            bx2 = int(round(np.clip(pb["xmax"] - cx0, 0, eff_crop) * scale))
            by2 = int(round(np.clip(pb["ymax"] - cy0, 0, eff_crop) * scale))
            side = max(bx2 - bx1, by2 - by1, fixed_mask_size_model)
            side = min(side, max_side)
            ccx = (bx1 + bx2) / 2.0
            ccy = (by1 + by2) / 2.0
            bx1 = int(round(ccx - side / 2.0))
            by1 = int(round(ccy - side / 2.0))
            bx1 = min(max(bx1, border), out_total - border - side)
            by1 = min(max(by1, border), out_total - border - side)
            mask[by1:by1 + side, bx1:bx1 + side] = pb["cat"]
            if pi_ == ref_i:
                # the returned ref_bbox must track the square actually
                # painted (reference apply_fixed_model_mask updates
                # x_min_ref et al.)
                ref_square = (bx1, by1, bx1 + side, by1 + side)
        if inverted_mask:
            mask = np.where(mask > 0, 0, 1).astype(np.int32)
        mask = mask[:, :, None]
    else:
        if inverted_mask:
            mask = np.where(mask > 0, 0, 1).astype(np.int32)
        mask_img = Image.fromarray(mask.astype(np.uint8))
        mask_img = mask_img.resize((out_total, out_total), Image.NEAREST)
        mask = np.asarray(mask_img, dtype=np.int32)[:, :, None]

    arr = np.asarray(crop, dtype=np.float32) / 127.5 - 1.0
    if arr.ndim == 2:
        arr = arr[:, :, None]

    if fixed_mask_size_model > 0 and ref_square is not None:
        ref_bbox = np.asarray(ref_square, dtype=np.float32)
    else:
        ref_bbox = np.asarray(
            [mx1 * scale, my1 * scale, mx2 * scale, my2 * scale],
            dtype=np.float32)
    if return_meta:
        meta = {
            "orig_width": int(src_w), "orig_height": int(src_h),
            "loaded_width": int(W), "loaded_height": int(H),
            "x_crop": int(cx0), "y_crop": int(cy0),
            "crop_size": int(eff_crop),
            "context_pixels": int(context_pixels),
            "mask_broaden_rect_aug": bool(broaden_rect_aug),
            "processed_bboxes": [dict(pb) for pb in processed],
        }
        if rotation_state is not None:
            meta["rotation"] = dict(rotation_state)
        return arr, mask, ref_bbox, int(cat), meta
    return arr, mask, ref_bbox, int(cat)


def sanitize_paths(img_paths, bbox_paths, root=None, max_check=None, verbose=False):
    """Drop samples whose image/bbox files are unreadable
    (reference online_creation.py:1405-1488)."""
    import os
    good_imgs, good_bboxes = [], []
    for i, (ip, bp) in enumerate(zip(img_paths, bbox_paths)):
        if max_check is not None and i >= max_check:
            good_imgs.extend(img_paths[i:])
            good_bboxes.extend(bbox_paths[i:])
            break
        rip = os.path.join(root, ip) if root else ip
        rbp = os.path.join(root, bp) if root else bp
        try:
            with Image.open(rip) as im:
                im.verify()
            read_bbox_file(rbp)
        except Exception as e:
            if verbose:
                print(f"sanitize: dropping {ip}: {e}")
            continue
        good_imgs.append(ip)
        good_bboxes.append(bp)
    return good_imgs, good_bboxes
