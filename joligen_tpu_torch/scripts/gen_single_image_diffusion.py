"""Diffusion single-image inference on the port
(``scripts/gen_single_image_diffusion.py``).

    python -m joligen_tpu_torch.scripts.gen_single_image_diffusion \\
        --model_in_file ckpt/latest_net_G_A.pth --img_in img.png \\
        --bbox_in img.txt --dir_out out --sampling_method ddim --seed 0

Same CLI and outputs as the JAX script: ``<name>_orig.png``,
``<name>_cond.png``, ``<name>_generated.png``, ``<name>_generated_crop.png``,
``<name>_y_t.png``, ``<name>_mask.png``, and with ``--bbox_in``
``<name>_orig_bbox.json`` (the crop window in full-image coordinates).

- ``--bbox_in``: the crop around a box of the file, cut as training cuts it
  (``data/online_creation.crop_image`` centred, with its meta giving the
  window); otherwise the whole image resized to the crop size, with
  ``--mask_in`` (or everything) as the mask.
- Conditioning: ``y_t`` (the masked region filled with noise), the canny
  sketch (``--alg_diffusion_sketch_canny_thresholds``), ``low_res``
  (``--alg_diffusion_super_resolution_downsample``: PIL bicubic down by the
  scale and back up) and ``pix2pix`` (the crop itself).
- The generated crop is resized back into the window of the full image.
- Model types palette (DDPM/DDIM), cm and cm_gan (the 5-sigma consistency
  sampler) and sc (Euler, ``--sampling_steps`` or
  ``--alg_sc_denoise_inferstep`` steps).
- ``--ref_in``: the reference image of a ref-conditioned palette model,
  read as RGB, PIL BICUBIC-resized to the crop and mapped to [-1, 1]
  (the JAX script's ``:224-231``).

``--cond_in`` (exemplar insertion) raises.
Runs on CUDA unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np

from ..data.online_creation import crop_image
from ..data.transforms import fill_mask_with_random
from ..models.palette_model import EDGE_MODES, check_cond_creation
from ..utils.mask_generation import random_edge_mask
from .common import load_image_rgb, load_model_from_file, save_image_rgb, \
    to_m1p1, to_uint8


def build_inputs(args, opt):
    """Returns (full_img_uint8, crop [-1,1], mask (H,W,1) int32,
    bbox_select [x1,y1,x2,y2] in full-image coords)."""
    from PIL import Image

    img = load_image_rgb(args.img_in)
    H, W = img.shape[:2]
    size = opt.data_crop_size

    if args.bbox_in:
        crop, mask, _, _, meta = crop_image(
            args.img_in, args.bbox_in,
            mask_delta=[args.mask_delta] if args.mask_delta else
            getattr(opt, "data_online_creation_mask_delta_A", [[]]),
            crop_delta=0, crop_center=True,
            mask_square=getattr(opt, "data_online_creation_mask_square_A",
                                False),
            crop_dim=(args.crop_width or
                      getattr(opt, "data_online_creation_crop_size_A", 512)),
            output_dim=size,
            context_pixels=getattr(opt, "data_online_context_pixels", 0),
            bbox_ref_id=args.bbox_ref_id,
            min_crop_bbox_ratio=args.min_crop_bbox_ratio or None,
            return_meta=True,
        )
        # the crop window the call used, in full-image coordinates
        cx, cy, cdim = meta["x_crop"], meta["y_crop"], meta["crop_size"]
        return img, crop, mask, [cx, cy, cx + cdim, cy + cdim]

    pil = Image.fromarray(img).resize((size, size), Image.BICUBIC)
    crop = to_m1p1(np.asarray(pil, np.uint8))
    if args.mask_in:
        m = Image.open(args.mask_in).convert("L").resize((size, size),
                                                         Image.NEAREST)
        mask = (np.asarray(m) > 0).astype(np.int32)[:, :, None]
    else:
        mask = np.ones((size, size, 1), np.int32)
    return img, crop, mask, [0, 0, W, H]


def _check_supported(args, opt):
    cond_creation = (args.alg_diffusion_cond_image_creation or
                     getattr(opt, "alg_diffusion_cond_image_creation", "y_t")
                     or "y_t")
    check_cond_creation(opt, cond_creation)
    if args.cond_in:
        raise NotImplementedError(
            "--cond_in exemplar insertion needs a perspective warp "
            "(ROADMAP Queue 1 item 7, entry points, the rest)")
    if opt.model_type not in ("palette", "cm", "cm_gan", "sc"):
        raise NotImplementedError(
            f"model type {opt.model_type} (ROADMAP Queue 1 items 9 to 13, "
            "the model families after the main path)")
    return cond_creation


def build_cond(args, opt, cond_creation, crop, mask):
    """The conditioning image of the request (reference
    scripts/gen_single_image_diffusion.py:127-166)."""
    if cond_creation in EDGE_MODES:
        fns = ((getattr(opt, "alg_diffusion_cond_computed_sketch_list", None)
                or ["canny"]) if cond_creation == "computed_sketch"
               else [cond_creation])
        kw = {}
        thr = args.alg_diffusion_sketch_canny_thresholds
        if thr and len(thr) == 2 and fns == ["canny"]:
            kw = dict(low_threshold=int(thr[0]), high_threshold=int(thr[1]))
        return random_edge_mask(fns, crop, mask, opt=opt, **kw)
    if cond_creation == "low_res":
        from PIL import Image
        cond = crop
        if args.alg_diffusion_super_resolution_downsample:
            size = crop.shape[0]
            scale = float(getattr(
                opt, "alg_diffusion_super_resolution_scale", 2.0) or 2.0)
            low = max(1, int(size / scale))
            u8 = ((cond + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
            u8 = np.asarray(Image.fromarray(u8).resize((low, low),
                                                       Image.BICUBIC))
            u8 = np.asarray(Image.fromarray(u8).resize((size, size),
                                                       Image.BICUBIC))
            cond = u8.astype(np.float32) / 127.5 - 1.0
        return cond
    if cond_creation == "pix2pix":
        return crop
    return fill_mask_with_random(crop, mask, -1)     # y_t


def load_ref(path, size):
    """The ``--ref_in`` image: RGB, BICUBIC to ``size``², in [-1, 1]."""
    from PIL import Image
    ref = np.asarray(Image.fromarray(load_image_rgb(path)).resize(
        (size, size), Image.BICUBIC), np.uint8)
    return to_m1p1(ref)


def _inference_kwargs(args, opt):
    """The sampler's arguments by model type (reference
    scripts/gen_single_image_diffusion.py:233-244): palette's method, steps
    and guidance; sc's step count (``--sampling_steps``, else
    ``--alg_sc_denoise_inferstep``, else the model's); none for cm."""
    kwargs = {}
    if opt.model_type == "palette":
        if args.sampling_method:
            kwargs["sampling_method"] = args.sampling_method
        if args.sampling_steps > 0:
            kwargs["num_steps"] = args.sampling_steps
        if args.alg_diffusion_guidance_scale > 0:
            kwargs["guidance_scale"] = args.alg_diffusion_guidance_scale
    elif opt.model_type == "sc":
        steps = (args.sampling_steps if args.sampling_steps > 0
                 else args.alg_sc_denoise_inferstep)
        if steps > 0:
            kwargs["denoise_timesteps"] = steps
    return kwargs


def inference(args, lmodel=None, lopt=None):
    """Run one generation; ``lmodel``/``lopt`` reuse a loaded model across
    calls. Returns (full_frame_uint8, model, opt)."""
    if lmodel is not None:
        model, opt = lmodel, lopt
    else:
        model, opt = load_model_from_file(args.model_in_file, cpu=args.cpu)
    cond_creation = _check_supported(args, opt)
    if args.seed >= 0:
        random.seed(args.seed)
        np.random.seed(args.seed)
        model.generator.manual_seed(args.seed)

    img, crop, mask, bbox_select = build_inputs(args, opt)
    cond = build_cond(args, opt, cond_creation, crop, mask)
    ref = load_ref(args.ref_in, crop.shape[0]) if args.ref_in else None

    outs = []
    for _ in range(max(1, args.nb_samples)):
        batch = {"A": cond[None], "B": crop[None],
                 "B_label_mask": mask[None]}
        if ref is not None:
            batch["ref_A"] = ref[None]
        fake = model.inference(batch, **_inference_kwargs(args, opt))
        outs.append(fake[0])

    name = args.name or os.path.splitext(os.path.basename(args.img_in))[0]
    os.makedirs(args.dir_out, exist_ok=True)
    from PIL import Image
    last_full = img
    for it, out in enumerate(outs):
        suffix = f"_{it}" if len(outs) > 1 else ""
        out_u8 = to_uint8(out)
        # paste the generated crop back into the original image
        x1, y1, x2, y2 = bbox_select
        resized = np.asarray(Image.fromarray(out_u8).resize(
            (min(img.shape[1], x2 - x1), min(img.shape[0], y2 - y1)),
            Image.BICUBIC), np.uint8)
        full = img.copy()
        full[y1:y1 + resized.shape[0], x1:x1 + resized.shape[1]] = resized
        last_full = full
        save_image_rgb(os.path.join(args.dir_out,
                                    f"{name}{suffix}_generated.png"), full)
        save_image_rgb(os.path.join(args.dir_out,
                                    f"{name}{suffix}_generated_crop.png"),
                       out_u8)
    save_image_rgb(os.path.join(args.dir_out, f"{name}_orig.png"), img)
    save_image_rgb(os.path.join(args.dir_out, f"{name}_cond.png"),
                   to_uint8(cond))
    save_image_rgb(os.path.join(args.dir_out, f"{name}_y_t.png"),
                   to_uint8(crop))
    save_image_rgb(os.path.join(args.dir_out, f"{name}_mask.png"),
                   (mask[:, :, 0] > 0).astype(np.uint8) * 255)
    if args.bbox_in:
        with open(os.path.join(args.dir_out, f"{name}_orig_bbox.json"),
                  "w") as f:
            json.dump(bbox_select, f)
    print("Successfully generated image", name)
    return last_full, model, opt


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_in_file", required=True)
    p.add_argument("--img_in", required=True)
    p.add_argument("--mask_in", default="")
    p.add_argument("--bbox_in", default="")
    p.add_argument("--dir_out", default=".")
    p.add_argument("--name", default="")
    p.add_argument("--nb_samples", type=int, default=1)
    p.add_argument("--sampling_steps", type=int, default=-1)
    p.add_argument("--cond_in", default="",
                   help="exemplar image pasted into the mask region")
    p.add_argument("--ref_in", default="",
                   help="reference image for ref-conditioned diffusion")
    p.add_argument("--alg_diffusion_guidance_scale", type=float, default=0.0,
                   help="classifier-free guidance scale at sampling")
    p.add_argument("--sampling_method", default="",
                   choices=["", "ddpm", "ddim"])
    p.add_argument("--alg_sc_denoise_inferstep", type=int, default=-1,
                   help="sc: the sampler's step count (default: the "
                        "model's alg_sc_denoise_timesteps)")
    p.add_argument("--alg_diffusion_cond_image_creation", default="")
    p.add_argument("--alg_diffusion_sketch_canny_thresholds", type=int,
                   nargs=2, default=None,
                   help="fixed canny thresholds for sketch conditioning")
    p.add_argument("--alg_diffusion_super_resolution_downsample",
                   action="store_true",
                   help="downsample the input by the SR scale before "
                        "low_res conditioning")
    p.add_argument("--mask_delta", type=int, nargs="*", default=[])
    p.add_argument("--bbox_ref_id", type=int, default=-1,
                   help="bbox id to use (reference "
                        "inference_diffusion_options.py:124)")
    p.add_argument("--min_crop_bbox_ratio", type=float, default=0,
                   help="minimum crop-to-bbox size ratio (reference "
                        "inference_diffusion_options.py:133)")
    p.add_argument("--crop_width", type=int, default=0)
    p.add_argument("--crop_height", type=int, default=0)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: CUDA, raising without it)")
    return p


if __name__ == "__main__":
    inference(build_parser().parse_args())
