"""Diffusion single-image inference on the port
(``scripts/gen_single_image_diffusion.py``), whole-image mode.

    python -m joligen_tpu_torch.scripts.gen_single_image_diffusion \\
        --model_in_file ckpt/latest_net_G_A.pth --img_in img.png \\
        --mask_in mask.png --dir_out out --sampling_method ddim --seed 0

Same CLI and outputs as the JAX script: ``<name>_orig.png``,
``<name>_cond.png``, ``<name>_generated.png``, ``<name>_generated_crop.png``,
``<name>_y_t.png``, ``<name>_mask.png``. The image is resized to the crop
size, the masked region (``--mask_in``, or the whole image) is filled with
noise (``y_t`` conditioning), sampled, and the generated crop is resized
back into the full image. Runs on CUDA unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from ..models.palette_model import UNPORTED_COND_CREATION
from .common import load_image_rgb, load_model_from_file, save_image_rgb, \
    to_m1p1, to_uint8


def build_inputs(args, opt):
    """Returns (full_img_uint8, crop [-1,1], mask (H,W,1) int32,
    bbox_select [x1,y1,x2,y2] in full-image coords)."""
    if args.bbox_in:
        raise NotImplementedError(
            "--bbox_in crop mode (ROADMAP Queue 1 item 7)")
    from PIL import Image

    img = load_image_rgb(args.img_in)
    H, W = img.shape[:2]
    size = opt.data_crop_size
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
    if cond_creation in UNPORTED_COND_CREATION:
        raise NotImplementedError(
            f"{cond_creation} conditioning (ROADMAP Queue 1 item 7)")
    if args.cond_in:
        raise NotImplementedError(
            "--cond_in exemplar insertion (ROADMAP Queue 1 item 7)")
    if args.ref_in:
        raise NotImplementedError(
            "--ref_in ref conditioning (ROADMAP Queue 1 item 7)")
    if opt.model_type != "palette":
        raise NotImplementedError(
            f"model type {opt.model_type} (ROADMAP Queue 1 item 7)")
    return cond_creation


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
    if cond_creation == "pix2pix":
        cond = crop
    else:  # y_t: randomize the masked region
        from ..data.transforms import fill_mask_with_random
        cond = fill_mask_with_random(crop, mask, -1)

    outs = []
    for _ in range(max(1, args.nb_samples)):
        batch = {"A": cond[None], "B": crop[None],
                 "B_label_mask": mask[None]}
        kwargs = {}
        if args.sampling_method:
            kwargs["sampling_method"] = args.sampling_method
        if args.sampling_steps > 0:
            kwargs["num_steps"] = args.sampling_steps
        if args.alg_diffusion_guidance_scale > 0:
            kwargs["guidance_scale"] = args.alg_diffusion_guidance_scale
        fake = model.inference(batch, **kwargs)
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
    p.add_argument("--alg_diffusion_cond_image_creation", default="")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: CUDA, raising without it)")
    return p


if __name__ == "__main__":
    inference(build_parser().parse_args())
