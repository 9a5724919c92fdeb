"""MAT single-image inpainting (``scripts/gen_single_image_mat.py``): load a
MAT checkpoint, inpaint the masked region of one image, save the result.
Runs on the CUDA device unless ``--cpu`` is given.

    python -m joligen_tpu_torch.scripts.gen_single_image_mat \\
        --model_in_file checkpoints/mat_inpaint/latest_net_G_A.pth \\
        --img_in in.png --mask_in mask.png --img_out out.png \\
        [--truncation_psi 0.7] [--seed 0]

As the JAX script: the image is resized to the crop size (bicubic), the
mask (nearest, any value above 0 is the hole) too; the output is resized
back to the image's size (bicubic).
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from .common import (load_image_rgb, load_model_from_file, save_image_rgb,
                     to_m1p1, to_uint8)


def mat_batch(img, mask_path, size):
    """The request's batch: the uint8 image and the mask file at the crop
    size."""
    x = to_m1p1(np.asarray(Image.fromarray(img).resize((size, size),
                                                       Image.BICUBIC)))
    m = Image.open(mask_path).convert("L").resize((size, size),
                                                  Image.NEAREST)
    label_mask = (np.asarray(m) > 0).astype(np.int32)[:, :, None]
    return {"B": x[None], "B_label_mask": label_mask[None]}


def to_full(out, shape):
    """The model's [-1, 1] output back to uint8 at the image's (H, W)."""
    return np.asarray(Image.fromarray(to_uint8(out)).resize(
        (shape[1], shape[0]), Image.BICUBIC))


def inference(args, model=None, opt=None):
    """Inpaint ``args.img_in`` under ``args.mask_in`` into
    ``args.img_out``; returns the uint8 output at the input's size.
    ``model``/``opt`` reuse a loaded model."""
    if model is None:
        model, opt = load_model_from_file(args.model_in_file, cpu=args.cpu)
    if opt.model_type != "mat":
        raise ValueError(f"not a MAT checkpoint: {opt.model_type}")
    img = load_image_rgb(args.img_in)
    batch = mat_batch(img, args.mask_in, opt.data_crop_size)
    out = model.inference(batch, truncation_psi=args.truncation_psi,
                          seed=(args.seed if args.seed >= 0 else None))
    full = to_full(out[0], img.shape)
    save_image_rgb(args.img_out, full)
    print("Successfully generated image", args.img_out)
    return full


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_in_file", required=True)
    p.add_argument("--img_in", required=True)
    p.add_argument("--mask_in", required=True)
    p.add_argument("--img_out", required=True)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    return p


def main(argv=None):
    return inference(parser().parse_args(argv))


if __name__ == "__main__":
    main()
