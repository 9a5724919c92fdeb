"""GAN single-image inference (``scripts/gen_single_image.py``): load a
trained generator checkpoint (CUT's G, or CycleGAN's G_A: A to B), translate
one image, save the result. Runs on the CUDA device unless ``--cpu`` is
given.

    python -m joligen_tpu_torch.scripts.gen_single_image \\
        --model_in_file checkpoints/horse2zebra/latest_net_G_A.pth \\
        --img_in in.png --img_out out.png [--img_width 256 --img_height 256]
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from .common import (load_image_rgb, load_model_from_file, save_image_rgb,
                     to_m1p1, to_uint8)


def inference(args, model=None, opt=None):
    """Translate ``args.img_in`` into ``args.img_out``; returns the uint8
    output at the input's size. ``model``/``opt`` reuse a loaded model (a
    server answering several requests)."""
    if model is None:
        model, opt = load_model_from_file(args.model_in_file, cpu=args.cpu)
    img = load_image_rgb(args.img_in)
    w = args.img_width or opt.data_crop_size
    h = args.img_height or opt.data_crop_size
    img_r = np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC),
                       np.uint8)
    if opt.model_input_nc == 1:
        img_r = np.asarray(Image.fromarray(img_r).convert("L"), np.uint8)[
            ..., None]
    a = to_m1p1(img_r)[None]
    fake = model.inference({"A": a, "B": a})
    out = to_uint8(fake[0])
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    if out.shape[:2] != img.shape[:2]:
        out = np.asarray(Image.fromarray(out).resize(
            (img.shape[1], img.shape[0]), Image.BICUBIC), np.uint8)
    save_image_rgb(args.img_out, out)
    print("Successfully generated image", args.img_out)
    return out


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_in_file", required=True,
                   help="path to a <prefix>_net_G_A.pth checkpoint")
    p.add_argument("--img_in", required=True)
    p.add_argument("--img_out", required=True)
    p.add_argument("--img_width", type=int, default=0)
    p.add_argument("--img_height", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    return p


def main(argv=None):
    return inference(parser().parse_args(argv))


if __name__ == "__main__":
    main()
