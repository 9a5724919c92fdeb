"""MAT video inpainting (``scripts/gen_video_mat.py``): every frame of a
directory inpainted by a MAT checkpoint under its mask, one frame at a time
through the single-image path. Runs on the CUDA device unless ``--cpu``.

    python -m joligen_tpu_torch.scripts.gen_video_mat \\
        --model_in_file checkpoints/mat_inpaint/latest_net_G_A.pth \\
        --dir_in frames/ --mask_dir_in masks/ --dir_out out [--seed 0]

The frames and masks are the sorted images of each directory (a mask file
instead of a directory serves every frame); outputs are written as
``frame_{i:05d}_generated.png``. ``--seed`` keeps z fixed across frames.
``--video_out`` (an MP4 through cv2) raises: the port does not import cv2.
"""

from __future__ import annotations

import argparse
import os

from .common import load_image_rgb, load_model_from_file, save_image_rgb
from .gen_single_image_mat import mat_batch, to_full


def _frames(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))


def inference(args, model=None, opt=None):
    """Inpaint the frames; returns the uint8 outputs at the frames' sizes.
    ``model``/``opt`` reuse a loaded model."""
    if args.video_out:
        raise NotImplementedError(
            "--video_out: the MP4 writer needs cv2, which the port does not "
            "import (ROADMAP Queue 1 item 16, export and serving); the "
            "frames are written as PNGs")
    if model is None:
        model, opt = load_model_from_file(args.model_in_file, cpu=args.cpu)
    if opt.model_type != "mat":
        raise ValueError(f"not a MAT checkpoint: {opt.model_type}")
    frames = _frames(args.dir_in)
    if args.max_frames > 0:
        frames = frames[:args.max_frames]
    if os.path.isdir(args.mask_dir_in):
        masks = _frames(args.mask_dir_in)
    else:
        masks = [args.mask_dir_in] * len(frames)
    os.makedirs(args.dir_out, exist_ok=True)
    outs = []
    for i, (fp, mp) in enumerate(zip(frames, masks)):
        orig = load_image_rgb(fp)
        out = model.inference(mat_batch(orig, mp, opt.data_crop_size),
                              truncation_psi=args.truncation_psi,
                              seed=(args.seed if args.seed >= 0 else None))
        full = to_full(out[0], orig.shape)
        save_image_rgb(os.path.join(args.dir_out,
                                    f"frame_{i:05d}_generated.png"), full)
        outs.append(full)
    print(f"Successfully generated {len(outs)} frames")
    return outs


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_in_file", required=True)
    p.add_argument("--dir_in", required=True, help="frame directory")
    p.add_argument("--mask_dir_in", required=True,
                   help="per-frame mask directory (same ordering); a single "
                        "file is reused for every frame")
    p.add_argument("--dir_out", default=".")
    p.add_argument("--video_out", default="")
    p.add_argument("--fps", "--vid_fps", type=int, default=25)
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=-1,
                   help="fixed z across frames for temporal stability")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    return p


def main(argv=None):
    return inference(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
