"""Video diffusion inference on the port (``scripts/gen_vid_diffusion.py``):

    python -m joligen_tpu_torch.scripts.gen_vid_diffusion \\
        --model_in_file ckpt/latest_net_G_A.pth --dir_in frames/ \\
        --dir_out out --sampling_steps 10 --seed 0

Same CLI and outputs as the JAX script. The frames of ``--dir_in`` (sorted
names, each with its ``.txt`` box file where there is one) or of
``--paths_file`` ('img [bbox]' lines under ``--data_prefix``) are cropped
with frame 0's window (``data/online_creation.crop_image``, centred), the
tail is padded with the last frame to whole clips of
``data_temporal_number_frames``, and each clip is sampled by the model,
palette or b2b (``--sampling_steps`` N: palette's DDIM with N steps, or
b2b's Heun sampler over N steps (``denoise_timesteps``); else the model's
sampler). The
conditioning is the crop with its mask filled with noise, or its canny
sketch (``--cond_canny``). ``--autoregressive`` carries the last
``--context_frames`` generated frames of a clip into the next as clean
context (re-noised inside the mask by ``--context_noise_sigma``);
``--direction backward`` generates the reversed sequence; ``--cls`` and
``--cls_progress`` give class labels. Frames are pasted back into their
windows and written as ``frame_{i:05d}_generated.png``.

``--video_out`` (an MP4 through cv2) raises. Runs on CUDA unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.online_creation import crop_image
from ..data.transforms import fill_mask_with_random
from ..utils.mask_generation import fill_img_with_canny
from .common import (load_image_rgb, load_model_from_file, save_image_rgb,
                     to_m1p1, to_uint8)


def list_frames(args):
    """(image paths, box paths or "") of the request's frames."""
    if args.paths_file:
        with open(args.paths_file) as f:
            pairs = [line.split() for line in f.read().splitlines() if line]
        imgs = [p[0] for p in pairs]
        bboxes = [p[1] if len(p) > 1 else "" for p in pairs]
        root = args.data_prefix or os.path.dirname(args.paths_file)
        imgs = [os.path.join(root, p) for p in imgs]
        bboxes = [os.path.join(root, p) if p else "" for p in bboxes]
        return imgs, bboxes
    d = args.dir_in
    imgs = sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))
    bboxes = [os.path.splitext(p)[0] + ".txt" for p in imgs]
    bboxes = [b if os.path.exists(b) else "" for b in bboxes]
    return imgs, bboxes


def _check_supported(args, opt):
    if args.video_out:
        raise NotImplementedError(
            "--video_out: the MP4 writer needs cv2, which the port does not "
            "import (ROADMAP Queue 1 item 16, export and serving); the "
            "frames are written as PNGs")
    if opt.model_type not in ("palette", "b2b"):
        raise NotImplementedError(
            f"video requests of model type {opt.model_type}: palette and "
            "b2b are ported (ROADMAP Queue 1 item 11, video diffusion)")


def crop_frames(imgs, bboxes, opt):
    """(crops, masks, originals, windows): every frame with a box file
    cropped with frame 0's window, a frame without one resized whole with an
    all-ones mask."""
    from PIL import Image
    size = opt.data_crop_size
    crop_dim = getattr(opt, "data_online_creation_crop_size_A", 512)
    crop_coords = None
    crops, masks, origs, windows = [], [], [], []
    for ip, bp in zip(imgs, bboxes):
        orig = load_image_rgb(ip)
        origs.append(orig)
        if bp:
            if crop_coords is None:
                crop_coords = crop_image(
                    ip, bp, crop_delta=0, crop_center=True, crop_dim=crop_dim,
                    output_dim=size, get_crop_coordinates=True)
            crop, mask, _, _ = crop_image(
                ip, bp, crop_delta=0, crop_center=True, crop_dim=crop_dim,
                output_dim=size, crop_coordinates=crop_coords)
            windows.append((crop_coords[0], crop_coords[1], crop_coords[2]))
        else:
            crop = to_m1p1(np.asarray(Image.fromarray(orig).resize(
                (size, size), Image.BICUBIC), np.uint8))
            mask = np.ones((size, size, 1), np.int32)
            windows.append((0, 0, max(orig.shape[:2])))
        crops.append(crop)
        masks.append(mask)
    return crops, masks, origs, windows


def inference(args, lmodel=None, lopt=None):
    """Generate every frame of the request; ``lmodel``/``lopt`` reuse a
    loaded model across calls. Returns the full frames written (uint8)."""
    if lmodel is not None:
        model, opt = lmodel, lopt
    else:
        model, opt = load_model_from_file(args.model_in_file, cpu=args.cpu)
    _check_supported(args, opt)

    imgs, bboxes = list_frames(args)
    if args.max_frames > 0:
        imgs, bboxes = imgs[: args.max_frames], bboxes[: args.max_frames]
    assert imgs, "no input frames found"
    backward = args.direction == "backward"
    if backward:  # generate the reversed sequence, un-reverse on output
        imgs, bboxes = imgs[::-1], bboxes[::-1]
    if args.seed is not None and args.seed >= 0:
        np.random.seed(args.seed)
        model.generator.manual_seed(args.seed)
    nf = int(getattr(opt, "data_temporal_number_frames", 4) or 4)
    crops, masks, origs, windows = crop_frames(imgs, bboxes, opt)

    # pad the tail so that every clip is whole
    n = len(crops)
    pad = (-n) % nf
    crops += [crops[-1]] * pad
    masks += [masks[-1]] * pad

    def make_cond(crop, mask):
        if args.cond_canny:
            return fill_img_with_canny(crop, mask)
        return fill_mask_with_random(crop, mask, -1)

    k_ctx = max(0, min(int(args.context_frames or 1), nf - 1))
    sigma = float(args.context_noise_sigma or 0.0)
    cls_progress = list(args.cls_progress or [])

    generated = []
    prev_frames = None  # the last k_ctx generated frames
    for ci, start in enumerate(range(0, len(crops), nf)):
        clip = np.stack(crops[start:start + nf])      # (F, H, W, C)
        cmask = np.stack(masks[start:start + nf])
        cond = np.stack([make_cond(c, m) for c, m in zip(clip, cmask)])
        gt = clip.copy()
        if args.autoregressive and prev_frames is not None:
            # context frames: the previous clip's last generated frames,
            # re-noised inside the mask by sigma, kept (mask 0)
            for j, pf in enumerate(prev_frames):
                ctx = pf
                if sigma > 0:
                    m = (cmask[j] > 0.5).astype(np.float32)
                    ctx = ctx + sigma * np.random.randn(
                        *ctx.shape).astype(np.float32) * m
                gt[j] = pf
                cond[j] = ctx
                cmask[j] = np.zeros_like(cmask[j])
        batch = {"A": cond[None], "B": gt[None], "B_label_mask": cmask[None]}
        label = (cls_progress[min(ci, len(cls_progress) - 1)]
                 if cls_progress else args.cls)
        if label >= 0:
            batch["B_label_cls"] = np.asarray([label], np.int32)
        kwargs = {}
        if opt.model_type == "palette" and args.sampling_steps > 0:
            kwargs.update(sampling_method="ddim",
                          num_steps=args.sampling_steps)
        elif opt.model_type == "b2b" and args.sampling_steps > 0:
            kwargs["denoise_timesteps"] = args.sampling_steps
        fake = model.inference(batch, **kwargs)
        frames = fake[0] if fake.ndim == 5 else fake  # (F, H, W, C)
        prev_frames = list(frames[-k_ctx:]) if k_ctx else None
        generated.extend(list(frames))
    generated = generated[:n]
    if backward:
        generated, origs, windows = (generated[::-1], origs[::-1],
                                     windows[::-1])

    os.makedirs(args.dir_out, exist_ok=True)
    written = []
    from PIL import Image
    for i, (g, orig, win) in enumerate(zip(generated, origs, windows)):
        x0, y0, cdim = win
        full = orig.copy()
        rs = np.asarray(Image.fromarray(to_uint8(g)).resize(
            (cdim, cdim), Image.BICUBIC), np.uint8)
        full[y0:y0 + cdim, x0:x0 + cdim] = rs[: orig.shape[0] - y0,
                                              : orig.shape[1] - x0]
        save_image_rgb(os.path.join(args.dir_out,
                                    f"frame_{i:05d}_generated.png"), full)
        written.append(full)
    print(f"Successfully generated {len(written)} frames -> {args.dir_out}")
    return written


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_in_file", required=True)
    p.add_argument("--dir_in", default="")
    p.add_argument("--paths_file", default="")
    p.add_argument("--data_prefix", default="")
    p.add_argument("--dir_out", default=".")
    p.add_argument("--video_out", default="",
                   help="an MP4 of the frames: raises (needs cv2)")
    p.add_argument("--fps", "--vid_fps", type=int, default=25)
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--sampling_steps", type=int, default=-1,
                   help="palette: DDIM with this many steps; b2b: this "
                        "many Heun steps (default: the model's sampler)")
    p.add_argument("--autoregressive", action="store_true")
    p.add_argument("--direction", default="forward",
                   choices=["forward", "backward"],
                   help="backward generates the reversed sequence")
    p.add_argument("--context_frames", type=int, default=1,
                   help="generated frames carried into the next clip as "
                        "clean context")
    p.add_argument("--context_noise_sigma", type=float, default=0.0,
                   help="gaussian noise added to the context frames inside "
                        "the mask (the noisy ground-truth context of "
                        "autoregressive training, up to 0.7)")
    p.add_argument("--cond_canny", action="store_true",
                   help="condition on per-frame canny sketches")
    p.add_argument("--cls", type=int, default=-1,
                   help="class label for class-conditioned checkpoints")
    p.add_argument("--cls_progress", type=int, nargs="*", default=[],
                   help="a class label per clip")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: CUDA, raising without it)")
    return p


if __name__ == "__main__":
    inference(build_parser().parse_args())
