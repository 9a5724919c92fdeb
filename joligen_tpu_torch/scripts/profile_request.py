"""Where a serving request's, or a training step's, time goes on the card.

    python -m joligen_tpu_torch.scripts.profile_request \\
        [--config examples/example_ddpm_noglasses2glasses.json] \\
        [--model_type sc] [--sampling_method ddim | --train] [--size PX] \\
        [--out profile_request.json] [--<option> VALUE ...]

Builds the config's model (palette; a GAN such as
``examples/example_gan_horse2zebra.json``, or
``examples/example_gan_noglasses2glasses.json`` or
``examples/example_gan_mario2sonic.json`` with their semantic-mask
branch, whose batch then carries the mask as A's and B's label; the
ref-conditioned ``examples/example_ddpm_unetref_viton.json``, whose batch
then carries a reference image; cm or
cm_gan from
``examples/example_cm*_noglasses2glasses.json``, or sc from the cm config
with ``--model_type sc``; a cm_gan step is one micro-step; the video
``examples/example_ddpm_vid_mario.json``, whose batch then holds clips of
``data_temporal_number_frames`` frames, a step one micro-step of its
``iter_size``; b2b from ``examples/example_b2b_vid_mario.json``, clips too,
a request its ``denoise_timesteps`` Heun steps; MAT from
``examples/example_mat_inpainting.json``, a step one ``optimize_prepared``
(the warm-up steps leave the timed and traced ones without R1), a request
one ``inference``, and with ``--alg_mat_motion`` on clips of
``data_temporal_number_frames`` frames; any other option of the train CLI overrides the
config's, as ``--model_type b2b --G_netG vit`` (the image b2b, a request
its 50 Heun steps) with ``--alg_b2b_lora`` (a LoRA step), or ``--G_netG
vit`` or ``hdit`` under palette) at full width
with seeded random weights and runs twice as warm-up, on a synthetic
masked image, either one serving request or (``--train``) one training
step on a batch of ``train_batch_size`` such images (a GAN reads its ``A``
and ``B``); then times one run by the host clock and traces another with
``torch.profiler``. Prints one JSON object: latency, kernels launched per
run, the device's busy time (the union of the kernels'
intervals) and idle share of the untraced latency, and the kernels that
take the most device time. The run is on one card: the ``tpu_mesh_*``
options are set to one device (b2b_vid_mario's ``tpu_mesh_fsdp`` 2 cannot
hold on one). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from .. import card_line
from ..models import create_model
from ..options import TrainOptions

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthetic_batch(size, seed, batch=1, frames=0):
    """Masked images, or (``frames``) clips of that many masked frames."""
    rng = np.random.default_rng(seed)
    lead = (batch, frames) if frames else (batch,)
    crop = rng.uniform(-1, 1, lead + (size, size, 3)).astype(np.float32)
    mask = np.zeros(lead + (size, size, 1), np.int32)
    mask[..., size // 4:3 * size // 4, size // 4:3 * size // 4, :] = 1
    cond = np.where(mask > 0, rng.uniform(-1, 1, crop.shape), crop)
    return {"A": cond.astype(np.float32), "B": crop, "B_label_mask": mask}


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=os.path.join(
        ROOT, "examples", "example_ddpm_noglasses2glasses.json"))
    p.add_argument("--sampling_method", default="ddim",
                   choices=["ddim", "ddpm"])
    p.add_argument("--train", action="store_true",
                   help="profile a training step instead of a request")
    p.add_argument("--model_type", default="",
                   help="model type instead of the config's")
    p.add_argument("--size", type=int, default=0,
                   help="load and crop size in px instead of the config's")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--out", default="")
    args, overrides = p.parse_known_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_request measures the card: no CUDA "
                           "device is available")

    if args.model_type:
        overrides += ["--model_type", args.model_type]
    opt = TrainOptions().parse_cli(["--config_json", args.config,
                                    *overrides])
    if args.size:
        opt.data_load_size = opt.data_crop_size = args.size
    opt.tpu_mesh_data, opt.tpu_mesh_fsdp = -1, 1
    opt.tpu_mesh_tensor = opt.tpu_mesh_seq = 1
    if args.train:
        # phase train makes its checkpoint directory; nothing is saved there
        opt.checkpoints_dir = tempfile.mkdtemp(prefix="profile_")
        model = create_model(opt, phase="train")
        os.rmdir(model.save_dir)
        os.rmdir(opt.checkpoints_dir)
        batch_size = opt.train_batch_size
    else:
        model = create_model(opt, phase="test")
        batch_size = 1
    frames = model.num_frames if getattr(model, "is_video", False) else 0
    batch = synthetic_batch(opt.data_crop_size, model.seed, batch_size,
                            frames)
    if getattr(model, "semantic_mask", False):
        batch["A_label_mask"] = batch["B_label_mask"]
    if getattr(model, "use_ref", False):
        batch["ref_A"] = synthetic_batch(opt.data_crop_size, model.seed + 1,
                                         len(batch["B"]))["B"]

    palette = opt.model_type == "palette"

    def request():
        if args.train:
            model.optimize_parameters(batch)
        elif palette:
            model.inference(batch, sampling_method=args.sampling_method)
        else:
            model.inference(batch)
        torch.cuda.synchronize()

    for _ in range(2):
        request()
    t0 = time.perf_counter()
    request()
    latency_us = (time.perf_counter() - t0) * 1e6

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        request()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    smi = card_line(0)
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "config": os.path.basename(args.config),
        "overrides": overrides, "model_type": opt.model_type,
        "G_netG": opt.G_netG,
        "run": ("training step, batch %d" % opt.train_batch_size
                if args.train else (args.sampling_method + " request"
                                    if palette else "request")),
        "crop_size": opt.data_crop_size, "frames": frames,
        "latency_ms": latency_us / 1e3,
        "device_launches": len(kernels),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / latency_us),
        "top_kernels": [{"name": n[:120], "launches": c, "ms": t / 1e3,
                         "share_of_busy": t / busy}
                        for n, (c, t) in top],
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
