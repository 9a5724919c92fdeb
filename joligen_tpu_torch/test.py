"""Offline metric evaluation of a checkpoint directory (root ``test.py``),
on one CUDA device, or on the CPU with ``--cpu``:

    python -m joligen_tpu_torch.test --test_model_dir checkpoints/<name> \\
        [--test_epoch latest] [--test_metrics_list FID KID PSNR ...] [--cpu]

It rebuilds the model from ``<dir>/train_config.json`` (flat flags on the
command line override it), loads the epoch's networks, runs inference over
every test set of the dataroot (``testA<name>``/``testB<name>``; phase
``test`` unnamed when there is none) at ``--test_batch_size``, and writes
the metrics to ``<dir>/metrics/<timestamp>.json``. palette takes the
sampling overrides (``--sampling_method``, ``--sampling_steps`` or
``--ddim_num_steps``, ``--ddim_eta``); sc evaluates every step count of
``alg_sc_denoise_timesteps`` and b2b every one of several
``alg_b2b_denoise_timesteps`` (``--sampling_steps`` sets one), each under
``steps<n>``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import random
import sys

import numpy as np

from . import resolve_device
from .options import TrainOptions

MAX_INT = 1000000000
METRICS = ["FID", "KID", "MSID", "PSNR", "LPIPS", "SSIM", "DINOv2", "FVD"]


def _infer_kwargs(opt, main_opt):
    """The inference overrides of ``main_opt`` for ``opt.model_type``."""
    kw = {}
    if opt.model_type == "palette":
        if main_opt.sampling_method:
            kw["sampling_method"] = main_opt.sampling_method
        if main_opt.sampling_steps or main_opt.ddim_num_steps:
            kw["num_steps"] = (main_opt.ddim_num_steps
                               or main_opt.sampling_steps)
        if main_opt.ddim_eta is not None:
            kw["eta"] = main_opt.ddim_eta
    elif opt.model_type in ("sc", "b2b") and main_opt.sampling_steps:
        kw["denoise_timesteps"] = main_opt.sampling_steps
    return kw


def _step_grid(opt, main_opt):
    """The step counts sc and b2b evaluate one by one."""
    grid = []
    if opt.model_type == "sc":
        grid = list(getattr(opt, "alg_sc_denoise_timesteps", []) or [])
    elif opt.model_type == "b2b":
        steps = getattr(opt, "alg_b2b_denoise_timesteps", []) or []
        if isinstance(steps, (int, float)):
            steps = [int(steps)]
        if len(steps) > 1:
            grid = [int(s) for s in steps]
    if main_opt.sampling_steps:
        grid = [main_opt.sampling_steps]
    return grid


def launch_testing(opt, main_opt, cpu=False):
    """Evaluate ``main_opt.test_model_dir``'s networks; returns the metrics
    and writes them to ``<dir>/metrics/<timestamp>.json``."""
    from .data import create_dataloader, create_dataset, list_test_sets
    from .models import create_model

    resolve_device(cpu=cpu)        # no card and no --cpu: raise before work
    opt.steps_per_epoch = 1
    model = create_model(opt, phase="test", cpu=cpu)
    model.save_dir = main_opt.test_model_dir
    model.load_networks(main_opt.test_epoch, load_optim=False)

    infer_kwargs = _infer_kwargs(opt, main_opt)
    step_grid = _step_grid(opt, main_opt)
    results = {}
    for name in list_test_sets(opt.dataroot) or [""]:
        try:
            ds = create_dataset(opt, "test", name=name)
        except (AssertionError, FileNotFoundError) as e:
            print(f"skipping test set '{name}': {e}")
            continue
        dl = create_dataloader(opt, ds, shuffle=False,
                               batch_size=opt.test_batch_size)
        model.init_metrics(dl)
        key = f"test{name}" if name else "test"
        if len(step_grid) > 1 and opt.model_type in ("sc", "b2b"):
            results[key] = {}
            for n_steps in step_grid:
                kw = dict(infer_kwargs, denoise_timesteps=int(n_steps))
                m = model.compute_metrics_test(dl, **kw)
                results[key][f"steps{n_steps}"] = m
                print(f"{key}[steps={n_steps}]", json.dumps(m))
        else:
            results[key] = model.compute_metrics_test(dl, **infer_kwargs)
            print(key, json.dumps(results[key]))

    out_dir = os.path.join(main_opt.test_model_dir, "metrics")
    os.makedirs(out_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_path = os.path.join(out_dir, f"{stamp}.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"metrics written to {out_path}")
    return results


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--test_model_dir", type=str, required=True)
    p.add_argument("--test_epoch", type=str, default="latest")
    p.add_argument("--test_metrics_list", type=str, nargs="*",
                   choices=METRICS,
                   default=["FID", "KID", "MSID", "PSNR", "LPIPS"])
    p.add_argument("--test_nb_img", type=int, default=MAX_INT)
    p.add_argument("--test_batch_size", type=int, default=1)
    p.add_argument("--test_seed", type=int, default=42)
    p.add_argument("--sampling_steps", type=int)
    p.add_argument("--sampling_method", type=str, choices=["ddpm", "ddim"])
    p.add_argument("--ddim_num_steps", type=int)
    p.add_argument("--ddim_eta", type=float)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    return p


def parse(argv=None):
    """(opt, main_opt): the saved config with the command line's flat
    overrides and the test options applied, and the test options."""
    main_opt, remaining = build_parser().parse_known_args(argv)
    with open(os.path.join(main_opt.test_model_dir,
                           "train_config.json")) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    if remaining:
        override = TrainOptions().parse_cli(remaining)
        for flag in TrainOptions._explicit_flags(remaining):
            if hasattr(override, flag):
                setattr(opt, flag, getattr(override, flag))
    opt.train_compute_metrics_test = True
    opt.train_epoch = main_opt.test_epoch
    opt.train_metrics_list = main_opt.test_metrics_list
    opt.train_nb_img_max_fid = main_opt.test_nb_img
    opt.test_batch_size = main_opt.test_batch_size
    opt.seed = main_opt.test_seed
    return opt, main_opt


def main(argv=None):
    opt, main_opt = parse(sys.argv[1:] if argv is None else list(argv))
    random.seed(main_opt.test_seed)
    np.random.seed(main_opt.test_seed)
    return launch_testing(opt, main_opt, cpu=main_opt.cpu)


if __name__ == "__main__":
    main()
