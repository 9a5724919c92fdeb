"""Multi-dataset B2B training-config generator of the port (the JAX
package's ``scripts/gen_multi_dataset_b2b_config.py``; reference
scripts/gen_multi_dataset_b2b_config.py:1-1413):

    python -m joligen_tpu_torch.scripts.gen_multi_dataset_b2b_config \\
        --datasets-root datasets/ --output-dir runs/multi

Given a directory of dataset roots (each with trainA/paths.txt in the
online-bbox layout), it:

1. derives a per-dataset online crop size from the bbox statistics (highest
   density interval over the bbox long sides, reference :141-200),
2. generates an automatic holdout test set per dataset when no testA* set
   exists — temporal-window aware for video children so the held-out frames
   never break the remaining train windows (reference :432-602),
3. writes ``multi_dataset_config.json`` (weighted child entries with
   per-child crop-size overrides + test_sets) and a ready-to-run
   ``train_config.json`` for the B2B flow-matching model (Muon, JiT-B/16,
   EMA, LPIPS and DISTS), which ``python -m joligen_tpu_torch.train
   --config_json`` trains,
4. optionally renders preview sample grids per dataset through the port's
   data pipeline and options,
5. caches per-dataset results under ``<output>/resume`` keyed by a content
   fingerprint so interrupted runs resume (``--resume``).

Both JSONs are the JAX script's on the same dataset roots (the body is a
copy of its framework-neutral code).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import math
import os
import random
import re

RESUME_SCHEMA_VERSION = 1
VIDEO_CHILD_MODE = "self_supervised_vid_mask_online"
CHILD_MODES = (VIDEO_CHILD_MODE, "self_supervised_labeled_mask_online",
               "self_supervised_labeled_mask_cls_online")


def natural_keys(text):
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


def clean_name(folder):
    toks = [t for t in folder.split("_") if t and t.lower() not in
            ("online", "clean")]
    return "_".join(toks) if toks else folder


def sanitize_id(value):
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", str(value)).strip("_") or "x"


def test_id(dataset_name, child_test_name):
    base = sanitize_id(dataset_name)
    return f"{base}_{sanitize_id(child_test_name)}" if child_test_name \
        else base


def hdi(values, coverage=0.75):
    """Narrowest window holding `coverage` of the sorted values (highest
    density interval) — robust to outlier bboxes."""
    values = sorted(values)
    win = max(1, math.ceil(coverage * len(values)))
    best = min(range(len(values) - win + 1),
               key=lambda i: values[i + win - 1] - values[i])
    return values[best], values[best + win - 1]


def fingerprint(payload):
    return hashlib.sha256(json.dumps(
        payload, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def path_meta(path):
    if not os.path.exists(path):
        return None
    st = os.stat(path)
    return {"path": os.path.realpath(path), "size": st.st_size,
            "mtime_ns": st.st_mtime_ns}


def atomic_write(path, text):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_json(path, payload):
    atomic_write(path, json.dumps(payload, indent=2) + "\n")


def read_lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def absolutize(line, dataroot):
    parts = []
    for p in line.split():
        parts.append(p if os.path.isabs(p) else
                     os.path.realpath(os.path.join(dataroot, p)))
    return " ".join(parts)


# ---------------------------------------------------------------- discovery

def discover_roots(args):
    if bool(args.datasets_root) == bool(args.dataset_dirs):
        raise SystemExit("provide exactly one of --datasets-root or "
                         "--dataset-dirs")
    if args.datasets_root:
        root = os.path.realpath(args.datasets_root)
        roots = []
        for child in sorted(os.listdir(root)):
            cpath = os.path.join(root, child)
            if not os.path.isdir(cpath):
                continue
            if os.path.isdir(os.path.join(cpath, "trainA")):
                roots.append(cpath)
            else:  # one nesting level: <root>/<group>/<dataset>/trainA
                roots.extend(
                    g for g in sorted(glob.glob(os.path.join(cpath, "*")))
                    if os.path.isdir(os.path.join(g, "trainA")))
    else:
        roots = [os.path.realpath(d) for d in args.dataset_dirs]
        bad = [d for d in roots
               if not os.path.isdir(os.path.join(d, "trainA"))]
        if bad:
            raise SystemExit(f"missing trainA under: {bad}")
    if not roots:
        raise SystemExit("no dataset roots with trainA found")
    return roots


def entry_name(dataroot, args):
    if args.datasets_root:
        rel = os.path.relpath(dataroot, os.path.realpath(args.datasets_root))
        parts = [p for p in rel.split(os.sep) if p not in (".", "")]
        if 1 <= len(parts) <= 2:
            return "_".join(clean_name(p) for p in parts)
    return clean_name(os.path.basename(dataroot))


# ---------------------------------------------------------- crop derivation

def derive_crop_size(paths_file, coverage, step, ignore_categories):
    """Crop size from bbox long-side HDI (reference :141-200: target =
    0.696*hdi_hi + 124.5 margin, capped below the max long side, floored to
    a MXU-friendly multiple of `step`)."""
    dataroot = os.path.dirname(os.path.dirname(paths_file))
    ignored = {str(c) for c in ignore_categories}
    long_sides = []
    for ln, line in enumerate(read_lines(paths_file), 1):
        parts = line.split()
        if len(parts) < 2:
            raise SystemExit(f"{paths_file}:{ln}: expected '<image> <bbox>'")
        bpath = parts[1] if os.path.isabs(parts[1]) else \
            os.path.join(dataroot, parts[1])
        if not os.path.exists(bpath):
            raise SystemExit(f"{paths_file}:{ln}: bbox missing: {bpath}")
        with open(bpath) as f:
            for bl in f:
                e = bl.split()
                if len(e) < 5 or e[0] in ignored:
                    continue
                x1, y1, x2, y2 = map(int, map(float, e[1:5]))
                long_sides.append(max(x2 - x1, y2 - y1))
    if not long_sides:
        raise SystemExit(f"no usable bboxes in {paths_file}")
    lo, hi = hdi(long_sides, coverage)
    target = min(0.696 * hi + 124.5, max(long_sides) - 1e-6)
    size = int(math.floor(target / step) * step)
    if size <= 0:
        raise SystemExit(f"derived crop size not positive for {paths_file}")
    print(f"  crop size {size} (n={len(long_sides)} bboxes, "
          f"hdi{int(coverage * 100)}=[{lo},{hi}], max={max(long_sides)})")
    return size


# ------------------------------------------------------------ holdout sets

def temporal_windows(lines, num_frames, frame_step, num_common_char=-1):
    """Index windows (into `lines`) that form a valid temporal clip: same
    directory, natural-sort order, optional common filename prefix."""
    order = sorted(range(len(lines)), key=lambda i: natural_keys(lines[i]))
    span = (num_frames - 1) * frame_step
    windows = []
    for s in range(0, len(order) - span):
        pos = [s + k * frame_step for k in range(num_frames)]
        paths = [lines[order[p]].split()[0] for p in pos]
        if len({os.path.dirname(p) for p in paths}) != 1:
            continue
        if num_common_char != -1:
            pref = os.path.basename(paths[0])[:num_common_char]
            if any(os.path.basename(p)[:num_common_char] != pref
                   for p in paths):
                continue
        windows.append([order[p] for p in pos])
    return windows


def sample_holdout_windows(windows, name, args):
    """Pick up to --auto-test-samples windows whose removal still leaves at
    least one intact train window (reference :474-512)."""
    rng = random.Random(args.auto_test_seed + sum(map(ord, name)))
    shuffled = list(windows)
    rng.shuffle(shuffled)
    target = min(args.auto_test_samples, len(windows))
    picked, held = [], set()
    for w in shuffled:
        if len(picked) >= target:
            break
        cand = held | set(w)
        if any(all(i not in cand for i in win) for win in windows):
            picked.append(w)
            held = cand
    if not picked:
        raise SystemExit(f"'{name}': holdout would leave no train windows")
    if len(picked) < target:
        print(f"  reduced holdout for '{name}' to {len(picked)} windows "
              "to preserve train coverage")
    return sorted(held)


def sample_holdout_rows(n_lines, name, args):
    rng = random.Random(args.auto_test_seed + sum(map(ord, name)))
    count = min(args.auto_test_samples, max(0, n_lines - 1))
    if count <= 0:
        raise SystemExit(f"'{name}': not enough rows for a holdout")
    idx = list(range(n_lines))
    rng.shuffle(idx)
    return sorted(idx[:count])


def existing_test_sets(entry):
    out = []
    for tdir in sorted(glob.glob(os.path.join(entry["dataroot"], "testA*"))):
        if not os.path.isfile(os.path.join(tdir, "paths.txt")):
            continue
        child = os.path.basename(tdir)[len("testA"):]
        out.append({"id": test_id(entry["name"], child),
                    "dataset": entry["name"],
                    "dataset_name": entry["name"],
                    "dataroot": entry["dataroot"],
                    "test_name": child, "child_test_name": child,
                    "generated": False})
    return out


def generate_holdout(entry, output_dir, args):
    """Split trainA/paths.txt into a filtered train list + held-out test
    list under <output>/generated_test_sets/<name>/ and repoint the entry's
    dataroot at the generated root (reference :532-602)."""
    dataroot = entry["dataroot"]
    lines = read_lines(os.path.join(dataroot, "trainA", "paths.txt"))
    is_video = entry["dataset_mode"] == VIDEO_CHILD_MODE
    ncc = entry.get("overrides", {}).get("data_temporal_num_common_char", -1)
    if is_video:
        windows = temporal_windows(lines, args.data_temporal_number_frames,
                                   args.data_temporal_frame_step, ncc)
        if not windows:
            raise SystemExit(f"'{entry['name']}': no valid temporal windows")
        held = sample_holdout_windows(windows, entry["name"], args)
    else:
        held = sample_holdout_rows(len(lines), entry["name"], args)
    held_set = set(held)
    train_lines = [l for i, l in enumerate(lines) if i not in held_set]
    if not train_lines:
        raise SystemExit(f"'{entry['name']}': holdout empties the train set")
    if is_video and not temporal_windows(
            train_lines, args.data_temporal_number_frames,
            args.data_temporal_frame_step, ncc):
        raise SystemExit(f"'{entry['name']}': holdout breaks train windows")

    gen_root = os.path.join(output_dir, "generated_test_sets",
                            sanitize_id(entry["name"]))
    atomic_write(os.path.join(gen_root, "trainA", "paths.txt"),
                 "".join(absolutize(l, dataroot) + "\n"
                         for l in train_lines))
    atomic_write(os.path.join(gen_root, "testA", "paths.txt"),
                 "".join(absolutize(lines[i], dataroot) + "\n"
                         for i in held))
    entry["dataroot"] = gen_root
    print(f"  holdout for '{entry['name']}': train={len(train_lines)} "
          f"test={len(held)} rows -> {gen_root}")
    return {"id": test_id(entry["name"], ""), "dataset": entry["name"],
            "dataset_name": entry["name"], "dataroot": gen_root,
            "test_name": "", "child_test_name": "", "generated": True}


def skip_auto_holdout(entry, args):
    if args.no_auto_test_holdout:
        return True
    if args.auto_test_min_images <= 0:
        return False
    n = len(read_lines(os.path.join(entry["dataroot"], "trainA",
                                    "paths.txt")))
    if n >= args.auto_test_min_images:
        return False
    print(f"  skipping auto holdout for '{entry['name']}': {n} rows < "
          f"--auto-test-min-images={args.auto_test_min_images}")
    return True


# ---------------------------------------------------------- dataset entries

def dataset_fingerprint(dataroot, name, args):
    return fingerprint({
        "schema_version": RESUME_SCHEMA_VERSION, "name": name,
        "dataroot": os.path.realpath(dataroot),
        "train_paths": path_meta(os.path.join(dataroot, "trainA",
                                              "paths.txt")),
        "test_paths": [path_meta(os.path.join(d, "paths.txt")) for d in
                       sorted(glob.glob(os.path.join(dataroot, "testA*")))],
        "entry_args": {
            "child_dataset_mode": args.child_dataset_mode,
            "coverage": args.coverage, "step": args.step, "size": args.size,
            "weight": args.weight,
            "crop_delta_ratio": args.crop_delta_ratio,
            "ignore_categories": list(args.ignore_categories)},
        "holdout_args": {
            "data_temporal_number_frames": args.data_temporal_number_frames,
            "data_temporal_frame_step": args.data_temporal_frame_step,
            "auto_test_samples": args.auto_test_samples,
            "auto_test_seed": args.auto_test_seed},
    })


def build_entry(dataroot, args):
    name = entry_name(dataroot, args)
    print(f"dataset '{name}' <- {dataroot}")
    if args.size is None:
        crop = derive_crop_size(
            os.path.join(dataroot, "trainA", "paths.txt"),
            args.coverage, args.step, args.ignore_categories)
    else:
        crop = args.size
    return {
        "name": name, "dataset_mode": args.child_dataset_mode,
        "dataroot": dataroot, "weight": args.weight,
        "overrides": {
            "data_online_creation_crop_size_A": crop,
            "data_online_creation_crop_delta_A":
                int(round(crop * args.crop_delta_ratio)),
        },
    }


def build_or_resume(dataroot, output_dir, args):
    name = entry_name(dataroot, args)
    fp = dataset_fingerprint(dataroot, name, args)
    cache_path = os.path.join(output_dir, "resume", "datasets",
                              sanitize_id(name) + ".json")
    if args.resume and os.path.isfile(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)
        if (cache.get("schema_version") == RESUME_SCHEMA_VERSION
                and cache.get("fingerprint") == fp
                and all(os.path.isfile(os.path.join(
                    t["dataroot"] or cache["entry"]["dataroot"], "testA"
                    + t.get("child_test_name", ""), "paths.txt"))
                    for t in cache.get("test_sets", []))):
            print(f"dataset '{name}': resumed from cache")
            return cache["entry"], cache["test_sets"]
    entry = build_entry(dataroot, args)
    tests = existing_test_sets(entry)
    if not tests and not skip_auto_holdout(entry, args):
        tests = [generate_holdout(entry, output_dir, args)]
    write_json(cache_path, {"schema_version": RESUME_SCHEMA_VERSION,
                            "fingerprint": fp, "entry": entry,
                            "test_sets": tests})
    return entry, tests


# ------------------------------------------------------------ train config

def build_train_config(args, multi_config_path, n_datasets, ref_dataroot):
    netG = args.G_netG or ("vit_vid" if args.child_dataset_mode ==
                           VIDEO_CHILD_MODE else "vit")
    is_video = args.child_dataset_mode == VIDEO_CHILD_MODE or \
        netG == "vit_vid"
    cfg = {
        "name": args.name, "model_type": "b2b",
        "checkpoints_dir": args.checkpoints_dir,
        "gpu_ids": args.gpu_ids,
        "model_input_nc": 3, "model_output_nc": 3,
        "data_dataset_mode": "multi_dataset",
        "data_multi_dataset_config": multi_config_path,
        "dataroot": ref_dataroot,
        "data_relative_paths": True,
        "G_netG": netG,
        "G_vit_variant": "JiT-B/16",
        "G_vit_num_classes": (int(n_datasets)
                              if args.alg_b2b_multi_dataset_class_conditioning
                              else 3),
        "G_vit_disable_bottleneck": True,
        "f_s_semantic_nclasses": 3,
        "data_load_size": args.data_load_size,
        "data_crop_size": args.data_crop_size,
        "data_online_creation_rand_mask_A": True,
        "data_num_threads": args.data_num_threads,
        "dataaug_flip": "both", "dataaug_no_rotate": True,
        "dataaug_diff_aug_policy": "color",
        "train_batch_size": args.train_batch_size,
        "train_iter_size": args.train_iter_size,
        "train_n_epochs": args.train_n_epochs,
        "train_n_epochs_decay": args.train_n_epochs_decay,
        "train_save_epoch_freq": args.train_save_epoch_freq,
        "train_G_ema": True, "train_G_lr": args.train_G_lr,
        "train_optim": "muon", "train_optim_weight_decay": 0.0,
        "train_beta1": 0.9, "train_beta2": 0.95,
        "train_compute_metrics_test": True,
        "train_metrics_list": ["PSNR", "FID"],
        "train_metrics_every": args.train_metrics_every,
        "output_print_freq": args.output_print_freq,
        "output_display_freq": args.output_display_freq,
        "alg_b2b_mask_as_channel": True,
        "alg_b2b_multi_dataset_class_conditioning":
            args.alg_b2b_multi_dataset_class_conditioning,
        "alg_b2b_denoise_timesteps": [2, 5, 20],
        "alg_b2b_timestep_uniform_mix_prob": 0.1,
        "alg_b2b_cfg_scale": 1.0,
        "alg_b2b_disable_inference_clipping": True,
        "alg_b2b_perceptual_loss": ["LPIPS", "DISTS"],
        "alg_b2b_lambda_perceptual": 0.1,
        "alg_b2b_loss": "pseudo_huber",
        "alg_b2b_loss_masked_region_only": True,
        "alg_b2b_autoregressive": True,
        "alg_b2b_use_gt_prob": 0.1,
    }
    if args.reference_frame_size is not None and args.keep_ratio_load_size:
        cfg["data_online_creation_load_size_A"] = args.reference_frame_size
        cfg["data_online_creation_load_size_keep_ratio_A"] = True
    if is_video:
        cfg["data_temporal_number_frames"] = args.data_temporal_number_frames
        cfg["data_temporal_frame_step"] = args.data_temporal_frame_step
        if args.data_temporal_frame_step_random_max > 0:
            cfg["data_temporal_frame_step_random_max"] = \
                args.data_temporal_frame_step_random_max
    if args.alg_b2b_temporal_frame_step_conditioning:
        cfg["alg_b2b_temporal_frame_step_conditioning"] = True
    if args.alg_b2b_force_class_token >= 0:
        cfg["alg_b2b_force_class_token"] = args.alg_b2b_force_class_token
    if args.data_online_creation_mask_fixed_size_A > 0:
        cfg["data_online_creation_mask_fixed_size_A"] = \
            args.data_online_creation_mask_fixed_size_A
        cfg["data_online_creation_mask_min_unmasked_border_A"] = \
            args.data_online_creation_mask_min_unmasked_border_A
    if args.data_online_creation_mask_broaden_rect_aug_A:
        cfg["data_online_creation_mask_broaden_rect_aug_A"] = True
    if args.base_train_config:
        with open(args.base_train_config) as f:
            base = json.load(f)
        base.update(cfg)
        cfg = base
    return cfg


# ---------------------------------------------------------------- previews

def write_previews(train_config, multi_config, preview_dir, num_samples):
    """Render sample batches per child dataset through the real pipeline:
    GT | conditioning | mask-overlay per sample."""
    import numpy as np
    from PIL import Image

    from ..data import find_dataset_class
    from ..options import TrainOptions

    def to_u8(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 4:  # T,H,W,C video sample: lay frames out horizontally
            x = np.concatenate(list(x), axis=1)
        return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)

    import copy
    base = TrainOptions().parse_json(dict(train_config), verbose=False)
    for entry in multi_config["datasets"]:
        opt = copy.deepcopy(base)
        for k, v in entry.get("overrides", {}).items():
            setattr(opt, k, v)
        opt.dataroot = entry["dataroot"]
        opt.data_relative_paths = False
        opt.data_dataset_mode = entry["dataset_mode"]
        ds = find_dataset_class(entry["dataset_mode"])(opt, "train")
        out_dir = os.path.join(preview_dir, sanitize_id(entry["name"]))
        os.makedirs(out_dir, exist_ok=True)
        for i in range(min(num_samples, len(ds))):
            s = ds[i]
            if s is None:
                continue
            panels = [to_u8(s["B"])]
            if "A" in s:
                panels.append(to_u8(s["A"]))
            mask = s.get("B_label_mask")
            if mask is not None:
                m = np.asarray(mask)
                if m.ndim == 4:
                    m = np.concatenate(list(m), axis=1)
                m = (np.squeeze(m, -1) if m.shape[-1] == 1 else m) > 0
                ov = panels[0].copy()
                ov[m] = (0.5 * ov[m] + [127, 0, 0]).astype(np.uint8)
                panels.append(ov)
            h = min(p.shape[0] for p in panels)
            grid = np.concatenate([p[:h] for p in panels], axis=1)
            Image.fromarray(grid).save(
                os.path.join(out_dir, f"sample_{i:03d}.png"))
        print(f"  previews for '{entry['name']}' -> {out_dir}")


# --------------------------------------------------------------------- cli

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets-root", default="")
    p.add_argument("--dataset-dirs", nargs="+", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--name", default="b2b_multi_dataset")
    p.add_argument("--checkpoints-dir", default="./checkpoints")
    p.add_argument("--gpu-ids", default="-1")
    p.add_argument("--base-train-config", default="")
    p.add_argument("--coverage", type=float, default=0.75)
    p.add_argument("--step", type=int, default=16)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--weight", type=float, default=1.0)
    p.add_argument("--crop-delta-ratio", type=float, default=0.1)
    p.add_argument("--ignore-categories", nargs="*", default=["2"])
    p.add_argument("--data-load-size", type=int, default=256)
    p.add_argument("--data-crop-size", type=int, default=256)
    p.add_argument("--child-dataset-mode", choices=sorted(CHILD_MODES),
                   default=VIDEO_CHILD_MODE)
    p.add_argument("--G-netG", choices=["vit_vid", "vit"], default=None)
    p.add_argument("--reference-frame-size", nargs=2, type=int, default=None,
                   metavar=("WIDTH", "HEIGHT"))
    p.add_argument("--keep-ratio-load-size", action="store_true")
    p.add_argument("--data-online-creation-mask-fixed-size-A", type=int,
                   default=-1)
    p.add_argument("--data-online-creation-mask-min-unmasked-border-A",
                   type=int, default=4)
    p.add_argument("--data-online-creation-mask-broaden-rect-aug-A",
                   action="store_true")
    p.add_argument("--data-temporal-number-frames", type=int, default=2)
    p.add_argument("--data-temporal-frame-step", type=int, default=1)
    p.add_argument("--data-temporal-frame-step-random-max", type=int,
                   default=0)
    p.add_argument("--alg-b2b-temporal-frame-step-conditioning",
                   action="store_true")
    p.add_argument("--data-num-threads", type=int, default=8)
    p.add_argument("--train-batch-size", type=int, default=8)
    p.add_argument("--train-iter-size", type=int, default=4)
    p.add_argument("--train-n-epochs", type=int, default=6000)
    p.add_argument("--train-n-epochs-decay", type=int, default=0)
    p.add_argument("--train-save-epoch-freq", type=int, default=1000)
    p.add_argument("--train-G-lr", type=float, default=1e-4)
    p.add_argument("--train-metrics-every", type=int, default=20000)
    p.add_argument("--output-print-freq", type=int, default=200)
    p.add_argument("--output-display-freq", type=int, default=1000)
    p.add_argument("--alg-b2b-multi-dataset-class-conditioning",
                   action="store_true")
    p.add_argument("--alg-b2b-force-class-token", type=int, default=-1)
    p.add_argument("--preview-samples", type=int, default=0)
    p.add_argument("--auto-test-samples", type=int, default=32)
    p.add_argument("--auto-test-seed", type=int, default=1337)
    p.add_argument("--auto-test-min-images", type=int, default=1000)
    p.add_argument("--no-auto-test-holdout", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--skip-preview", action="store_true")
    args = p.parse_args(argv)
    if (0 < args.data_temporal_frame_step_random_max
            < args.data_temporal_frame_step):
        p.error("--data-temporal-frame-step-random-max must be 0 or >= "
                "--data-temporal-frame-step")
    if args.alg_b2b_force_class_token < -1:
        p.error("--alg-b2b-force-class-token must be -1 or >= 0")
    return args


def main(argv=None):
    """Writes the two JSONs; returns their paths."""
    args = parse_args(argv)
    roots = discover_roots(args)
    output_dir = os.path.realpath(args.output_dir)
    os.makedirs(output_dir, exist_ok=True)

    names = [entry_name(r, args) for r in roots]
    ids = [sanitize_id(n) for n in names]
    if len(ids) != len(set(ids)):
        raise SystemExit(f"duplicate dataset names after sanitizing: {ids}")

    datasets, test_sets = [], []
    for root in roots:
        entry, tests = build_or_resume(root, output_dir, args)
        datasets.append(entry)
        test_sets.extend(tests)
    seen = set()
    for t in test_sets:
        if t["id"] in seen:
            raise SystemExit(f"duplicate test set id '{t['id']}'")
        seen.add(t["id"])

    multi_config = {"datasets": datasets, "test_sets": test_sets}
    multi_path = os.path.join(output_dir, "multi_dataset_config.json")
    write_json(multi_path, multi_config)

    train_config = build_train_config(args, multi_path, len(datasets),
                                      datasets[0]["dataroot"])
    train_path = os.path.join(output_dir, "train_config.json")
    write_json(train_path, train_config)

    if not args.skip_preview and args.preview_samples > 0:
        write_previews(train_config, multi_config,
                       os.path.join(output_dir, "previews"),
                       args.preview_samples)

    print(f"wrote {multi_path}")
    print(f"wrote {train_path}")
    return multi_path, train_path


if __name__ == "__main__":
    main()
