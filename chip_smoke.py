#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``joligen_tpu_torch``) on one NVIDIA
GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: compiles every kernel of the serving and training paths from
   ``csrc/`` (one ``nvcc`` per source, started together).
3. Kernels: K1 (flash-attention forward), K2 (dQ) and K3 (dK, dV) each
   against its plain PyTorch version on the same CUDA tensors at the paths'
   shapes, the autograd Function against autograd through the plain
   forward, and each kernel's time, its bound, the plain version's time and
   one library call's time as a yardstick.
4. Serving: palette inpainting at the full width of
   ``examples/example_ddpm_noglasses2glasses.json`` (128 px, ngf 64, 62.8M
   parameters, bf16) with seeded random weights, saved and reloaded through
   the checkpoint files, serving DDIM-10 and DDPM-1000 requests through
   ``scripts/gen_single_image_diffusion.inference``; launch counts per
   request; outputs checked; the full-width denoiser in fp32 on the card
   against the same forward on the CPU.
5. Training: ``launch_training`` on the same config over a synthetic
   dataset of 64 images at 128 px written here, 16 steps (2 epochs of 8,
   batch 8, AdamW, EMA); launch counts, loss, attention gradients, the EMA
   lerp, step time and peak memory; then one DDIM-10 request served from the
   trained ``latest`` checkpoint; then one fp32 training step's gradients,
   card (K1-K3) against CPU (plain versions), over all 327 leaves.

Prints one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(ROOT, "examples", "example_ddpm_noglasses2glasses.json")
SEED = 0
DDIM_REQUESTS = 3
EXPECTED_PARAMS = 62_838_467    # the example config's denoiser
# Published H100 SXM peaks (NVIDIA data sheet): memory 3.35 TB/s; bf16 on
# the tensor cores 989 TFLOP/s; fp32 outside them 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CROSS_CHECK_TOL = 1e-3
# fp32 training step, card against CPU: every leaf's max abs gradient error
# within 1e-3 of the largest gradient of all, and within 1e-2 of the leaf's
# own largest gradient (sums in another order through ~70 layers)
GRAD_TOL_GLOBAL = 1e-3
GRAD_TOL_LEAF = 1e-2
EXPECTED_LEAVES = 327
TRAIN_IMAGES = 64
TRAIN_EPOCHS = 2
BWD_CHECKS = [((8, 256, 16, 32), "bfloat16"), ((8, 256, 16, 32), "float32"),
              ((1, 256, 16, 32), "bfloat16"), ((8, 1024, 16, 32), "bfloat16"),
              ((2, 100, 2, 64), "float32"), ((2, 5, 2, 16), "float32")]
TRAIN_SHAPE = (8, 256, 16, 32)      # the mid block at 128 px, batch 8
BIG_SHAPE = (8, 1024, 16, 32)       # the mid block at 256 px, batch 8


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters):
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype_name):
    """Least time for one attention forward: each of q, k, v read once, o and
    lse written once, against 4*B*H*S*S*D matmul FLOPs."""
    b, s, h, d = shape
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * item + b * h * s * 4
    flops = 4 * b * h * s * s * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_phase():
    """K1 against its plain version; times at the two path shapes."""
    import torch
    import torch.nn.functional as F
    from joligen_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    checks = [((1, 256, 16, 32), torch.bfloat16),
              ((1, 256, 16, 32), torch.float32),
              ((8, 1024, 16, 32), torch.bfloat16),
              ((2, 100, 2, 64), torch.float32),
              ((2, 5, 2, 16), torch.float32)]
    results, inputs = [], {}
    for shape, dtype in checks:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        inputs[(shape, dtype)] = (q, k, v)
        o, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        results.append({"shape": list(shape), "dtype": name,
                        "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                        "tol": tol})
        log(f"K1 check {shape} {name}: err o {err_o:.3e} lse {err_lse:.3e} "
            f"(tol {tol})")
        if not (err_o <= tol and err_lse <= tol):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape} {name}")

    timings = {}
    for label, shape, iters in (("128px_batch1", (1, 256, 16, 32), 200),
                                ("256px_batch8", (8, 1024, 16, 32), 20)):
        q, k, v = inputs[(shape, torch.bfloat16)]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        scale = shape[-1] ** -0.5
        out = fa.flash_attention_fwd(q, k, v)
        # the kernel alone (outputs allocated once), then through the wrapper
        # (checks and allocation on the host every call)
        ms = time_ms(lambda: fa._launch(q, k, v, scale, out), iters)
        wrapper = time_ms(lambda: fa.flash_attention_fwd(q, k, v), iters)
        plain = time_ms(lambda: fa.flash_attention_reference(q, k, v), iters)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                      iters)
        bound, by = attention_bound_ms(shape, "bfloat16")
        timings[label] = {"shape": list(shape), "dtype": "bfloat16",
                          "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
                          "library_ms": lib, "bound_ms": bound,
                          "bound_by": by}
        log(f"K1 time {label} {shape} bf16: kernel {ms:.4f} ms, wrapper "
            f"{wrapper:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bound:.5f} ms ({by})")
    main = next(r for r in results if r["shape"] == [1, 256, 16, 32]
                and r["dtype"] == "bfloat16")
    t = timings["128px_batch1"]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "joligen_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "joligen_tpu/ops/flash_attention.py:43",
            "launches": None,
            "max_abs_err": max(main["max_abs_err_o"],
                               main["max_abs_err_lse"]),
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "(1, 256, 16, 32) bf16: 128 px, batch 1",
            "at_256px_batch8": timings["256px_batch8"], "checks": results}


def backward_bound_ms(shape, dtype_name, kernel):
    """Least time for K2 or K3: q, k, v, dO read once, lse and delta read
    once, dQ (K2) or dK and dV (K3) written once, against 6*B*H*S*S*D (K2:
    QK^T, dO V^T, dS K) or 8*B*H*S*S*D (K3: QK^T, dO V^T, P^T dO, dS^T Q)
    matmul FLOPs."""
    b, s, h, d = shape
    item = 2 if dtype_name == "bfloat16" else 4
    n_out = 1 if kernel == "dq" else 2
    nbytes = (4 + n_out) * b * s * h * d * item + 2 * b * h * s * 4
    flops = (6 if kernel == "dq" else 8) * b * h * s * s * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def backward_kernel_phase():
    """K2 and K3 against their plain version at the paths' shapes, the
    autograd Function against autograd through the plain forward, and their
    times at the training shape and at 256 px batch 8."""
    import torch
    import torch.nn.functional as F
    from joligen_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    inputs, checks = {}, []
    for shape, name in BWD_CHECKS:
        dtype = getattr(torch, name)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(o, do)
        scale = shape[-1] ** -0.5
        inputs[(shape, name)] = (q, k, v, do, lse, delta, scale)
        dq = fa._launch_bwd_dq(q, k, v, lse, delta, do, scale)
        dk, dv = fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, lse, delta, do,
                                                scale)
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip((dq, dk, dv), want)]
        rec = {"shape": list(shape), "dtype": name, "max_abs_err_dq": errs[0],
               "max_abs_err_dk": errs[1], "max_abs_err_dv": errs[2],
               "tol": TOL[name]}
        checks.append(rec)
        log(f"K2/K3 check {shape} {name}: err dq {errs[0]:.3e} dk "
            f"{errs[1]:.3e} dv {errs[2]:.3e} (tol {TOL[name]})")
        if max(errs) > TOL[name]:
            raise AssertionError(f"K2/K3 disagree with their plain version "
                                 f"at {shape} {name}")

    # the autograd Function on q/k/v column slices of a fused projection,
    # as AttentionBlock calls it, against autograd through the plain forward
    autograd_errs = {}
    b, s, h, d = TRAIN_SHAPE
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev).to(
            dtype).requires_grad_()
        do = torch.randn(TRAIN_SHAPE, generator=gen, device=dev).to(dtype)

        def grad(attn):
            q, k, v = (t.reshape(b, s, h, d)
                       for t in torch.split(qkv, h * d, dim=-1))
            return torch.autograd.grad(attn(q, k, v), qkv, do)[0]
        got = grad(fa.flash_attention)
        want = grad(lambda q, k, v: fa.flash_attention_reference(q, k, v)[0])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        autograd_errs[name] = err
        log(f"autograd Function vs autograd through the plain forward "
            f"{TRAIN_SHAPE} {name}: max abs err {err:.3e} (tol {TOL[name]})")
        if err > TOL[name]:
            raise AssertionError("FlashAttention gradients disagree")

    timings = {}
    for label, shape, iters in (("128px_batch8", TRAIN_SHAPE, 100),
                                ("256px_batch8", BIG_SHAPE, 10)):
        q, k, v, do, lse, delta, scale = inputs[(shape, "bfloat16")]
        dq = torch.empty_like(q)
        dkv = (torch.empty_like(q), torch.empty_like(q))
        # the kernels alone (outputs allocated once), then through their
        # launch wrappers (checks and allocation on the host every call)
        ms_dq = time_ms(lambda: fa._launch_bwd_dq(q, k, v, lse, delta, do,
                                                  scale, dq), iters)
        ms_dkv = time_ms(lambda: fa._launch_bwd_dkv(q, k, v, lse, delta, do,
                                                    scale, dkv), iters)
        w_dq = time_ms(lambda: fa._launch_bwd_dq(q, k, v, lse, delta, do,
                                                 scale), iters)
        w_dkv = time_ms(lambda: fa._launch_bwd_dkv(q, k, v, lse, delta, do,
                                                   scale), iters)
        plain = time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, lse, delta, do, scale), iters)
        # library: scaled_dot_product_attention's backward, as its
        # forward + backward time less its forward time (B, H, S, D inputs)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                      iters)
        fwd_bwd = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh), (qh, kh, vh), doh),
            iters)
        rec = {"shape": list(shape), "dtype": "bfloat16", "dq_ms": ms_dq,
               "dkv_ms": ms_dkv, "dq_wrapper_ms": w_dq,
               "dkv_wrapper_ms": w_dkv, "plain_ms": plain,
               "library_fwd_ms": fwd, "library_fwd_bwd_ms": fwd_bwd,
               "library_bwd_ms": fwd_bwd - fwd}
        for kern in ("dq", "dkv"):
            rec[kern + "_bound_ms"], rec[kern + "_bound_by"] = \
                backward_bound_ms(shape, "bfloat16", kern)
        timings[label] = rec
        log(f"K2 time {label} {shape} bf16: kernel {ms_dq:.4f} ms, wrapper "
            f"{w_dq:.4f} ms, bound {rec['dq_bound_ms']:.5f} ms "
            f"({rec['dq_bound_by']})")
        log(f"K3 time {label} {shape} bf16: kernel {ms_dkv:.4f} ms, wrapper "
            f"{w_dkv:.4f} ms, bound {rec['dkv_bound_ms']:.5f} ms "
            f"({rec['dkv_bound_by']})")
        log(f"backward {label}: plain (dq, dk, dv together) {plain:.4f} ms; "
            f"sdpa fwd+bwd {fwd_bwd:.4f} ms - fwd {fwd:.4f} ms = bwd "
            f"{fwd_bwd - fwd:.4f} ms")

    main = next(r for r in checks if r["shape"] == list(TRAIN_SHAPE)
                and r["dtype"] == "bfloat16")
    t = timings["128px_batch8"]
    out = []
    for kern, name, line, errs in (
            ("dq", "flash_attention_bwd_dq", 114, ("max_abs_err_dq",)),
            ("dkv", "flash_attention_bwd_dkv", 143,
             ("max_abs_err_dk", "max_abs_err_dv"))):
        out.append({
            "name": name, "route": "cuda",
            "source": "joligen_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"joligen_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(main[e] for e in errs),
            "ms": t[kern + "_ms"], "wrapper_ms": t[kern + "_wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t[kern + "_bound_ms"],
            "bound_by": t[kern + "_bound_by"],
            "library_ms": t["library_bwd_ms"],
            "shape": "(8, 256, 16, 32) bf16: 128 px, batch 8",
            "plain_and_library_compute": "dq, dk and dv together",
            "at_256px_batch8": timings["256px_batch8"], "checks": checks,
            "autograd_max_abs_err": autograd_errs})
    return out


def reset_launches():
    from joligen_tpu_torch.ops import flash_attention as fa
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0


def read_launches():
    from joligen_tpu_torch.ops import flash_attention as fa
    return dict(fa.LAUNCHES)


def write_dataset(root, n, size):
    """A synthetic dataset in the self_supervised_labeled_mask layout:
    trainA/imgs/*.png, trainA/masks/*.png (a rectangle of label 1) and
    trainA/paths.txt lines 'img cls mask', paths relative to ``root``."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(SEED + 2)
    for sub in ("imgs", "masks"):
        os.makedirs(os.path.join(root, "trainA", sub))
    yy, xx = np.mgrid[0:size, 0:size]
    lines = []
    for i in range(n):
        base = np.stack([xx * 2, yy * 2, (xx + yy)], -1) + rng.integers(
            0, 128, 3)
        img = np.clip(base + rng.normal(0, 15, base.shape), 0, 255).astype(
            np.uint8)
        mask = np.zeros((size, size), np.uint8)
        x0, y0 = rng.integers(8, size // 2, 2)
        w, h = rng.integers(size // 6, size // 3, 2)
        mask[y0:y0 + h, x0:x0 + w] = 1
        ipath = f"trainA/imgs/{i:03d}.png"
        mpath = f"trainA/masks/{i:03d}.png"
        Image.fromarray(img).save(os.path.join(root, ipath))
        Image.fromarray(mask).save(os.path.join(root, mpath))
        lines.append(f"{ipath} 0 {mpath}")
    with open(os.path.join(root, "trainA", "paths.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def training_phase(workdir):
    """The port's train entry point on the example config at full width:
    16 steps; launch counts, loss, attention gradients, EMA, step time,
    memory; then one DDIM-10 request served from the trained checkpoint."""
    import numpy as np
    import torch
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import load_model_from_file
    from joligen_tpu_torch.train import launch_training

    with open(EXAMPLE) as f:
        cfg = json.load(f)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    size = opt.data_crop_size
    dataroot = os.path.join(workdir, "train_data")
    write_dataset(dataroot, TRAIN_IMAGES, size)
    opt.dataroot = dataroot
    opt.checkpoints_dir = os.path.join(workdir, "train_ckpt")
    opt.name = "smoke_train"
    opt.train_n_epochs, opt.train_n_epochs_decay = TRAIN_EPOCHS, 0
    opt.output_print_freq = opt.train_batch_size        # every step
    steps = TRAIN_EPOCHS * TRAIN_IMAGES // opt.train_batch_size

    marks, losses, ema_prev = [], [], {}

    def on_step(model, iters):
        torch.cuda.synchronize()
        marks.append((iters, time.perf_counter()))
        losses.append(float(model.loss_log["G_tot"]))
        if iters == (steps - 1) * opt.train_batch_size:
            ema_prev.update({k: v.detach().clone() for k, v in
                             model.ema_nets["G_A"].state_dict().items()})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()                                 # main path starts here
    t0 = time.perf_counter()
    model = launch_training(opt, step_callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                       # main path ends here
    peak = torch.cuda.max_memory_allocated()

    n_params = model.param_count()["G_A"]
    if n_params != EXPECTED_PARAMS or model.device_dtype != torch.bfloat16:
        raise AssertionError(f"trained {n_params} parameters in "
                             f"{model.device_dtype}")
    if len(marks) != steps or any(n != steps for n in launches.values()):
        raise AssertionError(f"{len(marks)} steps, launches {launches}; "
                             f"expected {steps} of each kernel")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    # qkv's gradient reaches it only through K2/K3: a non-zero second moment
    # means some step's gradient was non-zero
    tx = model.states["G_A"].tx
    nu = dict(zip(tx.names, tx.nu))
    qkv_nu = nu["inner.AttentionBlock_0.qkv.weight"].abs().max().item()
    if not qkv_nu > 0:
        raise AssertionError("no gradient reached AttentionBlock_0/qkv")
    # the last step's EMA is the lerp of the one before and the parameters
    beta = model.ema_beta
    params = model.nets["G_A"].state_dict()
    ema = model.ema_nets["G_A"].state_dict()
    lerp_err = max((ema[k] - (beta * ema_prev[k] + (1 - beta) * params[k]))
                   .abs().max().item() for k in ema)
    ema_gap = max((ema[k] - params[k]).abs().max().item() for k in ema)
    if not (lerp_err <= 1e-6 and ema_gap > 0):
        raise AssertionError(f"EMA is not the lerp: err {lerp_err}, gap "
                             f"{ema_gap}")
    # warm steps: the step after another in the same epoch (the first of
    # an epoch waits for the loader and follows the epoch's saves)
    per_epoch = steps // TRAIN_EPOCHS
    warm = [t1 - t0 for (i0, t0), (i1, t1) in zip(marks, marks[1:])
            if (i1 // opt.train_batch_size - 1) % per_epoch != 0]
    step_s = float(np.median(warm))
    rec = {"steps": steps, "launches": launches, "loss_first": losses[0],
           "loss_last": losses[-1], "median_warm_step_s": step_s,
           "warm_steps": len(warm),
           "images_per_s": opt.train_batch_size / step_s,
           "max_memory_allocated": peak, "wall_s": wall,
           "qkv_nu_max": qkv_nu, "ema_lerp_max_err": lerp_err,
           "ema_param_max_gap": ema_gap}
    log(f"training: {steps} steps, launches {launches}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, median warm step "
        f"{step_s * 1e3:.1f} ms ({opt.train_batch_size / step_s:.1f} "
        f"images/s), max_memory_allocated {peak} B, whole run {wall:.1f} s")
    del model
    torch.cuda.empty_cache()

    # the two slices meet: serve one DDIM-10 request from the trained latest
    img = _write_inputs(workdir)
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    served, sopt = load_model_from_file(ckpt)
    args = gen.build_parser().parse_args([
        "--model_in_file", ckpt,
        "--img_in", os.path.join(workdir, "img.png"),
        "--mask_in", os.path.join(workdir, "mask.png"),
        "--dir_out", os.path.join(workdir, "out_trained"), "--name", "req",
        "--sampling_method", "ddim", "--seed", "0"])
    reset_launches()
    t0 = time.perf_counter()
    full, _, _ = gen.inference(args, lmodel=served, lopt=sopt)
    torch.cuda.synchronize()
    rec["trained_request_s"] = time.perf_counter() - t0
    rec["trained_request_launches"] = read_launches()
    if rec["trained_request_launches"]["flash_attention_fwd"] != 10 or not (
            full.shape == img.shape and np.isfinite(full).all()):
        raise AssertionError("DDIM-10 request from the trained checkpoint "
                             "failed")
    log(f"trained checkpoint: DDIM-10 request {rec['trained_request_s']:.3f}"
        f" s, launches {rec['trained_request_launches']}")
    del served
    torch.cuda.empty_cache()
    return rec


def gradient_cross_check():
    """One fp32 training step of the full-width denoiser, batch 2: every
    parameter gradient on the card (K1-K3) against the CPU (plain
    versions), same weights, batch and draws, TF32 off."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.models.modules.palette_diffusion import \
        continuous_gammas
    from joligen_tpu_torch.options import TrainOptions

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(EXAMPLE) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.tpu_bf16 = False
    size = opt.data_crop_size
    rng = np.random.default_rng(SEED + 9)
    gt = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    mask = np.zeros((2, size, size, 1), np.int32)
    mask[0, 20:90, 30:100] = 1
    mask[1, 50:120, 10:60] = 1
    batch = {"A": np.where(mask > 0, 0.0, gt).astype(np.float32), "B": gt,
             "B_label_mask": mask}
    t = rng.integers(1, opt.G_diff_n_timestep_train, 2)
    u = rng.uniform(0, 1, 2).astype(np.float32)
    noise = rng.standard_normal(gt.shape).astype(np.float32)
    grads, state = {}, None
    for dev in ("cuda", "cpu"):
        model = create_model(copy.copy(opt), phase="test", device=dev)
        net = model.nets["G_A"].requires_grad_(True)
        if state is None:
            init_weights(net, torch.Generator().manual_seed(SEED + 3),
                         zero_init_std=0.01)
            state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        tt = torch.from_numpy(t).to(dev)
        draws = {"t": tt, "noise": torch.from_numpy(noise).to(dev),
                 "gammas": continuous_gammas(model.sched_train, tt,
                                             torch.from_numpy(u).to(dev))}
        reset_launches()
        loss = model._loss_fn(model.prepare_batch(batch), draws)
        names, params = zip(*net.named_parameters())
        g = torch.autograd.grad(loss, params)
        launched = read_launches()
        want = 1 if dev == "cuda" else 0
        if any(n != want for n in launched.values()):
            raise AssertionError(f"{dev} step launched {launched}")
        grads[dev] = {n: x.detach().float().cpu() for n, x in zip(names, g)}
        grads[dev + "_loss"] = loss.item()
        del model, net
    scale = max(v.abs().max().item() for v in grads["cpu"].values())
    worst_abs, worst_leaf, worst_name = 0.0, 0.0, ""
    for n, ref in grads["cpu"].items():
        diff = (grads["cuda"][n] - ref).abs().max().item()
        rel = diff / max(ref.abs().max().item(), 1e-30)
        worst_abs = max(worst_abs, diff)
        if rel > worst_leaf:
            worst_leaf, worst_name = rel, n
    rec = {"leaves": len(grads["cpu"]), "max_abs_err": worst_abs,
           "max_abs_grad": scale, "max_abs_err_over_max_grad":
           worst_abs / scale, "worst_leaf_rel_err": worst_leaf,
           "worst_leaf": worst_name, "loss_cuda": grads["cuda_loss"],
           "loss_cpu": grads["cpu_loss"],
           "tol_global": GRAD_TOL_GLOBAL, "tol_leaf": GRAD_TOL_LEAF}
    log("gradient cross-check fp32 step card vs CPU: " + json.dumps(rec))
    if not (rec["leaves"] == EXPECTED_LEAVES
            and worst_abs <= GRAD_TOL_GLOBAL * scale
            and worst_leaf <= GRAD_TOL_LEAF
            and abs(rec["loss_cuda"] - rec["loss_cpu"])
            <= 1e-4 * abs(rec["loss_cpu"])):
        raise AssertionError("card and CPU training gradients disagree")
    return rec


def _write_inputs(d):
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:256, 0:256]
    base = np.stack([xx, yy, (xx + yy) // 2], -1).astype(np.float32)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)
    mask = np.zeros((256, 256), np.uint8)
    mask[64:192, 80:176] = 255
    Image.fromarray(img).save(os.path.join(d, "img.png"))
    Image.fromarray(mask).save(os.path.join(d, "mask.png"))
    return img


def _expected_crop(img, size):
    """The uint8-quantised input crop as the model decodes it (float32)."""
    import numpy as np
    from PIL import Image
    from joligen_tpu_torch.models.base import quantize_batch
    from joligen_tpu_torch.scripts.common import to_m1p1
    crop = to_m1p1(np.asarray(Image.fromarray(img).resize(
        (size, size), Image.BICUBIC)))
    q = quantize_batch({"x": crop}, float_keys=("x",))["x"]
    return q.astype(np.float32) / np.float32(127.5) - np.float32(1.0)


def slice_phase(workdir):
    """Serve DDIM-10 and DDPM requests at full width through the script."""
    import numpy as np
    import torch
    from PIL import Image
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.ops import flash_attention as fa
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import load_model_from_file, \
        to_uint8

    with open(EXAMPLE) as f:
        cfg = json.load(f)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    ckpt = os.path.join(workdir, "ckpt")
    os.makedirs(ckpt)
    model = create_model(opt, phase="test")
    # random weights from the seed; the zero-initialised output layers get
    # small values too, or the attention branch would be multiplied by zero
    init_weights(model.nets["G_A"], torch.Generator().manual_seed(SEED),
                 zero_init_std=0.01)
    init_weights(model.ema_nets["G_A"],
                 torch.Generator().manual_seed(SEED + 1), zero_init_std=0.01)
    n_params = model.param_count()["G_A"]
    log(f"slice: palette unet_mha {opt.data_crop_size}px ngf {opt.G_ngf}, "
        f"{n_params} parameters, compute {model.device_dtype}")
    if n_params != EXPECTED_PARAMS:
        raise AssertionError(f"unexpected parameter count {n_params}")
    model.save_dir = ckpt
    model.save_networks("latest")
    with open(os.path.join(ckpt, "train_config.json"), "w") as f:
        json.dump(cfg, f)
    ema_state = {k: v.detach().cpu()
                 for k, v in model.ema_nets["G_A"].state_dict().items()}
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, opt = load_model_from_file(os.path.join(ckpt,
                                                   "latest_net_G_A.pth"))
    log(f"slice: checkpoint reloaded in {time.perf_counter() - t0:.3f} s")
    for k, v in model.ema_nets["G_A"].state_dict().items():
        if not torch.equal(v.cpu(), ema_state[k]):
            raise AssertionError(f"reloaded EMA differs at {k}")

    img = _write_inputs(workdir)
    size = opt.data_crop_size
    expect = _expected_crop(img, size)
    keep = np.asarray(Image.open(os.path.join(workdir, "mask.png")).convert(
        "L").resize((size, size), Image.NEAREST)) == 0

    outputs = []
    infer = model.inference

    def recording_inference(*a, **kw):
        out = infer(*a, **kw)
        outputs.append(out)
        return out
    model.inference = recording_inference

    requests = ([("ddim", i) for i in range(DDIM_REQUESTS)]
                + [("ddpm", DDIM_REQUESTS)])
    expected_launches = {"ddim": 10, "ddpm": opt.G_diff_n_timestep_test}
    report = []
    reset_launches()                             # main path starts here
    for method, seed in requests:
        out_dir = os.path.join(workdir, f"out_{method}_{seed}")
        args = gen.build_parser().parse_args([
            "--model_in_file", os.path.join(ckpt, "latest_net_G_A.pth"),
            "--img_in", os.path.join(workdir, "img.png"),
            "--mask_in", os.path.join(workdir, "mask.png"),
            "--dir_out", out_dir, "--name", "req",
            "--sampling_method", method, "--seed", str(seed)])
        torch.cuda.reset_peak_memory_stats()
        before = fa.LAUNCHES["flash_attention_fwd"]
        t0 = time.perf_counter()
        gen.inference(args, lmodel=model, lopt=opt)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        launches = fa.LAUNCHES["flash_attention_fwd"] - before
        peak = torch.cuda.max_memory_allocated()
        out = outputs[-1][0]
        crop_png = np.asarray(Image.open(os.path.join(
            out_dir, "req_generated_crop.png")))
        ok_finite = bool(np.isfinite(out).all()) and out.shape == (
            size, size, 3)
        # The card divides by 127.5 as a multiply by its fp32 reciprocal, an
        # ulp or two off numpy's division; the PNG truncates, so that ulp
        # can move a pixel by one level.
        png_diff = np.abs(crop_png[keep].astype(np.int16)
                          - to_uint8(expect)[keep].astype(np.int16))
        ok_keep = bool(np.abs(out[keep] - expect[keep]).max() <= 1e-6
                       and np.array_equal(crop_png, to_uint8(out))
                       and png_diff.max() <= 1)
        rec = {"method": method, "seed": seed, "latency_s": latency,
               "k1_launches": launches, "max_memory_allocated": peak,
               "finite": ok_finite, "outside_mask_equals_input": ok_keep}
        report.append(rec)
        log(f"request {method} seed {seed}: {latency:.3f} s, K1 launches "
            f"{launches}, max_memory_allocated {peak} B, finite {ok_finite}, "
            f"outside mask equals input {ok_keep}")
        if launches != expected_launches[method]:
            raise AssertionError(f"{method}: {launches} K1 launches, "
                                 f"expected {expected_launches[method]}")
        if not (ok_finite and ok_keep):
            raise AssertionError(f"{method} request output check failed")
    main_launches = read_launches()              # main path ends here
    if main_launches["flash_attention_bwd_dq"] or \
            main_launches["flash_attention_bwd_dkv"]:
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{main_launches}")
    log("slice: " + json.dumps({"requests": report}))
    return model, main_launches


def cross_check(model):
    """The full-width denoiser in fp32: card (with K1) against the CPU
    (plain attention), same weights and inputs."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import define_G
    from joligen_tpu_torch.ops import flash_attention as fa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    opt32 = copy.copy(model.opt)
    opt32.tpu_bf16 = False
    state = {k: v.detach().cpu()
             for k, v in model.ema_nets["G_A"].state_dict().items()}
    rng = np.random.default_rng(SEED + 7)
    size = opt32.data_crop_size
    x = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 6)).astype(
        np.float32))
    gam = torch.tensor([0.37], dtype=torch.float32)
    mask = torch.zeros(1, size, size, 1, dtype=torch.int32)
    mask[:, 32:96, 40:88] = 1
    outs = {}
    for dev in ("cuda", "cpu"):
        net = define_G(opt32)
        net.load_state_dict(state)
        net = net.to(dev).eval()
        before = fa.LAUNCHES["flash_attention_fwd"]
        with torch.inference_mode():
            outs[dev] = net(x.to(dev), gam.to(dev),
                            mask=mask.to(dev)).float().cpu()
        launched = fa.LAUNCHES["flash_attention_fwd"] - before
        if launched != (1 if dev == "cuda" else 0):
            raise AssertionError(f"{dev} forward launched K1 {launched} "
                                 "times")
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    log(f"cross-check fp32 denoiser card vs CPU: max abs err {err:.3e} "
        f"(output max {scale:.3e}, tol {CROSS_CHECK_TOL})")
    if not (torch.isfinite(outs["cuda"]).all() and err <= CROSS_CHECK_TOL):
        raise AssertionError("card and CPU denoisers disagree")
    return err


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from joligen_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build(["flash_attention_fwd", "flash_attention_bwd"])
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (secs, ptxas) in built.items():
        log(f"build {name}: nvcc {secs:.2f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    k1 = kernel_phase()
    k2, k3 = backward_kernel_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        model, serving = slice_phase(workdir)
        k1["cross_check_fp32_max_abs_err"] = cross_check(model)
        del model
        training = training_phase(workdir)
    grad_check = gradient_cross_check()
    paths = {"serving": serving, "training": training["launches"],
             "trained_checkpoint_request":
                 training["trained_request_launches"]}
    for k in (k1, k2, k3):
        per_path = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(per_path.values())
        k["launches_per_path"] = per_path
    log("training: " + json.dumps(training))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    k1["training_gradient_cross_check"] = grad_check
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
