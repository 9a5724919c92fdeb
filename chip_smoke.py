#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``joligen_tpu_torch``) on one NVIDIA
GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: compiles every kernel of the serving path from ``csrc/``.
3. Kernels: each kernel against its plain PyTorch version on the same CUDA
   tensors at the path's shapes, with its time, its bound, the plain
   version's time and one library call's time as a yardstick.
4. Slice: palette inpainting at the full width of
   ``examples/example_ddpm_noglasses2glasses.json`` (128 px, ngf 64, 62.8M
   parameters, bf16) with seeded random weights, saved and reloaded through
   the checkpoint files, serving DDIM-10 and DDPM-1000 requests through
   ``scripts/gen_single_image_diffusion.inference``; launch counts per
   request; outputs checked; the full-width denoiser in fp32 on the card
   against the same forward on the CPU.

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
    fa.LAUNCHES["flash_attention_fwd"] = 0       # main path starts here
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
    main_launches = fa.LAUNCHES["flash_attention_fwd"]   # main path ends
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
    built = _build.build(["flash_attention_fwd"])
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (secs, ptxas) in built.items():
        log(f"build {name}: nvcc {secs:.2f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    k1 = kernel_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        model, launches = slice_phase(workdir)
    k1["launches"] = launches
    k1["cross_check_fp32_max_abs_err"] = cross_check(model)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
