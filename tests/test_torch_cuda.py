"""Kernels K1 (csrc/flash_attention_fwd.cu), K2 and K3
(csrc/flash_attention_bwd.cu), P1 and P2 (csrc/conv3x3_tap.cu) and P3
(csrc/dma_copy.cu) on the card, against their plain PyTorch versions, each
dtype on its route (``ROUTES``); one
training step of a small palette model counting one launch of each attention
kernel, one of an online bbox-crop batch with and without remat, and one
bf16 CycleGAN step with unet_256 Gs against fp32 on the CPU, and one
bf16 ReCycleGAN step (its unet_128 P nets) against fp32 on the CPU, and
the semantic networks' card-vs-CPU check (bf16 CUT steps with the basic
and resnet18 C and the mask D, fp32 VGG16-FCN8s); and one run of each
probe counting its kernels' launches. Marked
``cuda``: they skip without a CUDA device. This file imports neither jax nor
the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from joligen_tpu_torch.ops import conv3x3
from joligen_tpu_torch.ops import copy as dma
from joligen_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# ragged S and B*H at the edges of the bf16 kernels' 64-row tiles (S of 1,
# 63, 65, 100 and 1000; B*H of 3), at each head dim
EDGE_SHAPES = [(3, 1, 1, 16), (1, 63, 3, 64), (3, 65, 1, 16),
               (1, 1000, 3, 64)]
# xview's mid block (32 heads of 32) at 128 px: a request and a batch-16 step
XVIEW_SHAPES = [(1, 256, 32, 32), (16, 256, 32, 32)]
# the unet GAN generators' middle block at 256 px, batch 4 (CycleGAN and
# CUT with unet_256 or unet_mha)
GAN_SHAPE = (4, 1024, 16, 32)
SHAPES = [(2, 128, 2, 64), (2, 256, 1, 32), (2, 100, 2, 64), (2, 5, 2, 16),
          (1, 256, 16, 32), (8, 96, 12, 64), GAN_SHAPE, *XVIEW_SHAPES,
          *EDGE_SHAPES]
# the backward checks of chip_smoke.py: the training shape, batch 1, 256 px
# batch 8, and ragged ones
BWD_CHECKS = [((8, 256, 16, 32), torch.bfloat16),
              ((8, 256, 16, 32), torch.float32),
              ((1, 256, 16, 32), torch.bfloat16),
              ((8, 1024, 16, 32), torch.bfloat16),
              (GAN_SHAPE, torch.bfloat16), (GAN_SHAPE, torch.float32),
              ((2, 100, 2, 64), torch.float32),
              ((2, 5, 2, 16), torch.float32),
              ((2, 160, 2, 16), torch.bfloat16),
              ((2, 100, 2, 64), torch.bfloat16),
              *((shape, torch.bfloat16) for shape in XVIEW_SHAPES),
              *((shape, torch.bfloat16) for shape in EDGE_SHAPES)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# head dim 8 and short sequences (the motion modules of unet_vid: S of 8
# and 6 frames, 8 heads, D of 8 to 64), with ragged sequence counts and S
# of 1, 3, 17 and 32 at the packed tiling's edges; head dim 96 (the token
# motion module of vit_vid over 8 frames, ragged ones); head dims 80, 128
# and 160 (JiT-H's blocks, JiT-L's and MAT's 4-head motion modules,
# JiT-H's motion module), ragged
SHORT_SHAPES = [(64, 8, 8, 8), (37, 6, 8, 8), (5, 8, 8, 64), (3, 6, 8, 32),
                (7, 8, 3, 16), (2, 1, 3, 8), (3, 3, 5, 8), (2, 17, 3, 16),
                (3, 32, 2, 8), (2, 100, 2, 8), (1, 33, 3, 8),
                (64, 8, 8, 96), (5, 7, 3, 96), (3, 100, 2, 96),
                (3, 5, 3, 80), (2, 70, 3, 80), (7, 8, 3, 128),
                (2, 100, 3, 128), (5, 8, 3, 160), (2, 65, 3, 160)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(shape, g, dtype, n):
    return [torch.randn(shape, generator=g, device=g.device).to(dtype)
            for _ in range(n)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(cuda, shape, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = _randn(shape, g, dtype, 3)
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES + [(8, 1024, 16, 32)])
@pytest.mark.parametrize("q_tile", fa.Q_TILES)
def test_bf16_forward_matches_plain_version_at_each_query_tiling(
        cuda, shape, q_tile):
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + q_tile)
    q, k, v = _randn(shape, g, torch.bfloat16, 3)
    o, lse = fa._launch(q, k, v, shape[-1] ** -0.5, q_tile=q_tile)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", SHORT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiling", fa.TILINGS)
def test_short_sequences_and_head_dim_8_match_plain_version(
        cuda, shape, dtype, tiling):
    # K1, K2 and K3 at D = 8 (and 96) and S <= 32 in both routes and both
    # tilings
    # (the packed one only where S <= 32), strided as the motion module's
    # q, k, v are not: a fused projection's column slices
    if tiling == "packed" and shape[1] > fa.PACK_MAX_S:
        with pytest.raises(ValueError, match="packed"):
            fa._pack_arg(torch.empty(shape), tiling)
        return
    n, s, h, d = shape
    tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 3)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.reshape(shape) for t in torch.split(qkv, h * d, -1))
    (do,) = _randn(shape, g, dtype, 1)
    scale = d ** -0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa._launch(q, k, v, scale, tiling=tiling)
    delta = fa.attention_delta(o, do)
    dq = fa._launch_bwd_dq(q, k, v, lse, delta, do, scale, tiling=tiling)
    dk, dv = fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale,
                                tiling=tiling)
    torch.cuda.synchronize()
    assert all(fa.LAUNCHES[name] == before[name] + 1 for name in fa.LAUNCHES)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    bwd_tol = 5e-4 if dtype == torch.float32 else tol
    want = fa.flash_attention_bwd_reference(q, k, v, lse, delta, do, scale)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == shape
        torch.testing.assert_close(got.float(), ref.float(), atol=bwd_tol,
                                   rtol=bwd_tol)


def _kernel_names(fn, attempts=4):
    """The device kernels of one call of ``fn``, after a traced warm-up call
    (the trace misses launches at its very start). A trace that lost the
    call's launch altogether is taken again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if names:
            return names
    return names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_dtype_takes_its_route(cuda, dtype):
    # bf16: K1, K2 and K3 on wgmma; fp32: all three on FMAs
    name = str(dtype).split(".")[-1]
    q, k, v, do = (torch.randn(2, 100, 2, 32, device=cuda).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    kernels = {"flash_attention_fwd": (
                   lambda: fa.flash_attention_fwd(q, k, v),
                   {"wgmma": "flash_fwd_wgmma_kernel",
                    "fma": "flash_fwd_kernel<"}),
               "flash_attention_bwd_dq": (
                   lambda: fa._launch_bwd_dq(q, k, v, lse, delta, do, 0.2),
                   {"wgmma": "flash_bwd_dq_wgmma_kernel",
                    "fma": "flash_bwd_dq_kernel<"}),
               "flash_attention_bwd_dkv": (
                   lambda: fa._launch_bwd_dkv(q, k, v, lse, delta, do, 0.2),
                   {"wgmma": "flash_bwd_dkv_wgmma_kernel",
                    "fma": "flash_bwd_dkv_kernel<"})}
    for kernel, (call, by_route) in kernels.items():
        names = _kernel_names(call)
        want = by_route[fa.ROUTES[kernel][name]]
        assert len(names) == 1 and want in names[0], (kernel, names)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_short_sequences_take_the_packed_kernels(cuda, dtype):
    # S = 8 at D = 8: each of K1, K2 and K3 launches its packed kernel on
    # its dtype's route
    name = str(dtype).split(".")[-1]
    q, k, v, do = (torch.randn(64, 8, 8, 8, device=cuda).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    kernels = {"flash_attention_fwd": (
                   lambda: fa.flash_attention_fwd(q, k, v),
                   {"wgmma": "flash_fwd_wgmma_packed_kernel",
                    "fma": "flash_fwd_packed_kernel<"}),
               "flash_attention_bwd_dq": (
                   lambda: fa._launch_bwd_dq(q, k, v, lse, delta, do, 0.3),
                   {"wgmma": "flash_bwd_dq_wgmma_packed_kernel",
                    "fma": "flash_bwd_dq_packed_kernel<"}),
               "flash_attention_bwd_dkv": (
                   lambda: fa._launch_bwd_dkv(q, k, v, lse, delta, do, 0.3),
                   {"wgmma": "flash_bwd_dkv_wgmma_packed_kernel",
                    "fma": "flash_bwd_dkv_packed_kernel<"})}
    for kernel, (call, by_route) in kernels.items():
        names = _kernel_names(call)
        want = by_route[fa.ROUTES[kernel][name]]
        assert len(names) == 1 and want in names[0], (kernel, names)


@pytest.mark.parametrize("shape,dtype", BWD_CHECKS)
def test_backward_kernels_match_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    q, k, v, do = _randn(shape, g, dtype, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    scale = shape[-1] ** -0.5
    before = dict(fa.LAUNCHES)
    dq = fa._launch_bwd_dq(q, k, v, lse, delta, do, scale)
    dk, dv = fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    assert fa.LAUNCHES["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    want = fa.flash_attention_bwd_reference(q, k, v, lse, delta, do, scale)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == shape
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("shape", [(8, 256, 16, 32), (8, 1024, 16, 32),
                                   (2, 160, 2, 16), (2, 100, 2, 64),
                                   *XVIEW_SHAPES, *EDGE_SHAPES])
@pytest.mark.parametrize("q_tile", fa.Q_TILES)
def test_bf16_dq_backward_matches_plain_version_at_each_query_tiling(
        cuda, shape, q_tile):
    # K2 on wgmma at 64 and 128 queries a block: ragged S of 1, 63, 65, 100,
    # 160 and 1000 against both tilings, head dims 16, 32 and 64
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + q_tile)
    q, k, v, do = _randn(shape, g, torch.bfloat16, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    scale = shape[-1] ** -0.5
    before = fa.LAUNCHES["flash_attention_bwd_dq"]
    dq = fa._launch_bwd_dq(q, k, v, lse, delta, do, scale, q_tile=q_tile)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd_dq"] == before + 1
    want = fa.flash_attention_bwd_reference(q, k, v, lse, delta, do, scale)[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == shape
    torch.testing.assert_close(dq.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_autograd_function_matches_autograd_of_plain_version(cuda):
    # q/k/v as column slices of one fused projection, as AttentionBlock
    # hands them over
    n, s, h, d = 2, 77, 4, 32
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda,
                      requires_grad=True)
    do = torch.randn(n, s, h, d, generator=g, device=cuda)
    before = dict(fa.LAUNCHES)
    q, k, v = (t.reshape(n, s, h, d) for t in torch.split(qkv, h * d, -1))
    (got,) = torch.autograd.grad(fa.flash_attention(q, k, v), qkv, do)
    for name in fa.LAUNCHES:
        assert fa.LAUNCHES[name] == before[name] + 1
    q, k, v = (t.reshape(n, s, h, d) for t in torch.split(qkv, h * d, -1))
    (want,) = torch.autograd.grad(fa.flash_attention_reference(q, k, v)[0],
                                  qkv, do)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # inference launches the forward alone
    with torch.inference_mode():
        fa.flash_attention(q.detach(), k.detach(), v.detach())
    assert fa.LAUNCHES["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1


@pytest.mark.parametrize("shape,dtype", [((2, 77, 4, 32), torch.float32),
                                         ((8, 256, 16, 32), torch.bfloat16)])
def test_kernel_reads_strided_slices(cuda, shape, dtype):
    # q/k/v as column slices of one fused projection (row stride 3 H D), in
    # fp32 and at the training shape in bf16; forward and gradients
    n, s, h, d = shape
    tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(s)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(
        dtype).requires_grad_()
    do = torch.randn(shape, generator=g, device=cuda).to(dtype)

    def run(attn):
        q, k, v = (t.reshape(shape) for t in torch.split(qkv, h * d, -1))
        o = attn(q, k, v)
        return o, torch.autograd.grad(o, qkv, do)[0]
    o, grad = run(fa.flash_attention)
    ref, ref_grad = run(lambda q, k, v: fa.flash_attention_reference(
        q, k, v)[0])
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(grad.float(), ref_grad.float(), atol=tol,
                               rtol=tol)


def test_dq_kernel_matches_plain_version_on_the_wgmma_forward_lse(cuda):
    # K2's bf16 route reads the lse that K1's bf16 route writes, both on
    # wgmma
    for shape in ((8, 256, 16, 32), (1, 1000, 3, 64)):
        g = torch.Generator(device=cuda).manual_seed(sum(shape) + 7)
        q, k, v, do = _randn(shape, g, torch.bfloat16, 4)
        o, lse = fa.flash_attention_fwd(q, k, v)
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
        torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)
        scale = shape[-1] ** -0.5
        dq = fa._launch_bwd_dq(q, k, v, lse, fa.attention_delta(o, do), do,
                               scale)
        torch.cuda.synchronize()
        for lse_, o_ in ((lse, o), (ref_lse, ref_o)):
            want = fa.flash_attention_bwd_reference(
                q, k, v, lse_, fa.attention_delta(o_, do), do, scale)[0]
            torch.testing.assert_close(dq.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)


def test_bf16_route_refuses_unaligned_inputs(cuda):
    n, s, h, d = 1, 8, 2, 16
    good = torch.randn(n, s, h, d, device=cuda, dtype=torch.bfloat16)
    flat = torch.randn(n * s * h * d + 1, device=cuda, dtype=torch.bfloat16)
    off_by_2 = flat[1:].view(n, s, h, d)           # base pointer 2 bytes off
    padded = torch.randn(n, s, h * d + 4, device=cuda, dtype=torch.bfloat16)
    odd_rows = padded[..., :h * d].unflatten(-1, (h, d))  # 72-byte rows
    o, lse = fa.flash_attention_fwd(good, good, good)
    delta = fa.attention_delta(o, good)
    for bad in (off_by_2, odd_rows):
        with pytest.raises(ValueError, match="aligned"):
            fa.flash_attention(bad, good, good)
        with pytest.raises(ValueError, match="aligned"):
            fa._launch_bwd_dkv(good, good, bad, lse, delta, good, 0.25)
    # the fp32 route takes rows that are not 16-byte multiples (132 bytes)
    rows32 = torch.randn(n, s, h * d + 1, device=cuda)[..., :h * d].unflatten(
        -1, (h, d))
    torch.testing.assert_close(
        fa.flash_attention(rows32, rows32, rows32),
        fa.flash_attention_reference(rows32, rows32, rows32)[0],
        atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q112 = torch.randn(1, 8, 2, 112, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="still refused"):
        fa.flash_attention(q112, q112, q112)
    q40 = torch.randn(1, 40, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="packed"):
        fa._launch(q40, q40, q40, 0.25, tiling="packed")
    with pytest.raises(ValueError, match="tiling"):
        fa._launch(q40, q40, q40, 0.25, tiling="tiled")
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(*(torch.randn(1, 8, 2, 32, device=cuda,
                                         dtype=torch.float16),) * 3)
    q, k, v, do = (torch.randn(1, 8, 2, 32, device=cuda) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    bad = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_bwd_dq(bad, bad, bad, lse, delta, bad, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_bwd_dkv(bad, bad, bad, lse, delta, bad, 0.1)
    strided = torch.randn(1, 8, 32, 2, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa._launch_bwd_dq(q, k, v, lse, delta, strided, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fa._launch_bwd_dkv(strided, k, v, lse, delta, do, 0.1)
    h16 = q.to(torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa._launch_bwd_dkv(h16, h16, h16, lse, delta, h16, 0.1)


def test_training_step_launches_each_kernel_once(cuda, tmp_path):
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.options import TrainOptions

    cfg = {"model_type": "palette", "name": "cuda_step",
           "checkpoints_dir": str(tmp_path),
           "data": {"crop_size": 32, "load_size": 32},
           "G": {"netG": "unet_mha", "ngf": 32,
                 "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                              "num_head_channels": 32}},
           "alg": {"diffusion": {"task": "inpainting", "cond_embed": "mask",
                                 "cond_embed_dim": 64}},
           "train": {"G_ema": True, "optim": "adamw"}}
    opt = TrainOptions().parse_json(cfg, verbose=False)
    model = create_model(opt, phase="train")
    init_weights(model.nets["G_A"], torch.Generator().manual_seed(0),
                 zero_init_std=0.01)
    rng = np.random.default_rng(0)
    mask = np.zeros((2, 32, 32, 1), np.int32)
    mask[:, 8:24, 8:20] = 1
    batch = {"A": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "B_label_mask": mask}
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    losses = model.optimize_parameters(batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    assert torch.isfinite(losses["G_tot"]).item()


def test_cycle_gan_bf16_step_on_the_card_matches_fp32_cpu(cuda, tmp_path):
    """One CycleGAN step with unet_256 Gs (ngf 16, 64 px: the middle
    block's 4 heads of 32 over 8 x 8 tokens, the plain tiling), bf16 on
    the card against fp32 on the CPU from the same weights and the same
    draws (pools, DiffAugment): K1, K2 and K3 6 times each (3 forwards of
    each G, each with its backward), every loss within 5e-2 of the CPU's
    (relative, at least 1: bf16's 8 bits of mantissa through the step)."""
    import copy

    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.ops.diff_aug import draw_diff_augment
    from joligen_tpu_torch.options import TrainOptions

    cfg = {"model_type": "cycle_gan", "name": "cuda_cycle_gan",
           "checkpoints_dir": str(tmp_path),
           "data": {"crop_size": 64, "load_size": 64},
           "G": {"netG": "unet_256", "ngf": 16},
           "D": {"netDs": ["basic"], "ndf": 16},
           "dataaug": {"diff_aug_policy": "color,cutout"},
           "train": {"batch_size": 2, "pool_size": 4}}
    models = {}
    for dev, bf16 in (("cpu", False), ("cuda", True)):
        opt = TrainOptions().parse_json(copy.deepcopy(cfg), verbose=False)
        opt.tpu_bf16 = bf16
        models[dev] = create_model(opt, phase="train",
                                   device=torch.device(dev))
    for name, net in models["cpu"].nets.items():
        models["cuda"].nets[name].load_state_dict(net.state_dict())
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
             for k in ("A", "B")}
    g = torch.Generator().manual_seed(1)
    m = models["cpu"]
    draws = {"pool_A": m.pool_A.draw_query(g, 2),
             "pool_B": m.pool_B.draw_query(g, 2), "d_real_aug": {},
             "d_fake_aug": {}}
    for sname, _, _ in m.d_names:
        for k in ("d_real_aug", "d_fake_aug"):
            draws[k][sname] = draw_diff_augment(g, (2, 3, 64, 64),
                                                m.diff_policy, m.diff_prob)

    def moved(d, dev):
        if isinstance(d, dict):
            return {k: moved(v, dev) for k, v in d.items()}
        return d.to(dev) if torch.is_tensor(d) else d
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    losses = {}
    for dev, model in models.items():
        losses[dev] = {k: float(v) for k, v in model.optimize_prepared(
            model.prepare_batch(batch), moved(draws, dev)).items()}
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention_fwd": 6,
                           "flash_attention_bwd_dq": 6,
                           "flash_attention_bwd_dkv": 6}
    for k, want in losses["cpu"].items():
        assert abs(losses["cuda"][k] - want) <= 5e-2 * max(1.0, abs(want)), (
            k, losses["cuda"][k], want)


def test_semantic_nets_on_the_card_match_cpu(cuda):
    """The semantic networks' card-vs-CPU check of ``chip_smoke.py``
    (``semantic_cross_check``): a CUT step with the basic C and one with
    the resnet18 C, the gumbel mask D in both (noglasses2glasses at 64 px,
    widths 16, both gates opened), bf16 on the card against fp32 on the
    CPU from the same weights and draws, every loss within 5e-2
    (relative, at least 1); VGG16-FCN8s in fp32, TF32 off, at 64 px under
    both pads within 1e-4 of the largest logit. No kernel of the port
    runs."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before = {n: c for n, c in fa.LAUNCHES.items()}
    rec = smoke.semantic_cross_check()
    assert fa.LAUNCHES == before
    for template in ("basic", "resnet18"):
        assert rec[f"cut_step_{template}_c"]["loss_max_rel_err"] <= 5e-2
    for pad in ("fcn", "same"):
        r = rec[f"vgg_{pad}"]
        assert r["max_abs_err"] <= 1e-4 * r["max_abs_logit"]


def test_recycle_gan_bf16_step_on_the_card_matches_fp32_cpu(cuda, tmp_path,
                                                           monkeypatch):
    """One ReCycleGAN step (resnet_attn Gs and the unet_128 P nets at ngf
    16, 64 px: P's middle block 4 heads of 32 over 8 x 8 tokens; nuplets
    of 3 frames, 2 a batch), bf16 on the card against fp32 on the CPU from
    the same weights and the same draws (pools, DiffAugment), the gate
    open, the P nets redrawn from a seed with their zero-initialised layers
    (``proj_out`` among them) at N(0, 0.02), so that attention adds to P's
    outputs and K2/K3 get a non-zero dO: P_A's loss gradient at its middle
    block's qkv weight no further from the CPU's fp32 one than twice the
    same bf16 pass through the attention's plain version is, plus 5e-2 (of
    the norm; bf16 through the unet alone moves it by 10-15 %), and the
    block's alone, on the input and output gradient of the card's pass,
    within 5e-2 of its plain version; then K1, K2 and K3 4 times each in
    the step (P_A and P_B
    on the real sequences, then on the fakes, each with its backward),
    every loss within 5e-2 of the CPU's (relative, at least 1)."""
    import copy

    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.cut_model import channel_stack
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.models.modules import unet_mha
    from joligen_tpu_torch.ops.diff_aug import draw_diff_augment
    from joligen_tpu_torch.options import TrainOptions

    def plain(q, k, v):
        return fa.flash_attention_reference(q, k, v)[0]

    def p_grad(model, prepared):
        blk, seen = model.nets["P_A"].AttentionBlock_0, {}

        def keep(mod, args, out):
            seen["x"] = args[0].detach()
            out.register_hook(lambda g: seen.update(dy=g.detach()))
        handle = blk.register_forward_hook(keep)
        loss = torch.mean(torch.abs(
            model.nets["P_A"](channel_stack(prepared["real_A_seq"]))
            - prepared["real_A_last"]))
        grad = torch.autograd.grad(loss, blk.qkv.weight)[0]
        handle.remove()
        return grad.double().cpu(), seen

    def block_grad(blk, seen):
        return torch.autograd.grad(blk(seen["x"]), blk.qkv.weight,
                                   seen["dy"])[0].double().cpu()

    cfg = {"model_type": "re_cycle_gan", "name": "cuda_recycle_gan",
           "checkpoints_dir": str(tmp_path),
           "data": {"crop_size": 64, "load_size": 64},
           "G": {"netG": "resnet_attn", "ngf": 16, "nblocks": 2},
           "D": {"netDs": ["basic"], "ndf": 16},
           "alg": {"re": {"projection_threshold": 100.0}},
           "dataaug": {"diff_aug_policy": "color,cutout"},
           "train": {"batch_size": 2, "pool_size": 4}}
    models = {}
    for dev, bf16 in (("cpu", False), ("cuda", True)):
        opt = TrainOptions().parse_json(copy.deepcopy(cfg), verbose=False)
        opt.tpu_bf16 = bf16
        models[dev] = create_model(opt, phase="train",
                                   device=torch.device(dev))
    g = torch.Generator().manual_seed(1)
    m = models["cpu"]
    for name in ("P_A", "P_B"):
        init_weights(m.nets[name], g, zero_init_std=0.02)
    for name, net in m.nets.items():
        models["cuda"].nets[name].load_state_dict(net.state_dict())
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, (2, 3, 64, 64, 3)).astype(np.float32)
             for k in ("A", "B")}
    draws = {"pool_A": m.pool_A.draw_query(g, 4),
             "pool_B": m.pool_B.draw_query(g, 4), "d_real_aug": {},
             "d_fake_aug": {}}
    for sname, _, _ in m.d_names:
        for k in ("d_real_aug", "d_fake_aug"):
            draws[k][sname] = draw_diff_augment(g, (4, 3, 64, 64),
                                                m.diff_policy, m.diff_prob)

    def moved(d, dev):
        if isinstance(d, dict):
            return {k: moved(v, dev) for k, v in d.items()}
        return d.to(dev) if torch.is_tensor(d) else d
    losses, grads = {}, {}
    for dev, model in models.items():
        prepared = model.prepare_batch(batch)
        grads[dev], seen = p_grad(model, prepared)
        if dev == "cuda":
            blk = model.nets["P_A"].AttentionBlock_0
            grads["block"] = block_grad(blk, seen)
            with monkeypatch.context() as mp:
                mp.setattr(unet_mha, "flash_attention", plain)
                grads["plain"], _ = p_grad(model, prepared)
                grads["block_plain"] = block_grad(blk, seen)
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        losses[dev] = {k: float(v) for k, v in model.optimize_prepared(
            prepared, moved(draws, dev)).items()}
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention_fwd": 4,
                           "flash_attention_bwd_dq": 4,
                           "flash_attention_bwd_dkv": 4}

    def g_err(x, y):
        return (grads[x] - grads[y]).norm().item() / grads[y].norm().item()
    assert grads["cpu"].norm().item() > 0
    assert grads["block_plain"].norm().item() > 0
    assert g_err("block", "block_plain") <= 5e-2
    assert g_err("cuda", "cpu") <= 2 * g_err("plain", "cpu") + 5e-2
    assert min(losses["cpu"]["G_recycle_A"], losses["cpu"]["G_recycle_B"]) > 0
    for k, want in losses["cpu"].items():
        assert abs(losses["cuda"][k] - want) <= 5e-2 * max(1.0, abs(want)), (
            k, losses["cuda"][k], want)


@pytest.mark.parametrize("remat,k1", [(None, 1), ("conv", 1), ("full", 2)])
def test_online_batch_trains_on_the_card(cuda, tmp_path, remat, k1):
    """A batch of the online bbox-crop mode with canny sketch conditioning
    through one bf16 training step: one launch of each attention kernel,
    and with remat K1 once more under "full" (its block recomputed)."""
    from joligen_tpu_torch.data import create_dataloader, create_dataset
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.tools.synthetic_datasets import write_online

    write_online(str(tmp_path / "data"), 4, 96, seed=1)
    cfg = {"model_type": "palette", "name": "cuda_online",
           "checkpoints_dir": str(tmp_path), "dataroot": str(tmp_path / "data"),
           "data": {"dataset_mode": "self_supervised_labeled_mask_online",
                    "crop_size": 32, "load_size": 32, "relative_paths": True,
                    "online_creation": {"crop_size_A": 48,
                                        "crop_delta_A": 8}},
           "G": {"netG": "unet_mha", "ngf": 32,
                 "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                              "num_head_channels": 32}},
           "alg": {"diffusion": {"task": "inpainting",
                                 "cond_image_creation": "computed_sketch",
                                 "cond_computed_sketch_list": ["canny"],
                                 "cond_sketch_canny_range": [100, 400]}},
           "train": {"G_ema": True, "optim": "adamw", "batch_size": 4},
           "tpu": {"bf16": True, "remat": remat is not None,
                   "remat_policy": remat or "conv"}}
    opt = TrainOptions().parse_json(cfg, verbose=False)
    batch = next(iter(create_dataloader(opt, create_dataset(opt))))
    model = create_model(opt, phase="train")
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    losses = model.optimize_parameters(batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention_fwd": k1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    assert torch.isfinite(losses["G_tot"]).item()


# P1/P2: the probe's hot site at batch 2; shapes whose H, W and Co are not
# multiples of the kernels' tiles (bf16: 8, 16 or 32 rows, 64 columns, 128
# output channels; fp32: 32, 16 or 8 columns, 64 output channels); C = 8 and
# 24, which fill part of a 64-channel K step (and one 16-channel k16 slice
# by half); C = 256, two K steps a tap, beside Co = 72
CONV_CHECKS = [((2, 128, 128, 128), 128), ((1, 37, 53, 64), 40),
               ((1, 13, 16, 8), 8), ((3, 21, 65, 24), 16),
               ((2, 45, 64, 256), 72)]
CONV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of max |y|


def _conv_inputs(cuda, shape, co, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, shape[-1], co), generator=g, device=cuda)
         / (9 * shape[-1]) ** 0.5).to(dtype)
    return x, w


def _conv_call(s2):
    """P1 (``s2`` None) or P2 at ``s2``: (kernel name, wrapper, plain
    version)."""
    if s2 is None:
        return ("conv3x3_taps", conv3x3.conv3x3_taps,
                conv3x3.conv3x3_taps_reference)
    return ("conv3x3_taps_v2",
            lambda x, w: conv3x3.conv3x3_taps_v2(x, w, s2=s2),
            conv3x3.conv3x3_taps_v2_reference)


@pytest.mark.parametrize("shape,co", CONV_CHECKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s2", [None, 8, 16, 32])       # None: P1
def test_conv_kernels_match_plain_version(cuda, shape, co, dtype, s2):
    name, fn, plain = _conv_call(s2)
    x, w = _conv_inputs(cuda, shape, co, dtype, sum(shape) + co)
    before = dict(conv3x3.LAUNCHES)
    got = fn(x, w)
    want = plain(x, w)
    torch.cuda.synchronize()
    assert conv3x3.LAUNCHES[name] == before[name] + 1
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= CONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s2", [None, 8, 16, 32])
def test_conv_dtype_takes_its_route(cuda, dtype, s2):
    # bf16: the implicit GEMM on wgmma; fp32: the FMA kernel; one launch a
    # call either way
    name, fn, _ = _conv_call(s2)
    x, w = _conv_inputs(cuda, (1, 16, 64, 32), 32, dtype, 3)
    names = _kernel_names(lambda: fn(x, w))
    want = {"wgmma": "conv3x3_wgmma_kernel",
            "fma": "conv3x3_fma_kernel"}[
        conv3x3.ROUTES[name][str(dtype).split(".")[-1]]]
    # the wrapper lays the taps out on the card before the launch
    kernels = [n for n in names if "conv3x3" in n]
    assert len(kernels) == 1 and want in kernels[0], names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s2", [None, 8, 16, 32])
def test_conv_reads_nothing_beside_the_input(cuda, dtype, s2):
    # x and w are views into buffers that hold NaN right after them (and
    # before x): zero padding, ragged tiles and part-filled K steps must
    # never read there. C = 24 fills half of a k16 slice; W = 65 and Co = 16
    # are ragged.
    _, fn, plain = _conv_call(s2)
    shape, co = (2, 11, 65, 24), 16
    x0, w0 = _conv_inputs(cuda, shape, co, dtype, 9)
    nan = float("nan")
    xbuf = torch.full((x0.numel() + 64,), nan, dtype=dtype, device=cuda)
    x = xbuf[32:32 + x0.numel()].view(shape)
    x.copy_(x0)
    wbuf = torch.full((w0.numel() + 64,), nan, dtype=dtype, device=cuda)
    w = wbuf[:w0.numel()].view(w0.shape)
    w.copy_(w0)
    got = fn(x, w)
    torch.cuda.synchronize()
    want = plain(x0, w0)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= CONV_TOL[dtype]


# P3: the probe's chunkings (a single chunk at 4096 rows), an odd chunk
# count, chunks of 24 KiB and 48 KiB (whole 4 KiB tiles), chunks of 24000
# and 20000 bytes ending in a short tile; fewer items than blocks (one
# 2 KiB chunk); a block that wraps the ring many times (256 MiB); blocks
# whose items come from several chunks; chunks of one row, down to 16-byte
# items
COPY_CHECKS = [(4096, 1024, 256, torch.float32),
               (4096, 1024, 1024, torch.bfloat16),
               (4096, 1024, 4096, torch.float32),
               (768, 1024, 256, torch.float32),
               (1200, 1024, 12, torch.bfloat16),
               (60, 1024, 12, torch.float32),
               (1200, 1000, 12, torch.bfloat16),
               (60, 1000, 5, torch.float32),
               (1, 1024, 1, torch.bfloat16),
               (65536, 1024, 256, torch.float32),
               (16392, 1024, 12, torch.bfloat16),
               (4800, 1024, 10, torch.float32),
               (1000, 1024, 1, torch.float32),
               (2048, 8, 1, torch.bfloat16)]
WRAP_CHECK = (65536, 1024, 256, torch.float32)


def _copy_input(cuda, n_rows, row, dtype, seed):
    return dma.random_bits((n_rows, row), dtype,
                           torch.Generator(device=cuda).manual_seed(seed))


@pytest.mark.parametrize("n_rows,row,chunk_rows,dtype", COPY_CHECKS)
def test_copy_kernel_is_bit_exact(cuda, n_rows, row, chunk_rows, dtype):
    x, bits = _copy_input(cuda, n_rows, row, dtype, n_rows + chunk_rows)
    run = dma.make_copy(n_rows, row, chunk_rows, dtype, cuda)
    before = dma.LAUNCHES["dma_copy"]
    y = run(x)
    torch.cuda.synchronize()
    assert dma.LAUNCHES["dma_copy"] == before + 1
    assert torch.equal(y.view(bits), x.view(bits))
    assert torch.equal(dma.copy_reference(x, chunk_rows).view(bits),
                       x.view(bits))


@pytest.mark.parametrize("n_rows,row,chunk_rows,dtype", COPY_CHECKS)
def test_copy_kernel_schedule(cuda, n_rows, row, chunk_rows, dtype):
    # the persistent grid: a block on every SM, never more than the work
    # items, which are copy_tiles' items
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_chunks, chunk_bytes = n_rows // chunk_rows, chunk_rows * row * itemsize
    plan = dma.launch_plan(n_chunks, chunk_bytes, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan["tile_bytes"] == dma.TILE_BYTES
    assert plan["items"] == n_chunks * len(dma.copy_tiles(chunk_bytes))
    assert plan["grid"] == min(plan["items"], sms)
    assert plan["smem_bytes"] >= plan["stages"] * plan["tile_bytes"]
    if (n_rows, row, chunk_rows, dtype) == WRAP_CHECK:
        # every block walks the ring of stages at least three times over
        assert plan["items"] // plan["grid"] > 3 * plan["stages"]


@pytest.mark.parametrize("n_rows,row,chunk_rows,dtype", [
    (60, 1000, 5, torch.float32), (1, 1024, 1, torch.bfloat16),
    (2048, 8, 1, torch.bfloat16), (1200, 1000, 12, torch.bfloat16),
    (4800, 1024, 10, torch.float32)])
def test_copy_kernel_writes_nothing_beside_the_output(cuda, n_rows, row,
                                                      chunk_rows, dtype):
    # the output is a view into a buffer with a tile's worth of random
    # bits on each side: they must come out untouched
    x, bits = _copy_input(cuda, n_rows, row, dtype, n_rows + chunk_rows)
    guard = dma.TILE_BYTES // x.element_size()
    buf, _ = _copy_input(cuda, n_rows * row + 2 * guard, 1, dtype, row)
    before = buf.clone()
    out = buf[guard:guard + x.numel(), 0].view(n_rows, row)
    assert dma._launch(x, chunk_rows, out) is out
    torch.cuda.synchronize()
    assert torch.equal(out.view(bits), x.view(bits))
    assert torch.equal(buf[:guard].view(bits), before[:guard].view(bits))
    assert torch.equal(buf[guard + x.numel():].view(bits),
                       before[guard + x.numel():].view(bits))


def test_probe_kernels_refuse_what_they_do_not_take(cuda):
    w = torch.zeros(3, 3, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3.conv3x3_taps(torch.zeros(1, 8, 8, 12, device=cuda),
                             torch.zeros(3, 3, 12, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_taps(torch.zeros(1, 16, 8, 8, device=cuda)
                             .permute(0, 2, 3, 1), w)
    misaligned = torch.zeros(8 * 8 * 16 + 1, device=cuda)[1:].view(1, 8, 8, 16)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3.conv3x3_taps_v2(misaligned, w, s2=8)
    with pytest.raises(ValueError, match="s2"):
        conv3x3.conv3x3_taps_v2(torch.zeros(1, 8, 8, 16, device=cuda), w,
                                s2=64)
    x = torch.zeros(256, 1024, device=cuda)
    out = torch.zeros(256 * 1024 + 1, device=cuda)[1:].view(256, 1024)
    with pytest.raises(ValueError, match="aligned"):
        dma._launch(x, 256, out)
    run = dma.make_copy(256, 1024, 256, torch.float32, cuda)
    with pytest.raises(ValueError, match="expected a contiguous"):
        run(x.to(torch.bfloat16))


def test_probes_launch_each_kernel_the_counted_times(cuda):
    from joligen_tpu_torch.tools import bw_probe3
    from joligen_tpu_torch.tools import fused_resblock_probe as probe
    for counters in (conv3x3.LAUNCHES, dma.LAUNCHES):
        for name in counters:
            counters[name] = 0
    r = probe.stage_a(iters=2, batch=2)
    assert conv3x3.LAUNCHES == probe.stage_a_launches(2)
    assert max(r["rel_err_v1"], *r["rel_err_v2"].values()) < 3e-2
    records = bw_probe3.run_cases(mib=16)
    assert dma.LAUNCHES == bw_probe3.RUN_LAUNCHES
    assert all(r["exact"] for r in records)
