"""Kernels K1 (csrc/flash_attention_fwd.cu), K2 and K3
(csrc/flash_attention_bwd.cu) on the card, against their plain PyTorch
versions, and one training step of a small palette model counting one launch
of each. Marked ``cuda``: they skip without a CUDA device. This file imports
neither jax nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from joligen_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [(2, 128, 2, 64), (2, 256, 1, 32), (2, 100, 2, 64), (2, 5, 2, 16),
          (1, 256, 16, 32)]
# the backward checks of chip_smoke.py: the training shape, batch 1, 256 px
# batch 8, and two ragged ones
BWD_CHECKS = [((8, 256, 16, 32), torch.bfloat16),
              ((8, 256, 16, 32), torch.float32),
              ((1, 256, 16, 32), torch.bfloat16),
              ((8, 1024, 16, 32), torch.bfloat16),
              ((2, 100, 2, 64), torch.float32),
              ((2, 5, 2, 16), torch.float32),
              ((2, 160, 2, 16), torch.bfloat16)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def test_kernel_reads_strided_slices(cuda):
    n, s, h, d = 2, 77, 4, 32
    qkv = torch.randn(n, s, 3 * h * d, device=cuda)
    q, k, v = (t.reshape(n, s, h, d) for t in torch.split(qkv, h * d, -1))
    o = fa.flash_attention(q, k, v)
    ref, _ = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, ref, atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
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
