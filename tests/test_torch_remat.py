"""``tpu_remat`` in the port (``UNetMHA`` under ``torch.utils.checkpoint``,
``joligen_tpu/models/modules/unet_mha.py:383-397``), on the CPU in fp32:

- the loss and every gradient with remat, under both policies, equal those
  without it to 1e-6 (the recomputation repeats the same arithmetic);
- the state-dict keys are the same with and without remat, and they are the
  flax tree paths of the JAX denoiser built with ``remat=True``, so
  checkpoints interchange;
- ``"conv"`` keeps the attention forward's outputs (one forward per
  attention site a step), ``"full"`` recomputes it (two);
- the options reach the network through ``define_G``, and an unknown policy
  raises.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from joligen_tpu.models.modules import unet_mha as junet
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.models.diffusion_networks import define_G, init_weights
from joligen_tpu_torch.models.modules import unet_mha as tunet
from joligen_tpu_torch.ops import flash_attention as fa
from joligen_tpu_torch.options import TrainOptions

TOL = 1e-6
SMALL = dict(in_channel=6, out_channel=3, inner_channel=16, cond_embed_dim=32,
             res_blocks=(1, 1), attn_res=(2,), channel_mults=(1, 2),
             num_head_channels=16, group_size=8)
ATTENTION_SITES = 4       # level 2: one encoder and two decoder blocks; mid


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts the attention forwards (the plain version of K1 on the CPU)."""
    calls = []
    plain = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls


def _inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.randn(2, 16, 16, 6, generator=g),
            torch.randn(2, 32, generator=g))


def _loss_and_grads(net, calls):
    x, emb = _inputs()
    calls.clear()
    loss = (net(x, emb) ** 2).mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return loss.item(), grads, len(calls)


@pytest.mark.parametrize("policy,forwards", [("conv", 1), ("full", 2)])
def test_remat_gradients_equal_plain(attention_calls, policy, forwards):
    plain = tunet.UNetMHA(**SMALL)
    init_weights(plain, torch.Generator().manual_seed(1), zero_init_std=0.05)
    remat = tunet.UNetMHA(remat=True, remat_policy=policy, **SMALL)
    remat.load_state_dict(plain.state_dict())
    assert list(remat.state_dict()) == list(plain.state_dict())
    want_loss, want, n_plain = _loss_and_grads(plain, attention_calls)
    loss, got, n_remat = _loss_and_grads(remat, attention_calls)
    assert n_plain == ATTENTION_SITES
    assert n_remat == forwards * ATTENTION_SITES
    np.testing.assert_allclose(loss, want_loss, rtol=TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=0)
    # without a gradient to take, nothing is checkpointed or recomputed
    with torch.no_grad():
        attention_calls.clear()
        out = remat(*_inputs())
    assert len(attention_calls) == ATTENTION_SITES
    torch.testing.assert_close(out, plain(*_inputs()).detach(), rtol=0,
                               atol=0)


def test_remat_keys_are_the_jax_remat_tree():
    jnet = junet.UNetMHA(remat=True, **SMALL)
    x, emb = (jnp.asarray(t.numpy()) for t in _inputs())
    variables = jax.device_get(jnet.init(jax.random.PRNGKey(0), x, emb))
    tnet = tunet.UNetMHA(remat=True, **SMALL)
    want = flax_to_torch(variables)
    assert sorted(tnet.state_dict()) == sorted(want)
    tnet.load_state_dict(want)          # shapes agree too


def test_options_reach_the_network():
    cfg = {"model_type": "palette",
           "G": {"netG": "unet_mha", "ngf": 16,
                 "unet_mha": {"channel_mults": [1, 2], "res_blocks": [1, 1],
                              "num_head_channels": 16}},
           "tpu": {"remat": True, "remat_policy": "full"}}
    opt = TrainOptions().parse_json(cfg, verbose=False)
    inner = define_G(opt).inner
    assert inner.remat and inner.remat_policy == "full"
    opt2 = copy.copy(opt)
    opt2.tpu_remat = False
    plain = define_G(opt2)
    assert not plain.inner.remat
    assert list(plain.state_dict()) == list(define_G(opt).state_dict())
    opt2.tpu_remat, opt2.tpu_remat_policy = True, "dots"
    with pytest.raises(ValueError, match="dots"):
        define_G(opt2)
