"""LoRA finetuning in the port (``joligen_tpu_torch/models/lora.py``,
``B2BModel`` with ``alg_b2b_lora``) against the JAX package
(``joligen_tpu/models/lora.py``) on the CPU, fp32:

1. ``normalize_targets`` as the JAX function; the sites of ``init_lora``:
   the same adapter paths and factor shapes as the JAX ``init_lora`` on
   the same tree, for the image JiT and the video JiT (whose motion
   modules' GEGLU ``proj`` matches too), with the default targets and with
   ``final_proj`` and ``w12`` among them; ``proj`` does not hit
   ``patch_proj``; the b2b_image_256 denoiser's 10 adapter leaves and
   1,253,376 adapter parameters (meta device); A drawn from N(0, 1/d_in),
   B zero, so the merged weights are the base ones;
2. ``merge_deltas`` against ``merge_lora`` on seeded factors (B non-zero),
   without dropout and with the JAX keep masks fed, to 1e-6;
3. 3-step LoRA trajectories of ``B2BModel.optimize_prepared`` on ``vit``
   (``test_torch_b2b_image``'s config) and ``vit_vid``
   (``test_torch_b2b``'s) against the JAX model's steps, the keys' draws
   and dropout masks replayed: losses to 1e-4, the adapters to 1e-4 with
   the Adam allowance, the base weights and their EMA bit for bit as they
   started; a 2-step request with the adapters merged to 1e-3; on ``vit``
   then the ``G_lora`` checkpoint both ways bit for bit and
   ``merge_lora_checkpoint`` against the JAX one, to 1e-6;
4. a LoRA step under ``tpu_remat`` (the blocks recomputed in the backward
   within the merged weights) equal to the step without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from _torch_gan_common import few_torch_threads, seeded_tree
from test_torch_b2b import _models as video_models
from test_torch_b2b import clips, jax_training_draws
from test_torch_b2b_image import images, losses_close
from test_torch_b2b_image import models as image_models
from joligen_tpu.models import lora as jl
from joligen_tpu.models.modules import jit as jj
from joligen_tpu.models.modules import vit_vid as jvv
from joligen_tpu_torch.models import lora as tl
from joligen_tpu_torch.models.convert import (flax_to_torch, lora_from_flax,
                                              lora_to_flax)
from joligen_tpu_torch.models.modules import jit as tj
from joligen_tpu_torch.models.modules import vit_vid as tvv
from joligen_tpu_torch.options import TrainOptions

LR, FLIP_SHARE = 2e-4, 1e-2
JIT = dict(patch_size=4, hidden_size=64, depth=3, num_heads=2,
           bottleneck_dim=16, in_context_start=1, in_context_len=4,
           out_channels=3)
VID = dict(patch_size=4, hidden_size=64, depth=3, num_heads=2,
           bottleneck_dim=16, in_context_start=1, in_context_len=4,
           out_channels=3, motion_num_heads=2)
TARGETS = [jl.DEFAULT_TARGETS, ("attn.qkv", "attn.proj", "mlp.w12", "mlp.w3"),
           ("qkv", "final_proj")]


def _pair(video, seed):
    """(torch net, flax tree) of a small JiT or JiTViD on seeded values."""
    if video:
        jnet, tnet = jvv.JiTViD(**VID), tvv.JiTViD(6, **VID)
        x = jnp.zeros((1, 2, 16, 16, 6))
    else:
        jnet, tnet = jj.JiT(**JIT), tj.JiT(6, **JIT)
        x = jnp.zeros((1, 16, 16, 6))
    shapes = jax.eval_shape(lambda r: jnet.init(r, x, jnp.zeros((1,))),
                            jax.random.PRNGKey(0))
    tree = seeded_tree(shapes, seed, 0.05, lecun=True)
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    return tnet, tree


def test_normalize_targets_matches_jax():
    for targets in TARGETS + [("blocks.mlp.w12", "w3", "attn.q")]:
        assert tl.normalize_targets(targets) == jl.normalize_targets(targets)
    assert tl.DEFAULT_TARGETS == jl.DEFAULT_TARGETS


@pytest.mark.parametrize("video", [False, True])
@pytest.mark.parametrize("targets", TARGETS)
def test_sites_match_jax_init_lora(video, targets):
    tnet, tree = _pair(video, 1)
    want = jl.init_lora(jax.random.PRNGKey(0), tree, rank=4, targets=targets)
    adapters = tl.LoRAAdapters(tnet, 4, targets,
                               torch.Generator().manual_seed(0))
    assert adapters.paths == sorted(want)
    for path, a, b in adapters.factors():
        assert tuple(a.shape) == want[path]["a"].shape, path
        assert tuple(b.shape) == want[path]["b"].shape, path
        assert not b.any()
    assert ("patch_proj", "kernel") not in want
    assert (("final_proj", "kernel") in want) == ("final_proj" in targets)
    if video and "proj" in tl.normalize_targets(targets):
        assert any("motion" in p for p in want)    # the GEGLU's proj
    # the merged weights start at the base ones
    merged = tl.merge_deltas(tnet, adapters, 16.0, 4)
    params = dict(tnet.named_parameters())
    assert all(torch.equal(w, params[n]) for n, w in merged.items())


def test_b2b_image_256_adapter_count():
    opt = TrainOptions().parse_cli([
        "--config_json", "examples/example_ddpm_noglasses2glasses.json",
        "--model_type", "b2b", "--G_netG", "vit", "--data_crop_size", "256"])
    with torch.device("meta"):
        net = tj.JiT.from_opt(opt, 6)
        adapters = tl.LoRAAdapters(
            net, opt.alg_b2b_lora_rank, opt.alg_b2b_lora_target_modules)
    assert len(adapters.paths) == 10
    assert adapters.count() == 1_253_376
    # stacked like the blocks: (depth, d_in, r)
    a = dict((p, a) for p, a, _ in adapters.factors())
    assert a[("blocks_post", "block", "qkv", "kernel")].shape == (8, 768, 8)


def test_a_is_drawn_from_n_0_1_over_d_in():
    tnet, _ = _pair(False, 2)
    adapters = tl.LoRAAdapters(tnet, 8, generator=torch.Generator()
                               .manual_seed(3))
    a = dict((p, a) for p, a, _ in adapters.factors())
    big = a[("blocks_post", "block", "mlp", "w2", "kernel")]   # d_in 170
    assert abs(big.std().item() * 170 ** 0.5 - 1.0) < 0.05


def _jax_keep(key, adapters, dropout):
    """``merge_lora``'s keep masks from ``key``, in its order."""
    return [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(key, i), 1.0 - dropout,
        ab["a"].shape[:-1] + (1,))))
        for i, (_, ab) in enumerate(sorted(adapters.items()))]


@pytest.mark.parametrize("video", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_merge_matches_jax(video, dropout):
    tnet, tree = _pair(video, 4)
    jad = jl.init_lora(jax.random.PRNGKey(5), tree, rank=4)
    rng = np.random.default_rng(6)
    jad = {p: {"a": np.asarray(ab["a"]),
               "b": rng.normal(0, 0.1, ab["b"].shape).astype(np.float32)}
           for p, ab in jad.items()}
    key = jax.random.PRNGKey(7)
    want = flax_to_torch(jax.device_get(jl.merge_lora(
        tree, jad, alpha=16.0, rank=4, dropout=dropout,
        rng=key if dropout else None)))
    adapters = tl.LoRAAdapters(tnet, 4)
    adapters.load_flax_tree(serialization.to_state_dict(jad))
    keep = _jax_keep(key, jad, dropout) if dropout else None
    if keep is not None:
        assert 0 < sum(int((~k).sum()) for k in keep)
    got = tl.merge_deltas(tnet, adapters, 16.0, 4, dropout, keep=keep)
    assert len(got) == sum(len(n) for n in adapters.sites.values())
    for name, w in got.items():
        np.testing.assert_allclose(w.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)
    # the context shadows the weights and leaves the parameters
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    with tl.merged_weights(tnet, got):
        name = next(iter(got))
        mod, leaf = name.rsplit(".", 1)
        assert getattr(tnet.get_submodule(mod), leaf) is got[name]
    assert all(torch.equal(v, before[k])
               for k, v in tnet.state_dict().items())
    assert isinstance(getattr(tnet.get_submodule(mod), leaf),
                      torch.nn.Parameter)


def _lora_draws(key, jm, shape, labels=None):
    draws = jax_training_draws(key, shape, labels)
    draws["lora_keep"] = _jax_keep(jax.random.fold_in(key, 77),
                                   jax.device_get(jm.states["G_lora"].params),
                                   jm.lora_dropout)
    return draws


def _adapters_close(i, tm, jm):
    want = lora_from_flax(serialization.to_state_dict(jax.device_get(
        jm.states["G_lora"].params)))
    bad = []
    for path, a, b in tm.nets["G_lora"].factors():
        for got, w in ((a, want[path][0]), (b, want[path][1])):
            diff = (got.detach() - w).abs()
            if (diff > 1e-4).float().mean() > FLIP_SHARE:
                bad.append((i, path, "share", int((diff > 1e-4).sum())))
            if diff.max() > 2 * LR * (i + 1) + 1e-4:
                bad.append((i, path, float(diff.max())))
    assert not bad, bad


@pytest.mark.parametrize("video", [False, True])
def test_lora_trajectory_matches_jax(tmp_path, monkeypatch, video):
    if video:
        jm, tm = video_models(tmp_path, monkeypatch,
                              {"alg": {"b2b": {"lora": True,
                                               "lora_rank": 4}}})
        batches = [clips(60 + i) for i in range(4)]
    else:
        jm, tm = image_models(tmp_path, monkeypatch, [
            "--alg_b2b_lora", "--alg_b2b_lora_rank", "4"])
        batches = [images(60 + i) for i in range(4)]
    assert tm.use_lora and jm.use_lora and tm.lora_dropout == 0.05
    tm.nets["G_lora"].load_flax_tree(serialization.to_state_dict(
        jax.device_get(jm.states["G_lora"].params)))
    frozen = {k: v.clone() for k, v in tm.nets["G_A"].state_dict().items()}
    ema = {k: v.clone() for k, v in tm.ema_nets["G_A"].state_dict().items()}
    assert not any(p.requires_grad for p in tm.nets["G_A"].parameters())
    for i in range(3):
        batch, key = batches[i], jax.random.PRNGKey(70 + i)
        monkeypatch.setattr(jm, "next_rng", lambda k=key: k)
        want = jm.optimize_prepared(jm.prepare_batch(batch))
        got = tm.optimize_prepared(tm.prepare_batch(batch), draws=_lora_draws(
            key, jm, batch["B"].shape))
        losses_close(got, want, i)
        _adapters_close(i, tm, jm)
    assert all(torch.equal(v, frozen[k])
               for k, v in tm.nets["G_A"].state_dict().items())
    assert all(torch.equal(v, ema[k])
               for k, v in tm.ema_nets["G_A"].state_dict().items())
    assert tm.states["G_lora"].tx.count == 3 and tm.states["G_A"].step == 0
    assert all(b.abs().max() > 0 for _, _, b in tm.nets["G_lora"].factors())
    # a request with the adapters merged into the EMA weights
    batch, key = batches[3], jax.random.PRNGKey(80)
    monkeypatch.setattr(jm, "next_rng", lambda: key)
    want = jm.inference(batch, denoise_timesteps=2)
    got = tm.inference(batch, denoise_timesteps=2, draws={
        "noise": torch.from_numpy(np.array(jax.random.normal(
            key, batch["B"].shape)))})
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    if video:
        return
    # G_lora both ways, bit for bit
    tm.save_networks("port")
    jm.load_networks("port", load_optim=False)
    for path, (a, b) in lora_from_flax(serialization.to_state_dict(
            jax.device_get(jm.states["G_lora"].params))).items():
        i = tm.nets["G_lora"].paths.index(path)
        assert torch.equal(a, getattr(tm.nets["G_lora"], f"a{i}").detach())
        assert torch.equal(b, getattr(tm.nets["G_lora"], f"b{i}").detach())
    jm.states["G_lora"] = jm.states["G_lora"].replace(params=jax.tree.map(
        lambda x: x * 0.5, jm.states["G_lora"].params))
    jm.save_networks("jax")
    tm.load_networks("jax", load_optim=False)
    want_tree = lora_to_flax(lora_from_flax(serialization.to_state_dict(
        jax.device_get(jm.states["G_lora"].params))))
    got_tree = tm.nets["G_lora"].flax_tree()
    assert set(got_tree) == set(want_tree)
    for k, ab in want_tree.items():
        for f in ("a", "b"):
            np.testing.assert_array_equal(got_tree[k][f], ab[f])
    # the merged checkpoint
    jm.merge_lora_checkpoint()
    tm.merge_lora_checkpoint()
    want = flax_to_torch(jax.device_get(jm.states["G_A"].params))
    changed = 0
    for k, v in tm.nets["G_A"].state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                   err_msg=k)
        changed += not torch.equal(v, frozen[k])
    assert changed == 3 * 5             # each block's 5 adapted weights


def test_lora_step_under_remat_matches(tmp_path, monkeypatch):
    """``tpu_remat`` recomputes each JiT block in the backward, inside the
    merged weights' context: the adapters' step is the one without it."""
    jm, plain = image_models(tmp_path, monkeypatch, [
        "--alg_b2b_lora", "--alg_b2b_lora_rank", "4"])
    _, remat = image_models(tmp_path, monkeypatch, [
        "--alg_b2b_lora", "--alg_b2b_lora_rank", "4", "--tpu_remat"])
    assert remat.nets["G_A"].remat and not plain.nets["G_A"].remat
    tree = serialization.to_state_dict(jax.device_get(
        jm.states["G_lora"].params))
    batch, key = images(90), jax.random.PRNGKey(91)
    out = []
    for tm in (plain, remat):
        tm.nets["G_lora"].load_flax_tree(tree)
        out.append(tm.optimize_prepared(tm.prepare_batch(batch),
                                        draws=_lora_draws(key, jm,
                                                          batch["B"].shape)))
    assert torch.equal(out[0]["G_tot"], out[1]["G_tot"])
    for (_, a0, b0), (_, a1, b1) in zip(plain.nets["G_lora"].factors(),
                                        remat.nets["G_lora"].factors()):
        np.testing.assert_allclose(b1.detach().numpy(), b0.detach().numpy(),
                                   atol=1e-7)
        assert b1.abs().max() > 0
