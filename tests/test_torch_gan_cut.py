"""The CUT model against the JAX package, on the CPU.

1. A 3-step trajectory of ``CUTModel.optimize_prepared`` against the JAX
   ``CUTModel``'s jitted step (``_make_step``) in fp32, on horse2zebra's
   options at a small width (ngf 8, 2 blocks, ndf 8, 32 px crops, batch 2,
   16 patches; ``projected_d`` without its resize): G, F and both Ds from
   the same weights, the same batches, and each step's draws (patch ids,
   the pool, DiffAugment) made with ``jax.random`` from the key the JAX
   step splits. Once as horse2zebra stands (DiffAugment ``color,cutout``
   at probability 0.5), once with DiffAugment off and the step's other
   options together (lsgan with label smoothing, ``D_noise``, SRC + hDCE,
   the L1 identity loss, context pixels, G EMA: the EMA compared as the
   parameters). After every step: every loss to 1e-4 (relative), every
   parameter of G, F and both Ds to 1e-4, and the pool. Adam's first steps
   move a parameter by about the learning rate (lr) in the sign of its
   gradient, so an element whose gradient cancels to within rounding
   noise (a sum of terms ~1 ending near 5e-4: fp32 sums in another order
   can take either sign) moves by lr one way in one package and the other
   way in the other. Such elements may pass 1e-4, within 2 x lr a step, in
   at most 1 % of a leaf's elements; the pool holds G's outputs, which
   carry their effect, to 1e-3. A conv bias right before an InstanceNorm
   has an exact gradient of 0, only noise, so all its elements are held to
   2 x lr a step.
2. Before horse2zebra's trajectory, G's gradient of the G loss against
   ``jax.grad`` of the JAX ``_g_loss`` (1e-4 of each leaf's largest; the
   exact-zero leaves to 1e-4 of the largest of all), and the projected D's
   share of it: zero in both packages, its trunk's output being detached.
3. The batched NCE terms against the per-layer losses.

The entry points and the dataset are in ``tests/test_torch_gan_entry.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (BATCH, SIZE, aug_draws,
                               fast_init_net_state, few_torch_threads,
                               grads_close, h2z_cfg, load_flax, patch_ids,
                               pool_draws, to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import dequantize_on_device, quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions

STEPS, LR = 3, 2e-4
FLIP_SHARE = 1e-2


# the trajectory's option sets: horse2zebra as it stands (DiffAugment
# color,cutout), and DiffAugment off with the other options of the ported
# step together (lsgan with one-sided label smoothing, D_noise, SRC +
# hDCE, the L1 identity loss, online context pixels, G EMA)
CASES = {
    "color_cutout": {},
    "no_aug_options": {
        "train": {"gan_mode": "lsgan", "G_ema": True, "G_ema_beta": 0.9},
        "dataaug": {"diff_aug_policy": "", "D_noise": 0.1,
                    "D_label_smooth": True},
        "alg": {"cut": {"nce_loss": "SRC_hDCE", "lambda_SRC": 0.1,
                        "MSE_idt": True, "lambda_MSE_idt": 0.5}},
        "data": {"online_context_pixels": 2}},
}


@pytest.fixture
def fast_jax_init(monkeypatch):
    monkeypatch.setattr(jcut_model, "init_net_state",
                        fast_init_net_state(100))
    monkeypatch.setattr(jcut_model, "scheme_from_opt",
                        lambda state, key, opt: state)


def _models(tmp, extra=None):
    cfg = h2z_cfg(tmp, extra)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, device="cpu")
    assert list(tm.nets) == ["G_A", "F"] + list(jm.netDs)
    for name, net in tm.nets.items():
        load_flax(net, jm.states[name].params)
    for name, net in tm.ema_nets.items():
        load_flax(net, jm.states[name].ema_params)
    return jm, tm


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("A", "B")}


def _step_draws(key, jm, tm):
    """The draws of the JAX step for ``key`` (``cut_model.py:697``: split in
    8; G's loss splits rngs[0] for its augmentation, each D, then the two
    NCE calls; rngs[1] the pool; rngs[2], rngs[3] the Ds' augmentations)."""
    rngs = jax.random.split(key, 8)
    r, rng_aug = jax.random.split(rngs[0])
    for _ in jm.netDs:
        r, _ = jax.random.split(r)
    rng_nce, rng_idt = jax.random.split(r)
    feats = tm.nets["G_A"](torch.zeros(1, SIZE, SIZE, 3),
                           extract_layer_ids=tm.nce_layers)
    hws = [f.shape[1] * f.shape[2] for f in feats]
    shape = (BATCH, SIZE, SIZE, 3)
    draws = {"nce": patch_ids(rng_nce, hws, tm.num_patches),
             "nce_idt": patch_ids(rng_idt, hws, tm.num_patches),
             "pool": pool_draws(rngs[1], BATCH, tm.pool.pool_size)}
    if tm.d_noise > 0:
        draws["d_noise"] = tuple(torch.from_numpy(np.array(
            jax.random.normal(r, shape, jnp.float32))) for r in rngs[4:6])
    if tm.diff_policy:
        for k, r in (("g_aug", rng_aug), ("d_real_aug", rngs[2]),
                     ("d_fake_aug", rngs[3])):
            draws[k] = aug_draws(r, shape, tm.diff_policy, tm.diff_prob)
    return draws


def _zero_grad_biases(tm):
    """Conv biases right before an InstanceNorm (exact gradient 0): G's
    every conv but the heads, the basic D's middle convs."""
    names = {f"G_A.{n}" for n, _ in tm.nets["G_A"].named_parameters()
             if n.endswith(".bias") and ".head." not in n}
    n_layers = tm.opt.D_n_layers
    names |= {f"D_B_basic.Conv_{i}.bias" for i in range(1, n_layers + 1)}
    return names


def _check_g_gradient(jm, tm):
    """G's gradient of its loss against ``jax.grad`` of the JAX
    ``_g_loss``, and the projected D's GAN term alone reaching no G
    parameter, in either package."""
    batch = _batch(3)
    key = jax.random.PRNGKey(7)
    dev = quantize_batch(jm.set_input(batch), float_keys=("real_A",
                                                          "real_B"))
    inp = {k: dequantize_on_device(jnp.asarray(v), "image")
           for k, v in dev.items()}
    d_params = {n: jm.states[n].params for n in jm.netDs}
    rng_g = jax.random.split(key, 8)[0]

    def jloss(pG):
        return jm._g_loss(pG, jm.states["F"].params, d_params, rng_g,
                          inp)[0]

    jgrad = jax.jit(jax.grad(jloss))(jm.states["G_A"].params)
    real = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    total, _, _ = tm._g_loss(real["real_A"], real["real_B"],
                             _step_draws(key, jm, tm))
    netG = tm.nets["G_A"]
    for p, g in zip(netG.parameters(), torch.autograd.grad(
            total, list(netG.parameters()))):
        p.grad = g
    grads_close(jgrad, netG, 1e-4, 1e-4)

    # the projected D's GAN term alone reaches no G parameter
    netD, jD = tm.nets["D_B_projected_d"], jm.netDs["D_B_projected_d"]
    fake = netG(real["real_A"])
    gs = torch.autograd.grad(-netD(fake).mean(), list(netG.parameters()),
                             allow_unused=True)
    assert all(g is None or not g.any() for g in gs)
    jz = jax.jit(jax.grad(lambda pG: -jnp.mean(jD.apply(
        jm.states["D_B_projected_d"].params,
        jm.netG.apply(pG, inp["real_A"])))))(jm.states["G_A"].params)
    assert not any(np.asarray(v).any() for v in jax.tree.leaves(jz))
    for p in netG.parameters():
        p.grad = None


@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_trajectory_matches_jax_step(tmp_path, fast_jax_init, case):
    jm, tm = _models(tmp_path, CASES[case])
    assert tm.diff_policy == jm.diff_policy
    assert (tm.gan_mode, tm.nce_loss, tm.mse_idt, tm.context) == (
        jm.gan_mode, jm.nce_loss, jm.mse_idt,
        jm.opt.data_online_context_pixels)
    if case == "color_cutout":
        _check_g_gradient(jm, tm)
    step = jm._make_step()
    # committed like the step's outputs, so the step compiles once
    states, pool = jax.device_put((jm.states, jm.pool), jax.devices()[0])
    zero = _zero_grad_biases(tm)
    for i in range(STEPS):
        batch = _batch(10 + i)
        key = jax.random.PRNGKey(1000 + i)
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"))
        states, pool, _, _, jlosses = step(states, pool, jm.apa_p,
                                           jm.d_diff_p, key, dev)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch),
                                       _step_draws(key, jm, tm))
        assert set(tlosses) == set(jlosses)
        for k, v in jlosses.items():
            assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(tlosses[k]), float(v))
        bad = []
        nets = dict(tm.nets)
        nets.update({f"{n}_ema": net for n, net in tm.ema_nets.items()})
        for name, net in nets.items():
            tree = (states[name[:-4]].ema_params if name.endswith("_ema")
                    else states[name].params)
            want = flax_to_torch(jax.device_get(tree))
            for pname, p in net.named_parameters():
                diff = np.abs(to_np(p) - want[pname].numpy())
                if f"{name.removesuffix('_ema')}.{pname}" in zero:
                    off = diff > 2 * LR * (i + 1) + 1e-6
                else:
                    # past 1e-4 only where Adam's sign-like step took the
                    # other sign of a gradient that cancels to within noise
                    off = diff > 1e-4
                    if off.mean() > FLIP_SHARE:
                        bad.append((i, name, pname, int(off.sum()), diff.size))
                    off = diff > 2 * LR * (i + 1) + 1e-4
                if off.any():
                    bad.append((i, name, pname, float(diff.max())))
        assert not bad, bad
        # G's outputs carry those elements' effect: 1e-3
        np.testing.assert_allclose(to_np(tm.pool.buffer),
                                   np.asarray(pool.buffer), atol=1e-3)


@pytest.mark.parametrize("loss", ["monce", "patchnce", "SRC_hDCE"])
def test_batched_nce_terms_equal_the_per_layer_losses(tmp_path, loss):
    """``_nce_terms`` runs every layer of both NCE terms as one batch of
    the loss where their shapes agree, and layer by layer where they do
    not; both equal the per-layer means of ``cut_networks``' losses."""
    from joligen_tpu_torch.models.modules import cut_networks as tcut
    opt = TrainOptions().parse_json(h2z_cfg(tmp_path), verbose=False)
    opt.alg_cut_nce_loss = loss
    tm = create_model(opt, device="cpu")
    rng = np.random.default_rng(5)

    def unit(n):
        x = rng.standard_normal((n, 32)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    for sizes in ((16, 16, 16), (16, 9, 4)):
        groups = [([unit(BATCH * p) for p in sizes],
                   [unit(BATCH * p) for p in sizes]) for _ in range(2)]
        nce, src = tm._nce_terms(groups, BATCH)
        for g, (fq, fk) in enumerate(groups):
            want_nce, want_src = [], []
            for q, k in zip(fq, fk):
                if loss == "SRC_hDCE":
                    h, s_ = tcut.src_hdce_loss(q, k, 0.07, BATCH, 16,
                                               gamma=tm.hdce_gamma)
                    want_nce.append(float(h.mean()))
                    want_src.append(float(s_.mean()))
                else:
                    fn = (tcut.monce_loss if loss == "monce" else
                          lambda *a: tcut.patch_nce_loss(*a[:4]))
                    want_nce.append(float(fn(q, k, 0.07, BATCH, 16).mean()))
                    want_src.append(0.0)
            assert abs(float(nce[g]) - np.mean(want_nce)) <= 1e-5
            assert abs(float(src[g]) - np.mean(want_src)) <= 1e-5
