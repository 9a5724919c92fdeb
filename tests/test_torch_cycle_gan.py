"""The CycleGAN model against the JAX package, on the CPU.

1. A 3-step trajectory of ``CycleGANModel.optimize_prepared`` against the
   JAX ``CycleGANModel``'s jitted step (``_make_step``) in fp32, on
   horse2zebra's options at a small width (ngf 8, 2 blocks, ndf 8, 32 px,
   batch 2, a pool of 3; ``projected_d`` without its resize) with
   ``--model_type cycle_gan``: G_A, G_B and the four Ds (``projected_d``
   and ``basic`` for each domain) from the same weights, the same batches,
   and each step's draws (``rec_noise``, the two pools, DiffAugment,
   ``D_noise``) made with ``jax.random`` from the key the JAX step splits.
   Once as horse2zebra stands (``resnet_attn``, DiffAugment
   ``color,cutout``, the projected GAN mode) with ``rec_noise`` and the G
   EMA, once with ``unet_256`` (its middle attention: the plain route of
   K1–K3 on the CPU), lsgan with label smoothing, ``D_noise``, no
   DiffAugment, no identity terms and the ``basic`` Ds alone
   (``tests/test_torch_cycle_gan_unet.py``). As ``tests/_torch_glasses_common.py::run_trajectory``:
   each step's losses (to 1e-4 relative) and both pools (to 1e-3) from the
   state the packages share before it; the weights on the port's own run,
   with the Adam allowance of ``ROADMAP.md`` Queue 3 (at most 1 % of a
   leaf's elements past 1e-4, none past 2 × lr a step; the exact-zero
   gradients, conv biases before a norm that removes them and the key
   third of an attention ``qkv`` bias, to 2 × lr a step).
2. Checkpoints: the port's files load into the JAX model and the JAX
   model's into the port, bit for bit; ``inference`` in both directions
   against the JAX ``inference``; phase ``test`` builds the two Gs only.
3. ``re_cycle_gan_semantic_mask`` raises (as the JAX package);
   ``re_cycle_gan`` builds its P nets at the stack's width (its trajectory
   is in ``tests/test_torch_recycle_gan.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (BATCH, SIZE, aug_draws, fast_init_net_state,
                               few_torch_threads, h2z_cfg, load_flax,
                               pool_draws, to_np)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import cycle_gan_model as jcg
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import (flax_to_torch,
                                              optax_adam_state_to_torch)
from joligen_tpu_torch.options import TrainOptions

STEPS, LR = 3, 2e-4
FLIP_SHARE = 1e-2
CASES = {
    "h2z_rec_noise_ema": {
        "model_type": "cycle_gan",
        "alg": {"cyclegan": {"rec_noise": 0.1}},
        "train": {"G_ema": True, "G_ema_beta": 0.9}},
    "unet_256_options": {
        "model_type": "cycle_gan", "G": {"netG": "unet_256"},
        "D": {"netDs": ["basic"]}, "train": {"gan_mode": "lsgan"},
        "dataaug": {"diff_aug_policy": "", "D_noise": 0.1,
                    "D_label_smooth": True},
        "alg": {"cyclegan": {"lambda_A": 5.0, "lambda_identity": 0.0}}},
}
# the cases this file runs (the other file runs the rest)
RUN = ("h2z_rec_noise_ema",)


def build_pair(tmp_path_factory, cases):
    """{case: (JAX model, port model)} from the same seeded weights."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcg, "init_net_state", fast_init_net_state(300))
        mp.setattr(jcg, "scheme_from_opt", lambda state, key, opt: state)
        for case in cases:
            out[case] = _models(tmp_path_factory.mktemp(case), CASES[case])
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return build_pair(tmp_path_factory, RUN)


def _models(tmp, extra):
    cfg = h2z_cfg(tmp, extra)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = 4
    jm = jax_create_model(jopt)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.steps_per_epoch = 4
    tm = create_model(opt, device="cpu")
    assert list(tm.nets) == ["G_A", "G_B"] + [s for s, _, _ in jm.d_names]
    assert tm.d_names == jm.d_names
    for name, net in tm.nets.items():
        load_flax(net, jm.states[name].params)
    for name, net in tm.ema_nets.items():
        load_flax(net, jm.states[name].ema_params)
    return jm, tm


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("A", "B")}


def _step_draws(key, tm):
    """The JAX step's draws for ``key`` (``cycle_gan_model.py:208-290``):
    split in 8; rngs[0] split for rec_noise; rngs[1] and rngs[2] the pools
    of A and B; fold_in(rngs[3], i) D i's noise, fold_in(rngs[4], i) and
    fold_in(rngs[5], i) its real and fake DiffAugment."""
    rngs = jax.random.split(key, 8)
    shape = (BATCH, SIZE, SIZE, 3)

    def normal(k):
        return torch.from_numpy(np.array(jax.random.normal(k, shape,
                                                           jnp.float32)))
    draws = {"pool_A": pool_draws(rngs[1], BATCH, tm.pool_A.pool_size),
             "pool_B": pool_draws(rngs[2], BATCH, tm.pool_B.pool_size),
             "d_noise": {}, "d_real_aug": {}, "d_fake_aug": {}}
    if tm.rec_noise > 0:
        draws["rec_noise"] = tuple(normal(r)
                                   for r in jax.random.split(rngs[0]))
    for di, (sname, _, _) in enumerate(tm.d_names):
        if tm.d_noise > 0:
            draws["d_noise"][sname] = normal(jax.random.fold_in(rngs[3], di))
        if tm.diff_policy:
            for k, r in (("d_real_aug", rngs[4]), ("d_fake_aug", rngs[5])):
                draws[k][sname] = aug_draws(jax.random.fold_in(r, di), shape,
                                            tm.diff_policy, tm.diff_prob)
    return draws


def _zero_grad(tm):
    """{parameter: element mask} of the exact-zero gradients: conv biases
    right before an InstanceNorm (the resnet Gs' but their heads; the basic
    Ds' middle convs), and the key third of each attention ``qkv`` bias (it
    shifts all of a query's scores alike)."""
    out = {}
    for gname in ("G_A", "G_B"):
        for n, p in tm.nets[gname].named_parameters():
            if n.endswith("qkv.bias"):
                m = torch.zeros(p.shape, dtype=bool)
                m[p.numel() // 3:2 * p.numel() // 3] = True
                out[f"{gname}.{n}"] = m
            elif (tm.opt.G_netG != "unet_256" and n.endswith(".bias")
                  and ".head." not in n):
                out[f"{gname}.{n}"] = torch.ones(p.shape, dtype=bool)
    for sname, _, name in tm.d_names:
        if name == "D_B_basic":
            for i in range(1, tm.opt.D_n_layers + 1):
                p = tm.nets[sname].get_parameter(f"Conv_{i}.bias")
                out[f"{sname}.Conv_{i}.bias"] = torch.ones(p.shape,
                                                           dtype=bool)
    return out


def _port_state(tm):
    import copy
    return copy.deepcopy({
        "nets": {n: net.state_dict() for n, net in tm.nets.items()},
        "ema": {n: net.state_dict() for n, net in tm.ema_nets.items()},
        "tx": {n: s.tx.state_dict() for n, s in tm.states.items()},
        "step": {n: s.step for n, s in tm.states.items()},
        "pools": [(p.buffer, p.count) for p in (tm.pool_A, tm.pool_B)]})


def _set_port_state(tm, state):
    import copy
    for name, net in tm.nets.items():
        net.load_state_dict(state["nets"][name])
        tm.states[name].tx.load_state_dict(copy.deepcopy(state["tx"][name]))
        tm.states[name].step = state["step"][name]
    for name, net in tm.ema_nets.items():
        net.load_state_dict(state["ema"][name])
    for pool, (buf, count) in zip((tm.pool_A, tm.pool_B), state["pools"]):
        pool.buffer.copy_(buf)
        pool.count = count


def _jax_state(tm, states, pools):
    states, pools = jax.device_get((states, pools))
    return {
        "nets": {n: flax_to_torch(states[n].params) for n in tm.nets},
        "ema": {n: flax_to_torch(states[n].ema_params) for n in tm.ema_nets},
        "tx": {n: optax_adam_state_to_torch(states[n].opt_state)
               for n in tm.states},
        "step": {n: int(states[n].step) for n in tm.states},
        "pools": [(torch.from_numpy(np.array(p.buffer)), int(p.count))
                  for p in pools]}


def run_trajectory(jm, tm):
    """STEPS steps of both packages (see the module doc)."""
    assert (tm.gan_mode, tm.diff_policy, tm.rec_noise, tm.d_noise,
            tm.lambda_A, tm.lambda_idt, tm.use_ema) == (
        jm.gan_mode, jm.diff_policy, jm.rec_noise, jm.d_noise,
        jm.lambda_A, jm.lambda_idt, jm.use_ema)
    step = jm._make_step()
    # copies (the step donates its inputs, and the checkpoint test reads
    # jm's own state again), committed like the step's outputs, so the
    # step compiles once
    states, pools = jax.device_put(jax.tree.map(
        jnp.copy, (jm.states, (jm.pool_A, jm.pool_B))), jax.devices()[0])
    zero = _zero_grad(tm)
    for i in range(STEPS):
        batch = _batch(10 + i)
        key = jax.random.PRNGKey(1000 + i)
        dev = quantize_batch(jm.set_input(batch),
                             float_keys=("real_A", "real_B"))
        shared = _jax_state(tm, states, pools)
        states, pools, jlosses = step(states, pools, key, dev)
        own = _port_state(tm) if i else None
        _set_port_state(tm, shared)
        draws = _step_draws(key, tm)
        tlosses = tm.optimize_prepared(tm.prepare_batch(batch), draws)
        assert set(tlosses) == set(jlosses)
        for k, v in jlosses.items():
            assert abs(float(tlosses[k]) - float(v)) <= 1e-4 * max(
                1.0, abs(float(v))), (i, k, float(tlosses[k]), float(v))
        for tp, jp in zip((tm.pool_A, tm.pool_B), pools):
            np.testing.assert_allclose(to_np(tp.buffer),
                                       np.asarray(jp.buffer), atol=1e-3)
        if own is not None:
            # the port's own run: back to its state, the same step again
            _set_port_state(tm, own)
            tm.optimize_prepared(tm.prepare_batch(batch), draws)
        bad = []
        nets = dict(tm.nets)
        nets.update({f"{n}_ema": net for n, net in tm.ema_nets.items()})
        for name, net in nets.items():
            tree = (states[name[:-4]].ema_params if name.endswith("_ema")
                    else states[name].params)
            want = flax_to_torch(jax.device_get(tree))
            for pname, p in net.named_parameters():
                diff = np.abs(to_np(p) - want[pname].numpy())
                mask = zero.get(f"{name.removesuffix('_ema')}.{pname}")
                mask = (np.zeros(diff.shape, bool) if mask is None
                        else mask.numpy())
                off = mask & (diff > 2 * LR * (i + 1) + 1e-6)
                rest = diff[~mask]
                if rest.size and (rest > 1e-4).mean() > FLIP_SHARE:
                    bad.append((i, name, pname, int((rest > 1e-4).sum()),
                                rest.size))
                off |= ~mask & (diff > 2 * LR * (i + 1) + 1e-4)
                if off.any():
                    bad.append((i, name, pname, float(diff.max())))
        assert not bad, bad


@pytest.mark.parametrize("case", RUN)
def test_cycle_gan_trajectory_matches_jax_step(pair, case):
    run_trajectory(*pair[case])


def test_cycle_gan_checkpoints_and_inference(pair, tmp_path):
    """The port's checkpoint files into the JAX model and back, bit for
    bit, then ``inference`` both ways against the JAX model's."""
    from joligen_tpu_torch.utils import checkpoint_io
    jm, tm = pair["h2z_rec_noise_ema"]
    tm.save_dir = jm.save_dir = str(tmp_path)
    tm.save_networks("latest")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(
        [f"latest_net_{n}.pth" for n in tm.nets]
        + [f"latest_net_{n}_ema.pth" for n in tm.ema_nets]
        + ["latest_optim.pkl"])
    for n, net in tm.nets.items():
        tree = checkpoint_io.load(str(tmp_path / f"latest_net_{n}.pth"))
        back = flax_to_torch(tree)
        for k, v in net.state_dict().items():
            assert torch.equal(back[k], v), (n, k)
    jm.load_networks("latest", load_optim=False)
    for n, net in tm.nets.items():
        want = flax_to_torch(jax.device_get(jm.states[n].params))
        for k, v in net.state_dict().items():
            assert torch.equal(want[k], v), (n, k)
    batch = _batch(21)
    for direction, use_ema in (("AtoB", True), ("BtoA", False)):
        got = tm.inference(batch, use_ema=use_ema, direction=direction)
        want = jm.inference(batch, use_ema=use_ema, direction=direction)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    # phase test: the two Gs (and EMAs) only, loaded from those files
    test_m = create_model(tm.opt, phase="test", device="cpu")
    test_m.save_dir = str(tmp_path)
    test_m.load_networks("latest")
    assert sorted(test_m.nets) == ["G_A", "G_B"]
    np.testing.assert_array_equal(
        test_m.inference(batch), tm.inference(batch))


@pytest.mark.parametrize("model_type,match", [
    ("re_cycle_gan", "ROADMAP Queue 1 item 10"),
    ("re_cycle_gan_semantic_mask", "no semantic heads")])
def test_recycle_gan_raises(tmp_path, model_type, match):
    """``re_cycle_gan_semantic_mask`` raises, as in the JAX package;
    ``re_cycle_gan``, which raised naming ``match`` until ReCUT's slice,
    now builds P_A and P_B (``unet_128``) over the stack of
    ``alg_re_nuplet_size`` - 1 = 2 frames, 6 input channels."""
    opt = TrainOptions().parse_json(h2z_cfg(tmp_path), verbose=False)
    opt.model_type = model_type
    if model_type == "re_cycle_gan":
        model = create_model(opt, device="cpu")
        for name in ("P_A", "P_B"):
            assert model.nets[name].in_conv.weight.shape[1] == 6
        assert model.nets["G_A"].encoder.stem.weight.shape[1] == 3
        return
    with pytest.raises(NotImplementedError, match=match):
        create_model(opt, device="cpu")
