"""Helpers shared by the ``tests/test_torch_mat_*.py`` files: MAT's flax
trees with seeded values (every leaf non-zero: the zero-initialised biases
and noise strengths would hide errors), the random draws the JAX generator
and step take from their keys, laid out as the port takes them, and the
comparison helpers; the example config cut small."""

import contextlib
import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import mat_model as jmm
from joligen_tpu.models.train_state import NetState
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small widths of the CPU tests: generator and D base, w and z, stage 1
BASE, WZ, DIM = 16, 64, 12
# the ToRGB weights' std in the seeded trees: at 1 the accumulated image
# saturates the clamp over most of a 128 px output
RGB_STD = 0.1
# the Adam allowance of the trajectories: at most this share of a leaf's
# elements past 1e-4
FLIP_SHARE = 1e-2


def to_np(t):
    return t.detach().float().cpu().numpy()


def nchw(a, dtype=np.float32):
    return torch.from_numpy(np.array(
        np.asarray(a, dtype).transpose(0, 3, 1, 2), order="C"))


def seeded_mat_tree(shapes, seed):
    """A MAT flax tree of ``shapes`` (``jax.eval_shape``) with seeded
    values in the modules' own laws: weights N(0, 1) (the mapping's
    N(0, 100), its lr_mul 0.01; the ToRGB layers' N(0, ``RGB_STD``)),
    biases N(0, 0.2) (the modulation affines' 1 + N(0, 0.2)), noise
    strengths N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def walk(t, path):
        out = {}
        for k, v in t.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
                continue
            if k == "weight":
                std = (100.0 if "mapping" in p else
                       RGB_STD if any("rgb" in n for n in p) else 1.0)
                a = rng.normal(0.0, std, v.shape)
            elif k == "noise_strength":
                a = rng.normal(0.0, 0.5, v.shape)
            elif k == "bias":
                a = rng.normal(0.0, 0.2, v.shape) + (1.0 if "affine" in p
                                                    else 0.0)
            else:
                a = rng.normal(0.0, 0.2, v.shape)
            out[k] = np.asarray(a, np.float32)
        return out
    return walk(shapes, ())


def init_tree(module, args, kwargs, seed):
    """Seeded values for ``module.init(key, *args, **kwargs)``'s tree,
    without running the init (shapes by ``jax.eval_shape``)."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kwargs),
                            jax.random.PRNGKey(0))
    return jax.tree.map(jnp.asarray, seeded_mat_tree(shapes, seed))


def load_mat(net, tree):
    net.load_state_dict(flax_to_torch(jax.device_get(tree), True),
                        strict=True)
    return net


def noise_draws(key, net, batch, dtype=jnp.float32, frames=1):
    """The JAX generator's draws from its noise key ``key``: the first
    stage's and the bottleneck's mul_maps and the decoder's noise, in the
    port's layout (``MATGenerator.noise_shapes``; the first stage's over
    every frame of ``batch`` clips of ``frames``); float64 tensors when
    ``dtype`` is (call it under ``jax.enable_x64``, as the JAX generator then
    draws), else float32."""
    shapes = net.noise_shapes(batch, frames)
    r1, r2, r_inj = jax.random.split(key, 3)
    stage1 = jax.random.bernoulli(r1, 0.5, shapes["stage1_mul_map"])
    b, c, h, w = shapes["inj_mul_map"]
    inj = jax.random.bernoulli(r_inj, 0.5, (b, h, w, c))
    rngs = jax.random.split(r2, len(shapes["noise"]))
    noise = [jax.random.normal(r, (s[0], s[2], s[3], 1), dtype)
             for r, s in zip(rngs, shapes["noise"])]
    nd = np.float64 if dtype == jnp.float64 else np.float32
    return {"stage1_mul_map": torch.from_numpy(np.asarray(stage1, nd)),
            "inj_mul_map": nchw(inj, nd),
            "noise": [nchw(n, nd) for n in noise]}


def mix_draws(key, batch, z_dim, n_layers):
    """Style mixing's draws from ``mix_rng``: z2, the coin, the
    crossover."""
    r_z, r_p, r_c = jax.random.split(key, 3)
    return {"z2": torch.from_numpy(np.array(jax.random.normal(
                r_z, (batch, z_dim), jnp.float32))),
            "u": torch.tensor(float(jax.random.uniform(r_p, ()))),
            "cut": torch.tensor(int(jax.random.randint(r_c, (), 1,
                                                       n_layers)))}


def step_draws(key, net, batch, z_dim, mode, frames=1):
    """The JAX ``MATModel`` step's draws from its step key: z from
    rngs[0], the noise from rngs[1] (``const``: key 0; ``none``: no
    draws), style mixing from rngs[3]; ``frames`` a clip."""
    rngs = jax.random.split(key, 4)
    z = torch.from_numpy(np.array(jax.random.normal(rngs[0],
                                                    (batch, z_dim))))
    out = {"z": z, "mix": mix_draws(rngs[3], batch, z_dim,
                                    net.n_style_layers)}
    if mode != "none":
        nkey = jax.random.PRNGKey(0) if mode == "const" else rngs[1]
        out["noise"] = noise_draws(nkey, net, batch, frames=frames)
    return out


def jax_fwd_bwd(jfn, params, ins, cot):
    """``jfn(params, *ins)`` and the gradients of sum(output x ``cot``) for
    ``params`` and each of ``ins``, in one jitted call."""
    def f(p, *x):
        out, vjp = jax.vjp(jfn, p, *x)
        return out, vjp(jnp.asarray(cot, out.dtype))
    return jax.jit(f)(params, *ins)


def cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_fwd_bwd64(jfn, params, ins, cot):
    """``jax_fwd_bwd`` in float64 (``jax.enable_x64``; the tree, ``ins`` and
    ``cot`` cast), as numpy. ``jfn``'s own draws are then float64 draws
    from its keys: the port is fed the same, made under ``jax.enable_x64``."""
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    with jax.enable_x64(True):
        return jax.device_get(jax_fwd_bwd(
            jfn, jax.tree.map(f64, params), [f64(a) for a in ins], f64(cot)))


@contextlib.contextmanager
def float64(net):
    """``net`` (and the compute ``dtype`` of every module that has one: the
    video generator's motion module keeps its own) in float64 while the
    block runs, in float32 after it, each ``dtype`` as it was (the seeded
    fp32 values survive the round trip exactly; gradients are cast
    along)."""
    typed = [(m, m.dtype) for m in net.modules() if hasattr(m, "dtype")]
    net.to(torch.float64)
    for m, _ in typed:
        m.dtype = torch.float64
    try:
        yield net
    finally:
        net.to(torch.float32)
        for m, dt in typed:
            m.dtype = dt


def grads64(jfn, params, ins, net, tfn, seed):
    """The gradients of sum(output x ``cotangent(seed)``) for the
    parameters and each of ``ins`` in float64 on both sides: ``jfn(params,
    *ins)`` under ``jax.enable_x64`` and ``tfn(*ins)`` with ``net`` in float64.
    In fp32 an lrelu input within rounding of the kink may fall on either
    side, and the two packages then hold either of two valid gradients; in
    float64 both take the same side. Leaves ``net``'s gradients set;
    returns the port's input gradients and the JAX gradients (params
    first)."""
    with float64(net):
        xs = [torch.from_numpy(np.asarray(a, np.float64)).requires_grad_(
            True) for a in ins]
        got = tfn(*xs)
        cot = cotangent(tuple(got.shape), seed)
        (got * torch.from_numpy(cot).to(got.dtype)).sum().backward()
    _, jg = jax_fwd_bwd64(jfn, params, ins, cot)
    return [x.grad for x in xs], jg


def close(got, want, rtol, norm=False):
    """Largest |got - want| within ``rtol`` of the largest |want| (or, with
    ``norm``, the L2 error within ``rtol`` of the L2 norm)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    if norm:
        err, scale = np.linalg.norm(got - want), np.linalg.norm(want)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (float(err), float(scale))
    return float(err / max(scale, 1e-30))


def grads_close(jgrads, net, rtol=1e-4):
    """Every parameter gradient of ``net`` within ``rtol`` of the largest
    |JAX gradient| of all leaves (leaves' scales differ by orders of
    magnitude through the equalized-lr factors)."""
    ref = flax_to_torch(jax.device_get(jgrads), True)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    bad = []
    for name, p in net.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else to_np(p.grad)
        err = float(np.abs(g - ref[name].numpy()).max())
        if not err <= rtol * scale:
            bad.append((name, err))
    assert not bad, (scale, bad)


def merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
    return dst


def small_cfg(tmp, extra=None, size=32):
    """``example_mat_inpainting.json`` cut small: base 16, w and z 64,
    stage-1 dim 12, ``size`` px, batch 2, fp32."""
    with open(os.path.join(ROOT, "examples",
                           "example_mat_inpainting.json")) as f:
        cfg = json.load(f)
    merge(cfg, {
        "dataroot": str(tmp / "data"), "checkpoints_dir": str(tmp / "ckpt"),
        "data": {"load_size": size, "crop_size": size, "num_threads": 1},
        "G": {"ngf": BASE}, "D": {"ndf": BASE},
        "alg": {"mat": {"z_dim": WZ, "w_dim": WZ, "first_stage_dim": DIM}},
        "train": {"batch_size": 2, "n_epochs": 1, "n_epochs_decay": 0},
        "output": {"print_freq": 2, "display_freq": 0},
        "tpu": {"bf16": False}})
    return merge(cfg, extra or {})


def batch(seed, n=2, size=32, classes=1):
    """Images and label masks (a box hole each, class ids up to
    ``classes``)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    mask = np.zeros((n, size, size, 1), np.int32)
    for i in range(n):
        y0, x0 = rng.integers(0, size // 2, 2)
        h, w = rng.integers(size // 4, size // 2, 2)
        mask[i, y0:y0 + h, x0:x0 + w] = rng.integers(1, classes + 1)
    return {"B": img, "B_label_mask": mask}


def seeded_init_net_state(seed_base):
    """``init_net_state`` without running the init: the tree's shapes by
    ``jax.eval_shape``, seeded values (``seeded_mat_tree``)."""
    counter = [seed_base]

    def init(rng, module, example_inputs, tx, use_ema=False,
             init_kwargs=None):
        counter[0] += 1
        params = init_tree(module, example_inputs, init_kwargs or {},
                           counter[0])
        return NetState(params=params, opt_state=tx.init(params),
                        ema_params=(jax.tree.map(jnp.copy, params)
                                    if use_ema else None),
                        step=jnp.zeros((), jnp.int32))
    return init


def mat_models(tmp_path, monkeypatch, extra=None, seed_base=100):
    """The JAX and the port's MAT models of ``small_cfg`` on the same
    weights (G, its EMA, D and the VGG trunk)."""
    cfg = small_cfg(tmp_path, extra)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    monkeypatch.setattr(jmm, "init_net_state",
                        seeded_init_net_state(seed_base))
    jm = jax_create_model(jopt, phase="train")
    tm = create_model(opt, phase="train", device="cpu")
    for name in ("G_A", "D"):
        state = jax.device_get(jm.states[name])
        load_mat(tm.nets[name], state.params)
        if name in tm.ema_nets:
            load_mat(tm.ema_nets[name], state.ema_params)
    tm.vgg.load_state_dict(flax_to_torch(jax.device_get(jm._vgg_params)))
    # w_avg as the step returns it (replicated over the test mesh), so
    # that the jitted step compiles once
    leaf = jax.tree.leaves(jm.states["D"].params)[0]
    jm.w_avg = jax.device_put(jm.w_avg, leaf.sharding)
    return jm, tm


def weights_close(i, tm, jm, lr):
    bad = []
    for name in ("G_A", "D"):
        state = jax.device_get(jm.states[name])
        pairs = [(tm.nets[name], state.params)]
        if name in tm.ema_nets:
            pairs.append((tm.ema_nets[name], state.ema_params))
        for net, tree in pairs:
            want = flax_to_torch(tree, True)
            for n, p in net.named_parameters():
                diff = (p.detach() - want[n]).abs()
                if (diff > 1e-4).float().mean() > FLIP_SHARE:
                    bad.append((i, name, n, "share", int((diff > 1e-4).sum())))
                if diff.max() > 2 * lr * (i + 1) + 1e-4:
                    bad.append((i, name, n, float(diff.max())))
    assert not bad, bad
