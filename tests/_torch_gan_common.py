"""Helpers shared by the ``tests/test_torch_gan_*.py`` files: the random
draws the JAX GAN code takes from its keys, made with ``jax.random`` on the
host in the JAX order and laid out as the port's explicit-draw functions
take them; flax trees with seeded values; layout and comparison helpers;
horse2zebra's config cut small."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from joligen_tpu.models.train_state import NetState
from joligen_tpu_torch.models.convert import flax_to_torch

jaug = importlib.import_module("joligen_tpu.ops.diff_aug")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# horse2zebra cut small for the CPU tests: crop, batch
SIZE, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """One intra-op thread for torch while a port test module runs (the
    previous count is restored after it): these modules run beside others
    in parallel workers, where a thread per core in each worker
    oversubscribes the CPU (4 workers ran the GAN modules in 81 s with 2
    threads, 198 s with 8; 6 workers ran every port module in 4,754
    test-seconds with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def to_np(t):
    return t.detach().float().cpu().numpy()


def aug_draws(key, shape, policy, prob):
    """``diff_augment(key, x, policy, prob)``'s draws for an NHWC ``shape``
    (fp32), as ``apply_diff_augment`` takes them (NCHW noise)."""
    n, h, w, c = shape
    rng_gate, rng_ops = jax.random.split(key)
    d = {}
    for p in policy.split(","):
        p = p.strip()
        if p not in jaug.POLICY_FNS:
            continue
        for fn in jaug.POLICY_FNS[p]:
            rng_ops, sub = jax.random.split(rng_ops)
            name = fn.__name__
            if name in ("rand_brightness", "rand_saturation",
                        "rand_contrast"):
                d[name[5:]] = jax.random.uniform(sub, (n, 1, 1, 1),
                                                 jnp.float32).reshape(n)
            elif name == "rand_translation":
                sh, sw = max(1, int(h * 0.125)), max(1, int(w * 0.125))
                r1, r2 = jax.random.split(sub)
                d["ty"] = jax.random.randint(r1, (n,), -sh, sh + 1)
                d["tx"] = jax.random.randint(r2, (n,), -sw, sw + 1)
            elif name == "rand_cutout":
                r1, r2 = jax.random.split(sub)
                d["cy"] = jax.random.randint(r1, (n, 1, 1), 0, h).reshape(n)
                d["cx"] = jax.random.randint(r2, (n, 1, 1), 0, w).reshape(n)
            elif name == "rand_noise":
                d["noise"] = jnp.transpose(jax.random.normal(
                    sub, (n, h, w, c), jnp.float32), (0, 3, 1, 2))
            elif name == "rand_resize_crop":
                r1, r2, r3 = jax.random.split(sub, 3)
                d["zoom"] = jax.random.uniform(r1, (n,))
                d["oy"] = jax.random.uniform(r2, (n,))
                d["ox"] = jax.random.uniform(r3, (n,))
    out = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    for k in ("ty", "tx", "cy", "cx"):
        if k in out:
            out[k] = out[k].long()
    if prob < 1.0:
        out["use"] = torch.tensor(bool(jax.random.uniform(rng_gate, ())
                                       < prob))
    return out


def patch_ids(key, hws, num_patches):
    """``sample_patch_ids(key, feats, num_patches)``'s ids for maps of
    ``hws`` positions."""
    ids = []
    for hw in hws:
        key, sub = jax.random.split(key)
        ids.append(torch.from_numpy(np.array(jax.random.choice(
            sub, hw, shape=(min(num_patches, hw),), replace=False))).long())
    return ids


def pool_draws(key, batch, pool_size):
    """``ImagePool.query(key, fakes)``'s draws."""
    rng_u, rng_i = jax.random.split(key)
    return {"u": torch.from_numpy(np.array(jax.random.uniform(rng_u,
                                                              (batch,)))),
            "idx": torch.from_numpy(np.array(jax.random.randint(
                rng_i, (batch,), 0, pool_size))).long()}


def seeded_tree(shapes, seed, scale=0.1, lecun=False):
    """A flax tree of ``shapes`` (from ``jax.eval_shape``) with seeded
    values: kernels N(0, scale) (``lecun``: N(0, 1/fan_in), flax's default
    law, which keeps a deep trunk's signal alive), scales 1 + N(0, scale),
    biases N(0, scale)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            std = scale
            if lecun and k == "kernel":
                std = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            a = rng.normal(0.0, std, v.shape).astype(np.float32)
            out[k] = a + 1.0 if k == "scale" else a
        return out
    return walk(shapes)


def fast_init_net_state(seed_base):
    """``init_net_state`` without XLA: shapes from ``jax.eval_shape``,
    seeded values of flax's default law (the JAX package's own init and init
    scheme compile every net; the port gets the same values by
    conversion)."""
    counter = [seed_base]

    def init(rng, module, example_inputs, tx, use_ema=False,
             init_kwargs=None):
        shapes = jax.eval_shape(lambda r: module.init(
            r, *example_inputs, **(init_kwargs or {})), rng)
        counter[0] += 1
        params = jax.tree.map(jnp.asarray,
                              seeded_tree(shapes, counter[0], 0.05,
                                          lecun=True))
        return NetState(params=params, opt_state=tx.init(params),
                        ema_params=(jax.tree.map(jnp.copy, params)
                                    if use_ema else None),
                        step=jnp.zeros((), jnp.int32))
    return init


def memo_init_net_state(init_net_state):
    """``init_net_state`` with its params computed once per net: the JAX
    init of a flax module depends on the key, the module's fields and the
    example inputs' shapes only, so a test module that builds one net under
    several configs (losses, options) compiles its init once and gets the
    same values each time; the optimizer state and EMA are built anew."""
    cache = {}

    def init(rng, module, example_inputs, tx, use_ema=False,
             init_kwargs=None):
        shapes = jax.tree.map(lambda a: (np.shape(a), str(np.result_type(a))),
                              (list(example_inputs), init_kwargs or {}))
        key = (repr(module), repr(shapes),
               np.asarray(jax.random.key_data(rng)).tobytes())
        if key not in cache:
            cache[key] = init_net_state(rng, module, example_inputs, tx,
                                        use_ema, init_kwargs).params
        params = cache[key]
        return NetState(params=params, opt_state=tx.init(params),
                        ema_params=(jax.tree.map(jnp.copy, params)
                                    if use_ema else None),
                        step=jnp.zeros((), jnp.int32))
    return init


@pytest.fixture(autouse=True, scope="module")
def one_palette_init():
    """The JAX palette model's ``init_net_state`` memoised while a test
    module runs (``memo_init_net_state``): a module that builds one
    denoiser under several configs compiles its init once."""
    from joligen_tpu.models import palette_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(palette_model, "init_net_state",
                   memo_init_net_state(palette_model.init_net_state))
        yield


def load_flax(module, params):
    """Load a flax tree (with or without the top ``params`` key) into a
    port module, strictly."""
    module.load_state_dict(flax_to_torch(jax.device_get(params)), strict=True)
    return module


def err_and_scale(got, want, norm):
    """(error, scale) of ``got`` against ``want``: the largest absolute
    difference and |want|, or (``norm``) their L2 norms, the measure a bf16
    comparison takes, since single elements round one ulp apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if norm:
        return (float(np.linalg.norm(got - want)),
                float(np.linalg.norm(want)))
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def grads_close(jgrads, module, rtol, floor):
    """Every parameter gradient of ``module`` against the JAX gradient
    tree: within ``rtol`` of the leaf's largest |gradient|. A leaf whose
    JAX gradient is below ``floor`` of the largest of all has an exact
    gradient of 0 (a conv bias before InstanceNorm), rounding noise that
    differs between any two programs; the port's must be below that floor
    too."""
    ref = flax_to_torch(jax.device_get(jgrads))
    got = {n: np.zeros(p.shape, np.float32) if p.grad is None
           else to_np(p.grad) for n, p in module.named_parameters()}
    scale_all = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    bad = []
    for name, g in got.items():
        want = ref[name].numpy()
        scale = float(np.abs(want).max())
        if scale <= floor * scale_all:
            ok = float(np.abs(g).max()) <= floor * scale_all
        else:
            ok = float(np.abs(g - want).max()) <= rtol * scale
        if not ok:
            bad.append((name, float(np.abs(g - want).max()), scale))
    assert not bad, (scale_all, bad)


def merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
    return dst


def h2z_cfg(tmp, extra=None):
    """horse2zebra's config cut small (ngf 8, 2 blocks, ndf 8, no projected
    resize, 16 patches, a pool of 3, fp32), with ``extra`` merged in."""
    with open(os.path.join(ROOT, "examples",
                           "example_gan_horse2zebra.json")) as f:
        cfg = json.load(f)
    merge(cfg, {
        "checkpoints_dir": str(tmp), "G": {"ngf": 8, "nblocks": 2},
        "D": {"ndf": 8, "proj_interp": -1},
        "data": {"crop_size": SIZE, "load_size": SIZE, "num_threads": 1},
        "alg": {"cut": {"num_patches": 16}},
        "train": {"batch_size": BATCH, "pool_size": 3},
        "tpu": {"bf16": False}})
    return merge(cfg, extra or {})
