"""CUT with the classifier C (``train_semantic_cls``) and the gumbel mask D
against the JAX package, on the CPU.

A 3-step trajectory of ``CUTModel.optimize_prepared`` against the JAX
step (``_make_step``) in fp32, on ``example_gan_noglasses2glasses.json``
at a small width (mobile_resnet_attn G at ngf 8 and 2 blocks, the NCE taps
0 and 4; the basic and mask Ds at ndf 8; f_s nf 16; the ``basic`` C at nf
8; 32 px, 16 patches), batches of 2 with label masks and class labels, one
of them out of range (2 of 2 classes: its cross-entropy counts 0 in both
packages), with ``train_sem_cls_B``, ``train_sem_idt`` and
``cls_class_weights``, the JAX step's draws fed (patch ids, the pool, the
mask D's gumbel noise). The thresholds of f_s and C are raised to 10, so
that both gates open. Held as ``tests/_torch_re_common.py`` sets out:
each step's losses (``CLS``, ``G_sem_cls``, ``G_sem_cls_idt``,
``D_D_B_mask`` among them) to 1e-4, the pool to 1e-3, every net (C and
the mask D among them) on the port's own run with the Adam allowance of
``ROADMAP.md`` Queue 3. One JAX step is compiled for the file.

Then C's files in both directions bit for bit; the L1 regression
criterion (``train_cls_regression``, ``train_cls_l1_regression``): C's
loss and G's term of a port step against the JAX ``_cls_crit`` on the same
logits; and the raises: a mask D without ``train_semantic_mask`` (the
JAX ``ValueError``, word for word) and an unknown C template.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, fast_init_net_state,  # noqa: F401
                               few_torch_threads, merge)
from _torch_re_common import (SIZE, STEPS, build_models, cut_draws,
                              run_cut_trajectory)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import cut_model as jcut_model
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.utils import checkpoint_io

BATCH = 2


def cls_cfg(tmp, extra=None):
    with open(os.path.join(ROOT, "examples",
                           "example_gan_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    merge(cfg, {
        "checkpoints_dir": str(tmp), "G": {"ngf": 8, "nblocks": 2},
        "D": {"ndf": 8, "netDs": ["basic", "mask"]},
        "data": {"crop_size": SIZE, "load_size": SIZE, "num_threads": 1,
                 "dataset_mode": "unaligned_labeled_mask_cls"},
        "alg": {"cut": {"num_patches": 16, "nce_layers": "0,4"}},
        "f_s": {"nf": 16, "semantic_threshold": 10.0},
        "cls": {"nf": 8, "semantic_nclasses": 2, "class_weights": [1, 3],
                "semantic_threshold": 10.0},
        "train": {"batch_size": BATCH, "pool_size": 3,
                  "semantic_cls": True,
                  "sem": {"cls_B": True, "idt": True}},
        "tpu": {"bf16": False}})
    return merge(cfg, extra or {})


def cls_batch(seed):
    """Images, rectangle label masks (1 inside) and class labels of A and
    B; A's second label is out of range."""
    rng = np.random.default_rng(seed)
    out = {k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
           for k in "AB"}
    for k in ("A_label_mask", "B_label_mask"):
        m = np.zeros((BATCH, SIZE, SIZE, 1), np.int64)
        for b in range(BATCH):
            y, x = rng.integers(0, SIZE // 2, 2)
            m[b, y:y + SIZE // 3, x:x + SIZE // 3] = 1
        out[k] = m
    out["A_label_cls"] = np.array([int(rng.integers(0, 2)), 2], np.int32)
    out["B_label_cls"] = rng.integers(0, 2, BATCH).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return build_models(tmp_path_factory.mktemp("cls"),
                        cls_cfg(tmp_path_factory.mktemp("ck")), jcut_model)


def test_cls_and_mask_d_trajectory_matches_jax(pair):
    jm, tm = pair
    assert {"CLS", "D_B_mask", "D_B_basic", "f_s"} <= set(tm.nets)
    assert tm.nets["D_B_mask"].Conv_0.weight.shape[1] == 2

    def on_step(i, tlosses, jlosses, draws):
        assert {"CLS", "G_sem_cls", "G_sem_cls_idt", "D_D_B_mask",
                "G_sem_mask", "G_sem_mask_idt"} <= set(tlosses)
        assert float(tlosses["G_sem_cls"]) > 0
        assert draws["gumbel"]["D_B_mask"].shape == (BATCH, SIZE, SIZE, 2)
    run_cut_trajectory(jm, tm, [cls_batch(10 + i) for i in range(STEPS)],
                       [jax.random.PRNGKey(1000 + i) for i in range(STEPS)],
                       on_step)


def test_cls_checkpoints_both_ways(pair, tmp_path):
    """C's file from the port into the JAX model and the JAX model's into
    the port, bit for bit."""
    jm, tm = pair
    tm.save_dir = jm.save_dir = str(tmp_path)
    tm.save_networks("latest")
    jm.load_networks("latest", load_optim=False)
    want = flax_to_torch(jax.device_get(jm.states["CLS"].params))
    for k, v in tm.nets["CLS"].state_dict().items():
        assert torch.equal(want[k], v), k
    for p in tm.nets["CLS"].parameters():
        p.data.add_(0.5)
    jm.save_networks("jax")
    tree = checkpoint_io.load(str(tmp_path / "jax_net_CLS.pth"))
    tm.load_networks("jax", load_optim=False)
    for k, v in tm.nets["CLS"].state_dict().items():
        assert torch.equal(flax_to_torch(tree)[k], v), k


def test_cls_l1_regression_losses(pair):
    """``train_cls_regression`` with ``train_cls_l1_regression``: a port
    step's C loss (C before its update, on A and B) and G's
    ``G_sem_cls`` (C after it, on the step's fake) against the JAX
    ``_cls_crit`` in that mode on the same logits, 1e-5."""
    jm, tm = pair
    with pytest.MonkeyPatch.context() as mp:
        for m in (jm, tm):
            mp.setattr(m, "cls_regression", True)
            mp.setattr(m, "cls_l1_regression", True)
        _regression_step(jm, tm)


def _regression_step(jm, tm):
    batch = cls_batch(31)
    dev = tm.prepare_batch(batch)
    real_A, real_B = (dev[k].float() / 127.5 - 1.0 for k in ("real_A",
                                                             "real_B"))
    cls_A, cls_B = dev["cls_A"], dev["cls_B"]
    params = jax.tree.map(jnp.asarray, {"params": _flax_tree(
        tm.nets["CLS"])})

    def crit(img, label, p):
        logits = jm.netCLS.apply(p, jnp.asarray(img.numpy()))
        return float(jm._cls_crit(logits, jnp.asarray(label.numpy())))
    want_cls = crit(real_A, cls_A, params) + crit(real_B, cls_B, params)
    draws = cut_draws(jax.random.PRNGKey(5), jm, tm, BATCH, 0, 0.0)
    fakes = []      # the step's first G call gives (fake_B, features)
    handle = tm.nets["G_A"].register_forward_hook(
        lambda mod, args, out: fakes.append(out))
    try:
        losses = tm.optimize_prepared(dev, draws)
    finally:
        handle.remove()
    assert abs(float(losses["CLS"]) - want_cls) <= 1e-5 * max(1, want_cls)
    updated = jax.tree.map(jnp.asarray, {"params": _flax_tree(
        tm.nets["CLS"])})
    want_g = crit(fakes[0][0].detach(), cls_A, updated)  # the gate is open
    assert abs(float(losses["G_sem_cls"]) - want_g) <= 1e-5 * max(1, want_g)
    assert want_g > 0


def _flax_tree(net):
    from joligen_tpu_torch.models.convert import torch_to_flax
    return torch_to_flax({k: v.detach() for k, v in
                          net.state_dict().items()})["params"]


def test_mask_d_without_semantic_mask_raises_as_jax(tmp_path, monkeypatch):
    """Both packages refuse a mask D without ``train_semantic_mask``, with
    the same ``ValueError``; an unknown C template raises
    ``NotImplementedError`` in both."""
    monkeypatch.setattr(jcut_model, "init_net_state", fast_init_net_state(7))
    monkeypatch.setattr(jcut_model, "scheme_from_opt",
                        lambda state, key, opt: state)
    cfg = cls_cfg(tmp_path, {"train": {"semantic_mask": False,
                                       "semantic_cls": False}})
    msgs = []
    for make, opts in ((jax_create_model, JaxTrainOptions),
                       (lambda o: create_model(o, device="cpu"),
                        TrainOptions)):
        with pytest.raises(ValueError) as err:
            make(opts().parse_json(copy.deepcopy(cfg), verbose=False))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "train_semantic_mask" in msgs[0]
    cfg = cls_cfg(tmp_path)
    msgs = []
    for make, opts in ((jax_create_model, JaxTrainOptions),
                       (lambda o: create_model(o, device="cpu"),
                        TrainOptions)):
        opt = opts().parse_json(copy.deepcopy(cfg), verbose=False)
        opt.train_sem_cls_template = "resnet101"
        with pytest.raises(NotImplementedError) as err:
            make(opt)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "resnet101" in msgs[0]
