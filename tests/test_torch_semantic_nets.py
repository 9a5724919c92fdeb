"""The classifiers and the semantic Ds of the port
(``joligen_tpu_torch/models/modules/semantic_networks.py``,
``gan_networks.define_D``) against the JAX package's, on the CPU, with
seeded weights (flax's default law, every leaf non-zero) carried by the
converter and the same numpy inputs:

1. ``Classifier`` (the ``basic`` C) at img_size 32 (2 levels) and 128 (4
   levels): fp32 forward and every gradient (parameters and input) to 1e-4
   of the largest; bf16 to 2e-2 of the L2 norm of the JAX fp32 output, and
   as close to JAX's bf16 output as twice that one's own distance from
   fp32;
2. ``ResNetTemplate`` resnet18 on 1 channel (tiled to 3) and 3 channels,
   resnet50 (bottleneck) on 3, at an odd size (the −inf max pool's
   border): the fp32 forward to 1e-4, every gradient in float64 on both
   sides to 1e-4 (in fp32 a ReLU input within rounding of 0 deep in
   resnet50 takes either side, each a valid gradient);
3. the ``mask`` D (a PatchGAN over 2-class one-hot masks) and the
   ``resnet18`` D from both factories on noglasses2glasses: the same (the
   mask D's gradients in fp32);
4. the factories: ``define_C`` for ``basic`` and the three templates (the
   parameter counts of ``jax.eval_shape``; the templates in fp32 under
   ``tpu_bf16``), the converter both ways bit for bit;
5. ``load_resnet_template`` on a seeded ``resnet18_tv.npz`` under a
   temporary ``JOLIGEN_TPU_WEIGHTS_DIR``: the same tree as the JAX loader's,
   bit for bit (``fc`` and a module the file holds only part of kept);
   without the file nothing changes;
6. ``f_s_net: sam`` raises in the port.
VGG16-FCN8s is in ``tests/test_torch_vgg_fcn8s.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, err_and_scale,  # noqa: F401
                               few_torch_threads, grads_close, load_flax,
                               seeded_tree, to_np)
from _torch_mat_common import cotangent, grads64, jax_fwd_bwd
from joligen_tpu.models import gan_networks as jgan
from joligen_tpu.models.modules import semantic_networks as jsem
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch.models import gan_networks as tgan
from joligen_tpu_torch.models.convert import torch_to_flax
from joligen_tpu_torch.models.modules import semantic_networks as tsem
from joligen_tpu_torch.options import TrainOptions


def _x(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _tree(jmod, x, seed):
    return seeded_tree(jax.eval_shape(lambda k: jmod.init(k, jnp.asarray(x)),
                                      jax.random.PRNGKey(0)), seed, 0.05,
                       lecun=True)


def check_fwd_grad(jmod, tmod, x, seed, float64=False):
    """Seeded weights into both; the fp32 forward to 1e-4 of the largest;
    the gradients of sum(output x cotangent) for every parameter and the
    input to 1e-4 of each leaf's largest, in fp32 or (``float64``) in
    float64 on both sides (``_torch_mat_common.grads64``: the ResNets' —
    in fp32 a ReLU input within rounding of 0, deep in resnet50, falls on
    either side, and the packages then hold either of two valid
    gradients); the converter back to the same tree, bit for bit."""
    tree = _tree(jmod, x, seed)
    load_flax(tmod, tree)
    back = torch_to_flax(tmod.state_dict())["params"]
    assert jax.tree.all(jax.tree.map(np.array_equal, back, tree["params"]))
    p = jax.tree.map(jnp.asarray, tree)
    if float64:
        want = jmod.apply(p, jnp.asarray(x))
        with torch.no_grad():
            out = tmod(torch.from_numpy(x))
        (gx,), (jg, jgx) = grads64(jmod.clone(dtype=jnp.float64).apply,
                                   tree, [x], tmod, tmod, seed + 1)
    else:
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tmod(xt)
        cot = cotangent(tuple(out.shape), seed + 1)
        (out * torch.from_numpy(cot)).sum().backward()
        want, (jg, jgx) = jax_fwd_bwd(jmod.apply, p, [jnp.asarray(x)], cot)
        gx = xt.grad
    assert out.dtype == torch.float32
    err, scale = err_and_scale(to_np(out), want, norm=False)
    assert err <= 1e-4 * scale, (err, scale)
    grads_close(jg, tmod, 1e-4, 1e-4)
    err, scale = err_and_scale(to_np(gx), jgx, norm=False)
    assert err <= 1e-4 * scale, (err, scale)
    return tree


@pytest.mark.parametrize("img_size", [32, 128])
def test_classifier_matches_jax(img_size):
    jmod = jsem.Classifier(nclasses=3, nf=8, img_size=img_size)
    tmod = tsem.Classifier(3, 3, nf=8, img_size=img_size)
    assert tmod.n_levels == (2 if img_size == 32 else 4)
    check_fwd_grad(jmod, tmod, _x(1, (2, img_size, img_size, 3)), 2)


@pytest.mark.parametrize("img_size", [32, 128])
def test_classifier_bf16_matches_jax(img_size):
    jmod = jsem.Classifier(nclasses=3, nf=8, img_size=img_size,
                           dtype=jnp.bfloat16)
    tmod = tsem.Classifier(3, 3, nf=8, img_size=img_size,
                           dtype=torch.bfloat16)
    x = _x(3, (2, img_size, img_size, 3))
    tree = _tree(jmod, x, 4)
    load_flax(tmod, tree)
    p = jax.tree.map(jnp.asarray, tree)
    want = jmod.apply(p, jnp.asarray(x))
    ref = jmod.clone(dtype=jnp.float32).apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    err, scale = err_and_scale(to_np(got), ref, norm=True)
    own, _ = err_and_scale(want, ref, norm=True)
    apart, _ = err_and_scale(to_np(got), want, norm=True)
    assert err <= 2e-2 * scale and apart <= 2 * own, (err, apart, own, scale)


@pytest.mark.parametrize("variant,channels", [
    ("resnet18", 1), ("resnet18", 3), ("resnet50", 3)])
def test_resnet_template_matches_jax(variant, channels):
    jmod = jsem.ResNetTemplate(nclasses=3, variant=variant)
    tmod = tsem.ResNetTemplate(3, variant)
    check_fwd_grad(jmod, tmod, _x(5, (2, 37, 37, channels)), 6, float64=True)


def _glasses_opts(extra=None):
    with open(os.path.join(ROOT, "examples",
                           "example_gan_noglasses2glasses.json")) as f:
        cfg = json.load(f)
    cfg["D"]["ndf"] = 8
    cfg["data"]["crop_size"] = cfg["data"]["load_size"] = 32
    cfg["tpu"]["bf16"] = False
    cfg.update(extra or {})
    return (JaxTrainOptions().parse_json(cfg, verbose=False),
            TrainOptions().parse_json(cfg, verbose=False))


@pytest.mark.parametrize("name", ["mask", "resnet18"])
def test_semantic_ds_match_jax(name):
    """The factories' mask D (its input the one-hot of
    ``f_s_semantic_nclasses`` = 2 classes) and resnet18 D."""
    jopt, opt = _glasses_opts()
    jmod = jgan.define_D(jopt, [name])[f"D_B_{name}"]
    tmod = tgan.define_D(opt, [name])[f"D_B_{name}"]
    if name == "mask":
        labels = np.random.default_rng(7).integers(0, 2, (2, 32, 32))
        x = np.eye(2, dtype=np.float32)[labels]
        assert tmod.Conv_0.weight.shape[1] == 2 and not tmod.freq_space
    else:
        x = _x(7, (2, 32, 32, 3))
        assert isinstance(tmod, tsem.ResNetTemplate)
    check_fwd_grad(jmod, tmod, x, 8, float64=name != "mask")


@pytest.mark.parametrize("template", ["basic", "resnet18", "resnet34",
                                      "resnet50"])
def test_define_c_matches_jax(template):
    """``define_C``'s net and parameter count as ``jax.eval_shape`` gives
    them; the templates stay fp32 under ``tpu_bf16``, the basic C takes
    the compute dtype."""
    jopt, opt = _glasses_opts({"tpu": {"bf16": True}})
    for o in (jopt, opt):
        o.train_sem_cls_template = template
        o.cls_semantic_nclasses = 3
    jmod, tmod = jsem.define_C(jopt), tsem.define_C(opt)
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.zeros((1, 32, 32, 3))),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
    assert n == sum(p.numel() for p in tmod.parameters())
    want = torch.float32 if template != "basic" else torch.bfloat16
    assert tmod.dtype == want and jmod.dtype == (
        jnp.float32 if template != "basic" else jnp.bfloat16)
    if template == "basic":
        assert tmod.n_levels == 2 and tmod.Dense_0.weight.shape == (3, 128)


def test_load_resnet_template_matches_jax(tmp_path, monkeypatch):
    """A seeded ``resnet18_tv.npz`` with every module's leaves but
    ``layer4_1_bn2``'s bias, and an ``fc``: both loaders swap the same
    modules (not ``fc``, not ``layer4_1_bn2``), bit for bit."""
    jmod = jsem.ResNetTemplate(nclasses=2, variant="resnet18")
    tmod = tsem.ResNetTemplate(2, "resnet18")
    x = _x(9, (1, 32, 32, 3))
    tree = _tree(jmod, x, 10)
    load_flax(tmod, tree)
    monkeypatch.setenv("JOLIGEN_TPU_WEIGHTS_DIR", str(tmp_path))
    assert tsem.load_resnet_template(tmod, "resnet18") == []
    assert jax.tree.all(jax.tree.map(
        np.array_equal, torch_to_flax(tmod.state_dict())["params"],
        tree["params"]))
    rng = np.random.default_rng(11)
    raw = {f"{k}/{leaf}": rng.normal(size=v.shape).astype(np.float32)
           for k, leaves in tree["params"].items()
           for leaf, v in leaves.items()
           if f"{k}/{leaf}" != "layer4_1_bn2/bias"}
    np.savez(tmp_path / "resnet18_tv.npz", **raw)
    swapped = tsem.load_resnet_template(tmod, "resnet18")
    assert "fc" not in swapped and "layer4_1_bn2" not in swapped
    assert len(swapped) == len(tree["params"]) - 2
    want = jsem.load_resnet_template(jax.tree.map(jnp.asarray, tree),
                                     "resnet18")
    got = torch_to_flax(tmod.state_dict())["params"]
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.array_equal(a, np.asarray(b)), got, want["params"]))
    assert np.array_equal(got["conv1"]["kernel"], raw["conv1/kernel"])
    assert np.array_equal(got["fc"]["kernel"], tree["params"]["fc"]["kernel"])


def test_sam_f_s_raises():
    _, opt = _glasses_opts()
    opt.f_s_net = "sam"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        tsem.define_f(opt)
