"""The port stands alone: it imports with jax, flax, jaxlib, msgpack, the
JAX package, cv2, tifffile and scipy blocked (every module, the training slice's,
the probes', the video slice's, b2b's and MAT's included), no source file of it (nor chip_smoke.py) imports
them, and without a CUDA device its
entry points (model, serving script, train CLI) raise unless the CPU is
asked for."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "joligen_tpu_torch")
# cv2, tifffile and scipy: outside the port's allowed set (torch, numpy, PIL
# and the standard library), though the JAX package imports them
BLOCKED = ("jax", "flax", "jaxlib", "msgpack", "joligen_tpu", "cv2",
           "tifffile", "scipy")


def _blocked(name):
    # exact module names: ``joligen_tpu_torch`` is not ``joligen_tpu``
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_blocked_names_are_exact():
    assert _blocked("joligen_tpu") and _blocked("joligen_tpu.ops")
    assert _blocked("jax.numpy") and not _blocked("joligen_tpu_torch")
    assert not _blocked("jaxtyping") and not _blocked("msgpack_numpy")
    assert _blocked("cv2") and _blocked("tifffile")
    assert not _blocked("cv2x") and not _blocked("tifffile_plugins")
    assert _blocked("scipy.special") and not _blocked("scipyx")


IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import joligen_tpu_torch
names = [m.name for m in pkgutil.walk_packages(joligen_tpu_torch.__path__,
                                               "joligen_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not bad, bad
print(" ".join(names))
""" % (BLOCKED,)
# the training slice's modules, among those the walk imports
TRAINING_MODULES = ("data", "data.datasets", "data.image_folder",
                    "data.loader", "data.transforms", "train",
                    "utils.visualizer", "models.train_state")
# the probes' modules (kernels P1-P3 and their entry points)
PROBE_MODULES = ("ops.conv3x3", "ops.copy", "tools",
                 "tools.fused_resblock_probe", "tools.bw_probe3")
# the online crops, the canny and low_res conditioning, the datasets
CONDITIONING_MODULES = ("data.online_creation", "utils.mask_generation",
                        "ops.cv_resize", "tools.synthetic_datasets")
# the CUT GAN family: ops, networks, models, the serving script
GAN_MODULES = ("ops.upfirdn2d", "ops.diff_aug", "ops.resize",
               "models.modules.resnet_generator", "models.modules.spectral",
               "models.modules.discriminators", "models.modules.projected_d",
               "models.modules.cut_networks", "models.modules.image_pool",
               "models.gan_networks", "models.cut_model",
               "models.test_model", "scripts.gen_single_image")
# the consistency and shortcut models (their host tables take math.erf where
# the JAX package takes scipy's)
CM_MODULES = ("models.modules.cm", "models.modules.sc", "models.cm_model",
              "models.sc_model")
# CUT's semantic-mask branch and the vision-aided D with its frozen towers
GLASSES_MODULES = ("models.modules.semantic_networks",
                   "models.modules.vision_aided_d", "utils.vit_layers",
                   "utils.clip_vit", "utils.dinov2")
# the segformer nets and the ref-conditioned denoiser
SEGFORMER_REF_MODULES = ("models.modules.segformer",
                         "models.modules.unet_ref_attn")
# video palette: the motion modules, the video denoiser, the temporal
# sampling and the video request script
VIDEO_MODULES = ("models.modules.motion", "models.modules.unet_vid",
                 "data.temporal_sampling", "scripts.gen_vid_diffusion")
# b2b flow matching with the video JiT denoiser
B2B_MODULES = ("models.modules.jit", "models.modules.vit_vid",
               "models.modules.b2b", "models.b2b_model")
# MAT inpainting: the generator and D, the model, the perceptual trunk,
# the request scripts
MAT_MODULES = ("models.modules.mat", "models.mat_model", "utils.metrics",
               "scripts.gen_single_image_mat", "scripts.gen_video_mat")


def test_package_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 58
    for m in (TRAINING_MODULES + PROBE_MODULES + CONDITIONING_MODULES
              + GAN_MODULES + CM_MODULES + GLASSES_MODULES
              + SEGFORMER_REF_MODULES + VIDEO_MODULES + B2B_MODULES
              + MAT_MODULES):
        assert "joligen_tpu_torch." + m in names, m


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(path, n) for n in names if _blocked(n)]
    assert not offenders


def test_no_silent_cpu_fallback(monkeypatch, tmp_path):
    from joligen_tpu_torch import resolve_device
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.scripts.common import load_model_from_file

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device(cpu=True).type == "cpu"
    cfg = {"model_type": "palette", "G": {"ngf": 8, "unet_mha": {
        "channel_mults": [1], "res_blocks": [1]}}}
    opt = TrainOptions().parse_json(cfg, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(opt)
    (tmp_path / "train_config.json").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_from_file(str(tmp_path / "latest_net_G_A.pth"))
    # python -m joligen_tpu_torch.train without --cpu: raises before any work
    from joligen_tpu_torch import train
    argv = ["--model_type", "palette", "--dataroot", str(tmp_path / "none"),
            "--checkpoints_dir", str(tmp_path / "ckpt")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    assert not (tmp_path / "ckpt").exists()
    # the video request script: the model loads on CUDA unless --cpu
    from joligen_tpu_torch.scripts import gen_vid_diffusion
    args = gen_vid_diffusion.build_parser().parse_args([
        "--model_in_file", str(tmp_path / "latest_net_G_A.pth"),
        "--dir_in", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_vid_diffusion.inference(args)
