"""ReCUT's and ReCycleGAN's data and frame predictors against the JAX
package, on the CPU, and their entry points, the port alone:

1. ``nuplet_unaligned_labeled_mask`` against the JAX dataset on the same
   files (labeled masks in both domains, 40 px loads cut to 32 px crops
   with flips), Python's ``random`` and numpy seeded alike before each
   item: masks and paths exactly, images to 1e-6 (one float32 ulp, as
   ``tests/test_torch_data.py``), A and B (N, H, W, C); A's frames
   wrap at the end of the domain; the loader's batches are (B, N, H, W,
   C).
2. ``define_P`` for each ``alg_re_netP`` choice (resnet_9blocks,
   resnet_6blocks, resnet_attn, unet_256, unet_128) at ngf 8 against the
   JAX net built over the same stack of 2 frames, on seeded weights: the
   input width, the names and the forward to 1e-4 of the largest output.
3. ``--model_type re_cycle_gan`` and ``re_cut_semantic_mask`` (with
   FastCUT's flips) through ``joligen_tpu_torch/train.py`` over the nuplet
   layout (2 steps), the P checkpoint files among the others, then one
   request through ``scripts/gen_single_image.py`` from G_A's checkpoint;
   ``re_cut`` builds P_B and no f_s; ``re_cycle_gan_semantic_mask`` raises
   as in the JAX package.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (ROOT, few_torch_threads, h2z_cfg,  # noqa: F401
                               load_flax, merge, seeded_tree, to_np)
from joligen_tpu.data import create_dataset as jax_create_dataset
from joligen_tpu.models import gan_networks as jgan
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu_torch import train
from joligen_tpu_torch.data import create_dataloader, create_dataset
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.gan_networks import define_P
from joligen_tpu_torch.options import TrainOptions
from joligen_tpu_torch.scripts import gen_single_image as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth

MODE = "nuplet_unaligned_labeled_mask"
NETS_P = ("resnet_9blocks", "resnet_6blocks", "resnet_attn", "unet_256",
          "unet_128")
SMALL = ["--data_load_size", "32", "--data_crop_size", "32", "--G_ngf", "8",
         "--G_nblocks", "2", "--D_ndf", "8", "--D_proj_interp", "-1",
         "--data_num_threads", "1", "--train_n_epochs", "1",
         "--train_n_epochs_decay", "0", "--output_print_freq", "1",
         "--train_batch_size", "2", "--data_dataset_mode", MODE,
         "--data_relative_paths", "--D_netDs", "basic"]


@pytest.fixture(scope="module")
def nuplet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuplet"))
    synth.write_unaligned_labeled(root, 5, 40, seed=7)
    return root


def _data_cfg(root, size=3):
    return {"model_type": "re_cut_semantic_mask", "dataroot": root,
            "data": {"dataset_mode": MODE, "load_size": 40, "crop_size": 32,
                     "relative_paths": True},
            "alg": {"re": {"nuplet_size": size}},
            "train": {"batch_size": 2}}


@pytest.mark.parametrize("size", [2, 3])
def test_nuplet_items_match_jax_dataset(nuplet_root, size):
    cfg = _data_cfg(nuplet_root, size)
    jds = jax_create_dataset(JaxTrainOptions().parse_json(cfg, verbose=False))
    tds = create_dataset(TrainOptions().parse_json(cfg, verbose=False))
    assert type(jds).__name__ == type(tds).__name__ == \
        "NupletUnalignedLabeledMaskDataset"
    assert len(tds) == len(jds) == 5
    for i in range(len(tds)):
        items = []
        for ds in (jds, tds):
            random.seed(200 + i)
            np.random.seed(200 + i)
            items.append(ds[i])
        want, got = items
        assert sorted(got) == sorted(want) == [
            "A", "A_img_paths", "A_label_mask", "B", "B_label_mask"]
        assert got["A"].shape == got["B"].shape == (size, 32, 32, 3)
        assert got["A_label_mask"].shape == (size, 32, 32, 1)
        for k, w in want.items():
            if isinstance(w, np.ndarray) and w.dtype == np.float32:
                # as tests/test_torch_data.py: the JAX package may normalise
                # with its g++ helper, one float32 ulp off the division
                assert got[k].dtype == w.dtype, k
                np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0,
                                           err_msg=k)
            elif isinstance(w, np.ndarray):
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                assert got[k] == w, k
    # A's frames wrap at the domain's end: item 4 holds frames 4, 0 (, 1)
    random.seed(0)
    item = tds[4]
    random.seed(0)
    p = tds.transform.sample_params()
    first = tds.transform.image(tds._load_img(tds.A_img_paths[0]), p)
    np.testing.assert_array_equal(item["A"][1], first)


def test_nuplet_loader_batches(nuplet_root):
    opt = TrainOptions().parse_json(_data_cfg(nuplet_root), verbose=False)
    batch = next(iter(create_dataloader(opt, create_dataset(opt))))
    assert batch["A"].shape == batch["B"].shape == (2, 3, 32, 32, 3)
    assert batch["A_label_mask"].shape == batch["B_label_mask"].shape == (
        2, 3, 32, 32, 1)
    assert batch["A"].dtype == np.float32
    assert batch["A_label_mask"].dtype == np.int32


@pytest.mark.parametrize("net_p", NETS_P)
def test_frame_predictor_matches_jax(tmp_path, net_p):
    """P over the channel stack of 2 frames (6 channels) to one frame."""
    cfg = h2z_cfg(tmp_path, {"model_type": "re_cycle_gan",
                             "alg": {"re": {"netP": net_p}}})
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.G_netG = net_p
    jnet = jgan.define_G(jopt)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 6)).astype(
        np.float32)
    tree = seeded_tree(jax.eval_shape(lambda k: jnet.init(
        k, jnp.asarray(x)), jax.random.PRNGKey(0)), 11, 0.05, lecun=True)
    tnet = define_P(opt)
    assert opt.model_input_nc == 3 and opt.G_netG == "resnet_attn"
    load_flax(tnet, tree)
    stem = next(p for n, p in tnet.named_parameters() if p.ndim == 4)
    assert stem.shape[1] == 6
    want = np.asarray(jax.jit(jnet.apply)(jax.tree.map(jnp.asarray, tree),
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = to_np(tnet(torch.from_numpy(x)))
    assert got.shape == want.shape == (2, 16, 16, 3)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(got - want).max()) <= 1e-4 * scale


def _serve(run, root, tmp_path):
    img_in = os.path.join(root, "trainA", "imgs", "0000.png")
    out = gen.main(["--cpu", "--model_in_file",
                    os.path.join(run, "latest_net_G_A.pth"),
                    "--img_in", img_in, "--img_out", str(tmp_path / "o.png")])
    assert out.shape == np.asarray(Image.open(img_in)).shape
    assert out.dtype == np.uint8


@pytest.mark.parametrize("model_type,config,extra,nets,keys", [
    ("re_cycle_gan", "horse2zebra", ["--alg_re_adversarial_loss_p"],
     {"G_A", "G_B", "D_B_basic_A", "D_B_basic_B", "P_A", "P_B"},
     {"P_proj_real_A", "P_proj_real_B", "G_recycle_A", "G_recycle_B",
      "G_proj_adversarial"}),
    ("re_cut_semantic_mask", "noglasses2glasses",
     ["--alg_cut_flip_equivariance", "--f_s_nf", "8",
      "--alg_cut_num_patches", "16"],
     {"G_A", "G_A_ema", "F", "D_B_basic", "f_s", "P_B"},
     {"P_proj_real_B", "G_recut", "G_sem_mask", "f_s"})])
def test_recycle_and_recut_train_and_serve(tmp_path, nuplet_root, model_type,
                                           config, extra, nets, keys):
    ckpt = str(tmp_path / "ckpt")
    model = train.launch_training(train.TrainOptions().parse_cli([
        "--cpu", "--config_json",
        os.path.join(ROOT, "examples", f"example_gan_{config}.json"),
        "--model_type", model_type,
        "--dataroot", nuplet_root, "--checkpoints_dir", ckpt,
        "--name", "re", *SMALL, *extra]), cpu=True)
    losses = {k: float(v) for k, v in model.loss_log.items()}
    assert keys <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    assert model.nets["P_B"].in_conv.weight.shape[1] == 6
    run = os.path.join(ckpt, "re")
    assert {f[len("latest_net_"):-4] for f in os.listdir(run)
            if f.startswith("latest_net_")} == nets
    _serve(run, nuplet_root, tmp_path)


def test_recut_builds_p_and_recycle_semantic_raises(tmp_path):
    opt = TrainOptions().parse_json(merge(h2z_cfg(tmp_path), {
        "model_type": "re_cut", "D": {"netDs": ["basic"]}}), verbose=False)
    model = create_model(opt, device="cpu")
    assert model.recut and not model.semantic_mask
    assert sorted(model.nets) == ["D_B_basic", "F", "G_A", "P_B"]
    assert model.nets["P_B"].in_conv.weight.shape[1] == 6
    opt.model_type = "re_cycle_gan_semantic_mask"
    with pytest.raises(NotImplementedError, match="no semantic heads"):
        create_model(opt, device="cpu")
