"""The GAN entry points with CycleGAN and the new generators, on the CPU,
the port alone:

1. horse2zebra with ``--model_type cycle_gan`` at a reduced width through
   ``joligen_tpu_torch/train.py`` (2 steps): finite losses, the checkpoint
   files of both Gs (and their EMAs) and of each domain's Ds; then one
   request through ``scripts/gen_single_image.py --cpu`` from G_A's
   checkpoint, which the script serves as it serves a CUT G (G_A, A to B).
2. horse2zebra's CUT with ``--G_netG`` set to each new generator (HAT
   shrunk: its factory width is fixed), one step through the train CLI,
   then one request through ``gen_single_image.py``.
"""

import functools
import os

import numpy as np
import pytest
from PIL import Image

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import ROOT, few_torch_threads  # noqa: F401
from joligen_tpu_torch import train
from joligen_tpu_torch.models.modules import hat as that
from joligen_tpu_torch.scripts import gen_single_image as gen
from joligen_tpu_torch.tools import synthetic_datasets as synth

EXAMPLE = os.path.join(ROOT, "examples", "example_gan_horse2zebra.json")
SMALL = ["--data_load_size", "36", "--data_crop_size", "32", "--G_ngf", "8",
         "--G_nblocks", "2", "--D_ndf", "8", "--D_proj_interp", "-1",
         "--data_num_threads", "1", "--train_n_epochs", "1",
         "--train_n_epochs_decay", "0", "--output_print_freq", "1",
         "--G_unet_mha_channel_mults", "1", "2",
         "--G_unet_mha_res_blocks", "1", "1",
         "--G_unet_mha_num_head_channels", "8",
         "--G_unet_mha_group_norm_size", "4", "--G_hdit_widths", "32", "64",
         "--G_hdit_depths", "2", "2", "--G_uvit_num_transformer_blocks",
         "2"]


def _serve(run, root, tmp_path):
    out = gen.main(["--cpu", "--model_in_file",
                    os.path.join(run, "latest_net_G_A.pth"),
                    "--img_in", os.path.join(root, "trainA", "0000.png"),
                    "--img_out", str(tmp_path / "out.png")])
    img = np.asarray(Image.open(os.path.join(root, "trainA", "0000.png")))
    assert out.shape == img.shape and out.dtype == np.uint8
    assert os.path.exists(tmp_path / "out.png")


def test_cycle_gan_trains_and_serves(tmp_path, capsys):
    root = str(tmp_path / "data")
    synth.write_unaligned(root, 4, 40)
    ckpt = str(tmp_path / "ckpt")
    model = train.launch_training(train.TrainOptions().parse_cli([
        "--cpu", "--config_json", EXAMPLE, "--model_type", "cycle_gan",
        "--dataroot", root, "--checkpoints_dir", ckpt, "--name", "cg",
        "--train_batch_size", "2", "--train_G_ema", *SMALL]), cpu=True)
    losses = {k: float(v) for k, v in model.loss_log.items()}
    assert set(losses) == {
        "G_GAN", "G_cycle_A", "G_cycle_B", "G_idt_A", "G_idt_B", "G_tot",
        "D_D_B_projected_d_A", "D_D_B_basic_A", "D_D_B_projected_d_B",
        "D_D_B_basic_B"}
    assert all(np.isfinite(v) for v in losses.values())
    run = os.path.join(ckpt, "cg")
    assert {f[len("latest_net_"):-4] for f in os.listdir(run)
            if f.startswith("latest_net_")} == {
        "G_A", "G_A_ema", "G_B", "G_B_ema", "D_B_projected_d_A",
        "D_B_basic_A", "D_B_projected_d_B", "D_B_basic_B"}
    _serve(run, root, tmp_path)


@pytest.mark.parametrize("netg", ["unet_mha", "uvit", "unet_256",
                                  "unet_128", "hdit", "hat", "ittr"])
def test_cut_with_new_generator_trains_and_serves(tmp_path, monkeypatch,
                                                  netg):
    monkeypatch.setattr(that, "HAT", functools.partial(
        that.HAT, embed_dim=12, depths=(2, 2), num_heads=(2, 2)))
    root = str(tmp_path / "data")
    synth.write_unaligned(root, 2, 40)
    ckpt = str(tmp_path / "ckpt")
    train.main(["--cpu", "--config_json", EXAMPLE, "--G_netG", netg,
                "--dataroot", root, "--checkpoints_dir", ckpt, "--name",
                netg, "--train_batch_size", "2", "--D_netDs", "basic",
                *SMALL])
    _serve(os.path.join(ckpt, netg), root, tmp_path)
