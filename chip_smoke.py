#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``joligen_tpu_torch``) on one NVIDIA
GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: compiles every kernel of the serving and training paths and of
   the probes from ``csrc/`` (one ``nvcc`` per source, started together);
   fails if ``ptxas`` spills in a ``wgmma`` kernel or injects a
   ``warpgroup.wait`` (C7517) anywhere. Every nvcc (the attention
   backward's for minutes: 72 kernels at eight head dims) runs on while
   the phases that launch no kernel of the port run (items 7, 9, 18 and
   20 and item 21's tutorial video run); the forward's
   is awaited before K1's phase, the backward's before K2/K3's.
3. Kernels: K1 (flash-attention forward), K2 (dQ) and K3 (dK, dV) each
   against its plain PyTorch version on the same CUDA tensors at the paths'
   shapes (K1 and K2 in bf16 at both query tilings; xview's 32 heads at
   (1, 256, 32, 32) and (16, 256, 32, 32), cm's (16, 256, 16, 32),
   cm_gan's (4, 256, 16, 32) and the unet GAN generators' middle block at
   horse2zebra's 256 px and batch 4, (4, 1024, 16, 32), timed there too,
   among them), and at the video paths' shapes
   (the motion modules of unet_vid at S <= 32 and head dim 8:
   (4096, 8, 8, 8), (64, 8, 8, 64), (16384, 6, 8, 8); vit_vid's token
   motion module at head dim 96, (64, 8, 8, 96), and JiT blocks,
   (8, 64, 12, 64) and (8, 96, 12, 64), and the image JiT's at 256 px,
   (8, 256, 12, 64) and (8, 288, 12, 64); b2b's blocks after the global
   context's and a reference's tokens, (8, 176, 12, 64); ragged ones) in
   both dtypes and,
   where S <= 32, both tilings, packed and plain (the card tests'
   tolerance there, TOL (1 + |want|): one bf16 ulp of those gradients
   exceeds TOL), then timed at those shapes in both tilings beside sdpa;
   the head dims 80, 128 and 160 at their paths' shapes (video MAT's
   motion module at 8 and 4 heads over 5 frames, (2048, 5, 8, 64) and
   (2048, 5, 4, 128); JiT-H's and JiT-L's motion modules, (64, 8, 8, 160)
   and (64, 8, 8, 128); JiT-H's blocks, (8, 64 | 96, 16, 80) on video and
   (8, 288, 16, 80) on images at 256 px) and ragged ones (S of 1, 5, 17,
   32, 63, 65 and 100 over odd B*H) the same way, timed at the path
   shapes beside their bounds and sdpa; the autograd Function
   against autograd through the plain forward; P1 and P2 (the 3×3 tap
   conv, each s2; bf16 on wgmma, fp32 on FMAs) against their plain versions
   in bf16 and fp32 at the conv probe's hot site (batch 2) and at ragged
   shapes, and against the library conv, then at the probe's own shape
   (batch 16) in bf16, timed there in bf16 and fp32; P3 (the chunked copy
   through TMA bulk copies on a persistent grid) bit for bit on random
   bits at fourteen chunkings, each with the grid it launched, then timed
   and checked at its path's 1 GiB in both dtypes at 256, 1024 and 4096
   rows a chunk, beside ``Tensor.copy_`` in both dtypes. For each kernel
   its time, its
   bound, the plain version's time and one library call's time as a
   yardstick, at its path's shape: each as device time (the kernels' own
   durations in a ``torch.profiler`` trace) and as wall time (CUDA events
   around back-to-back calls, the host's pace where calls are short).
4. Serving: palette inpainting at the full width of
   ``examples/example_ddpm_noglasses2glasses.json`` (128 px, ngf 64, 62.8M
   parameters, bf16) with seeded random weights, saved and reloaded through
   the checkpoint files, serving DDIM-10 requests and a DDPM one (its
   test schedule cut to 10 steps) through
   ``scripts/gen_single_image_diffusion.inference``; launch counts per
   request; outputs checked; the full-width denoiser in fp32 on the card
   against the same forward on the CPU.
5. Training: ``launch_training`` on the same config over a synthetic
   dataset of 64 images at 128 px written here, 16 steps (2 epochs of 8,
   batch 8, AdamW, EMA); launch counts, loss, attention gradients, the EMA
   lerp, step time and peak memory; then one DDIM-10 request served from the
   trained ``latest`` checkpoint; then the config at 256 px, 6 steps over
   48 images, with K1-K3's share of the step; then one fp32 training step's
   gradients, card (K1-K3) against CPU (plain versions), over all 327
   leaves.
6. The other palette configs, each over a synthetic dataset in its
   on-disk layout written here (``tools/synthetic_datasets.py``):
   ``example_ddpm_xview.json`` at full width (236,326,339 parameters, bf16,
   batch 16, 128 px, online bbox crops of 320 px images), 8 steps with
   loss, step time, images/s, peak memory and data wait; one DDIM-10
   ``--bbox_in`` request from the trained checkpoint (10 K1 launches, the
   image outside the crop window unchanged, ``_orig_bbox.json`` the window
   of ``crop_image``'s meta); 2 steps with ``tpu_remat`` under each policy
   (peak memory beside the run without it; K1 once a step under
   ``"conv"``, which keeps its outputs, twice under ``"full"``); the
   full-width denoiser in fp32 on the card against the CPU. Then 2 steps and
   one request each of mapillary (canny sketch conditioning, checked on the
   host batch; a request with fixed canny thresholds), df2kost
   (``low_res`` super-resolution, no mask; as written, its train-time
   metrics PSNR, SSIM and LPIPS over a test split of 2 images, evaluated
   at the last step and after the epoch with the config's DDPM sampler cut
   to 10 steps, ``eval_results.json``; then ``python -m
   joligen_tpu_torch.test`` on its run directory, FID, PSNR, SSIM and
   LPIPS at DDIM-10), SEN2VEN (``aligned`` pix2pix) and mario (class
   conditioning; ``inference_per_class``).
7. The CUT GANs, over synthetic unaligned datasets written here:
   ``example_gan_horse2zebra.json`` at full width (resnet_attn G, ngf 64, 9
   blocks; projected and basic Ds, ndf 64; MoNCE; DiffAugment color,cutout;
   batch 4, 256 px crops, bf16), 8 steps with every loss finite, the
   parameters of each net, step time, images/s, peak memory and data wait;
   two requests through ``scripts/gen_single_image.inference`` from the
   trained checkpoint (output finite, of the input's size); its G forward
   and its G loss with every G gradient in fp32, card against CPU; then
   ``example_gan_mnist2USPS.json``, 2 steps and one request. Then the
   glasses configs, over synthetic ``unaligned_labeled_mask`` datasets
   (masks of both domains): ``example_gan_noglasses2glasses.json`` at full
   width (mobile_resnet_attn G, 2,462,565 parameters; projected, basic and
   vision-aided Ds, the last 175,001,860 with its frozen CLIP ViT-B/16 and
   DINOv2 ViT-B/14 towers; the unet f_s, 3,469,506; the out-mask loss; G
   EMA; batch 2, 256 px, bf16), 4 steps, the towers bit for bit after them
   and every head and f_s changed, two requests; the vision-aided D in
   fp32, card against CPU; ``example_gan_glasses2noglasses.json`` (128 px)
   2 steps and one request. No kernel of the port runs on these paths
   (their launch counts are 0).
8. The consistency and shortcut models, over a synthetic labeled-mask
   dataset of 128 px images written here: ``example_cm_noglasses2glasses
   .json`` at full width (63,084,611 parameters in 327 leaves, the trunk's
   input [A, x] of 6 channels, bf16, batch 16, AdamW, EMA), 8 steps with K1
   twice (student and teacher) and K2 and K3 once a step, its checkpoint
   reloaded (the EMA bit for bit), 2 requests of the 5-sigma consistency
   sampler through ``scripts/gen_single_image_diffusion`` (K1 5 times each,
   the image outside the mask the input's to 1e-6), the fp32 denoiser card
   against the CPU; ``example_cm_gan_noglasses2glasses.json`` (the same G,
   projected and basic Ds, batch 4, iter_size 16), 16 micro-steps, every
   net changing at the 16th only, one request; the cm config as
   ``sc`` (62,822,083 parameters), 2 steps with K1 three times a step and
   one 16-step request (K1 16 times). Step time, images/s, peak memory,
   data wait and request latency for each.
9. Segformer and ref-conditioned palette, each over a synthetic dataset
   in its config's layout: ``example_gan_mario2sonic.json`` at full width
   (the segformer G, 3,931,824 parameters; the unet f_s of 7 classes; the
   projected, basic and vision-aided Ds; batch 2, 128 px online crops of
   180 px images in both domains, bf16), 4 steps and 2 requests through
   ``scripts/gen_single_image``; its segformer G and a segformer f_s of
   19 classes at 512 px in fp32, card against CPU (1e-4 of the largest
   output); ``example_ddpm_unetref_viton.json`` at full width
   (unet_mha_ref_attn, 147,557,059 parameters; batch 16, 128 px online
   crops with a reference each; EMA; bf16), 4 steps, two DDIM-10 and one
   DDPM (its test schedule cut to 10 steps) ``--bbox_in --ref_in`` requests,
   the memory of the legacy attention's fp32 logits at ds 4, and the
   full-width ``UNetRefAttn`` in fp32, card against CPU. Step time,
   images/s, peak memory, data wait and request latency for each. No
   kernel of the port runs on these paths (their launch counts are 0).
10. Video palette, over synthetic series of frames with a box file each:
   ``example_ddpm_vid_mario.json`` at full width (unet_vid, 132,645,763
   parameters; one clip of 8 frames at 64 px a micro-step; EMA; bf16;
   its iter_size of 32 cut to 8), 8 micro-steps with K1, K2 and K3 81
   times each a micro-step, the weights still until the 8th, its
   checkpoint reloaded
   (the EMA bit for bit), two DDIM-10 clip requests and one with the
   config's DDPM sampler (its test schedule cut to 10 steps) through
   ``scripts/gen_vid_diffusion``; ``_ft`` (batch 3) and ``_ft_from_image``
   (277,532,355 parameters, 6 frames at 128 px, 89 K1 a call) an epoch of
   one series, as written: their train-time metrics (PSNR, LPIPS, SSIM)
   over one test clip at the last micro-step and after the epoch, the
   DDPM sampler cut to 10 steps; and a DDIM-10 ``--cond_canny`` request
   each from the trained model; the full-width UNetVid in fp32, card
   against CPU.
11. b2b flow matching: ``example_b2b_vid_mario.json`` at full width
   (vit_vid JiT-B/16, 156,640,512 parameters; one clip of 8 frames at 128
   px a step, online crops with delta 16 of 192 px frames; AdamW, EMA,
   bf16; ``tpu_mesh_fsdp`` 1, its one override: one card), 8 steps with
   K1, K2 and K3 16 times each a step and finite losses, ``G_ref_copy``
   among them; its checkpoint reloaded (the EMA bit for bit); two clip
   requests with the config's 50 Heun steps (99 denoiser calls of 16 K1)
   and one ``--autoregressive`` request over two clips through
   ``scripts/gen_vid_diffusion``, the pixels outside each mask kept; the
   full-width JiTViD in fp32, card against CPU.
12. MAT inpainting: ``example_mat_inpainting.json`` at full width (the
   MAT generator, 59,779,834 parameters, and its two-trunk D, 36,083,330;
   batch 8, 256 px, bf16) over a synthetic labeled-mask set, 8 steps (R1
   at step 0) with finite losses, then the R1 and the non-R1 step timed
   again warm; two requests through ``scripts/gen_single_image_mat``
   (truncation 1.0 and 0.7) and a 4-frame one through
   ``scripts/gen_video_mat`` from the checkpoint, the known pixels the
   input's at ``model.inference``; the fp32 G and D at full width and the R1
   penalty's D gradient, card against CPU. No kernel of the port runs on
   this path (its launch counts are 0).
13. The image transformer trunks, each ``examples/example_ddpm_noglasses2
   glasses.json`` plus command-line overrides over a synthetic labeled-mask
   set: ``b2b_image_256`` (``--model_type b2b --G_netG vit``, 256 px: the
   image JiT-B/16, 130,454,784 parameters, batch 8, bf16, EMA), 8 steps
   with K1, K2 and K3 12 times each a step, then through
   ``scripts/gen_single_image_diffusion`` a request of the config's 50
   Heun steps (99 denoiser calls of 12 K1) and one of ``--sampling_steps
   10``, the known pixels the input's to 1e-6; ``b2b_lora``
   (``--alg_b2b_lora``: rank 8, 10 adapter leaves of 1,253,376
   parameters; ``--train_continue_from`` that checkpoint), 4 steps with the
   base weights bit for bit and every adapter B moved, then
   ``merge_lora_checkpoint`` and a 10-step request from the merged
   weights; ``palette_vit_128`` (``--G_netG vit``, 130,487,552 parameters,
   K1 12 a call at (8, 64 and 96, 12, 64)) and ``palette_hdit_128``
   (``--G_netG hdit``, 62,901,014 parameters, no kernel), 8 steps and a
   DDIM-10 request each (their data and checkpoints in RAM, under
   ``/dev/shm``, where the machine has it); JiT-B/16 and HDiT at full
   width in fp32, card against CPU to 1e-4 of the largest output, and one
   LoRA merge card against CPU bit for bit.
14. Perceptual steps: cm (``example_cm_noglasses2glasses``) and
   b2b_image_256 with ``alg_*_perceptual_loss LPIPS DISTS``, 4 steps each
   with ``G_perceptual`` among the finite losses and the VGG16 trunk
   frozen; the warm step time.
15. Metrics: ``RandomConvFeatures`` (2048-d, 128 px), ``InceptionV3FID``
   (299 px), the VGG16 trunk with LPIPS and DISTS (256 px), ``I3D`` (8
   frames of 224 px) and the DINOv2 fallback at full width from seeded
   trees, each timed with its peak memory and held against the CPU to 1e-4
   of the largest output (fp32, TF32 off); FID, KID, PSNR, SSIM and LPIPS
   of one pair of sets, card against CPU to 1e-3.
16. Probes: ``tools.fused_resblock_probe.stage_a`` at (16, 128, 128, 128)
   bf16 and ``tools.bw_probe3`` over 1 GiB arrays, each with the launch
   counters set to 0 just before it and read just after.
17. Video MAT and the wide head dims: ``example_mat_inpainting.json`` with
   ``--alg_mat_motion --data_dataset_mode self_supervised_vid_mask_online``
   at the options' defaults (clips of 5 frames, frame step 30, centred
   crops of 512 +- 50 px to 256 px; the motion module's 8 heads of 64, 2
   blocks, at most 8 frames; 70,809,338 generator parameters; batch 8,
   bf16) over one synthetic series of 121 frames of 576 px: an epoch (15
   steps, R1 at step 0, K1, K2 and K3 4 each a step), a clip through
   ``model.inference`` (K1 4; the history frames and known pixels kept)
   and 4 frames through ``scripts/gen_video_mat`` (frame by frame, as the
   JAX script: no kernel); the fp32 generator on a clip and D on its last
   frame, card against CPU to 1e-4 of the largest output. Then
   ``example_b2b_vid_mario.json`` with JiT-H/16 (1,023,910,976
   parameters, head dims 80 and 160; K1-K3 36 a step) for 4 of the model's
   own steps (no save) and one clip request of 50 Heun steps from it; 2
   steps each of video MAT at 4 motion heads (head dim 128), b2b_vid_mario
   with JiT-L/16 (504,401,632 parameters, head dim 128 in its motion
   module) and the image JiT-H/16 under b2b at 256 px (951,432,256
   parameters, (8, 256 | 288, 16, 80)), their data in RAM (``/dev/shm``).
18. CycleGAN and the GAN generator zoo, their data and checkpoints in RAM
   (``/dev/shm``), each run's deleted once served: horse2zebra with
   ``--model_type cycle_gan`` at full width (resnet_attn G_A and G_B,
   11,853,669 parameters each; projected and basic Ds for each domain;
   batch 4, 256 px), 8 steps with every loss finite, the warm step time,
   images/s, peak memory, data wait, a profiled step's launches and idle
   share, and 2 requests through ``scripts/gen_single_image`` from G_A's
   checkpoint (no kernel); the same with ``--G_netG unet_256`` (45,192,387
   parameters a G), 3 steps with K1, K2 and K3 6 times each a step (3
   forwards of each G, fake, rec and idt, each with its backward; the Ds
   reuse the fakes) and 2 requests of one K1; CUT over horse2zebra with
   ``--G_netG`` unet_mha (K1-K3 2 a step, 1 a request), uvit, hdit, ittr
   and hat (batch 1, ``--tpu_remat``) at their factory widths, 2 steps and
   a request each; palette (the example config at 128 px) with
   ``--G_netG uvit``, ``--G_netG resnet_attn`` and
   ``--train_feat_wavelet`` (K1-K3 1 a step, 10 K1 a request), 2 steps
   and a DDIM-10 request each; the CycleGAN G and Ds, HAT (128 px), ITTR
   and the UViT denoiser at full width in fp32, card against CPU to 1e-4
   of the largest output.
19. ReCycleGAN and ReCUT over synthetic data in the labeled-mask layout
   read as nuplets of 3 frames (frames 0 and 1 fold into the batch, frame
   2 is the P nets' target), in RAM (``/dev/shm``): horse2zebra with
   ``--model_type re_cycle_gan`` at full width (recycle_h2z: the CycleGAN
   nets and P_A, P_B, unet_128 over 6 channels, 45,194,115 parameters
   each; batch 4 nuplets, 256 px), 3 steps with K1, K2 and K3 4 times each
   a step (P_A and P_B on the real sequences, then on the stacks of the
   fakes, each with its backward), and noglasses2glasses with
   ``--model_type re_cut_semantic_mask --alg_cut_flip_equivariance``
   (recut_glasses: batch 2 nuplets; P_B; K1-K3 2 a step), 3 steps; each
   with the nets' parameter counts, the P and recycle or ReCUT losses
   finite, the warm step time, images/s, peak memory, data wait, a
   profiled step's launches and idle share, and a request through
   ``scripts/gen_single_image`` from G_A's checkpoint (no kernel); and a
   ReCycleGAN step in bf16 on the card against fp32 on the CPU at a
   reduced width (1 nuplet, 64 px), every loss within 5e-2 (relative).
20. The semantic networks, over synthetic data in RAM (``/dev/shm``; the
   ``unaligned_labeled_mask_cls`` layout, each class tinting its images):
   ``example_gan_noglasses2glasses.json`` at full width (256 px, batch 2,
   bf16) with ``--train_semantic_cls`` and ``--D_netDs projected_d basic
   vision_aided mask`` (glasses_cls_maskd: the basic C, 3,914,754
   parameters, the gumbel mask D, 2,763,713), 2 steps with CLS, D_B_mask's
   loss and G_sem_cls finite, G_sem_cls > 0 (a step with C's gate opened
   where none was), C's term with a gradient in G, G_sem_mask's gradient
   in G changed by the mask D's target rule, a profiled step and a
   request; with
   ``--train_sem_cls_template resnet50 --f_s_net vgg --D_netDs projected_d
   basic resnet18`` (glasses_resnet_vgg: the resnet50 C in fp32,
   23,512,130; VGG16-FCN8s, 134,270,278; the resnet18 D, 11,177,025), 2
   steps and a profiled one; ``--model_type segmentation`` with the unet f_s
   (4 steps) and the vgg f_s (2 steps), each with a profiled step,
   ``compute_miou`` in [0, 1] and ``inference`` (B, 256, 256, 1) int32;
   then a CUT step with the basic C and one with the resnet18 C (the mask
   D in both; 64 px, widths 16) in bf16 on the card against fp32 on the
   CPU, every loss within 5e-2 (relative), and VGG16-FCN8s in fp32 at 64
   px under both pads, card against CPU to 1e-4 of the largest logit. No
   kernel of the port runs on these paths.
21. The rest of video: ``example_b2b_vid_mario.json`` with
   ``--tpu_mesh_fsdp 1 --alg_b2b_global_context_mode tokens
   --alg_b2b_object_ref_paths`` (one 64 px PNG written here;
   b2b_vid_gc_tokens: 157,098,240 parameters, the blocks after the prefix
   at S = 176, (8, 176, 12, 64)), 4 of the model's own steps with K1, K2
   and K3 16 times each a step, a profiled step (idle share, K1-K3's
   device time), one ``model.inference`` on a dataset batch with its
   context (99 denoiser calls of 16 K1, the pixels outside the mask kept)
   and one 50-step clip request through ``scripts/gen_vid_diffusion``; the
   same with ``adaln`` (b2b_vid_gc_adaln: 158,390,784 parameters, S stays
   96), 2 steps and a profiled one; the video variant of the bdd100k
   tutorial's command (cut_video_clear2snowy: CUT over
   ``temporal_labeled_mask_online`` at the options' defaults, batch 4
   clips (the command's 8 do not fit on one card) of 5 frames 30 apart
   at 256 px from 512 +- 64 px crops of video MAT's series of 121 frames
   of 576 px (item 17; written here first), mobile_resnet_attn G,
   projected, basic and temporal Ds, the vgg f_s of 11 classes, G EMA),
   5 steps with the temporal D at steps 0 and 4 (its loss 0
   and its state still on the others), the steps with and without it
   timed apart, a profiled step off its cadence, a warm step on it, one
   ``gen_single_image`` request on a frame (no kernel on this path); then
   JiTViD in ``tokens`` mode with one reference and the temporal D at 256
   px on a clip of 5 frames, fp32, card against CPU.

Prints one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(ROOT, "examples", "example_ddpm_noglasses2glasses.json")
SEED = 0
DDIM_REQUESTS = 3
# the serving, unetref and video phases' DDPM requests, and the train-time
# metrics' DDPM sampling, on a test schedule cut to this many steps
# (cut_test_schedule: a DDPM-1000 request is 1,000 denoiser calls of the
# same kernels; 100 until the smoke took the wide head dims' phases, 50
# until it took the GAN zoo's)
DDPM_TEST_STEPS = 10
EXPECTED_PARAMS = 62_838_467    # the example config's denoiser
# Published H100 SXM peaks (NVIDIA data sheet): memory 3.35 TB/s; bf16 on
# the tensor cores 989 TFLOP/s; fp32 outside them 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CROSS_CHECK_TOL = 1e-3
# fp32 training step, card against CPU: every leaf's max abs gradient error
# within 1e-3 of the largest gradient of all, and within 1e-2 of the leaf's
# own largest gradient (sums in another order through ~70 layers)
GRAD_TOL_GLOBAL = 1e-3
GRAD_TOL_LEAF = 1e-2
EXPECTED_LEAVES = 327
TRAIN_IMAGES = 64
TRAIN_EPOCHS = 2
TRAIN_256_IMAGES = 48               # one epoch of 6 steps at 256 px
PATH_SHAPE = (1, 256, 16, 32)       # the mid block of a 128 px request
TRAIN_SHAPE = (8, 256, 16, 32)      # the mid block at 128 px, batch 8
BIG_SHAPE = (8, 1024, 16, 32)       # the mid block at 256 px, batch 8
GAN_SHAPE = (4, 1024, 16, 32)       # the unet GAN Gs' mid block, 256 px
RECUT_SHAPE = (2, 1024, 16, 32)     # ReCUT's P_B mid block, batch 2, 256 px
# xview's mid block (1024 channels, 32 heads of 32) at 128 px: a request and
# a training step at batch 16
XVIEW_PATH_SHAPE = (1, 256, 32, 32)
XVIEW_TRAIN_SHAPE = (16, 256, 32, 32)
EXPECTED_PARAMS_XVIEW = 236_326_339
CM_TRAIN_SHAPE = (16, 256, 16, 32)      # the cm mid block, batch 16
CM_GAN_TRAIN_SHAPE = (4, 256, 16, 32)   # and at cm_gan's batch 4
XVIEW_STEPS = 8                     # one epoch of 128 images at batch 16
REMAT_STEPS = 2
ONLINE_SIZE = 320                   # the online configs' source images
# the other configs, CONFIG_STEPS steps each: layout, image size, and the
# writer's box classes (mario's embedding has one class besides the null
# class)
CONFIG_STEPS = 2
# df2kost's test split: its train-time metrics (and ``test.py``'s FID) over
# this many test batches
METRIC_TEST_BATCHES = 2
CONFIG_RUNS = {
    "mapillary": ("online", ONLINE_SIZE, (1, 2)),
    "df2kost": ("single", 160, None),
    "SEN2VEN": ("aligned", 256, None),
    "mario": ("online", ONLINE_SIZE, (1,)),
}
# ragged S and B*H at the bf16 kernels' tile edges (64 queries or keys per
# warpgroup) and the other head dims, checked beside the paths' shapes
EDGE_CHECKS = [((3, 1, 1, 16), "bfloat16"), ((1, 63, 3, 64), "bfloat16"),
               ((3, 65, 1, 16), "bfloat16"), ((2, 100, 2, 64), "bfloat16"),
               ((1, 1000, 3, 64), "bfloat16"), ((2, 100, 2, 64), "float32"),
               ((2, 5, 2, 16), "float32")]
# the head dims 80, 128 and 160 past S = 32 (both query tilings in bf16):
# the image JiT-H/16's blocks after its prefix at 256 px, batch 8, and
# ragged S of 63, 65 and 100 over odd B*H
WIDE_CHECKS = [((8, 288, 16, 80), "bfloat16"), ((8, 288, 16, 80), "float32"),
               ((1, 63, 3, 80), "bfloat16"), ((3, 65, 1, 128), "bfloat16"),
               ((1, 100, 3, 128), "float32"), ((2, 100, 3, 160), "bfloat16"),
               ((3, 65, 1, 160), "float32")]
FWD_CHECKS = [(PATH_SHAPE, "bfloat16"), (PATH_SHAPE, "float32"),
              (TRAIN_SHAPE, "bfloat16"), (BIG_SHAPE, "bfloat16"),
              (GAN_SHAPE, "bfloat16"), (RECUT_SHAPE, "bfloat16"),
              (XVIEW_PATH_SHAPE, "bfloat16"), (XVIEW_TRAIN_SHAPE, "bfloat16"),
              (CM_TRAIN_SHAPE, "bfloat16"), (CM_GAN_TRAIN_SHAPE, "bfloat16"),
              ((8, 64, 16, 32), "bfloat16"), ((2, 100, 2, 8), "bfloat16"),
              ((2, 100, 2, 8), "float32"), *EDGE_CHECKS, *WIDE_CHECKS]
BWD_CHECKS = [(TRAIN_SHAPE, "bfloat16"), (TRAIN_SHAPE, "float32"),
              (PATH_SHAPE, "bfloat16"), (BIG_SHAPE, "bfloat16"),
              (GAN_SHAPE, "bfloat16"), (RECUT_SHAPE, "bfloat16"),
              (XVIEW_PATH_SHAPE, "bfloat16"),
              (XVIEW_TRAIN_SHAPE, "bfloat16"), (CM_TRAIN_SHAPE, "bfloat16"),
              (CM_GAN_TRAIN_SHAPE, "bfloat16"), ((8, 64, 16, 32), "bfloat16"),
              ((2, 100, 2, 8), "bfloat16"), ((2, 100, 2, 8), "float32"),
              *EDGE_CHECKS, *WIDE_CHECKS]
# P1/P2: the probe's hot site at batch 2; shapes whose H, W and Co are not
# multiples of the kernels' tiles; C = 8 and 24 (part of a 64-channel K
# step of the wgmma route), C = 256 (two K steps a tap); errors relative to
# max |y|
CONV_CHECKS = [((2, 128, 128, 128), 128), ((1, 37, 53, 64), 40),
               ((1, 13, 16, 8), 8), ((3, 21, 65, 24), 16),
               ((2, 45, 64, 256), 72)]
CONV_PATH_SHAPE = (16, 128, 128, 128)
LIBRARY_CONV_TOL = 3e-2             # the probe's own tolerance
# P3: (n_rows, row, chunk_rows, dtype): the probe's chunkings, an odd chunk
# count, a single chunk, chunks of 24 KiB and 48 KiB, chunks of 24000 and
# 20000 bytes ending in a short tile; fewer items than blocks (one 2 KiB
# chunk); a block that wraps the ring many times (256 MiB); blocks whose
# items come from several chunks; chunks of one row, down to 16-byte items
COPY_CHECKS = [(4096, 1024, 256, "float32"), (4096, 1024, 1024, "bfloat16"),
               (4096, 1024, 4096, "float32"), (768, 1024, 256, "float32"),
               (1200, 1024, 12, "bfloat16"), (60, 1024, 12, "float32"),
               (1200, 1000, 12, "bfloat16"), (60, 1000, 5, "float32"),
               (1, 1024, 1, "bfloat16"), (65536, 1024, 256, "float32"),
               (16392, 1024, 12, "bfloat16"), (4800, 1024, 10, "float32"),
               (1000, 1024, 1, "float32"), (2048, 8, 1, "bfloat16")]
COPY_WRAP_CHECK = (65536, 1024, 256, "float32")
COPY_PATH = (1024, 1024, "float32")     # the probe's 1 GiB, row, ms dtype
# horse2zebra: one epoch of CUT_STEPS steps at batch 4, then CUT_REQUESTS
# requests; its fp32 G loss card against CPU to CUT_LOSS_TOL (relative), its
# G gradient against float64 on the CPU to twice the CPU fp32's error plus
# GRAD_TOL_GLOBAL of the largest gradient
CUT_STEPS = 8
CUT_REQUESTS = 2
CUT_LOSS_TOL = 1e-3
# the glasses configs (CUT with the semantic-mask branch and the
# vision-aided D): noglasses2glasses one epoch of GLASSES_STEPS steps at
# batch 2 (256 px), then GLASSES_REQUESTS requests; glasses2noglasses
# GLASSES2_STEPS steps (128 px), one request. Full width: the JAX modules'
# parameter counts (jax.eval_shape)
GLASSES_STEPS = 4
GLASSES_REQUESTS = 2
GLASSES2_STEPS = 2
EXPECTED_PARAMS_GLASSES_G = 2_462_565      # mobile_resnet_attn, ngf 64
EXPECTED_PARAMS_GLASSES = {"D_B_vision_aided": 175_001_860,
                           "f_s": 3_469_506}
EXPECTED_PARAMS_TOWERS = {"freezenet_clip": 86_192_640,
                          "freezenet_dino": 86_579_712}
# the consistency and shortcut models on the cm configs: cm one epoch of
# CM_STEPS steps at batch 16, then CM_REQUESTS requests; cm_gan CM_GAN_STEPS
# micro-steps at batch 4 (one real update at iter_size 16; two until the
# smoke took the GAN zoo's phases), one request; sc
# SC_STEPS steps at batch 16, one request
CM_EXAMPLE = "example_cm_noglasses2glasses.json"
CM_GAN_EXAMPLE = "example_cm_gan_noglasses2glasses.json"
EXPECTED_PARAMS_CM = 63_084_611
EXPECTED_PARAMS_SC = 62_822_083
EXPECTED_PARAMS_CM_D = {"D_B_projected_d": 5_948_532,
                        "D_B_basic": 2_764_737}
CM_STEPS = 8
CM_REQUESTS = 2
CM_GAN_STEPS = 16
SC_STEPS = 2
CM_IMAGES = 128         # an epoch of cm (8 x 16)
# attention launches a step: cm's student (K1, then K2 and K3 in its
# backward) and teacher (K1 without a graph); sc's two bootstrap forwards
# and its student; and a request: one K1 a sigma (cm's 5) or a step (sc's
# 16)
CM_PER_STEP = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 1,
               "flash_attention_bwd_dkv": 1}
SC_PER_STEP = dict(CM_PER_STEP, flash_attention_fwd=3)
CM_REQUEST_K1 = 5
SC_REQUEST_K1 = 16
# mario2sonic (CUT with the segformer G, the unet f_s of 7 classes, the
# projected, basic and vision-aided Ds): one epoch of MARIO_STEPS steps at
# batch 2 over 128 px online crops of MARIO_IMAGE px images, then
# MARIO_REQUESTS requests; the segformer G (128 px) and a bdd100k-wide
# segformer f_s (512 px, 19 classes) in fp32, card against CPU, to
# MIT_TOL of the largest output
MARIO_STEPS = 4
MARIO_REQUESTS = 2
MARIO_IMAGE = 180
EXPECTED_PARAMS_MARIO_G = 3_931_824
MIT_TOL = 1e-4
# unetref_viton (palette with the unet_mha_ref_attn G): one epoch of
# UNETREF_STEPS steps at batch 16 over 128 px online crops of ONLINE_SIZE px
# images with a reference each, then UNETREF_REQUESTS DDIM-10 --ref_in
# requests and one with the config's DDPM sampler; the full-width
# UNetRefAttn in fp32, card against CPU
UNETREF_STEPS = 4
UNETREF_REQUESTS = 2
EXPECTED_PARAMS_UNETREF = 147_557_059
# the ref UNet's legacy attention at ds 4 of a 128 px training batch: 16
# images, 8 heads of 32 over 1024 tokens (qkv of 3 x 256 rows)
UNETREF_ATTN_QKV = (16, 768, 1024)
# the video palette configs (unet_vid): vid_mario one epoch of VID_STEPS
# micro-steps at batch 1, one update at VID_ITER_SIZE (the config's 32,
# cut for the smoke's time when it took the rest of video; two updates
# until it took the wide head dims' phases) over clips of 8
# frames cropped from VID_IMAGE px frames (VID_SERIES series of VID_FRAMES
# frames: the dataset's length is its frame count), then VID_DDIM_REQUESTS
# DDIM-10 clip requests and one with the config's DDPM sampler at its test
# schedule; _ft (batch 3) and _ft_from_image (6 frames at 128 px, batch 1)
# one epoch of one series each (2 and 6 micro-steps) and one DDIM-10
# request each
VID_EXAMPLES = ("example_ddpm_vid_mario.json",
                "example_ddpm_vid_mario_ft.json",
                "example_ddpm_vid_mario_ft_from_image.json")
VID_STEPS = VID_ITER_SIZE = 8
VID_SERIES, VID_FRAMES = 1, 8
VID_IMAGE = 160
VID_DDIM_REQUESTS = 2
EXPECTED_PARAMS_VID = 132_645_763         # the denoiser; its trunk 132,643,651
EXPECTED_PARAMS_VID_FT_FROM_IMAGE = 277_532_355
# K1 launches a denoiser call: 20 motion modules of 2 blocks of 2 temporal
# attentions, and the middle block's attention (_ft_from_image: 44 modules
# of 1 block, 89)
VID_K1_PER_CALL = 81
# the attention shapes of a vid_mario call (B*H*W, F, 8 heads, C / 8): the
# motion modules at 64 px (level 1, D = 8) and 8 px (level 4, D = 64), and
# _ft_from_image's level 1 (6 frames at 128 px); the middle block (16
# heads of 32 over 8 x 8 tokens of 8 frames) takes the plain tiling
VID_L1_SHAPE = (4096, 8, 8, 8)
VID_L4_SHAPE = (64, 8, 8, 64)
VID_S6_SHAPE = (16384, 6, 8, 8)
VID_MID_SHAPE = (8, 64, 16, 32)
# the attention shapes of a b2b_vid_mario call (JiT-B/16, 8 frames at 128
# px): the token motion module (B*T, F, 8 heads, 768 / 8 = 96), and the JiT
# blocks (B*F, S, 12 heads, 64) before the 32 in-context tokens (S = 64)
# and after (S = 96: the second key tile half masked)
B2B_MOTION_SHAPE = (64, 8, 8, 96)
B2B_PRE_SHAPE = (8, 64, 12, 64)
B2B_POST_SHAPE = (8, 96, 12, 64)
# with the global context's tokens and one object reference's after block
# 4: S = 64 + 64 + 16 + 32 = 176 (b2b_vid_gc_tokens)
B2B_GC_POST_SHAPE = (8, 176, 12, 64)
# the image JiT-B/16's blocks at 256 px, batch 8 (b2b_image_256): 256
# tokens before the 32 in-context tokens and 288 after (a ragged last tile
# of queries and of keys); palette_vit_128's are B2B_PRE_SHAPE and
# B2B_POST_SHAPE
JIT_IMAGE_PRE_SHAPE = (8, 256, 12, 64)
JIT_IMAGE_POST_SHAPE = (8, 288, 12, 64)
# the wide head dims on their paths: video MAT's motion module over the
# 16 x 16 bottleneck of 5 frames, (B * 256, 5, heads, 512 / heads), at
# MAT_VIDEO_BATCH clips (8 heads: D = 64; 4: D = 128); JiT-H/16 under
# vit_vid (its blocks (B * F, 64 | 96, 16, 80), its motion module (B * T,
# 8, 8, 160)); JiT-L/16's motion module (B * T, 8, 8, 128); the image
# JiT-H/16 at 256 px, batch 8, after its prefix (8, 288, 16, 80)
MAT_VIDEO_BATCH = 8
MAT_MOTION_SHAPE = (MAT_VIDEO_BATCH * 256, 5, 8, 64)
MAT_MOTION_4H_SHAPE = (MAT_VIDEO_BATCH * 256, 5, 4, 128)
JITH_MOTION_SHAPE = (64, 8, 8, 160)
JITL_MOTION_SHAPE = (64, 8, 8, 128)
JITH_VID_POST_SHAPE = (8, 96, 16, 80)
JITH_IMAGE_POST_SHAPE = (8, 288, 16, 80)
# K1-K3 at the video paths' shapes, in both dtypes, and at S <= 32 in both
# tilings (packed and plain): every motion-module shape of the video path
# (vid_mario's levels 1-4, _ft_from_image's levels 1-4; D = 8), b2b's
# four shapes (D = 96 and the JiT blocks' S = 64, 96 and, with the global
# context's tokens and a reference, 176 with 12 heads), and ragged
# sequence counts and lengths, at D = 96 too
SHORT_CHECKS = [VID_L1_SHAPE, (1024, 8, 8, 16), (256, 8, 8, 32),
                VID_L4_SHAPE, VID_S6_SHAPE, (4096, 6, 8, 16),
                (1024, 6, 8, 32), (256, 6, 8, 64), (3, 6, 8, 32),
                (7, 8, 3, 16), (2, 17, 3, 8), (3, 32, 2, 8), (2, 1, 3, 8),
                B2B_MOTION_SHAPE, B2B_PRE_SHAPE, B2B_POST_SHAPE,
                B2B_GC_POST_SHAPE, (5, 7, 3, 96), (3, 100, 2, 96),
                JIT_IMAGE_PRE_SHAPE, JIT_IMAGE_POST_SHAPE, MAT_MOTION_SHAPE,
                MAT_MOTION_4H_SHAPE,
                JITH_MOTION_SHAPE, JITL_MOTION_SHAPE, (8, 64, 16, 80),
                JITH_VID_POST_SHAPE, (3, 1, 1, 80), (5, 5, 3, 160),
                (7, 8, 3, 128), (3, 17, 3, 80), (3, 32, 3, 160),
                (1, 63, 3, 128), (2, 100, 3, 80)]
VID_TIMINGS = (("vid_level1", VID_L1_SHAPE, 50),
               ("vid_level4", VID_L4_SHAPE, 50),
               ("vid_s6_level1", VID_S6_SHAPE, 20),
               ("vid_mid", VID_MID_SHAPE, 50),
               ("b2b_motion", B2B_MOTION_SHAPE, 50),
               ("b2b_jit_pre", B2B_PRE_SHAPE, 50),
               ("b2b_jit_post", B2B_POST_SHAPE, 50),
               ("b2b_gc_post", B2B_GC_POST_SHAPE, 50),
               ("jit_image_pre", JIT_IMAGE_PRE_SHAPE, 50),
               ("jit_image_post", JIT_IMAGE_POST_SHAPE, 50),
               ("mat_motion", MAT_MOTION_SHAPE, 20),
               ("mat_motion_4h", MAT_MOTION_4H_SHAPE, 20),
               ("jith_motion", JITH_MOTION_SHAPE, 20),
               ("jitl_motion", JITL_MOTION_SHAPE, 20),
               ("jith_vid_post", JITH_VID_POST_SHAPE, 20),
               ("jith_image_post", JITH_IMAGE_POST_SHAPE, 20))
# b2b_vid_mario (example_b2b_vid_mario.json) as it is but for its mesh
# (tpu_mesh_fsdp 2 cannot hold on one card): B2B_STEPS steps at batch 1
# over one series of 8 frames of B2B_IMAGE px (its crops are 128 px with
# delta 16), B2B_REQUESTS clip requests with the config's 50 Heun steps and
# one --autoregressive request over two clips of a 16-frame series
B2B_EXAMPLE = "example_b2b_vid_mario.json"
B2B_STEPS = 8
B2B_REQUESTS = 2
B2B_IMAGE = 192
EXPECTED_PARAMS_B2B = 156_640_512      # [y_cond, z]: 6 input channels
# K1 launches a b2b denoiser call (and K2 and K3 a step): 12 JiT blocks and
# the motion module's 2 blocks of 2 temporal attentions
B2B_K1_PER_CALL = 16
# b2b_vid_mario with the global context and an object reference
# (B2B_EXAMPLE + --tpu_mesh_fsdp 1 and the context's options), over one
# series of 8 frames of B2B_IMAGE px: ``tokens`` with one reference of
# B2B_GC_REF_SIZE px (the context's 64 tokens and the reference's 16
# before the 32 in-context ones: S = 176 from block 4, B2B_GC_POST_SHAPE)
# B2B_GC_STEPS steps, a 50-step clip request through
# scripts/gen_vid_diffusion (no context: the zero image, as the JAX
# script) and one model.inference on a dataset batch with its context;
# ``adaln`` (the context's encoder adds to c; S stays 96)
# B2B_GC_ADALN_STEPS steps. K1 B2B_K1_PER_CALL a call, K2 and K3 as many a
# step, in both. The parameter counts are the JAX package's
# (jax.eval_shape; the tests hold them)
B2B_GC_STEPS = 4
B2B_GC_ADALN_STEPS = 2
B2B_GC_REF_SIZE = 64
EXPECTED_PARAMS_B2B_GC = {"tokens": 157_098_240, "adaln": 158_390_784}
# the video variant of docs/tutorial_styletransfer_bdd100k.md's command:
# CUT over temporal_labeled_mask_online with the temporal D beside the
# projected and basic ones, at the options' defaults (clips of 5 frames 30
# apart, the temporal D every 4 steps, the vgg f_s of 11 classes), but for
# the batch: the command's 8 clips (40 frames a step) do not fit on one
# NVIDIA H100 80GB HBM3 at 700.00 W (out of memory at 77.6 GB allocated,
# in G's identity pass), so CUT_VIDEO_BATCH clips; over video MAT's series
# (``_video_series``; B's paths list A's frames); CUT_VIDEO_STEPS steps
# (the temporal D at steps 0 and 4), a profiled step off its cadence and
# one on it, a gen_single_image request on one frame. No kernel of the
# port. The parameter counts are the JAX package's (jax.eval_shape)
CUT_VIDEO_ARGS = [
    "--model_type", "cut", "--data_dataset_mode",
    "temporal_labeled_mask_online", "--data_load_size", "360",
    "--data_crop_size", "256", "--data_online_creation_crop_size_A", "512",
    "--data_online_creation_crop_delta_A", "64",
    "--data_online_creation_crop_size_B", "512",
    "--data_online_creation_crop_delta_B", "64", "--G_netG",
    "mobile_resnet_attn", "--D_netDs", "projected_d", "basic", "temporal",
    "--train_semantic_mask", "--f_s_semantic_nclasses", "11",
    "--train_G_ema"]
CUT_VIDEO_BATCH = 4
CUT_VIDEO_STEPS = 5
EXPECTED_PARAMS_CUT_VIDEO = {"G_A": 2_462_565,
                             "D_B_projected_d": 9_227_252,
                             "D_B_basic": 2_764_737,
                             "D_B_temporal": 12_016_372}
# the temporal D in fp32, card against CPU: one clip of CUT_VIDEO_FRAMES
# frames at 256 px, to CROSS_CHECK_TOL
CUT_VIDEO_FRAMES = 5
# MAT inpainting (example_mat_inpainting.json as it is: batch 8, 256 px,
# base 64, stage-1 dim 180, bf16): one epoch of MAT_STEPS steps over a
# synthetic labeled-mask set (step 0 takes R1: d_reg_every 16), then the
# R1 and non-R1 steps timed again warm (MAT_TIMED of each); two image
# requests (truncation 1.0 and 0.7, one seed) and one video request of
# MAT_FRAMES frames from its checkpoint, known pixels the input's to
# MAT_KNOWN_TOL; the fp32 G and D at full width, card against CPU, to
# MAT_TOL of the largest output, and the R1 penalty's D gradient at a small
# size (MAT_R1_SIZE px, base 16, batch 4), to MAT_TOL of the largest
MAT_EXAMPLE = "example_mat_inpainting.json"
MAT_STEPS = 8
MAT_TIMED = 3
MAT_FRAMES = 4
MAT_KNOWN_TOL = 1e-6
MAT_TOL = 1e-4
MAT_R1_SIZE = 64
EXPECTED_PARAMS_MAT = {"G_A": 59_779_834, "D": 36_083_330}
# video MAT: MAT_EXAMPLE + MAT_VIDEO_ARGS at the options' defaults (clips of
# 5 frames, a frame step of 30, centred crops of 512 +- 50 px; the motion
# module's 8 heads, 2 blocks, at most 8 frames) over one synthetic series
# of MAT_VIDEO_SERIES frames of MAT_VIDEO_IMAGE px: an epoch (its steps,
# R1 at step 0), a clip through ``model.inference`` and a clip through
# ``scripts/gen_video_mat``; K1, K2 and K3 MAT_VIDEO_K1 times each a step
# (2 blocks of 2 temporal attentions); the fp32 generator on one clip and
# D on its last frame at full width, card against CPU to MAT_TOL
MAT_VIDEO_ARGS = ["--alg_mat_motion", "--data_dataset_mode",
                  "self_supervised_vid_mask_online"]
MAT_VIDEO_SERIES = 121
MAT_VIDEO_IMAGE = 576
MAT_VIDEO_K1 = 4
EXPECTED_PARAMS_MAT_VIDEO = {"G_A": 70_809_338, "D": 36_083_330}
# the wide variants (the parameter counts are the JAX package's, by
# jax.eval_shape; the tests hold them): b2b_vid_jith (B2B_EXAMPLE with
# JiT-H/16: its 32 blocks and the motion module's 4 temporal attentions a
# call), WIDE_STEPS of the model's own steps (no save: its checkpoint with
# EMA and AdamW is ~16 GB) and one clip request of the config's 50 Heun
# steps from the trained model; then SHORT_STEPS each of video MAT at 4
# motion heads, b2b_vid_mario with JiT-L/16 and the image JiT-H/16 under
# b2b at 256 px
WIDE_STEPS = 4
SHORT_STEPS = 2
EXPECTED_PARAMS_JITH_VID = 1_023_910_976
EXPECTED_PARAMS_JITL_VID = 504_401_632
EXPECTED_PARAMS_JITH_IMAGE = 951_432_256
JITH_VID_K1 = 36
JITL_VID_K1 = 28
JITH_IMAGE_K1 = 32
# the image transformer trunks, each EXAMPLE plus command-line overrides:
# b2b_image_256 (the image JiT-B/16 under b2b, 256 px, batch 8; IMAGE_STEPS
# steps, a request of the config's B2B_IMAGE_HEUN_STEPS Heun steps and one
# of 10), b2b_lora (its LoRA finetuning, rank 8, alpha 16, dropout 0.05,
# the default targets, continued from its checkpoint: LORA_STEPS steps, a
# 10-step request from the merged weights), palette_vit_128 and
# palette_hdit_128 (IMAGE_STEPS steps and a DDIM-10 request each); the
# parameter counts are the JAX package's (jax.eval_shape; the tests hold
# them), the JiT's with 12 K1 a call; the fp32 cross-checks to IMAGE_TOL of
# the largest output
IMAGE_EXAMPLE = "example_ddpm_noglasses2glasses.json"
B2B_IMAGE_ARGS = ["--model_type", "b2b", "--G_netG", "vit",
                  "--data_load_size", "256", "--data_crop_size", "256"]
B2B_LORA_ARGS = B2B_IMAGE_ARGS + ["--alg_b2b_lora"]
IMAGE_STEPS = 8
LORA_STEPS = 4
# the metrics phase: images a batch, clips a batch, timed calls, the card
# against the CPU (fp32, TF32 off) of the largest output; compute_metrics'
# list and its tolerance (relative; KID against 1: a difference of means of
# terms ~1)
METRIC_BATCH = 16
METRIC_CLIPS = 2
METRIC_ITERS = 5
METRIC_TOL = 1e-4
METRIC_LIST = ["FID", "KID", "PSNR", "SSIM", "LPIPS"]
METRIC_FLOOR = {"KID": 1.0}
METRIC_SET_TOL = 1e-3
PERCEPTUAL_STEPS = 4
B2B_IMAGE_HEUN_STEPS = 50
JIT_K1_PER_CALL = 12
EXPECTED_PARAMS_B2B_IMAGE = 130_454_784
EXPECTED_LORA = (10, 1_253_376)            # adapter leaves, parameters
EXPECTED_PARAMS_PALETTE_VIT = 130_487_552
EXPECTED_PARAMS_PALETTE_HDIT = 62_901_014
IMAGE_TOL = 1e-4
# CycleGAN over horse2zebra (``example_gan_horse2zebra.json`` with
# ``--model_type cycle_gan``, as written otherwise: resnet_attn Gs,
# projected_d and basic Ds for each domain, batch 4, 256 px), and the same
# with ``--G_netG unet_256``, whose middle AttentionBlock (16 heads of 32
# over 32 x 32 tokens) runs K1-K3 at GAN_SHAPE: 3 forwards of each G a step
# (fake, rec, idt; the Ds reuse the fakes), each with its backward, and one
# K1 a request
GAN_EXAMPLE = "example_gan_horse2zebra.json"
CYCLEGAN_STEPS = 8
CYCLEGAN_REQUESTS = 2
CYCLEGAN_UNET_STEPS = 3
CYCLEGAN_UNET_REQUESTS = 2
CYCLEGAN_UNET_PER_STEP = 6
EXPECTED_PARAMS_CYCLEGAN = {"G_A": 11_853_669, "G_B": 11_853_669,
                            "D_B_projected_d_A": 9_227_252,
                            "D_B_basic_A": 2_764_737,
                            "D_B_projected_d_B": 9_227_252,
                            "D_B_basic_B": 2_764_737}
EXPECTED_PARAMS_UNET256 = 45_192_387
# CUT over horse2zebra with each new generator at its factory width, 2
# steps and a request each: (name, overrides, G parameters, K1 a step, K1
# a request). The unet Gs take ``--G_nblocks 2``, which picks their NCE
# taps (G_nblocks·i - 1 of 12 encoder features: horse2zebra's 9 reaches
# past them in both packages) and nothing else; their middle
# AttentionBlock runs K1-K3 at GAN_SHAPE for G on A and on B. HAT at batch
# 1 with ``--tpu_remat``: a graph of it at 256 px holds ~32 GB an image and
# a CUT step takes four.
ZOO_STEPS = 2
CUT_ZOO = (("unet_mha", ["--G_nblocks", "2"], 62_557_187, 2, 1),
           ("uvit", ["--G_nblocks", "2"], 72_170_307, 0, 0),
           ("hdit", [], 62_100_758, 0, 0),
           ("ittr", [], 11_509_507, 0, 0),
           ("hat", ["--train_batch_size", "1", "--tpu_remat"], 5_128_147,
            0, 0))
# palette (the example config at 128 px) with the new denoisers: 2 steps
# and a DDIM-10 request each: (name, overrides, parameters, K1 a call); the
# Haar trunk's middle block runs K1-K3 at (8, 64, 16, 32)
PALETTE_ZOO = (("palette_uvit_128", ["--G_netG", "uvit"], 72_451_587, 0),
               ("palette_resnet_attn_128", ["--G_netG", "resnet_attn"],
                12_929_573, 0),
               ("palette_wavelet_128", ["--train_feat_wavelet"], 63_296_396,
                1))
ZOO_TOL = 1e-4
# ReCycleGAN and ReCUT over the nuplet layout (nuplets of 3 frames:
# frames 0 and 1 fold into the batch, frame 2 is P's target), at full
# width: recycle_h2z (horse2zebra with --model_type re_cycle_gan: batch 4
# nuplets, 256 px, resnet_attn Gs, projected and basic Ds a domain) and
# recut_glasses (noglasses2glasses with --model_type re_cut_semantic_mask
# and FastCUT's flips: batch 2 nuplets, 256 px, the vision-aided D among
# its three). Their P nets are unet_128 at ngf 64 over 6 channels, whose
# middle AttentionBlock runs K1-K3 at GAN_SHAPE and RECUT_SHAPE: P_A and
# P_B on the real sequences, then on the stacks of G's fakes, each with
# its backward (ReCUT: P_B alone). No kernel serves the Gs. After the
# steps one more with the gate opened (threshold RE_OPEN_THRESHOLD): its
# recycle or ReCUT terms must be positive. The bf16 step on the card is
# held against fp32 on the CPU as the CycleGAN step of
# tests/test_torch_cuda.py is: at a reduced width (RE_STEP_WIDTH: G_ngf
# and D_ndf), batch 1 nuplet, RE_STEP_SIZE px, the P nets redrawn with
# their zero layers at N(0, RE_STEP_ZERO_STD), to RE_STEP_TOL of each loss
# (relative, at least 1); P_A's qkv gradient against the CPU's and its
# middle block's against the plain attention (``re_step_check``).
# Steps were cut to pay for these phases: glasses, mario2sonic and unetref
# 8 -> 4, CycleGAN unet_256 6 -> 3
RE_NUPLET = 3
RE_STEPS = 2
RECUT_STEPS = 2
RE_PER_STEP = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 4,
               "flash_attention_bwd_dkv": 4}
RECUT_PER_STEP = {k: 2 for k in RE_PER_STEP}
EXPECTED_PARAMS_P = 45_194_115             # unet_128 at ngf 64, 6 channels
RE_OPEN_THRESHOLD = 100.0
RE_STEP_SIZE = 64
RE_STEP_WIDTH = 16
RE_STEP_ZERO_STD = 0.02
RE_STEP_TOL = 5e-2
# the semantic networks on noglasses2glasses at full width, in RAM
# (/dev/shm), over synthetic unaligned_labeled_mask_cls data (a class tint
# an image): glasses_cls_maskd (the basic C, the mask D beside the config's
# three Ds) and glasses_resnet_vgg (the resnet50 C, the vgg f_s, a resnet18
# D), SEM_STEPS steps each; the segmentation model with the unet f_s
# SEG_UNET_STEPS steps and the vgg f_s SEG_VGG_STEPS steps. Full width: the
# JAX modules' parameter counts (jax.eval_shape)
SEM_EXAMPLE = "example_gan_noglasses2glasses.json"
SEM_SIZE = 256                      # the config's crop
SEM_STEPS = 2
SEG_UNET_STEPS = 4
SEG_VGG_STEPS = 2
EXPECTED_PARAMS_SEM = {"CLS": 3_914_754, "D_B_mask": 2_763_713,
                       "D_B_basic": 2_764_737}
EXPECTED_PARAMS_SEM_VGG = {"CLS": 23_512_130, "f_s": 134_270_278,
                           "D_B_resnet18": 11_177_025}
EXPECTED_PARAMS_RESNET18_C = 11_177_538
SEM_OPEN_THRESHOLD = 100.0
# the card-vs-CPU checks: a CUT step (bf16 card, fp32 CPU) at
# SEM_CHECK_SIZE px, G_ngf, D_ndf, f_s_nf and cls_nf SEM_CHECK_WIDTH, to
# SEM_STEP_TOL of each loss (relative, at least 1); VGG16-FCN8s in fp32 at
# SEM_CHECK_SIZE px, its zero-initialised skips at N(0, SEM_SKIP_STD), to
# VGG_CHECK_TOL of the largest logit
SEM_CHECK_SIZE = 64
SEM_CHECK_WIDTH = 16
SEM_STEP_TOL = 5e-2
SEM_SKIP_STD = 0.02
VGG_CHECK_TOL = 1e-4
PROBE_ITERS = 32
TRACE_ATTEMPTS = 2                  # traces of one timing, at most
SPIN_HZ = 1.98e9                    # the H100's top SM clock, cycles a second


def log(msg):
    print(msg, flush=True)


def wall_ms(fn, iters):
    """Mean time of one call by CUDA events around ``iters`` calls back to
    back, after three warm-up calls. Where a call's kernels are shorter than
    its launch on the host, this is the host's pace, not the device's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters):
    """Mean device time of one call by CUDA events around ``iters`` calls
    queued behind a spin kernel: the card spins while the host queues the
    calls, then runs them back to back whatever the host's pace. Twice the
    host's time for ``iters`` calls, synchronised, bounds how long queueing
    takes; the spin is that long at SPIN_HZ (longer at a lower clock)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_HZ) + 10_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(fn, iters):
    """(name, µs) of every kernel, copy and fill that ``iters`` calls of
    ``fn`` launched, from a ``torch.profiler`` trace with CUDA activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    # one warm-up step, traced and discarded, so that the tracing is running
    # when the timed calls start (it misses launches at its start otherwise)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    # not the profiler step's own range
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, iters, kernel=None):
    """Mean device time of one call: each device name's mean duration times
    its launches per call, summed, from a trace of ``iters`` calls. A trace
    still loses a launch now and then (9 of 10 on an H100 once); one whose
    counts are not whole multiples of ``iters`` is taken again, up to
    ``TRACE_ATTEMPTS`` times, and the last is read with the counts per call
    rounded. Where every trace is empty, the call is timed by ``queued_ms``.
    With ``kernel`` given, every launch a trace saw must be of a kernel of
    that name, one a call."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        events = _device_events(fn, iters)
        counts = collections.Counter(name for name, _ in events)
        if kernel is not None and not all(kernel in n for n in counts):
            raise AssertionError(f"expected launches of {kernel} only, got "
                                 f"{dict(counts)}")
        if counts and all(c % iters == 0 for c in counts.values()):
            break
        log(f"trace {attempt} of {iters} calls lost launches: "
            f"{dict(counts)}")
    if not events:
        # CUPTI hands back an empty trace now and then, several in a row
        # at times (4 of 4 once on an H100): time by CUDA events instead
        log(f"{TRACE_ATTEMPTS} traces of {iters} calls saw no device time; "
            f"timed by CUDA events behind a spin kernel"
            + (f", so the launches of {kernel} went unchecked here"
               if kernel is not None else ""))
        return queued_ms(fn, iters)
    if not sum(us for _, us in events) > 0:
        raise AssertionError("the profiler saw no device time")
    per_call = {n: max(1, round(c / iters)) for n, c in counts.items()}
    if kernel is not None and sum(per_call.values()) != 1:
        raise AssertionError(f"expected one launch of {kernel} a call, got "
                             f"{dict(counts)} in {iters} calls")
    us = sum(dur / counts[n] * per_call[n] for n, dur in events)
    return us / 1e3


def timed(fn, iters, kernel=None):
    """(device ms, wall ms) of one call: ``device_ms`` and ``wall_ms``."""
    return device_ms(fn, iters, kernel), wall_ms(fn, iters)


def short_close(got, want, name):
    """The card tests' tolerance (``torch.testing.assert_close``, atol =
    rtol = TOL): |got - want| <= TOL * (1 + |want|). Where S is short the
    bf16 gradients reach 4 to 16, where one bf16 ulp (0.03 to 0.06) is more
    than TOL. Returns (max abs error, max |want|, within)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = TOL[name]
    return (err.max().item(), want.abs().max().item(),
            bool((err <= tol * (1 + want.abs())).all()))


def attention_bound_ms(shape, dtype_name):
    """Least time for one attention forward: each of q, k, v read once, o and
    lse written once, against 4*B*H*S*S*D matmul FLOPs."""
    b, s, h, d = shape
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * item + b * h * s * 4
    flops = 4 * b * h * s * s * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_phase():
    """K1 against its plain version (each bf16 check at both query tilings);
    times at the path shapes and at 256 px, for both tilings."""
    import torch
    import torch.nn.functional as F
    from joligen_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    results, inputs = [], {}
    for shape, name in FWD_CHECKS:
        dtype = getattr(torch, name)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        inputs[(shape, name)] = (q, k, v)
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
        tiles = fa.Q_TILES if name == "bfloat16" else (None,)
        for tile in tiles:
            o, lse = fa._launch(q, k, v, shape[-1] ** -0.5, q_tile=tile)
            torch.cuda.synchronize()
            err_o = (o.float() - ref_o.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            tol = TOL[name]
            results.append({"shape": list(shape), "dtype": name,
                            "route": fa.ROUTES["flash_attention_fwd"][name],
                            "q_tile": tile, "max_abs_err_o": err_o,
                            "max_abs_err_lse": err_lse, "tol": tol})
            log(f"K1 check {shape} {name} q_tile {tile}: err o {err_o:.3e} "
                f"lse {err_lse:.3e} (tol {tol})")
            if not (err_o <= tol and err_lse <= tol):
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at {shape} {name} q_tile {tile}")

    # the video paths' shapes: both tilings where S <= 32, both dtypes
    for shape in SHORT_CHECKS:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
            for tiling in (fa.TILINGS if shape[1] <= fa.PACK_MAX_S
                           else ("plain",)):
                o, lse = fa._launch(q, k, v, shape[-1] ** -0.5,
                                    tiling=tiling)
                torch.cuda.synchronize()
                err_o, top_o, ok_o = short_close(o, ref_o, name)
                err_lse, _, ok_lse = short_close(lse, ref_lse, name)
                results.append({"shape": list(shape), "dtype": name,
                                "route": fa.ROUTES["flash_attention_fwd"][name],
                                "tiling": tiling, "max_abs_err_o": err_o,
                                "max_abs_err_lse": err_lse,
                                "max_abs_o": top_o,
                                "tol": f"{TOL[name]} (1 + |want|)"})
                log(f"K1 check {shape} {name} {tiling} tiling: err o "
                    f"{err_o:.3e} (|o| up to {top_o:.3f}) lse "
                    f"{err_lse:.3e} (tol {TOL[name]} (1 + |want|))")
                if not (ok_o and ok_lse):
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version at {shape} {name} "
                                         f"{tiling}")

    timings = {}
    for label, shape, iters in VID_TIMINGS:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        scale = shape[-1] ** -0.5
        out = fa.flash_attention_fwd(q, k, v)
        rec = {"shape": list(shape), "dtype": "bfloat16"}
        # the packed tiling (S <= 32) and the plain one at 64 queries a
        # block, the kernels alone
        tilings = fa.TILINGS if shape[1] <= fa.PACK_MAX_S else ("plain",)
        for tiling in tilings:
            rec[f"{tiling}_tiling_ms"], rec[f"{tiling}_tiling_wall_ms"] = \
                timed(lambda tiling=tiling: fa._launch(
                    q, k, v, scale, out, 64, tiling), iters,
                    "flash_fwd_wgmma_packed_kernel" if tiling == "packed"
                    else "flash_fwd_wgmma_kernel")
        rec["tiling"] = tilings[-1]
        rec["ms"] = rec[f"{rec['tiling']}_tiling_ms"]
        rec["wall_ms"] = rec[f"{rec['tiling']}_tiling_wall_ms"]
        rec["plain_ms"], rec["plain_wall_ms"] = timed(
            lambda: fa.flash_attention_reference(q, k, v), iters)
        rec["library_ms"], rec["library_wall_ms"] = timed(
            lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)
        rec["bound_ms"], rec["bound_by"] = attention_bound_ms(shape,
                                                              "bfloat16")
        timings[label] = rec
        log(f"K1 time {label} {shape} bf16: " + ", ".join(
            f"{t} tiling {rec[f'{t}_tiling_ms']:.4f} ms (wall "
            f"{rec[f'{t}_tiling_wall_ms']:.4f})" for t in tilings)
            + (f", packed / plain {rec['packed_tiling_ms'] / rec['plain_tiling_ms']:.3f}"
               if len(tilings) == 2 else "")
            + f"; plain version {rec['plain_ms']:.4f} ms; sdpa "
            f"{rec['library_ms']:.4f} ms (wall {rec['library_wall_ms']:.4f});"
            f" bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    for label, shape, iters in (("128px_batch1", PATH_SHAPE, 200),
                                ("128px_batch8", TRAIN_SHAPE, 100),
                                ("256px_batch8", BIG_SHAPE, 20),
                                ("gan_256px_batch4", GAN_SHAPE, 20),
                                ("xview_128px_batch1", XVIEW_PATH_SHAPE, 200),
                                ("xview_128px_batch16", XVIEW_TRAIN_SHAPE,
                                 50),
                                ("cm_128px_batch16", CM_TRAIN_SHAPE, 50)):
        q, k, v = inputs[(shape, "bfloat16")]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        scale = shape[-1] ** -0.5
        out = fa.flash_attention_fwd(q, k, v)
        rec = {"shape": list(shape), "dtype": "bfloat16"}
        # the kernel alone (outputs allocated once) at each query tiling
        for tile in fa.Q_TILES:
            rec[f"q_tile_{tile}_ms"], rec[f"q_tile_{tile}_wall_ms"] = timed(
                lambda tile=tile: fa._launch(q, k, v, scale, out, tile),
                iters, "flash_fwd_wgmma_kernel")
        # the tiling the wrapper picks for this shape on this card
        rec["q_tile"] = fa.fwd_q_tile(*shape[:3], sm_count)
        rec["ms"] = rec[f"q_tile_{rec['q_tile']}_ms"]
        rec["wall_ms"] = rec[f"q_tile_{rec['q_tile']}_wall_ms"]
        # through the wrapper: checks and allocation on the host every call
        rec["wrapper_wall_ms"] = wall_ms(
            lambda: fa.flash_attention_fwd(q, k, v), iters)
        rec["plain_ms"], rec["plain_wall_ms"] = timed(
            lambda: fa.flash_attention_reference(q, k, v), iters)
        rec["library_ms"], rec["library_wall_ms"] = timed(
            lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)
        rec["bound_ms"], rec["bound_by"] = attention_bound_ms(shape,
                                                              "bfloat16")
        timings[label] = rec
        log(f"K1 time {label} {shape} bf16: " + ", ".join(
            f"q_tile {t} {rec[f'q_tile_{t}_ms']:.4f} ms (wall "
            f"{rec[f'q_tile_{t}_wall_ms']:.4f})" for t in fa.Q_TILES)
            + f"; the wrapper picks {rec['q_tile']}, its wall "
            f"{rec['wrapper_wall_ms']:.4f} ms; plain "
            f"{rec['plain_ms']:.4f} ms; sdpa {rec['library_ms']:.4f} ms "
            f"(wall {rec['library_wall_ms']:.4f}); bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    main = [r for r in results if r["shape"] == list(PATH_SHAPE)
            and r["dtype"] == "bfloat16"]
    t = timings["128px_batch1"]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "dtype_routes": fa.ROUTES["flash_attention_fwd"],
            "q_tile": t["q_tile"],
            "source": "joligen_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "joligen_tpu/ops/flash_attention.py:43",
            "launches": None,
            "max_abs_err": max(max(r["max_abs_err_o"], r["max_abs_err_lse"])
                               for r in main),
            "ms": t["ms"], "wall_ms": t["wall_ms"],
            "wrapper_wall_ms": t["wrapper_wall_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "(1, 256, 16, 32) bf16: 128 px, batch 1",
            "timings": timings, "checks": results}


def backward_bound_ms(shape, dtype_name, kernel):
    """Least time for K2 or K3: q, k, v, dO read once, lse and delta read
    once, dQ (K2) or dK and dV (K3) written once, against 6*B*H*S*S*D (K2:
    QK^T, dO V^T, dS K) or 8*B*H*S*S*D (K3: QK^T, dO V^T, P^T dO, dS^T Q)
    matmul FLOPs."""
    b, s, h, d = shape
    item = 2 if dtype_name == "bfloat16" else 4
    n_out = 1 if kernel == "dq" else 2
    nbytes = (4 + n_out) * b * s * h * d * item + 2 * b * h * s * 4
    flops = (6 if kernel == "dq" else 8) * b * h * s * s * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def backward_kernel_phase():
    """K2 and K3 against their plain version at the paths' shapes, the
    autograd Function against autograd through the plain forward, and their
    times at the training shape and at 256 px batch 8."""
    import torch
    import torch.nn.functional as F
    from joligen_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    inputs, checks = {}, []
    for shape, name in BWD_CHECKS:
        dtype = getattr(torch, name)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(o, do)
        scale = shape[-1] ** -0.5
        inputs[(shape, name)] = (q, k, v, do, lse, delta, scale)
        tiles = fa.Q_TILES if name == "bfloat16" else (None,)
        dqs = [fa._launch_bwd_dq(q, k, v, lse, delta, do, scale, q_tile=tile)
               for tile in tiles]
        dk, dv = fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, lse, delta, do,
                                                scale)
        err_dq = {tile: (dq.float() - want[0].float()).abs().max().item()
                  for tile, dq in zip(tiles, dqs)}
        errs = [max(err_dq.values())] + [
            (a.float() - b.float()).abs().max().item()
            for a, b in zip((dk, dv), want[1:])]
        rec = {"shape": list(shape), "dtype": name, "max_abs_err_dq": errs[0],
               "max_abs_err_dq_by_q_tile": err_dq,
               "max_abs_err_dk": errs[1], "max_abs_err_dv": errs[2],
               "tol": TOL[name]}
        checks.append(rec)
        log(f"K2/K3 check {shape} {name}: err dq " + ", ".join(
            f"{e:.3e} (q_tile {t})" for t, e in err_dq.items())
            + f", dk {errs[1]:.3e}, dv {errs[2]:.3e} (tol {TOL[name]})")
        if max(errs) > TOL[name]:
            raise AssertionError(f"K2/K3 disagree with their plain version "
                                 f"at {shape} {name}")

    # the video paths' shapes: both tilings where S <= 32, both dtypes
    for shape in SHORT_CHECKS:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            q, k, v, do = (torch.randn(shape, generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = fa.attention_delta(o, do)
            scale = shape[-1] ** -0.5
            want = fa.flash_attention_bwd_reference(q, k, v, lse, delta, do,
                                                    scale)
            for tiling in (fa.TILINGS if shape[1] <= fa.PACK_MAX_S
                           else ("plain",)):
                dq = fa._launch_bwd_dq(q, k, v, lse, delta, do, scale,
                                       tiling=tiling)
                dk, dv = fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale,
                                            tiling=tiling)
                torch.cuda.synchronize()
                res = [short_close(a, b, name)
                       for a, b in zip((dq, dk, dv), want)]
                checks.append({"shape": list(shape), "dtype": name,
                               "tiling": tiling,
                               **{f"max_abs_err_{g}": r[0]
                                  for g, r in zip(("dq", "dk", "dv"), res)},
                               **{f"max_abs_{g}": r[1]
                                  for g, r in zip(("dq", "dk", "dv"), res)},
                               "tol": f"{TOL[name]} (1 + |want|)"})
                log(f"K2/K3 check {shape} {name} {tiling} tiling: " + ", ".join(
                    f"err {g} {r[0]:.3e} (|{g}| up to {r[1]:.3f})"
                    for g, r in zip(("dq", "dk", "dv"), res))
                    + f" (tol {TOL[name]} (1 + |want|))")
                if not all(r[2] for r in res):
                    raise AssertionError(f"K2/K3 disagree with their plain "
                                         f"version at {shape} {name} "
                                         f"{tiling}")

    # the autograd Function on q/k/v column slices of a fused projection,
    # as AttentionBlock calls it, against autograd through the plain forward
    autograd_errs = {}
    b, s, h, d = TRAIN_SHAPE
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev).to(
            dtype).requires_grad_()
        do = torch.randn(TRAIN_SHAPE, generator=gen, device=dev).to(dtype)

        def grad(attn):
            q, k, v = (t.reshape(b, s, h, d)
                       for t in torch.split(qkv, h * d, dim=-1))
            return torch.autograd.grad(attn(q, k, v), qkv, do)[0]
        got = grad(fa.flash_attention)
        want = grad(lambda q, k, v: fa.flash_attention_reference(q, k, v)[0])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        autograd_errs[name] = err
        log(f"autograd Function vs autograd through the plain forward "
            f"{TRAIN_SHAPE} {name}: max abs err {err:.3e} (tol {TOL[name]})")
        if err > TOL[name]:
            raise AssertionError("FlashAttention gradients disagree")

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    timings = {}
    for label, shape, iters in VID_TIMINGS:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(o, do)
        scale = shape[-1] ** -0.5
        dq = torch.empty_like(q)
        dkv = (torch.empty_like(q), torch.empty_like(q))
        rec = {"shape": list(shape), "dtype": "bfloat16"}
        tilings = fa.TILINGS if shape[1] <= fa.PACK_MAX_S else ("plain",)
        for tiling in tilings:
            packed = tiling == "packed"
            rec[f"dq_{tiling}_tiling_ms"], rec[f"dq_{tiling}_tiling_wall_ms"] \
                = timed(lambda tiling=tiling: fa._launch_bwd_dq(
                    q, k, v, lse, delta, do, scale, dq, 64, tiling), iters,
                    "flash_bwd_dq_wgmma_packed_kernel" if packed
                    else "flash_bwd_dq_wgmma_kernel")
            rec[f"dkv_{tiling}_tiling_ms"], \
                rec[f"dkv_{tiling}_tiling_wall_ms"] = timed(
                    lambda tiling=tiling: fa._launch_bwd_dkv(
                        q, k, v, lse, delta, do, scale, dkv, tiling), iters,
                    "flash_bwd_dkv_wgmma_packed_kernel" if packed
                    else "flash_bwd_dkv_wgmma_kernel")
        rec["tiling"] = tilings[-1]
        for kern in ("dq", "dkv"):
            rec[kern + "_ms"] = rec[f"{kern}_{rec['tiling']}_tiling_ms"]
            rec[kern + "_bound_ms"], rec[kern + "_bound_by"] = \
                backward_bound_ms(shape, "bfloat16", kern)
        rec["plain_ms"], rec["plain_wall_ms"] = timed(
            lambda: fa.flash_attention_bwd_reference(q, k, v, lse, delta, do,
                                                     scale), iters)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qh, kh, vh)
        rec["library_bwd_ms"], rec["library_bwd_wall_ms"] = timed(
            lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                        retain_graph=True), iters)
        del lib_out
        timings[label] = rec
        for kern, kid in (("dq", "K2"), ("dkv", "K3")):
            log(f"{kid} time {label} {shape} bf16: " + ", ".join(
                f"{t} tiling {rec[f'{kern}_{t}_tiling_ms']:.4f} ms (wall "
                f"{rec[f'{kern}_{t}_tiling_wall_ms']:.4f})" for t in tilings)
                + f"; bound {rec[kern + '_bound_ms']:.5f} ms "
                f"({rec[kern + '_bound_by']})")
        log(f"backward {label}: plain (dq, dk, dv together) "
            f"{rec['plain_ms']:.4f} ms; sdpa backward "
            f"{rec['library_bwd_ms']:.4f} ms; K2 + K3 "
            f"{rec['dq_ms'] + rec['dkv_ms']:.4f} ms")
    for label, shape, iters in (("128px_batch8", TRAIN_SHAPE, 100),
                                ("256px_batch8", BIG_SHAPE, 10),
                                ("gan_256px_batch4", GAN_SHAPE, 10),
                                ("xview_128px_batch16", XVIEW_TRAIN_SHAPE,
                                 50),
                                ("cm_128px_batch16", CM_TRAIN_SHAPE, 50)):
        q, k, v, do, lse, delta, scale = inputs[(shape, "bfloat16")]
        dq = torch.empty_like(q)
        dkv = (torch.empty_like(q), torch.empty_like(q))
        rec = {"shape": list(shape), "dtype": "bfloat16"}
        # the kernels alone (outputs allocated once; K2 at each query
        # tiling), then through their launch wrappers (checks and
        # allocation on the host every call)
        for tile in fa.Q_TILES:
            rec[f"dq_q_tile_{tile}_ms"], rec[f"dq_q_tile_{tile}_wall_ms"] = \
                timed(lambda tile=tile: fa._launch_bwd_dq(
                    q, k, v, lse, delta, do, scale, dq, tile),
                    iters, "flash_bwd_dq_wgmma_kernel")
        # the tiling the wrapper picks for this shape on this card
        rec["dq_q_tile"] = fa.bwd_dq_q_tile(*shape[:3], sm_count)
        rec["dq_ms"] = rec[f"dq_q_tile_{rec['dq_q_tile']}_ms"]
        rec["dq_wall_ms"] = rec[f"dq_q_tile_{rec['dq_q_tile']}_wall_ms"]
        rec["dkv_ms"], rec["dkv_wall_ms"] = timed(
            lambda: fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale, dkv),
            iters, "flash_bwd_dkv_wgmma_kernel")
        rec["dq_wrapper_wall_ms"] = wall_ms(
            lambda: fa._launch_bwd_dq(q, k, v, lse, delta, do, scale), iters)
        rec["dkv_wrapper_wall_ms"] = wall_ms(
            lambda: fa._launch_bwd_dkv(q, k, v, lse, delta, do, scale), iters)
        rec["plain_ms"], rec["plain_wall_ms"] = timed(
            lambda: fa.flash_attention_bwd_reference(q, k, v, lse, delta, do,
                                                     scale), iters)
        # library: scaled_dot_product_attention's backward alone, run again
        # and again through one retained graph (B, H, S, D inputs)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qh, kh, vh)
        rec["library_bwd_ms"], rec["library_bwd_wall_ms"] = timed(
            lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                        retain_graph=True), iters)
        del lib_out
        for kern in ("dq", "dkv"):
            rec[kern + "_bound_ms"], rec[kern + "_bound_by"] = \
                backward_bound_ms(shape, "bfloat16", kern)
        timings[label] = rec
        log(f"K2 tilings {label}: " + ", ".join(
            f"q_tile {t} {rec[f'dq_q_tile_{t}_ms']:.4f} ms (wall "
            f"{rec[f'dq_q_tile_{t}_wall_ms']:.4f})" for t in fa.Q_TILES)
            + f"; the wrapper picks {rec['dq_q_tile']}")
        for kern, kid in (("dq", "K2"), ("dkv", "K3")):
            log(f"{kid} time {label} {shape} bf16: kernel "
                f"{rec[kern + '_ms']:.4f} ms (wall "
                f"{rec[kern + '_wall_ms']:.4f}), wrapper wall "
                f"{rec[kern + '_wrapper_wall_ms']:.4f} ms, bound "
                f"{rec[kern + '_bound_ms']:.5f} ms "
                f"({rec[kern + '_bound_by']})")
        log(f"backward {label}: plain (dq, dk, dv together) "
            f"{rec['plain_ms']:.4f} ms (wall {rec['plain_wall_ms']:.4f}); "
            f"sdpa backward {rec['library_bwd_ms']:.4f} ms (wall "
            f"{rec['library_bwd_wall_ms']:.4f}); K2 + K3 "
            f"{rec['dq_ms'] + rec['dkv_ms']:.4f} ms, "
            f"{(rec['dq_ms'] + rec['dkv_ms']) / rec['library_bwd_ms']:.2f}x "
            f"the sdpa backward")

    main = next(r for r in checks if r["shape"] == list(TRAIN_SHAPE)
                and r["dtype"] == "bfloat16")
    t = timings["128px_batch8"]
    out = []
    for kern, name, line, errs in (
            ("dq", "flash_attention_bwd_dq", 114, ("max_abs_err_dq",)),
            ("dkv", "flash_attention_bwd_dkv", 143,
             ("max_abs_err_dk", "max_abs_err_dv"))):
        out.append({
            "name": name, "route": "cuda", "dtype_routes": fa.ROUTES[name],
            "source": "joligen_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"joligen_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(main[e] for e in errs),
            **({"q_tile": t["dq_q_tile"],
                "ms_by_q_tile": {tile: t[f"dq_q_tile_{tile}_ms"]
                                 for tile in fa.Q_TILES}}
               if kern == "dq" else {}),
            "ms": t[kern + "_ms"], "wall_ms": t[kern + "_wall_ms"],
            "wrapper_wall_ms": t[kern + "_wrapper_wall_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t[kern + "_bound_ms"],
            "bound_by": t[kern + "_bound_by"],
            "library_ms": t["library_bwd_ms"],
            "shape": "(8, 256, 16, 32) bf16: 128 px, batch 8",
            "plain_and_library_compute": "dq, dk and dv together",
            "timings": timings, "checks": checks,
            "autograd_max_abs_err": autograd_errs})
    return out


def conv_bound_ms(shape, co, dtype_name):
    """Least time for one 3×3 conv: x and w read once, y written once,
    against 2*9*B*H*W*C*Co FLOPs."""
    b, h, w, c = shape
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (b * h * w * (c + co) + 9 * c * co) * item
    flops = 2 * 9 * b * h * w * c * co
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-6)).item()


def probe_kernel_phase():
    """P1, P2 and P3 against their plain versions (and P1, P2 against the
    library conv) on CUDA tensors; their times at the probes' shapes."""
    import torch
    import torch.nn.functional as F
    from joligen_tpu_torch.ops import conv3x3
    from joligen_tpu_torch.ops import copy as dma
    from joligen_tpu_torch.tools.bw_probe3 import CHUNK_ROWS
    from joligen_tpu_torch.tools.fused_resblock_probe import conv_library

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    variants = [("P1", None)] + [("P2", s2) for s2 in conv3x3.STRIPS]
    conv_checks = []
    for shape, co in CONV_CHECKS:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, 3, shape[-1], co), generator=gen, device=dev)
                 / (9 * shape[-1]) ** 0.5).to(dtype)
            lib = conv_library(x, w) if name == "bfloat16" else None
            for kern, s2 in variants:
                if s2 is None:
                    got = conv3x3.conv3x3_taps(x, w)
                    want = conv3x3.conv3x3_taps_reference(x, w)
                else:
                    got = conv3x3.conv3x3_taps_v2(x, w, s2=s2)
                    want = conv3x3.conv3x3_taps_v2_reference(x, w)
                torch.cuda.synchronize()
                rec = {"kernel": kern, "s2": s2, "shape": list(shape),
                       "co": co, "dtype": name,
                       "max_abs_err": (got.float() - want.float()).abs()
                       .max().item(),
                       "rel_err": _rel_err(got, want), "tol": TOL[name]}
                if lib is not None:
                    rec["rel_err_vs_library"] = _rel_err(got, lib)
                conv_checks.append(rec)
                log(f"{kern}{'' if s2 is None else f' s2={s2}'} check {shape}"
                    f"->{co} {name}: rel err {rec['rel_err']:.3e} (tol "
                    f"{TOL[name]}), vs library "
                    f"{rec.get('rel_err_vs_library', float('nan')):.3e}")
                if not (rec["rel_err"] <= TOL[name] and rec.get(
                        "rel_err_vs_library", 0.0) < LIBRARY_CONV_TOL):
                    raise AssertionError(f"{kern} s2={s2} disagrees at "
                                         f"{shape} {name}")

    copy_checks = []
    for n_rows, row, chunk_rows, name in COPY_CHECKS:
        x, bits = dma.random_bits((n_rows, row), getattr(torch, name), gen)
        y = dma.make_copy(n_rows, row, chunk_rows, x.dtype, dev)(x)
        plain = dma.copy_reference(x, chunk_rows)
        torch.cuda.synchronize()
        exact = torch.equal(y.view(bits), x.view(bits)) and torch.equal(
            plain.view(bits), x.view(bits))
        plan = dma.launch_plan(n_rows // chunk_rows,
                               chunk_rows * row * x.element_size(), dev)
        copy_checks.append({"n_rows": n_rows, "row": row,
                            "chunk_rows": chunk_rows, "dtype": name,
                            "chunks": n_rows // chunk_rows, **plan,
                            "exact": exact})
        log(f"P3 check ({n_rows}, {row}) {name} chunk_rows {chunk_rows} "
            f"({n_rows // chunk_rows} chunks, {plan['items']} items, grid "
            f"{plan['grid']}, {plan['items'] // plan['grid']}+ items a "
            f"block): exact {exact}")
        if not exact:
            raise AssertionError("P3 is not an exact copy")
        if (n_rows, row, chunk_rows, name) == COPY_WRAP_CHECK and not (
                plan["items"] // plan["grid"] > 3 * plan["stages"]):
            raise AssertionError("P3's wrap check wraps the ring fewer "
                                 "than three times a block")
        del x, y, plain

    # the probe's shape: each wrapper against its plain version, then the
    # times of the kernels alone (outputs allocated once)
    x = (torch.randn(CONV_PATH_SHAPE, generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    c = CONV_PATH_SHAPE[-1]
    w = (torch.randn((3, 3, c, c), generator=gen, device=dev)
         / (9 * c) ** 0.5).to(torch.bfloat16)
    plain = {"P1": conv3x3.conv3x3_taps_reference(x, w),
             "P2": conv3x3.conv3x3_taps_v2_reference(x, w)}
    path_checks = {}
    for kern, s2 in variants:
        got = (conv3x3.conv3x3_taps(x, w) if s2 is None
               else conv3x3.conv3x3_taps_v2(x, w, s2=s2))
        want = plain[kern]
        torch.cuda.synchronize()
        rec = path_checks[(kern, s2)] = {
            "kernel": kern, "s2": s2, "shape": list(CONV_PATH_SHAPE),
            "co": c, "dtype": "bfloat16",
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "rel_err": _rel_err(got, want), "tol": TOL["bfloat16"]}
        conv_checks.append(rec)
        log(f"{kern}{'' if s2 is None else f' s2={s2}'} check "
            f"{CONV_PATH_SHAPE}->{c} bfloat16: rel err {rec['rel_err']:.3e} "
            f"(tol {TOL['bfloat16']})")
        if not rec["rel_err"] <= TOL["bfloat16"]:
            raise AssertionError(f"{kern} s2={s2} disagrees at "
                                 f"{CONV_PATH_SHAPE}")
        del got
    del plain
    out = torch.empty_like(x)
    taps = {None: conv3x3.kernel_taps(w, v2=False),
            "v2": conv3x3.kernel_taps(w, v2=True)}
    # each entry (device ms, wall ms); every launch must be the wgmma kernel
    conv_ms = {"P1": timed(lambda: conv3x3._launch(x, taps[None], 0, out),
                           20, "conv3x3_wgmma_kernel")}
    for s2 in conv3x3.STRIPS:
        conv_ms[f"P2 s2={s2}"] = timed(
            lambda s2=s2: conv3x3._launch(x, taps["v2"], s2, out), 20,
            "conv3x3_wgmma_kernel")
    plain_ms = {"P1": timed(lambda: conv3x3.conv3x3_taps_reference(x, w), 5),
                "P2": timed(lambda: conv3x3.conv3x3_taps_v2_reference(x, w),
                            5)}
    xn = x.permute(0, 3, 1, 2)                      # channels_last NCHW
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_ms = timed(lambda: F.conv2d(xn, wn, padding=1), 20)
    bound, by = conv_bound_ms(CONV_PATH_SHAPE, c, "bfloat16")
    bound32, _ = conv_bound_ms(CONV_PATH_SHAPE, c, "float32")
    flops = 2 * 9 * x.numel() * c
    tflops = {k: flops / v[0] / 1e9 for k, v in
              [*conv_ms.items(), ("cuDNN", lib_ms)]}
    log(f"conv times {CONV_PATH_SHAPE} bf16 (device ms, wall ms): " + ", ".join(
        f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in conv_ms.items())
        + f"; plain P1 {plain_ms['P1'][0]:.4f} / {plain_ms['P1'][1]:.4f}, "
        f"P2 {plain_ms['P2'][0]:.4f} / {plain_ms['P2'][1]:.4f}; cuDNN conv "
        f"{lib_ms[0]:.4f} / {lib_ms[1]:.4f}; bound {bound:.5f} ms ({by}), on "
        f"fp32 FMAs {bound32:.4f} ms; TFLOP/s " + ", ".join(
            f"{k} {v:.1f}" for k, v in tflops.items()))
    # fp32 stays on the FMA kernel: its time at the same shape
    x32, w32 = x.float(), w.float()
    out32 = torch.empty_like(x32)
    taps32 = {None: conv3x3.kernel_taps(w32, v2=False),
              "v2": conv3x3.kernel_taps(w32, v2=True)}
    conv_ms_fp32 = {"P1": timed(
        lambda: conv3x3._launch(x32, taps32[None], 0, out32), 5,
        "conv3x3_fma_kernel")}
    for s2 in conv3x3.STRIPS:
        conv_ms_fp32[f"P2 s2={s2}"] = timed(
            lambda s2=s2: conv3x3._launch(x32, taps32["v2"], s2, out32), 5,
            "conv3x3_fma_kernel")
    log(f"conv times {CONV_PATH_SHAPE} fp32 on FMAs (device ms, wall ms): "
        + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                    for k, v in conv_ms_fp32.items()))
    del x, out, taps, xn, wn, x32, w32, out32, taps32

    # the probe's cases over 1 GiB, each dtype beside copy_: (device ms,
    # wall ms), every launch the kernel; the output is set to the
    # complement of the input before each case and held against it after
    # its timed calls: the elements whose bits differ, and the largest
    # |dst - src| among them (inf where only one is NaN), both 0 when exact
    mib, row, path_name = COPY_PATH
    nbytes = mib * 2**20
    copy_bound = 2 * nbytes / PEAK_BYTES_PER_S * 1e3
    copy_ms, copy_lib, copy_plans, copy_diff = {}, {}, {}, {}
    for name in ("float32", "bfloat16"):
        n_rows = nbytes // (row * (4 if name == "float32" else 2))
        src, bits = dma.random_bits((n_rows, row), getattr(torch, name), gen)
        dst = torch.empty_like(src)
        for chunk_rows in CHUNK_ROWS:
            case = f"{name} {chunk_rows}"
            torch.bitwise_not(src.view(bits), out=dst.view(bits))
            copy_ms[case] = timed(lambda: dma._launch(src, chunk_rows, dst),
                                  10, "dma_copy_kernel")
            differ = dst.view(bits) != src.view(bits)
            err = torch.where(differ, (dst.float() - src.float()).abs()
                              .nan_to_num(nan=float("inf")), 0.0)
            copy_diff[case] = {"elements": differ.count_nonzero().item(),
                               "max_abs_err": err.max().item()}
            del differ, err
            if copy_diff[case]["elements"]:
                raise AssertionError(f"P3 is not an exact copy at 1 GiB "
                                     f"{case}: {copy_diff[case]}")
            copy_plans[case] = dma.launch_plan(
                n_rows // chunk_rows, chunk_rows * row * src.element_size(),
                dev)
            ms, wall = copy_ms[case]
            log(f"P3 time ({n_rows}, {row}) {name} chunk_rows {chunk_rows}: "
                f"{ms:.4f} ms ({2 * nbytes / ms / 1e6:.1f} GB/s, "
                f"{copy_bound / ms:.1%} of the bound; wall {wall:.4f}), "
                f"{copy_plans[case]}")
        copy_lib[name] = timed(lambda: dst.copy_(src), 10)
        log(f"copy_ time ({n_rows}, {row}) {name}: {copy_lib[name][0]:.4f} "
            f"ms ({2 * nbytes / copy_lib[name][0] / 1e6:.1f} GB/s; wall "
            f"{copy_lib[name][1]:.4f})")
        if name == path_name:
            # the plain version: one strided copy a tile of the chunk
            copy_plain = timed(lambda: dma.copy_reference(src, 1024), 5)
            log(f"P3 plain ({n_rows}, {row}) {name} chunk_rows 1024: "
                f"{copy_plain[0]:.4f} ms (wall {copy_plain[1]:.4f})")
        del src, dst
        torch.cuda.empty_cache()
    log(f"P3 bound over 1 GiB: {copy_bound:.4f} ms (bytes)")

    shape_note = f"{CONV_PATH_SHAPE} -> {c} bf16 NHWC: the probe's hot site"
    p1 = {"name": "conv3x3_taps", "route": "cuda",
          "dtype_routes": conv3x3.ROUTES["conv3x3_taps"],
          "source": "joligen_tpu_torch/csrc/conv3x3_tap.cu",
          "replaces": "tools/fused_resblock_probe.py:43",
          "launches": None,
          "max_abs_err": path_checks[("P1", None)]["max_abs_err"],
          "ms": conv_ms["P1"][0], "wall_ms": conv_ms["P1"][1],
          "plain_ms": plain_ms["P1"][0], "plain_wall_ms": plain_ms["P1"][1],
          "bound_ms": bound, "bound_by": by, "bound_fp32_ms": bound32,
          "library_ms": lib_ms[0], "library_wall_ms": lib_ms[1],
          "tflops": tflops["P1"], "library_tflops": tflops["cuDNN"],
          "fp32_ms": conv_ms_fp32["P1"][0],
          "shape": shape_note, "checks": conv_checks}
    p2 = {"name": "conv3x3_taps_v2", "route": "cuda",
          "dtype_routes": conv3x3.ROUTES["conv3x3_taps_v2"],
          "source": "joligen_tpu_torch/csrc/conv3x3_tap.cu",
          "replaces": "tools/fused_resblock_probe.py:121",
          "launches": None,
          "max_abs_err": max(path_checks[("P2", s2)]["max_abs_err"]
                             for s2 in conv3x3.STRIPS),
          "ms": conv_ms["P2 s2=16"][0], "wall_ms": conv_ms["P2 s2=16"][1],
          "ms_by_s2": {s2: conv_ms[f"P2 s2={s2}"][0]
                       for s2 in conv3x3.STRIPS},
          "wall_ms_by_s2": {s2: conv_ms[f"P2 s2={s2}"][1]
                            for s2 in conv3x3.STRIPS},
          "tflops": tflops["P2 s2=16"], "library_tflops": tflops["cuDNN"],
          "fp32_ms_by_s2": {s2: conv_ms_fp32[f"P2 s2={s2}"][0]
                            for s2 in conv3x3.STRIPS},
          "plain_ms": plain_ms["P2"][0], "plain_wall_ms": plain_ms["P2"][1],
          "bound_ms": bound, "bound_by": by, "bound_fp32_ms": bound32,
          "library_ms": lib_ms[0], "library_wall_ms": lib_ms[1],
          "shape": shape_note + "; ms at s2 = 16"}
    path_case = f"{path_name} 1024"
    p3 = {"name": "dma_copy", "route": "cuda",
          "source": "joligen_tpu_torch/csrc/dma_copy.cu",
          "replaces": "tools/bw_probe3.py:24", "launches": None,
          "max_abs_err": max(d["max_abs_err"] for d in copy_diff.values()),
          "bit_mismatches_by_case": {k: d["elements"]
                                     for k, d in copy_diff.items()},
          "ms": copy_ms[path_case][0],
          "wall_ms": copy_ms[path_case][1],
          "ms_by_case": {k: v[0] for k, v in copy_ms.items()},
          "wall_ms_by_case": {k: v[1] for k, v in copy_ms.items()},
          "plan_by_case": copy_plans,
          "plain_ms": copy_plain[0], "plain_wall_ms": copy_plain[1],
          "bound_ms": copy_bound, "bound_by": "bytes",
          "library_ms": copy_lib[path_name][0],
          "library_wall_ms": copy_lib[path_name][1],
          "library_ms_by_dtype": {k: v[0] for k, v in copy_lib.items()},
          "shape": f"1 GiB of {row}-element rows, {path_name}, chunk_rows "
                   "1024 (ms_by_case: 'dtype chunk_rows')",
          "checks": copy_checks}
    return p1, p2, p3


def probe_paths():
    """The two probes at full size, each with the launch counters at 0 just
    before it and read just after."""
    import torch
    from joligen_tpu_torch.tools import bw_probe3
    from joligen_tpu_torch.tools import fused_resblock_probe as frp

    launches, results = {}, {}
    for path, run, expect in (
            ("fused_resblock_probe", lambda: frp.stage_a(PROBE_ITERS),
             frp.stage_a_launches(PROBE_ITERS)),
            ("bw_probe3", bw_probe3.run_cases, bw_probe3.RUN_LAUNCHES)):
        reset_launches()                         # the probe's path starts
        t0 = time.perf_counter()
        results[path] = run()
        torch.cuda.synchronize()
        launches[path] = read_launches()         # and ends here
        want = {n: expect.get(n, 0) for n in launches[path]}
        log(f"{path}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[path]}")
        if launches[path] != want:
            raise AssertionError(f"{path} launched {launches[path]}, "
                                 f"expected {want}")
        torch.cuda.empty_cache()
    return launches, results


def _counters():
    from joligen_tpu_torch.ops import conv3x3
    from joligen_tpu_torch.ops import copy as dma
    from joligen_tpu_torch.ops import flash_attention as fa
    return fa.LAUNCHES, conv3x3.LAUNCHES, dma.LAUNCHES


def reset_launches():
    for counters in _counters():
        for name in counters:
            counters[name] = 0


def read_launches():
    return {n: c for counters in _counters() for n, c in counters.items()}


def _attention_only(launches, n):
    """The launch counts expected where each attention kernel ran ``n``
    times (``n`` a dict: ``n[kernel]`` times) and no probe kernel ran."""
    from joligen_tpu_torch.ops import flash_attention as fa
    counts = n if isinstance(n, dict) else dict.fromkeys(fa.LAUNCHES, n)
    return {name: counts.get(name, 0) for name in launches}


def _train(workdir, size, n_images, epochs, hook=None):
    """``launch_training`` on the example config at ``size`` px over
    ``n_images`` synthetic images for ``epochs`` epochs (``_train_run``).
    Returns (model, opt, record)."""
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.tools.synthetic_datasets import write_labeled

    with open(EXAMPLE) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.data_load_size = opt.data_crop_size = size
    dataroot = os.path.join(workdir, f"train_data_{size}")
    write_labeled(dataroot, n_images, size, seed=SEED + 2)
    opt.dataroot = dataroot
    opt.checkpoints_dir = os.path.join(workdir, "train_ckpt")
    opt.name = f"smoke_train_{size}px"
    opt.train_n_epochs, opt.train_n_epochs_decay = epochs, 0
    opt.output_print_freq = opt.train_batch_size        # every step
    steps = epochs * n_images // opt.train_batch_size
    return _train_run(opt, steps, epochs, f"training {size} px",
                      EXPECTED_PARAMS, hook)


def _train_run(opt, steps, epochs, label, expected_params=None, hook=None,
               attention_per_step=1, eval_k1=0, main_net="G_A",
               main_loss="G_tot"):
    """``launch_training(opt)`` with the launch counters at 0 just before it
    and read just after (one main path). Checks the step count, the
    parameter count of ``main_net`` (when given) and bf16,
    ``attention_per_step`` launches of each attention kernel a step (a dict:
    per kernel; none for the GANs) and ``eval_k1`` more of K1 (the
    train-time metrics' sampling), and finite losses, every loss the model
    logs (``main_loss`` the one recorded first and last). ``hook(model,
    iters, steps)`` runs after each step, outside the step times. Returns
    (model, opt, record): losses, median warm step, images/s, peak memory,
    the loop's data wait."""
    import numpy as np
    import torch
    from joligen_tpu_torch.train import launch_training

    marks, losses, all_losses = [], [], []

    def on_step(model, iters):
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        losses.append(float(model.loss_log[main_loss]))
        all_losses.append({k: float(v) for k, v in model.loss_log.items()})
        if hook is not None:
            hook(model, iters, steps)
            torch.cuda.synchronize()
        # the step's end, and the next step's start: after this callback
        marks.append((iters, t_end, time.perf_counter()))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()                                 # main path starts here
    t0 = time.perf_counter()
    model = launch_training(opt, step_callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                       # main path ends here
    peak = torch.cuda.max_memory_allocated()

    n_params = model.param_count()[main_net]
    if (expected_params is not None and n_params != expected_params) or \
            model.device_dtype != torch.bfloat16:
        raise AssertionError(f"{label}: trained {n_params} parameters in "
                             f"{model.device_dtype}")
    per = attention_per_step
    want = _attention_only(launches, {k: steps * v for k, v in per.items()}
                           if isinstance(per, dict) else steps * per)
    if eval_k1:
        want["flash_attention_fwd"] += eval_k1
    if len(marks) != steps or launches != want:
        raise AssertionError(f"{label}: {len(marks)} steps, launches "
                             f"{launches}; expected {want}")
    if not all(np.isfinite(v) for d in all_losses for v in d.values()):
        raise AssertionError(f"{label}: non-finite loss: {all_losses}")
    # warm steps: the step after another in the same epoch (the first of
    # an epoch waits for the loader and follows the epoch's saves)
    per_epoch = steps // epochs
    warm = [t1 - t0 for (_, _, t0), (i1, t1, _) in zip(marks, marks[1:])
            if (i1 // opt.train_batch_size - 1) % per_epoch != 0]
    step_s = float(np.median(warm))
    data_s = model.loop_times["data_s"]
    rec = {"batch": opt.train_batch_size, "steps": steps,
           "parameters": n_params, "launches": launches,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses_last": all_losses[-1],
           "median_warm_step_s": step_s, "warm_steps": len(warm),
           "images_per_s": opt.train_batch_size / step_s,
           "max_memory_allocated": peak, "data_wait_s": data_s,
           "data_wait_per_step_s": data_s / steps, "wall_s": wall,
           "metrics_s": model.loop_times["metrics_s"]}
    log(f"{label}: {steps} steps, {n_params} parameters, launches "
        f"{launches}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, median warm "
        f"step {step_s * 1e3:.1f} ms ({opt.train_batch_size / step_s:.1f} "
        f"images/s), max_memory_allocated {peak} B, data wait "
        f"{data_s:.3f} s ({data_s / steps * 1e3:.1f} ms a step), whole run "
        f"{wall:.1f} s")
    return model, opt, rec


def training_phase(workdir):
    """The port's train entry point on the example config at full width:
    16 steps; launch counts, loss, attention gradients, EMA, step time,
    memory; then one DDIM-10 request served from the trained checkpoint."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import load_model_from_file

    ema_prev = {}

    def keep_ema(model, iters, steps):
        if iters == (steps - 1) * model.opt.train_batch_size:
            ema_prev.update({k: v.detach().clone() for k, v in
                             model.ema_nets["G_A"].state_dict().items()})

    model, opt, rec = _train(workdir, 128, TRAIN_IMAGES, TRAIN_EPOCHS,
                             keep_ema)
    rec["size"] = 128
    # qkv's gradient reaches it only through K2/K3: a non-zero second moment
    # means some step's gradient was non-zero
    tx = model.states["G_A"].tx
    nu = dict(zip(tx.names, tx.nu))
    qkv_nu = nu["inner.AttentionBlock_0.qkv.weight"].abs().max().item()
    if not qkv_nu > 0:
        raise AssertionError("no gradient reached AttentionBlock_0/qkv")
    # the last step's EMA is the lerp of the one before and the parameters
    beta = model.ema_beta
    params = model.nets["G_A"].state_dict()
    ema = model.ema_nets["G_A"].state_dict()
    lerp_err = max((ema[k] - (beta * ema_prev[k] + (1 - beta) * params[k]))
                   .abs().max().item() for k in ema)
    ema_gap = max((ema[k] - params[k]).abs().max().item() for k in ema)
    if not (lerp_err <= 1e-6 and ema_gap > 0):
        raise AssertionError(f"EMA is not the lerp: err {lerp_err}, gap "
                             f"{ema_gap}")
    rec.update({"qkv_nu_max": qkv_nu, "ema_lerp_max_err": lerp_err,
                "ema_param_max_gap": ema_gap})
    del model
    torch.cuda.empty_cache()

    # the two slices meet: serve one DDIM-10 request from the trained latest
    img = _write_inputs(workdir)
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    served, sopt = load_model_from_file(ckpt)
    args = gen.build_parser().parse_args([
        "--model_in_file", ckpt,
        "--img_in", os.path.join(workdir, "img.png"),
        "--mask_in", os.path.join(workdir, "mask.png"),
        "--dir_out", os.path.join(workdir, "out_trained"), "--name", "req",
        "--sampling_method", "ddim", "--seed", "0"])
    reset_launches()
    t0 = time.perf_counter()
    full, _, _ = gen.inference(args, lmodel=served, lopt=sopt)
    torch.cuda.synchronize()
    rec["trained_request_s"] = time.perf_counter() - t0
    rec["trained_request_launches"] = read_launches()
    if rec["trained_request_launches"]["flash_attention_fwd"] != 10 or not (
            full.shape == img.shape and np.isfinite(full).all()):
        raise AssertionError("DDIM-10 request from the trained checkpoint "
                             "failed")
    log(f"trained checkpoint: DDIM-10 request {rec['trained_request_s']:.3f}"
        f" s, launches {rec['trained_request_launches']}")
    del served
    torch.cuda.empty_cache()
    return rec


def training_256px_phase(workdir, attention_ms):
    """The same config at 256 px (mid block S = 1024), the JAX package's
    bench headline shape: one epoch of 6 steps at batch 8 over 48 synthetic
    images. ``attention_ms`` maps K1, K2 and K3 to their device ms at that
    attention shape, each launched once a step; their sum over the median
    warm step is the attention's share of the step."""
    import torch
    model, _, rec = _train(workdir, 256, TRAIN_256_IMAGES, 1)
    rec["size"] = 256
    del model
    torch.cuda.empty_cache()
    per_step = sum(attention_ms.values())
    rec.update({"attention_device_ms_per_step": attention_ms,
                "attention_share_of_step":
                    per_step / (rec["median_warm_step_s"] * 1e3)})
    log(f"training 256 px: K1-K3 device time {per_step:.4f} ms a step "
        f"({attention_ms}), {100 * rec['attention_share_of_step']:.2f} % of "
        f"the median warm step")
    return rec


def gradient_cross_check():
    """One fp32 training step of the full-width denoiser, batch 2: every
    parameter gradient on the card (K1-K3) against the CPU (plain
    versions), same weights, batch and draws, TF32 off."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.models.modules.palette_diffusion import \
        continuous_gammas
    from joligen_tpu_torch.options import TrainOptions

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(EXAMPLE) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.tpu_bf16 = False
    size = opt.data_crop_size
    rng = np.random.default_rng(SEED + 9)
    gt = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    mask = np.zeros((2, size, size, 1), np.int32)
    mask[0, 20:90, 30:100] = 1
    mask[1, 50:120, 10:60] = 1
    batch = {"A": np.where(mask > 0, 0.0, gt).astype(np.float32), "B": gt,
             "B_label_mask": mask}
    t = rng.integers(1, opt.G_diff_n_timestep_train, 2)
    u = rng.uniform(0, 1, 2).astype(np.float32)
    noise = rng.standard_normal(gt.shape).astype(np.float32)
    grads, state = {}, None
    for dev in ("cuda", "cpu"):
        model = create_model(copy.copy(opt), phase="test", device=dev)
        net = model.nets["G_A"].requires_grad_(True)
        if state is None:
            init_weights(net, torch.Generator().manual_seed(SEED + 3),
                         zero_init_std=0.01)
            state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        tt = torch.from_numpy(t).to(dev)
        draws = {"t": tt, "noise": torch.from_numpy(noise).to(dev),
                 "gammas": continuous_gammas(model.sched_train, tt,
                                             torch.from_numpy(u).to(dev))}
        reset_launches()
        loss = model._loss_fn(model.prepare_batch(batch), draws)
        names, params = zip(*net.named_parameters())
        g = torch.autograd.grad(loss, params)
        launched = read_launches()
        want = 1 if dev == "cuda" else 0
        if launched != _attention_only(launched, want):
            raise AssertionError(f"{dev} step launched {launched}")
        grads[dev] = {n: x.detach().float().cpu() for n, x in zip(names, g)}
        grads[dev + "_loss"] = loss.item()
        del model, net
    scale = max(v.abs().max().item() for v in grads["cpu"].values())
    worst_abs, worst_leaf, worst_name = 0.0, 0.0, ""
    for n, ref in grads["cpu"].items():
        diff = (grads["cuda"][n] - ref).abs().max().item()
        rel = diff / max(ref.abs().max().item(), 1e-30)
        worst_abs = max(worst_abs, diff)
        if rel > worst_leaf:
            worst_leaf, worst_name = rel, n
    rec = {"leaves": len(grads["cpu"]), "max_abs_err": worst_abs,
           "max_abs_grad": scale, "max_abs_err_over_max_grad":
           worst_abs / scale, "worst_leaf_rel_err": worst_leaf,
           "worst_leaf": worst_name, "loss_cuda": grads["cuda_loss"],
           "loss_cpu": grads["cpu_loss"],
           "tol_global": GRAD_TOL_GLOBAL, "tol_leaf": GRAD_TOL_LEAF}
    log("gradient cross-check fp32 step card vs CPU: " + json.dumps(rec))
    if not (rec["leaves"] == EXPECTED_LEAVES
            and worst_abs <= GRAD_TOL_GLOBAL * scale
            and worst_leaf <= GRAD_TOL_LEAF
            and abs(rec["loss_cuda"] - rec["loss_cpu"])
            <= 1e-4 * abs(rec["loss_cpu"])):
        raise AssertionError("card and CPU training gradients disagree")
    return rec


def _write_inputs(d):
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:256, 0:256]
    base = np.stack([xx, yy, (xx + yy) // 2], -1).astype(np.float32)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)
    mask = np.zeros((256, 256), np.uint8)
    mask[64:192, 80:176] = 255
    Image.fromarray(img).save(os.path.join(d, "img.png"))
    Image.fromarray(mask).save(os.path.join(d, "mask.png"))
    return img


def _expected_crop(img, size):
    """The uint8-quantised input crop as the model decodes it (float32)."""
    import numpy as np
    from PIL import Image
    from joligen_tpu_torch.models.base import quantize_batch
    from joligen_tpu_torch.scripts.common import to_m1p1
    crop = to_m1p1(np.asarray(Image.fromarray(img).resize(
        (size, size), Image.BICUBIC)))
    q = quantize_batch({"x": crop}, float_keys=("x",))["x"]
    return q.astype(np.float32) / np.float32(127.5) - np.float32(1.0)


def cut_test_schedule(model, opt):
    """Cut a loaded palette model's test schedule (its DDPM sampler) to
    DDPM_TEST_STEPS steps."""
    from joligen_tpu_torch.ops.schedules import NoiseSchedule
    opt.G_diff_n_timestep_test = DDPM_TEST_STEPS
    model.sched_test = NoiseSchedule.for_phase(opt, "test")


def slice_phase(workdir):
    """Serve DDIM-10 requests and a DDPM one (its test schedule cut to
    DDPM_TEST_STEPS steps) at full width through the script."""
    import numpy as np
    import torch
    from PIL import Image
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.ops import flash_attention as fa
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import load_model_from_file, \
        to_uint8

    with open(EXAMPLE) as f:
        cfg = json.load(f)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    ckpt = os.path.join(workdir, "ckpt")
    os.makedirs(ckpt)
    model = create_model(opt, phase="test")
    # random weights from the seed; the zero-initialised output layers get
    # small values too, or the attention branch would be multiplied by zero
    init_weights(model.nets["G_A"], torch.Generator().manual_seed(SEED),
                 zero_init_std=0.01)
    init_weights(model.ema_nets["G_A"],
                 torch.Generator().manual_seed(SEED + 1), zero_init_std=0.01)
    n_params = model.param_count()["G_A"]
    log(f"slice: palette unet_mha {opt.data_crop_size}px ngf {opt.G_ngf}, "
        f"{n_params} parameters, compute {model.device_dtype}")
    if n_params != EXPECTED_PARAMS:
        raise AssertionError(f"unexpected parameter count {n_params}")
    model.save_dir = ckpt
    model.save_networks("latest")
    with open(os.path.join(ckpt, "train_config.json"), "w") as f:
        json.dump(cfg, f)
    ema_state = {k: v.detach().cpu()
                 for k, v in model.ema_nets["G_A"].state_dict().items()}
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, opt = load_model_from_file(os.path.join(ckpt,
                                                   "latest_net_G_A.pth"))
    log(f"slice: checkpoint reloaded in {time.perf_counter() - t0:.3f} s")
    cut_test_schedule(model, opt)
    for k, v in model.ema_nets["G_A"].state_dict().items():
        if not torch.equal(v.cpu(), ema_state[k]):
            raise AssertionError(f"reloaded EMA differs at {k}")

    img = _write_inputs(workdir)
    size = opt.data_crop_size
    expect = _expected_crop(img, size)
    keep = np.asarray(Image.open(os.path.join(workdir, "mask.png")).convert(
        "L").resize((size, size), Image.NEAREST)) == 0

    outputs = []
    infer = model.inference

    def recording_inference(*a, **kw):
        out = infer(*a, **kw)
        outputs.append(out)
        return out
    model.inference = recording_inference

    requests = ([("ddim", i) for i in range(DDIM_REQUESTS)]
                + [("ddpm", DDIM_REQUESTS)])
    expected_launches = {"ddim": 10, "ddpm": opt.G_diff_n_timestep_test}
    report = []
    reset_launches()                             # main path starts here
    for method, seed in requests:
        out_dir = os.path.join(workdir, f"out_{method}_{seed}")
        args = gen.build_parser().parse_args([
            "--model_in_file", os.path.join(ckpt, "latest_net_G_A.pth"),
            "--img_in", os.path.join(workdir, "img.png"),
            "--mask_in", os.path.join(workdir, "mask.png"),
            "--dir_out", out_dir, "--name", "req",
            "--sampling_method", method, "--seed", str(seed)])
        torch.cuda.reset_peak_memory_stats()
        before = fa.LAUNCHES["flash_attention_fwd"]
        t0 = time.perf_counter()
        gen.inference(args, lmodel=model, lopt=opt)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        launches = fa.LAUNCHES["flash_attention_fwd"] - before
        peak = torch.cuda.max_memory_allocated()
        out = outputs[-1][0]
        crop_png = np.asarray(Image.open(os.path.join(
            out_dir, "req_generated_crop.png")))
        ok_finite = bool(np.isfinite(out).all()) and out.shape == (
            size, size, 3)
        # The card divides by 127.5 as a multiply by its fp32 reciprocal, an
        # ulp or two off numpy's division; the PNG truncates, so that ulp
        # can move a pixel by one level.
        png_diff = np.abs(crop_png[keep].astype(np.int16)
                          - to_uint8(expect)[keep].astype(np.int16))
        ok_keep = bool(np.abs(out[keep] - expect[keep]).max() <= 1e-6
                       and np.array_equal(crop_png, to_uint8(out))
                       and png_diff.max() <= 1)
        rec = {"method": method, "seed": seed, "latency_s": latency,
               "k1_launches": launches, "max_memory_allocated": peak,
               "finite": ok_finite, "outside_mask_equals_input": ok_keep}
        report.append(rec)
        log(f"request {method} seed {seed}: {latency:.3f} s, K1 launches "
            f"{launches}, max_memory_allocated {peak} B, finite {ok_finite}, "
            f"outside mask equals input {ok_keep}")
        if launches != expected_launches[method]:
            raise AssertionError(f"{method}: {launches} K1 launches, "
                                 f"expected {expected_launches[method]}")
        if not (ok_finite and ok_keep):
            raise AssertionError(f"{method} request output check failed")
    main_launches = read_launches()              # main path ends here
    if main_launches["flash_attention_bwd_dq"] or \
            main_launches["flash_attention_bwd_dkv"]:
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{main_launches}")
    log("slice: " + json.dumps({"requests": report}))
    return model, main_launches


def _card_vs_cpu(build, args, kwargs, label, k1=1, tol=CROSS_CHECK_TOL):
    """One forward of the fp32 net that ``build()`` returns (seeded or
    loaded weights, on the CPU), TF32 off: on the card (with K1, launched
    ``k1`` times) against the CPU (plain attention), on the same inputs, to
    ``tol`` (absolute). Returns (max abs error, the CPU output)."""
    import torch
    from joligen_tpu_torch.ops import flash_attention as fa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    net, outs = build(), {}
    for dev in ("cuda", "cpu"):
        net = net.to(dev).eval()
        before = fa.LAUNCHES["flash_attention_fwd"]
        with torch.inference_mode():
            outs[dev] = net(*(a.to(dev) for a in args), **{
                k: v.to(dev) for k, v in kwargs.items()}).float().cpu()
        launched = fa.LAUNCHES["flash_attention_fwd"] - before
        if launched != (k1 if dev == "cuda" else 0):
            raise AssertionError(f"{dev} forward launched K1 {launched} "
                                 "times")
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    log(f"cross-check fp32 {label} card vs CPU: max abs err {err:.3e} "
        f"(output max {scale:.3e}, tol {tol})")
    if not (torch.isfinite(outs["cuda"]).all() and err <= tol):
        raise AssertionError(f"card and CPU {label}s disagree")
    return err, outs["cpu"]


def _fp32(opt):
    import copy
    opt32 = copy.copy(opt)
    opt32.tpu_bf16 = False
    return opt32


def cross_check(opt, state, label="denoiser"):
    """A full-width palette denoiser in fp32, card against CPU
    (``_card_vs_cpu``), the weights ``state``."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import define_G

    opt32 = _fp32(opt)
    rng = np.random.default_rng(SEED + 7)
    size = opt32.data_crop_size
    x = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 6)).astype(
        np.float32))
    gam = torch.tensor([0.37], dtype=torch.float32)
    mask = torch.zeros(1, size, size, 1, dtype=torch.int32)
    mask[:, 32:96, 40:88] = 1

    def build():
        net = define_G(opt32)
        net.load_state_dict(state)
        return net
    return _card_vs_cpu(build, (x, gam), {"mask": mask}, label)[0]


def _config_opt(name, workdir, steps=None, layout=None, size=None,
                classes=None):
    """The example config ``name`` over a synthetic dataset in its layout of
    ``steps`` batches, written here (``steps`` None: the one written
    before): one epoch, the loss every step, no display inference,
    ``latest`` saved at the epoch's end only."""
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.tools import synthetic_datasets as synth

    path = os.path.join(ROOT, "examples", f"example_ddpm_{name}.json")
    with open(path) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.dataroot = os.path.join(workdir, f"data_{name}")
    if steps:
        kw = {"classes": classes} if classes else {}
        synth.WRITERS[layout](opt.dataroot, steps * opt.train_batch_size,
                              size, seed=SEED + 11, **kw)
    opt.checkpoints_dir = os.path.join(workdir, "config_ckpt")
    opt.name = f"smoke_{name}"
    opt.train_n_epochs, opt.train_n_epochs_decay = 1, 0
    opt.output_print_freq = opt.train_batch_size
    opt.output_display_freq = 0
    opt.train_save_epoch_freq = 10 ** 6
    if steps and opt.train_compute_metrics_test:
        _metric_test_split(opt, layout, size, steps)
    return opt


def _metric_test_split(opt, layout, size, steps):
    """For a config with its train-time metrics on: a test split of
    METRIC_TEST_BATCHES test batches (``layout``, ``size`` px; FID, which
    ``_offline_test`` adds, needs two images), an evaluation at the last
    step (inside the loop) as well as the final one, and the DDPM sampler's
    test schedule cut to DDPM_TEST_STEPS steps (the requests' cut)."""
    from joligen_tpu_torch.tools import synthetic_datasets as synth

    if layout != "video":                 # the video writer writes it
        synth.write_test_split(layout, opt.dataroot, METRIC_TEST_BATCHES
                               * opt.test_batch_size, size, seed=SEED + 13)
    opt.train_metrics_every = steps * opt.train_batch_size
    opt.G_diff_n_timestep_test = DDPM_TEST_STEPS


def _metric_evals_k1(opt, k1_per_call, batches=METRIC_TEST_BATCHES):
    """K1 launches of the train-time metrics of a ``_metric_test_split``
    run: two evaluations of ``batches`` test batches, DDPM_TEST_STEPS
    denoiser calls each."""
    return 2 * batches * DDPM_TEST_STEPS * k1_per_call if \
        opt.train_compute_metrics_test else 0


def _check_eval_results(opt, label, metrics_s):
    """``eval_results.json`` of a run with its train-time metrics on: the
    config's metric list, ``_test`` keys, finite values; ``metrics_s``, the
    evaluations' seconds (``model.loop_times``), goes on its line."""
    import numpy as np
    path = os.path.join(opt.checkpoints_dir, opt.name, "eval_results.json")
    with open(path) as f:
        res = json.load(f)["test"]
    names = sorted(k.split("(")[0].removesuffix("_test") for k in res)
    log(f"{label} train-time metrics (eval at step "
        f"{opt.train_metrics_every // opt.train_batch_size} and the final "
        f"one; DDPM cut to {DDPM_TEST_STEPS} steps) in {metrics_s:.2f} s: "
        f"{json.dumps(res)}")
    if names != sorted(opt.train_metrics_list) or not all(
            np.isfinite(v) for v in res.values()):
        raise AssertionError(f"{label}: eval_results.json {res}")
    return res


def _capture_set_input():
    """Patches ``PaletteModel.set_input`` to keep its first loader batch
    and output (the host batch as the model builds it); returns (list of
    (batch, output), undo)."""
    from joligen_tpu_torch.models.palette_model import PaletteModel
    seen, plain = [], PaletteModel.set_input

    def spy(self, batch):
        out = plain(self, batch)
        if not seen:
            seen.append((batch, out))
        return out
    PaletteModel.set_input = spy
    return seen, lambda: setattr(PaletteModel, "set_input", plain)


def _serve_request(ckpt, img, out_dir, extra, label):
    """One DDIM-10 request through the serving script from ``ckpt``, with
    the launch counters at 0 just before it and read just after: exactly 10
    K1 launches and no other kernel. Returns (record, full image, crop
    output, model)."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import load_model_from_file

    served, sopt = load_model_from_file(ckpt)
    outputs, infer = [], served.inference

    def recording_inference(*a, **kw):
        outputs.append(infer(*a, **kw))
        return outputs[-1]
    served.inference = recording_inference
    args = gen.build_parser().parse_args([
        "--model_in_file", ckpt, "--img_in", img, "--dir_out", out_dir,
        "--name", "req", "--sampling_method", "ddim", "--sampling_steps",
        "10", "--seed", "0", *extra])
    reset_launches()                             # the request starts here
    t0 = time.perf_counter()
    full, _, _ = gen.inference(args, lmodel=served, lopt=sopt)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches = read_launches()                   # and ends here
    want = {n: (10 if n == "flash_attention_fwd" else 0) for n in launches}
    crop = outputs[-1][0]
    size = sopt.data_crop_size
    rec = {"latency_s": latency, "launches": launches,
           "finite": bool(np.isfinite(crop).all()),
           "crop_shape": list(crop.shape)}
    log(f"{label} request: {latency:.3f} s, launches {launches}")
    if launches != want or not rec["finite"] or crop.shape != (size, size,
                                                               3):
        raise AssertionError(f"{label} request failed: {rec}")
    return rec, full, crop, served


def _check_outside_window(full, img_path, window, label):
    """The served image equals its input bit for bit outside the crop
    window [x1, y1, x2, y2]."""
    import numpy as np
    from PIL import Image
    src = np.asarray(Image.open(img_path).convert("RGB"))
    x1, y1, x2, y2 = window
    outside = np.ones(src.shape[:2], bool)
    outside[y1:y2, x1:x2] = False
    ok = (full.shape == src.shape and outside.any()
          and np.array_equal(full[outside], src[outside]))
    if not ok:
        raise AssertionError(f"{label}: the image changed outside the crop "
                             f"window {window}")
    return int(outside.sum())


def xview_phase(workdir, attention_ms):
    """xview at full width: 8 training steps, a DDIM-10 ``--bbox_in``
    request from the trained checkpoint, 2 steps under each remat policy, and
    the fp32 denoiser card against the CPU. ``attention_ms`` maps K1, K2
    and K3 to their device ms at xview's step shape, each launched once a
    step; their sum over the median warm step is attention's share."""
    import random
    import torch
    from joligen_tpu_torch.data import create_dataloader, create_dataset
    from joligen_tpu_torch.data.online_creation import crop_image
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.diffusion_networks import (define_G,
                                                             init_weights)

    opt = _config_opt("xview", workdir, XVIEW_STEPS, "online", ONLINE_SIZE,
                      (1, 2))
    model, opt, rec = _train_run(opt, XVIEW_STEPS, 1, "xview training",
                                 EXPECTED_PARAMS_XVIEW)
    del model
    torch.cuda.empty_cache()
    per_step = sum(attention_ms.values())
    rec.update({"attention_device_ms_per_step": attention_ms,
                "attention_share_of_step":
                    per_step / (rec["median_warm_step_s"] * 1e3)})
    log(f"xview training: K1-K3 device time {per_step:.4f} ms a step "
        f"({attention_ms}), {100 * rec['attention_share_of_step']:.2f} % of "
        f"the median warm step")

    # the trained checkpoint serves a --bbox_in request on a dataset image
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    img = os.path.join(opt.dataroot, "trainA", "imgs", "0000.png")
    bbox = os.path.join(opt.dataroot, "trainA", "bbox", "0000.txt")
    out_dir = os.path.join(workdir, "out_xview")
    req, full, _, served = _serve_request(
        ckpt, img, out_dir, ["--bbox_in", bbox], "xview --bbox_in")
    del served
    # the checkpoint files (3.8 GB) are not read again
    shutil.rmtree(os.path.join(opt.checkpoints_dir, opt.name))
    with open(os.path.join(out_dir, "req_orig_bbox.json")) as f:
        window = json.load(f)
    # the window of crop_image's meta, cut as the script cuts it (seed 0)
    random.seed(0)
    meta = crop_image(
        img, bbox, mask_delta=opt.data_online_creation_mask_delta_A,
        crop_delta=0, crop_center=True,
        mask_square=opt.data_online_creation_mask_square_A,
        crop_dim=opt.data_online_creation_crop_size_A,
        output_dim=opt.data_crop_size,
        context_pixels=opt.data_online_context_pixels, return_meta=True)[-1]
    want = [meta["x_crop"], meta["y_crop"], meta["x_crop"] + meta[
        "crop_size"], meta["y_crop"] + meta["crop_size"]]
    if window != want:
        raise AssertionError(f"_orig_bbox.json {window}, crop meta {want}")
    req["window"] = window
    req["pixels_outside_window_unchanged"] = _check_outside_window(
        full, img, window, "xview --bbox_in")
    rec["bbox_request"] = req
    torch.cuda.empty_cache()

    # remat: 2 steps under each policy on the same loader, peak memory
    # beside the run without it; "conv" keeps K1's outputs (one forward a
    # step), "full" recomputes the block (two)
    rec["remat"] = {}
    for policy, k1_per_step in (("conv", 1), ("full", 2)):
        ropt = _config_opt("xview", workdir)
        ropt.tpu_remat, ropt.tpu_remat_policy = True, policy
        ropt.name = f"smoke_xview_remat_{policy}"
        m = create_model(ropt, phase="train")
        if not (m.nets["G_A"].inner.remat
                and m.param_count()["G_A"] == EXPECTED_PARAMS_XVIEW):
            raise AssertionError("tpu_remat did not reach the network")
        loader = create_dataloader(ropt, create_dataset(ropt))
        batches = [b for _, b in zip(range(REMAT_STEPS), loader)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        reset_launches()                         # the remat path starts
        for b in batches:
            t0 = time.perf_counter()
            losses.append(float(m.optimize_parameters(b)["G_tot"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = read_launches()               # and ends here
        peak = torch.cuda.max_memory_allocated()
        want = {n: 0 for n in launches}
        want.update(flash_attention_fwd=k1_per_step * REMAT_STEPS,
                    flash_attention_bwd_dq=REMAT_STEPS,
                    flash_attention_bwd_dkv=REMAT_STEPS)
        # the last step is warm (the first also loads the batch and warms
        # up); the run without remat's warm steps include their data wait
        r = {"steps": REMAT_STEPS, "launches": launches, "losses": losses,
             "step_s": step_s, "max_memory_allocated": peak,
             "peak_over_no_remat": peak / rec["max_memory_allocated"],
             "warm_step_over_no_remat":
                 step_s[-1] / rec["median_warm_step_s"]}
        rec["remat"][policy] = r
        log(f"xview remat {policy}: steps {[round(t * 1e3, 1) for t in step_s]}"
            f" ms (the last {r['warm_step_over_no_remat']:.3f}x the median "
            f"warm step without remat), launches {launches}, loss {losses}, "
            f"max_memory_allocated {peak} B ({r['peak_over_no_remat']:.3f}x "
            f"the run without remat, {rec['max_memory_allocated']} B)")
        if launches != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f"remat {policy}: launches {launches}, "
                                 f"expected {want}; losses {losses}")
        del m, loader, batches
        torch.cuda.empty_cache()

    # the full-width denoiser in fp32, card against CPU, seeded weights
    net = define_G(opt)
    init_weights(net, torch.Generator().manual_seed(SEED + 5),
                 zero_init_std=0.01)
    state = {k: v.detach() for k, v in net.state_dict().items()}
    del net
    rec["cross_check_fp32_max_abs_err"] = cross_check(opt, state,
                                                      "xview denoiser")
    rec["paths"] = {"xview_training": rec["launches"],
                    "xview_bbox_request": req["launches"],
                    **{f"xview_remat_{p}": r["launches"]
                       for p, r in rec["remat"].items()}}
    return rec


def other_configs_phase(workdir):
    """mapillary, df2kost, SEN2VEN and mario: 2 training steps each and one
    request of the config's kind; the conditioning checked on the host
    batch."""
    import numpy as np
    import torch
    from joligen_tpu_torch.data import create_dataset
    from joligen_tpu_torch.data.loader import collate
    from joligen_tpu_torch.ops.cv_resize import resize_area, resize_cubic

    recs, paths = {}, {}
    for name, (layout, size, classes) in CONFIG_RUNS.items():
        opt = _config_opt(name, workdir, CONFIG_STEPS, layout, size, classes)
        seen, undo = _capture_set_input()
        try:
            model, opt, rec = _train_run(opt, CONFIG_STEPS, 1,
                                         f"{name} training",
                                         eval_k1=_metric_evals_k1(opt, 1))
        finally:
            undo()
        if opt.train_compute_metrics_test:
            rec["eval_results"] = _check_eval_results(
                opt, name, model.loop_times["metrics_s"])
        batch, host = seen[0]
        gt, cond = host["gt"], host["y_cond"]
        if name == "mapillary":
            inside = host["mask"][..., 0] > 0
            ok = (np.array_equal(cond[~inside], gt[~inside])
                  and set(np.unique(cond[inside])) <= {-1.0, 1.0}
                  and inside.any())
        elif name == "df2kost":
            factor = int(opt.alg_diffusion_super_resolution_scale)
            ok = "mask" not in host and all(
                np.array_equal(c, resize_cubic(resize_area(g, factor),
                                               g.shape[1::-1]))
                for c, g in zip(cond, gt))
        elif name == "SEN2VEN":           # pix2pix: domain A conditions
            ok = "mask" not in host and np.array_equal(cond, batch["A"])
        else:                             # mario: y_t, mask and class
            ok = (np.array_equal(cond, batch["A"]) and "mask" in host
                  and np.array_equal(host["cls"], batch["B_label_cls"]))
        rec["host_batch_conditioning_ok"] = bool(ok)
        log(f"{name}: host batch conditioning "
            f"{opt.alg_diffusion_cond_image_creation} / "
            f"{opt.alg_diffusion_task}: {'ok' if ok else 'WRONG'}")
        if not ok:
            raise AssertionError(f"{name}: wrong conditioning on the host "
                                 "batch")
        del model
        torch.cuda.empty_cache()
        paths[f"{name}_training"] = rec["launches"]

        ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                            "latest_net_G_A.pth")
        out_dir = os.path.join(workdir, f"out_{name}")
        if layout == "online":
            img = os.path.join(opt.dataroot, "trainA", "imgs", "0000.png")
            extra = ["--bbox_in", os.path.join(opt.dataroot, "trainA",
                                               "bbox", "0000.txt")]
            if name == "mapillary":
                extra += ["--alg_diffusion_sketch_canny_thresholds", "100",
                          "400"]
        else:
            img = os.path.join(opt.dataroot, "trainA", "0000.png")
            extra = (["--alg_diffusion_super_resolution_downsample"]
                     if name == "df2kost" else [])
        req, full, _, served = _serve_request(ckpt, img, out_dir, extra,
                                              name)
        if layout == "online":
            with open(os.path.join(out_dir, "req_orig_bbox.json")) as f:
                req["window"] = json.load(f)
            req["pixels_outside_window_unchanged"] = _check_outside_window(
                full, img, req["window"], name)
        rec["request"] = req
        paths[f"{name}_request"] = req["launches"]
        if name == "df2kost":
            rec["offline_test"] = _offline_test(opt)
            paths["df2kost_offline_test"] = rec["offline_test"]["launches"]
        if name == "mario":
            # one DDIM-10 output per class on two dataset items
            ds = create_dataset(served.opt)
            batch = collate([ds[i] for i in range(2)])
            reset_launches()
            outs = served.inference_per_class(batch, sampling_method="ddim",
                                              num_steps=10)
            torch.cuda.synchronize()
            launches = read_launches()
            classes = list(range(1, served.null_class + 1))
            want = {n: (10 * len(classes) if n == "flash_attention_fwd"
                        else 0) for n in launches}
            ok = (sorted(outs) == classes and launches == want and all(
                o.shape == (2, opt.data_crop_size, opt.data_crop_size, 3)
                and np.isfinite(o).all() for o in outs.values()))
            rec["per_class"] = {"classes": sorted(outs),
                                "launches": launches}
            log(f"mario inference_per_class: classes {sorted(outs)}, "
                f"launches {launches}")
            if not ok:
                raise AssertionError("mario inference_per_class failed")
            paths["mario_per_class"] = launches
        del served
        torch.cuda.empty_cache()
        recs[name] = rec
    return recs, paths


def _offline_test(opt):
    """``python -m joligen_tpu_torch.test`` (in process, on the card) on a
    trained run's directory: FID, PSNR, SSIM and LPIPS over its test split
    at DDIM-10, ``metrics/<timestamp>.json`` written; the launch counters
    read around it."""
    import numpy as np
    import torch
    from joligen_tpu_torch import test as ttest

    run_dir = os.path.join(opt.checkpoints_dir, opt.name)
    n_test = len(os.listdir(os.path.join(opt.dataroot, "testA")))
    reset_launches()
    t0 = time.perf_counter()
    out = ttest.main(["--test_model_dir", run_dir, "--test_metrics_list",
                      "FID", "PSNR", "SSIM", "LPIPS", "--sampling_method",
                      "ddim", "--sampling_steps", "10"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    files = os.listdir(os.path.join(run_dir, "metrics"))
    want = _attention_only(launches, {"flash_attention_fwd": 10 * n_test})
    ok = (len(files) == 1 and launches == want and len(out["test"]) == 4
          and all(np.isfinite(v) for v in out["test"].values()))
    log(f"offline test.py on {opt.name}: {json.dumps(out)} in {wall:.1f} s, "
        f"launches {launches}")
    if not ok:
        raise AssertionError(f"offline test.py: {out}, {files}, {launches}")
    return {"metrics": out["test"], "wall_s": wall, "launches": launches}


def _example_opt(example, workdir, name, args=()):
    """An example config with the command-line overrides ``args`` (as the
    train CLI reads them): one epoch, the loss every step, no display
    inference, ``latest`` saved at the epoch's end only; its dataset is
    ``workdir/data_<name>``, written by the caller."""
    from joligen_tpu_torch.options import TrainOptions

    opt = TrainOptions().parse_cli([
        "--config_json", os.path.join(ROOT, "examples", example), *args])
    opt.dataroot = os.path.join(workdir, f"data_{name}")
    opt.checkpoints_dir = os.path.join(workdir, f"{name}_ckpt")
    opt.name = f"smoke_{name}"
    opt.train_n_epochs, opt.train_n_epochs_decay = 1, 0
    opt.output_print_freq = opt.train_batch_size
    opt.output_display_freq = 0
    opt.train_save_epoch_freq = 10 ** 6
    return opt


def _cut_opt(example, workdir, n_images, size, name):
    """A GAN example config over a synthetic unaligned dataset of
    ``n_images`` a domain, ``size`` px, written here (``_example_opt``)."""
    from joligen_tpu_torch.tools.synthetic_datasets import write_unaligned

    opt = _example_opt(example, workdir, name)
    write_unaligned(opt.dataroot, n_images, size, seed=SEED + 11)
    return opt


def _serve_gan(ckpt, img, out_dir, n):
    """``n`` requests through ``scripts/gen_single_image.inference`` from
    one load of ``ckpt``, launch counters at 0 just before them and read
    just after. Each output is finite and of the input's size."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_single_image as gen
    from joligen_tpu_torch.scripts.common import (load_image_rgb,
                                                  load_model_from_file)

    served, sopt = load_model_from_file(ckpt)
    src = load_image_rgb(img)
    reset_launches()
    secs = []
    for i in range(n):
        args = gen.parser().parse_args([
            "--model_in_file", ckpt, "--img_in", img,
            "--img_out", os.path.join(out_dir, f"req{i}.png")])
        t0 = time.perf_counter()
        out = gen.inference(args, served, sopt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if out.shape != src.shape or not np.isfinite(out).all():
            raise AssertionError(f"request {i}: output {out.shape}, input "
                                 f"{src.shape}")
    launches = read_launches()
    del served
    torch.cuda.empty_cache()
    return {"request_s": secs, "launches": launches}


def cut_phase(workdir):
    """horse2zebra (``example_gan_horse2zebra.json``) at full width: CUT_STEPS
    steps over a synthetic unaligned dataset (batch 4, 256 px crops of 286
    px loads, bf16, resnet_attn G, projected and basic Ds, MoNCE,
    DiffAugment color,cutout), then CUT_REQUESTS requests from the trained
    checkpoint; then mnist2USPS (``example_gan_mnist2USPS.json``, 1 channel,
    28 px, batch 16), 2 steps and one request. No kernel of the port runs
    on these paths."""
    import torch

    recs, paths = {}, {}
    for name, example, n_images, size, steps, n_req in (
            ("horse2zebra", "example_gan_horse2zebra.json",
             CUT_STEPS * 4, 300, CUT_STEPS, CUT_REQUESTS),
            ("mnist2USPS", "example_gan_mnist2USPS.json", 32, 32, 2, 1)):
        opt = _cut_opt(example, workdir, n_images, size, name)
        model, opt, rec = _train_run(opt, steps, 1, f"{name} training",
                                     attention_per_step=0)
        rec["parameters_per_net"] = model.param_count()
        log(f"{name}: parameters per net {rec['parameters_per_net']}")
        if name == "horse2zebra":
            want = {"G_A", "F", "D_B_projected_d", "D_B_basic"}
            if (set(rec["parameters_per_net"]) != want
                    or opt.data_crop_size != 256 or opt.G_ngf != 64
                    or opt.G_nblocks != 9 or opt.D_ndf != 64
                    or opt.train_batch_size != 4):
                raise AssertionError("horse2zebra is not at full width")
        del model
        torch.cuda.empty_cache()
        paths[f"{name}_training"] = rec["launches"]
        ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                            "latest_net_G_A.pth")
        out_dir = os.path.join(workdir, f"out_{name}")
        os.makedirs(out_dir)
        req = _serve_gan(ckpt, os.path.join(opt.dataroot, "trainA",
                                            "0000.png"), out_dir, n_req)
        log(f"{name}: {n_req} requests from the trained checkpoint, "
            f"{[round(s, 4) for s in req['request_s']]} s, launches "
            f"{req['launches']}")
        rec["requests"] = req
        paths[f"{name}_requests"] = req["launches"]
        recs[name] = rec
    return recs, paths


def _float64(model):
    """A port model's nets in float64 (parameters and compute dtype), for an
    exact-arithmetic reference on the CPU."""
    import torch
    for net in model.nets.values():
        net.double()
        for mod in net.modules():
            if getattr(mod, "dtype", None) == torch.float32:
                mod.dtype = torch.float64


def cut_cross_check():
    """horse2zebra at full width in fp32, TF32 off: one G forward (batch 1,
    256 px) and one G loss (both Ds and MoNCE on the same draws, batch 1)
    with every G gradient, the card against the CPU on the same weights.
    fp32 itself leaves gradient errors of a few 1e-3 of the largest
    gradient here, so both are also held against the same loss in float64
    on the CPU: the card must be as close to it as the CPU's fp32 is."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.ops.diff_aug import draw_diff_augment
    from joligen_tpu_torch.options import TrainOptions

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(os.path.join(ROOT, "examples",
                           "example_gan_horse2zebra.json")) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.tpu_bf16 = False
    opt.checkpoints_dir = tempfile.mkdtemp(prefix="cut_xcheck_")
    size = opt.data_crop_size
    rng = np.random.default_rng(SEED + 13)
    real_A, real_B = (torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3))
                                       .astype(np.float32)) for _ in range(2))
    g = torch.Generator().manual_seed(SEED + 14)
    # the NCE taps 0, 4, 8, 12, 16: the input, then res1, res5, res8 twice
    hw = [size * size] + [(size // 4) ** 2] * 4
    draws = {"g_aug": draw_diff_augment(g, (1, 3, size, size),
                                        opt.dataaug_diff_aug_policy,
                                        opt.dataaug_diff_aug_proba),
             "nce": [torch.randperm(n, generator=g)[:256] for n in hw],
             "nce_idt": [torch.randperm(n, generator=g)[:256] for n in hw]}

    def moved(dev, dtype):
        def cast(t):
            return t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
        return {k: ([cast(t) for t in v] if isinstance(v, list) else
                    {kk: cast(vv) for kk, vv in v.items()})
                for k, v in draws.items()}

    res, state = {}, None
    for run, dev, dtype in (("cuda", "cuda", torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_fp64", "cpu", torch.float64)):
        model = create_model(copy.copy(opt), phase="train", device=dev)
        if state is None:
            state = {n: {k: v.detach().cpu() for k, v in
                         net.state_dict().items()}
                     for n, net in model.nets.items()}
        for n, net in model.nets.items():
            net.load_state_dict(state[n])
        if dtype == torch.float64:
            _float64(model)
        a, b = real_A.to(dev, dtype), real_B.to(dev, dtype)
        with torch.inference_mode():
            fwd = model.nets["G_A"](a).double().cpu()
        total, losses, _ = model._g_loss(a, b, moved(dev, dtype))
        names = [n for n, _ in model.nets["G_A"].named_parameters()]
        grads = torch.autograd.grad(total, model.states["G_A"].params)
        res[run] = {"fwd": fwd,
                    "loss": {k: float(v.detach()) for k, v in losses.items()},
                    "grads": {n: x.detach().double().cpu()
                              for n, x in zip(names, grads)}}
        del model

    def grad_err(x, y):
        return max((res[x]["grads"][n] - v).abs().max().item()
                   for n, v in res[y]["grads"].items())

    fwd_err = (res["cuda"]["fwd"] - res["cpu"]["fwd"]).abs().max().item()
    scale = max(v.abs().max().item()
                for v in res["cpu_fp64"]["grads"].values())
    loss_err = max(abs(res["cuda"]["loss"][k] - v) / max(1.0, abs(v))
                   for k, v in res["cpu"]["loss"].items())
    rec = {"forward_max_abs_err": fwd_err, "losses_cuda": res["cuda"]["loss"],
           "losses_cpu": res["cpu"]["loss"], "loss_max_rel_err": loss_err,
           "leaves": len(res["cpu"]["grads"]), "max_abs_grad": scale,
           "grad_err_card_vs_cpu": grad_err("cuda", "cpu") / scale,
           "grad_err_card_vs_fp64": grad_err("cuda", "cpu_fp64") / scale,
           "grad_err_cpu_vs_fp64": grad_err("cpu", "cpu_fp64") / scale,
           "tol_forward": CROSS_CHECK_TOL, "tol_loss": CUT_LOSS_TOL}
    log("horse2zebra fp32 card vs CPU (gradient errors over the largest "
        "gradient): " + json.dumps(rec))
    if not (fwd_err <= CROSS_CHECK_TOL and loss_err <= CUT_LOSS_TOL
            and rec["grad_err_card_vs_fp64"]
            <= 2 * rec["grad_err_cpu_vs_fp64"] + GRAD_TOL_GLOBAL
            and all(np.isfinite(v) for v in rec["losses_cuda"].values())):
        raise AssertionError("card and CPU horse2zebra disagree")
    return rec


def _shm_workdir(workdir, prefix):
    """A directory under ``/dev/shm`` where the machine has it (in RAM: its
    files add nothing to the disk's writes), else under ``workdir``."""
    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        return tempfile.mkdtemp(prefix=f"chip_smoke_{prefix}_",
                                dir="/dev/shm")
    return tempfile.mkdtemp(prefix=f"{prefix}_", dir=workdir)


def _profiled_step(model, opt, batch=None):
    """One warm step of ``model`` on a synthetic batch (or ``batch``) timed
    by the host clock, and another traced (``torch.profiler``): latency,
    device launches, busy time (the union of the kernels' intervals) and
    the idle share of the latency, as ``scripts/profile_request.py`` reads
    them."""
    import torch
    from joligen_tpu_torch.scripts.profile_request import (busy_us,
                                                           synthetic_batch)
    if batch is None:
        batch = synthetic_batch(opt.data_crop_size, SEED + 80,
                                opt.train_batch_size)

    def step():
        model.optimize_parameters(batch)
        torch.cuda.synchronize()
    step()
    t0 = time.perf_counter()
    step()
    latency_us = (time.perf_counter() - t0) * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    # the trace's raw events (ns): building the profiler's FunctionEvents
    # from a GAN step's ~10^5 events takes ~20 s of host time
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    kernels = [(e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events]
    busy = busy_us(kernels)
    # K1-K3's own time (the port's attention kernels' names hold flash_)
    flash = sum((e.end_ns() - e.start_ns()) / 1e3 for e in events
                if "flash_" in e.name())
    rec = {"latency_ms": latency_us / 1e3, "device_launches": len(kernels),
           "device_busy_ms": busy / 1e3, "flash_kernels_ms": flash / 1e3,
           "device_idle_share": (max(0.0, 1.0 - busy / latency_us)
                                 if kernels else None)}
    return rec


def cyclegan_phase(workdir, unet=False):
    """CycleGAN over horse2zebra at full width (see GAN_EXAMPLE): with the
    config's resnet_attn Gs, CYCLEGAN_STEPS steps and CYCLEGAN_REQUESTS
    requests, no kernel; with ``unet``, ``--G_netG unet_256``,
    CYCLEGAN_UNET_STEPS steps with K1, K2 and K3 CYCLEGAN_UNET_PER_STEP
    times each a step, and CYCLEGAN_UNET_REQUESTS requests of one K1. Each
    with the nets' parameter counts, finite losses, the warm step time,
    images/s, peak memory, data wait, a profiled step's launches and idle
    share, and the requests through ``scripts/gen_single_image`` from G_A's
    checkpoint. Returns (records, launch counts per path)."""
    import torch
    from joligen_tpu_torch.tools.synthetic_datasets import write_unaligned

    name = "cyclegan_h2z_unet256" if unet else "cyclegan_h2z"
    steps = CYCLEGAN_UNET_STEPS if unet else CYCLEGAN_STEPS
    n_req = CYCLEGAN_UNET_REQUESTS if unet else CYCLEGAN_REQUESTS
    per = CYCLEGAN_UNET_PER_STEP if unet else 0
    workdir = _shm_workdir(workdir, name)
    try:
        opt = _example_opt(GAN_EXAMPLE, workdir, name, [
            "--model_type", "cycle_gan",
            *(["--G_netG", "unet_256"] if unet else [])])
        write_unaligned(opt.dataroot, steps * opt.train_batch_size, 300,
                        seed=SEED + 81)
        model, opt, rec = _train_run(
            opt, steps, 1, f"{name} training",
            EXPECTED_PARAMS_UNET256 if unet else
            EXPECTED_PARAMS_CYCLEGAN["G_A"], attention_per_step=per)
        counts = model.param_count()
        want = dict(EXPECTED_PARAMS_CYCLEGAN)
        if unet:
            want["G_A"] = want["G_B"] = EXPECTED_PARAMS_UNET256
            mid = model.nets["G_A"].AttentionBlock_0
            if mid.heads != GAN_SHAPE[2]:
                raise AssertionError(f"{name}: {mid.heads} heads")
        if (counts != want or opt.train_batch_size != GAN_SHAPE[0]
                or opt.data_crop_size != 256 or opt.G_ngf != 64
                or opt.D_ndf != 64):
            raise AssertionError(f"{name} is not at full width: {counts}")
        rec["parameters_per_net"] = counts
        rec["profiled_step"] = _profiled_step(model, opt)
        log(f"{name}: parameters {counts}; a profiled step "
            + json.dumps(rec["profiled_step"]))
        del model
        torch.cuda.empty_cache()
        ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                            "latest_net_G_A.pth")
        out_dir = os.path.join(workdir, f"out_{name}")
        os.makedirs(out_dir)
        req = _serve_gan(ckpt, os.path.join(opt.dataroot, "trainA",
                                            "0000.png"), out_dir, n_req)
        if req["launches"] != _attention_only(
                req["launches"], {"flash_attention_fwd": n_req * bool(unet)}):
            raise AssertionError(f"{name} requests launched "
                                 f"{req['launches']}")
        log(f"{name}: {n_req} requests from G_A's checkpoint, "
            f"{[round(t, 4) for t in req['request_s']]} s, launches "
            f"{req['launches']}")
        rec["requests"] = req
        return {name: rec}, {f"{name}_training": rec["launches"],
                             f"{name}_requests": req["launches"]}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _sem_opt(workdir, name, args, n_images, cls=True):
    """noglasses2glasses with ``args`` (``_example_opt``) over a synthetic
    dataset of ``n_images`` a domain at SEM_SIZE px written here: the
    ``unaligned_labeled_mask_cls`` layout, or without ``cls`` the config's
    ``unaligned_labeled_mask``."""
    from joligen_tpu_torch.tools import synthetic_datasets as synth

    opt = _example_opt(SEM_EXAMPLE, workdir, name, args)
    write = (synth.write_unaligned_labeled_mask_cls if cls
             else synth.write_unaligned_labeled)
    write(opt.dataroot, n_images, SEM_SIZE, seed=SEED + 101)
    return opt


def _sem_batch(size, seed, batch):
    """A host batch of the cls layout: images, rectangle label masks and
    class labels of both domains."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {k: rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
           for k in "AB"}
    for k in ("A_label_mask", "B_label_mask"):
        m = np.zeros((batch, size, size, 1), np.int32)
        m[:, size // 4:size // 2, size // 3:2 * size // 3] = 1
        out[k] = m
    for k in ("A_label_cls", "B_label_cls"):
        out[k] = rng.integers(0, 2, batch).astype(np.int32)
    return out


def _g_gradients(model, batch):
    """What C and the mask D give G's gradient on ``batch``, cuDNN in its
    deterministic mode: the norm of the gradient of C's term G_sem_cls
    alone (relative to the norm of G_sem_mask's), and the distance between
    G_sem_mask's gradients with its target as a mask D makes it (f_s's own
    prediction on A) and as it is without one (A's label mask), beside
    the former's distance from itself run again (the card's noise), both
    relative to its norm."""
    import torch
    from joligen_tpu_torch.models.base import dequantize

    dev = model.prepare_batch(batch)
    real_A, real_B = (dequantize(dev[k], "image") for k in ("real_A",
                                                            "real_B"))
    mask_A = dequantize(dev["mask_A"], "label")
    netG = model.nets["G_A"]
    params = list(netG.parameters())
    one = torch.ones((), device=model.device)

    def grad(term):
        loss = term(netG(real_A))
        return torch.cat([g.float().flatten() for g in
                          torch.autograd.grad(loss, params)])

    def sem_mask(mask_d):
        def term(fake):
            keep = model.has_mask_d
            model.has_mask_d = mask_d
            try:
                return model._semantic_terms(real_A, real_B, fake, None,
                                             mask_A, None, one)["G_sem_mask"]
            finally:
                model.has_mask_d = keep
        return term

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        cls = grad(lambda fake: model._cls_crit(model.nets["CLS"](fake),
                                                dev["cls_A"]))
        with_d, again = grad(sem_mask(True)), grad(sem_mask(True))
        without_d = grad(sem_mask(False))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    norm = with_d.norm().item()
    return {"cls_term": cls.norm().item() / norm,
            "mask_d_target": (with_d - without_d).norm().item() / norm,
            "again": (with_d - again).norm().item() / norm,
            "sem_mask_norm": norm}


def semantic_phase(workdir):
    """The semantic networks at full width (see SEM_EXAMPLE):
    glasses_cls_maskd and glasses_resnet_vgg SEM_STEPS steps each, the
    segmentation model with the unet and the vgg f_s; each with the nets'
    parameter counts, finite losses, the warm step time, images/s, peak
    memory, data wait and a profiled step's launches and idle share (no
    kernel of the port runs here). glasses_cls_maskd: CLS, D_B_mask's loss
    and G_sem_cls finite, G_sem_cls > 0 on a step (one more with C's gate
    opened, SEM_OPEN_THRESHOLD, where none had it), a non-zero gradient of
    C's term in G, G_sem_mask's gradient in G moved by the mask D's target
    rule beyond the card's own noise, a request from G_A's checkpoint.
    The segmentation runs: ``compute_miou`` in [0, 1], ``inference`` a (B,
    SEM_SIZE, SEM_SIZE, 1) int32 label map. Returns (records, launch
    counts per path)."""
    import numpy as np
    import torch

    recs, paths = {}, {}
    runs = (
        ("glasses_cls_maskd",
         ["--data_dataset_mode", "unaligned_labeled_mask_cls",
          "--train_semantic_cls", "--cls_semantic_nclasses", "2",
          "--D_netDs", "projected_d", "basic", "vision_aided", "mask"],
         SEM_STEPS, EXPECTED_PARAMS_SEM, {"CLS", "D_D_B_mask", "G_sem_cls"}),
        ("glasses_resnet_vgg",
         ["--data_dataset_mode", "unaligned_labeled_mask_cls",
          "--train_semantic_cls", "--train_sem_cls_template", "resnet50",
          "--f_s_net", "vgg", "--D_netDs", "projected_d", "basic",
          "resnet18"],
         SEM_STEPS, EXPECTED_PARAMS_SEM_VGG,
         {"CLS", "D_D_B_resnet18", "G_sem_cls", "f_s"}),
        ("segmentation_unet", ["--model_type", "segmentation"],
         SEG_UNET_STEPS, {"f_s": EXPECTED_PARAMS_GLASSES["f_s"]}, {"f_s"}),
        ("segmentation_vgg", ["--model_type", "segmentation", "--f_s_net",
                              "vgg"],
         SEG_VGG_STEPS, {"f_s": EXPECTED_PARAMS_SEM_VGG["f_s"]}, {"f_s"}))
    for name, args, steps, want, keys in runs:
        wd = _shm_workdir(workdir, name)
        t0 = time.perf_counter()
        seg = name.startswith("segmentation")
        sem_cls = []
        try:
            opt = _sem_opt(wd, name, args, 2 * steps, cls=not seg)
            model, opt, rec = _train_run(
                opt, steps, 1, f"{name} training",
                want["f_s"] if seg else EXPECTED_PARAMS_GLASSES_G,
                hook=None if seg else (lambda m, i, n: sem_cls.append(
                    float(m.loss_log["G_sem_cls"]))),
                attention_per_step=0, main_net="f_s" if seg else "G_A",
                main_loss="f_s" if seg else "G_tot")
            counts = model.param_count()
            if ({k: counts.get(k) for k in want} != want
                    or opt.data_crop_size != SEM_SIZE
                    or opt.train_batch_size != 2
                    or (not seg and (opt.G_ngf != 64 or opt.D_ndf != 64))):
                raise AssertionError(f"{name} is not at full width: "
                                     f"{counts}")
            if not keys <= set(rec["losses_last"]):
                raise AssertionError(f"{name}: losses {rec['losses_last']}")
            rec["parameters_per_net"] = counts
            batch = _sem_batch(SEM_SIZE, SEED + 102, 2)
            if name == "glasses_resnet_vgg":
                dtypes = {model.nets["CLS"].dtype,
                          model.nets["D_B_resnet18"].dtype}
                if dtypes != {torch.float32} or \
                        model.nets["f_s"].dtype != torch.bfloat16:
                    raise AssertionError(f"{name}: templates in {dtypes}")
            if name == "glasses_cls_maskd":
                rec["G_sem_cls_per_step"] = sem_cls
                if not any(v > 0 for v in sem_cls):
                    model.cls_threshold = SEM_OPEN_THRESHOLD
                    model.optimize_parameters(batch)
                    rec["G_sem_cls_gate_opened"] = float(
                        model.loss_log["G_sem_cls"])
                    sem_cls.append(rec["G_sem_cls_gate_opened"])
                rec["g_gradient"] = _g_gradients(model, batch)
                g = rec["g_gradient"]
                log(f"{name}: G_sem_cls {sem_cls}; G's gradient "
                    + json.dumps(g))
                if not (max(sem_cls) > 0 and g["sem_mask_norm"] > 0
                        and 0 < g["cls_term"] < float("inf")
                        and g["mask_d_target"] > 10 * g["again"]):
                    raise AssertionError(f"{name}: C and the mask D do not "
                                         "reach G")
            rec["profiled_step"] = _profiled_step(model, opt, batch)
            if seg:
                miou = model.compute_miou(batch)
                pred = model.inference(batch)
                rec["miou"] = miou
                if not (isinstance(miou, float) and 0.0 <= miou <= 1.0
                        and pred.shape == (2, SEM_SIZE, SEM_SIZE, 1)
                        and pred.dtype == np.int32):
                    raise AssertionError(f"{name}: mIoU {miou}, inference "
                                         f"{pred.shape} {pred.dtype}")
            log(f"{name}: parameters {counts}; a profiled step "
                + json.dumps(rec["profiled_step"]))
            del model
            torch.cuda.empty_cache()
            paths[f"{name}_training"] = rec["launches"]
            if name == "glasses_cls_maskd":
                out_dir = os.path.join(wd, f"out_{name}")
                os.makedirs(out_dir)
                req = _serve_gan(
                    os.path.join(opt.checkpoints_dir, opt.name,
                                 "latest_net_G_A.pth"),
                    os.path.join(opt.dataroot, "trainA", "imgs", "0000.png"),
                    out_dir, 1)
                if req["launches"] != _attention_only(req["launches"], 0):
                    raise AssertionError(f"{name} request launched "
                                         f"{req['launches']}")
                rec["requests"] = req
                paths[f"{name}_requests"] = req["launches"]
            rec["phase_s"] = time.perf_counter() - t0
            prof = rec["profiled_step"]
            log(f"{name}: step {rec['median_warm_step_s'] * 1e3:.1f} ms, "
                f"{rec['images_per_s']:.2f} images/s, peak "
                f"{rec['max_memory_allocated'] / 1e9:.2f} GB, launches "
                f"{rec['launches']}, idle share "
                f"{prof['device_idle_share']}, {rec['phase_s']:.1f} s in all")
            recs[name] = rec
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    return recs, paths


def semantic_cross_check():
    """The card against the CPU: a CUT step with the basic C and one with
    the resnet18 C, the mask D in both (noglasses2glasses at
    SEM_CHECK_SIZE px, widths SEM_CHECK_WIDTH, Ds basic and mask), bf16 on
    the card and fp32 on the CPU from the same weights on the same batch
    and draws (patch ids, the pool, the gumbel noise), C's and f_s's gates
    opened (SEM_OPEN_THRESHOLD): every loss within
    SEM_STEP_TOL (relative, at least 1); then VGG16-FCN8s in fp32 (TF32
    off) at SEM_CHECK_SIZE px under both pads, its skips drawn non-zero,
    to VGG_CHECK_TOL of the largest logit. Returns its record."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.modules import semantic_networks as sem
    from joligen_tpu_torch.models.modules.cut_networks import \
        sample_patch_ids

    rec = {}
    size, width = SEM_CHECK_SIZE, SEM_CHECK_WIDTH
    ckpt = tempfile.mkdtemp(prefix="sem_step_")
    try:
        for template in ("basic", "resnet18"):
            base = _example_opt(SEM_EXAMPLE, ckpt, f"sem_{template}", [
                "--data_dataset_mode", "unaligned_labeled_mask_cls",
                "--train_semantic_cls", "--train_sem_cls_template", template,
                "--D_netDs", "basic", "mask"])
            models = {}
            for dev, bf16 in (("cpu", False), ("cuda", True)):
                o = copy.copy(base)
                o.tpu_bf16 = bf16
                o.data_crop_size = o.data_load_size = size
                o.G_ngf = o.D_ndf = o.f_s_nf = o.cls_nf = width
                # both gates open: C's and f_s's terms count
                o.cls_semantic_threshold = SEM_OPEN_THRESHOLD
                o.f_s_semantic_threshold = SEM_OPEN_THRESHOLD
                models[dev] = create_model(o, phase="train",
                                           device=torch.device(dev))
            m = models["cpu"]
            if template == "resnet18" and m.param_count()["CLS"] != \
                    EXPECTED_PARAMS_RESNET18_C:
                raise AssertionError(f"resnet18 C: {m.param_count()}")
            for name, net in m.nets.items():
                models["cuda"].nets[name].load_state_dict(net.state_dict())
            g = torch.Generator().manual_seed(SEED + 103)
            batch = _sem_batch(size, SEED + 104, base.train_batch_size)
            n = base.train_batch_size
            with torch.no_grad():
                feats = m.nets["G_A"](torch.zeros(1, size, size, 3),
                                      extract_layer_ids=m.nce_layers)
            draws = {"nce": sample_patch_ids(g, feats, m.num_patches),
                     "nce_idt": sample_patch_ids(g, feats, m.num_patches),
                     "pool": m.pool.draw_query(g, n),
                     "gumbel": {"D_B_mask": torch.rand(
                         (n, size, size, m.nclasses_fs), generator=g)
                         * (1.0 - 2e-6) + 1e-6}}

            def moved(d, dev):
                if isinstance(d, dict):
                    return {k: moved(v, dev) for k, v in d.items()}
                if isinstance(d, list):
                    return [moved(v, dev) for v in d]
                return d.to(dev) if torch.is_tensor(d) else d
            losses = {}
            for dev, model in models.items():
                out = model.optimize_prepared(model.prepare_batch(batch),
                                              moved(draws, dev))
                losses[dev] = {k: float(v) for k, v in out.items()}
            err = max(abs(losses["cuda"][k] - v) / max(1.0, abs(v))
                      for k, v in losses["cpu"].items())
            rec[f"cut_step_{template}_c"] = {
                "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
                "loss_max_rel_err": err, "tol": SEM_STEP_TOL}
            log(f"semantic CUT step ({template} C, mask D) bf16 card vs "
                "fp32 CPU: " + json.dumps(rec[f"cut_step_{template}_c"]))
            if not ({"CLS", "G_sem_cls", "D_D_B_mask"} <= set(losses["cpu"])
                    and err <= SEM_STEP_TOL and all(
                        np.isfinite(v) for v in losses["cuda"].values())):
                raise AssertionError(f"card and CPU CUT steps ({template} "
                                     "C) disagree")
            del models, m
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator().manual_seed(SEED + 105)
        x = torch.rand((1, size, size, 3), generator=gen) * 2 - 1
        weights = sem.init_segmenter(sem.VGG16FCN8s(3, 2), gen).state_dict()
        for name in sem.VGG16FCN8s.ZERO_INIT:
            for leaf in ("weight", "bias"):
                weights[f"{name}.{leaf}"].normal_(0.0, SEM_SKIP_STD,
                                                  generator=gen)
        for pad in ("fcn", "same"):        # both pads share one tree
            net = sem.VGG16FCN8s(3, 2, pad=pad)
            net.load_state_dict(weights)
            outs = {}
            for dev in ("cuda", "cpu"):
                with torch.inference_mode():
                    outs[dev] = net.to(dev)(x.to(dev)).float().cpu()
            err = (outs["cuda"] - outs["cpu"]).abs().max().item()
            scale = outs["cpu"].abs().max().item()
            rec[f"vgg_{pad}"] = {"max_abs_err": err, "max_abs_logit": scale,
                                 "tol": VGG_CHECK_TOL}
            log(f"cross-check fp32 VGG16-FCN8s ({pad}) card vs CPU: max abs "
                f"err {err:.3e} (logit max {scale:.3e})")
            if not (outs["cuda"].shape == (1, size, size, 2)
                    and torch.isfinite(outs["cuda"]).all()
                    and err <= VGG_CHECK_TOL * scale):
                raise AssertionError(f"card and CPU VGG16-FCN8s ({pad}) "
                                     "disagree")
            del net
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return rec


def _re_opt(example, workdir, name, args, n_images, size):
    """An example config with ``args`` over a synthetic
    ``unaligned_labeled_mask`` dataset (the nuplet mode reads its layout)
    of ``n_images`` a domain, ``size`` px (``_example_opt``)."""
    from joligen_tpu_torch.tools.synthetic_datasets import \
        write_unaligned_labeled

    opt = _example_opt(example, workdir, name, [
        "--data_dataset_mode", "nuplet_unaligned_labeled_mask",
        "--data_relative_paths", *args])
    write_unaligned_labeled(opt.dataroot, n_images, size, seed=SEED + 90)
    return opt


def _nuplets(size, seed, batch):
    """Synthetic nuplets of RE_NUPLET frames (``synthetic_batch``), the
    label mask given to both domains."""
    from joligen_tpu_torch.scripts.profile_request import synthetic_batch
    clip = synthetic_batch(size, seed, batch, frames=RE_NUPLET)
    clip["A_label_mask"] = clip["B_label_mask"]
    return clip


def re_step_check(opt):
    """One ReCycleGAN step in bf16 on the card against fp32 on the CPU from
    the same state and the same draws (pools, DiffAugment): the CPU model's
    init at G_ngf and D_ndf RE_STEP_WIDTH with its P nets redrawn from the
    seed, their zero-initialised layers (``proj_out`` among them) at
    N(0, RE_STEP_ZERO_STD), so that attention adds to P's outputs and K2
    and K3 get a non-zero dO; batch 1 nuplet, RE_STEP_SIZE px, the gate
    opened (RE_OPEN_THRESHOLD) so that the recycle terms count. First P_A's
    loss gradient at its middle block's qkv weight, which reaches it only
    through K2/K3: on the card no further from the CPU's fp32 gradient than
    twice the same bf16 pass through the attention's plain version is, plus
    RE_STEP_TOL (of the norm: bf16 through the whole unet moves it by 10-15
    %, and the two bf16 passes differ by about as much); and the
    block alone, on the input and output gradient that the card's pass gave
    it, within RE_STEP_TOL of its plain version; then the step: K1-K3
    RE_PER_STEP times on the card, every loss within RE_STEP_TOL
    (relative, at least 1). Returns its record."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models import create_model
    from joligen_tpu_torch.models.cut_model import channel_stack
    from joligen_tpu_torch.models.diffusion_networks import init_weights
    from joligen_tpu_torch.models.modules import unet_mha
    from joligen_tpu_torch.ops.diff_aug import draw_diff_augment
    from joligen_tpu_torch.ops.flash_attention import \
        flash_attention_reference

    @contextlib.contextmanager
    def attention(plain):
        """The unet's attention through K1-K3, or with ``plain`` through
        their plain version."""
        kernel = unet_mha.flash_attention
        if plain:
            unet_mha.flash_attention = (
                lambda q, k, v: flash_attention_reference(q, k, v)[0])
        try:
            yield
        finally:
            unet_mha.flash_attention = kernel

    def p_grad(model, prepared, plain=False):
        """P_A's loss gradient at its middle block's qkv weight, and the
        block's input and output gradient on the way."""
        blk, seen = model.nets["P_A"].AttentionBlock_0, {}

        def keep(mod, args, out):
            seen["x"] = args[0].detach()
            out.register_hook(lambda g: seen.update(dy=g.detach()))
        handle = blk.register_forward_hook(keep)
        try:
            with attention(plain):
                loss = torch.mean(torch.abs(
                    model.nets["P_A"](channel_stack(prepared["real_A_seq"]))
                    - prepared["real_A_last"]))
                grad = torch.autograd.grad(loss, blk.qkv.weight)[0]
        finally:
            handle.remove()
        return grad.double().cpu(), seen

    def block_grad(blk, seen, plain):
        """The block's qkv gradient on the input and output gradient that
        P_A's own pass gave it (``seen``)."""
        with attention(plain):
            out = blk(seen["x"])
            return torch.autograd.grad(out, blk.qkv.weight, seen["dy"])[
                0].double().cpu()

    size, n = RE_STEP_SIZE, RE_NUPLET - 1
    ckpt = tempfile.mkdtemp(prefix="re_step_")
    try:
        models = {}
        for dev, bf16 in (("cpu", False), ("cuda", True)):
            o = copy.copy(opt)
            o.tpu_bf16, o.train_batch_size = bf16, 1
            o.data_crop_size = o.data_load_size = size
            o.G_ngf = o.D_ndf = RE_STEP_WIDTH
            o.alg_re_projection_threshold = RE_OPEN_THRESHOLD
            o.checkpoints_dir = ckpt
            models[dev] = create_model(o, phase="train",
                                       device=torch.device(dev))
        m = models["cpu"]
        g = torch.Generator().manual_seed(SEED + 91)
        for name in ("P_A", "P_B"):
            init_weights(m.nets[name], g, zero_init_std=RE_STEP_ZERO_STD)
        for name, net in m.nets.items():
            models["cuda"].nets[name].load_state_dict(net.state_dict())
        draws = {"pool_A": m.pool_A.draw_query(g, n),
                 "pool_B": m.pool_B.draw_query(g, n), "d_real_aug": {},
                 "d_fake_aug": {}}
        for sname, _, _ in m.d_names:
            for k in ("d_real_aug", "d_fake_aug"):
                draws[k][sname] = draw_diff_augment(
                    g, (n, 3, size, size), m.diff_policy, m.diff_prob)

        def moved(d, dev):
            if isinstance(d, dict):
                return {k: moved(v, dev) for k, v in d.items()}
            return d.to(dev) if torch.is_tensor(d) else d
        batch = _nuplets(size, SEED + 92, 1)
        losses, grads = {}, {}
        for dev, model in models.items():
            prepared = model.prepare_batch(batch)
            grads[dev], seen = p_grad(model, prepared)
            if dev == "cuda":
                grads["cuda_plain"], _ = p_grad(model, prepared, plain=True)
                blk = model.nets["P_A"].AttentionBlock_0
                grads["block"] = block_grad(blk, seen, False)
                grads["block_plain"] = block_grad(blk, seen, True)
            reset_launches()
            out = model.optimize_prepared(prepared, moved(draws, dev))
            losses[dev] = {k: float(v) for k, v in out.items()}
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_launches()
        del models, m
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    err = max(abs(losses["cuda"][k] - v) / max(1.0, abs(v))
              for k, v in losses["cpu"].items())
    g_norm = grads["cpu"].norm().item()

    def g_err(x, y):
        return (grads[x] - grads[y]).norm().item() / grads[y].norm().item()
    g_errs = {"block_card_vs_plain": g_err("block", "block_plain"),
              "card_vs_plain": g_err("cuda", "cuda_plain"),
              "card_vs_cpu": g_err("cuda", "cpu"),
              "plain_vs_cpu": g_err("cuda_plain", "cpu")}
    rec = {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_err": err, "tol": RE_STEP_TOL,
           "p_qkv_grad_norm_cpu": g_norm, "p_qkv_grad_rel_err": g_errs,
           "launches": launches, "size": size, "nuplets": 1,
           "width": RE_STEP_WIDTH}
    log("recycle_h2z bf16 step on the card vs fp32 on the CPU: "
        + json.dumps(rec))
    if (launches != _attention_only(launches, RE_PER_STEP)
            or err > RE_STEP_TOL or not g_norm > 0
            or not grads["block_plain"].norm().item() > 0
            or g_errs["block_card_vs_plain"] > RE_STEP_TOL
            or g_errs["card_vs_cpu"]
            > 2 * g_errs["plain_vs_cpu"] + RE_STEP_TOL
            or not min(losses["cpu"]["G_recycle_A"],
                       losses["cpu"]["G_recycle_B"]) > 0
            or not all(np.isfinite(v) for v in losses["cuda"].values())):
        raise AssertionError("card and CPU ReCycleGAN steps disagree")
    return rec


def re_phase(workdir):
    """ReCycleGAN and ReCUT over the nuplet layout at full width (see
    RE_NUPLET): recycle_h2z RE_STEPS steps and recut_glasses RECUT_STEPS
    steps, K1-K3 RE_PER_STEP and RECUT_PER_STEP times a step, each with the
    nets' parameter counts (the P nets EXPECTED_PARAMS_P), finite losses
    (the P losses and the ReCUT or recycle terms among them), the warm step
    time, images/s, peak memory and data wait; then a step with the gate
    opened (RE_OPEN_THRESHOLD), whose recycle or ReCUT terms must be
    positive: recycle_h2z's is the profiled step (``_profiled_step``:
    launches and idle share); one request each through
    ``scripts/gen_single_image`` from G_A's checkpoint (no kernel); and
    recycle_h2z's bf16 step against fp32 on the CPU (``re_step_check``).
    Returns (records, launch counts per path)."""
    import numpy as np
    import torch

    recs, paths = {}, {}
    runs = (
        ("recycle_h2z", GAN_EXAMPLE, ["--model_type", "re_cycle_gan"],
         RE_STEPS, GAN_SHAPE[0], 286, RE_PER_STEP,
         dict(EXPECTED_PARAMS_CYCLEGAN, P_A=EXPECTED_PARAMS_P,
              P_B=EXPECTED_PARAMS_P),
         {"P_proj_real_A", "P_proj_real_B", "G_recycle_A", "G_recycle_B"},
         ("G_recycle_A", "G_recycle_B")),
        ("recut_glasses", "example_gan_noglasses2glasses.json",
         ["--model_type", "re_cut_semantic_mask",
          "--alg_cut_flip_equivariance"],
         RECUT_STEPS, RECUT_SHAPE[0], 256, RECUT_PER_STEP,
         dict(EXPECTED_PARAMS_GLASSES, G_A=EXPECTED_PARAMS_GLASSES_G,
              P_B=EXPECTED_PARAMS_P),
         {"P_proj_real_B", "G_recut", "f_s", "G_sem_mask"}, ("G_recut",)))
    for (name, example, args, steps, batch, image, per, want, keys,
         gated) in runs:
        wd = _shm_workdir(workdir, name)
        t0 = time.perf_counter()
        try:
            opt = _re_opt(example, wd, name, args, steps * batch, image)
            model, opt, rec = _train_run(
                opt, steps, 1, f"{name} training", want["G_A"],
                attention_per_step=per)
            counts = model.param_count()
            if ({k: counts.get(k) for k in want} != want
                    or opt.train_batch_size != batch
                    or opt.data_crop_size != 256 or opt.G_ngf != 64
                    or opt.alg_re_nuplet_size != RE_NUPLET
                    or model.nets["P_B"].AttentionBlock_0.heads
                    != GAN_SHAPE[2]):
                raise AssertionError(f"{name} is not at full width: "
                                     f"{counts}")
            if not keys <= set(rec["losses_last"]) or not all(
                    np.isfinite(rec["losses_last"][k]) for k in keys):
                raise AssertionError(f"{name}: losses {rec['losses_last']}")
            rec["parameters_per_net"] = counts
            rec["images_per_step"] = batch * (RE_NUPLET - 1)
            # P's losses (about 3 after these steps) keep the config's
            # threshold of 1 shut; opened, the gated terms count, and the
            # step runs what it ran before (P's calls run whatever the gate)
            t1 = time.perf_counter()
            model.p_threshold = RE_OPEN_THRESHOLD
            clip = _nuplets(256, SEED + 93, batch)
            if name == "recycle_h2z":
                rec["profiled_step"] = _profiled_step(model, opt, clip)
                log(f"{name}: a profiled step "
                    + json.dumps(rec["profiled_step"]))
            else:
                model.optimize_parameters(clip)
                torch.cuda.synchronize()
            rec["gate_open_losses"] = {k: float(model.loss_log[k])
                                       for k in gated}
            rec["gate_open_s"] = time.perf_counter() - t1
            log(f"{name}: parameters {counts}; gate opened: "
                f"{rec['gate_open_losses']}")
            if not all(np.isfinite(v) and v > 0
                       for v in rec["gate_open_losses"].values()):
                raise AssertionError(f"{name}: gated terms "
                                     f"{rec['gate_open_losses']}")
            del model
            torch.cuda.empty_cache()
            ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                                "latest_net_G_A.pth")
            out_dir = os.path.join(wd, f"out_{name}")
            os.makedirs(out_dir)
            req = _serve_gan(ckpt, os.path.join(opt.dataroot, "trainA",
                                                "imgs", "0000.png"),
                             out_dir, 1)
            if req["launches"] != _attention_only(req["launches"], 0):
                raise AssertionError(f"{name} request launched "
                                     f"{req['launches']}")
            log(f"{name}: a request from G_A's checkpoint, "
                f"{[round(t, 4) for t in req['request_s']]} s")
            rec["requests"] = req
            if name == "recycle_h2z":
                t1 = time.perf_counter()
                rec["step_check_bf16_card_vs_fp32_cpu"] = re_step_check(opt)
                rec["step_check_s"] = time.perf_counter() - t1
            rec["phase_s"] = time.perf_counter() - t0
            log(f"{name}: {rec['phase_s']:.1f} s in all (training "
                f"{rec['wall_s']:.1f} s, the gate-open step(s) "
                f"{rec['gate_open_s']:.1f} s"
                + (f", the step check {rec['step_check_s']:.1f} s"
                   if "step_check_s" in rec else "") + ")")
            recs[name] = rec
            paths[f"{name}_training"] = rec["launches"]
            paths[f"{name}_requests"] = req["launches"]
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    return recs, paths


def gan_zoo_phase(workdir):
    """CUT over horse2zebra with each new generator at its factory width
    (CUT_ZOO): ZOO_STEPS steps (finite losses, the G's parameter count,
    K1-K3 where its middle block has them) and one request through
    ``scripts/gen_single_image`` each. Returns (records, launch counts per
    path)."""
    import torch
    from joligen_tpu_torch.tools.synthetic_datasets import write_unaligned

    recs, paths = {}, {}
    for netg, args, count, k1_step, k1_req in CUT_ZOO:
        name = f"cut_h2z_{netg}"
        wd = _shm_workdir(workdir, name)
        try:
            opt = _example_opt(GAN_EXAMPLE, wd, name,
                               ["--G_netG", netg, *args])
            write_unaligned(opt.dataroot, ZOO_STEPS * opt.train_batch_size,
                            300, seed=SEED + 82)
            model, opt, rec = _train_run(opt, ZOO_STEPS, 1,
                                         f"{name} training", count,
                                         attention_per_step=k1_step)
            rec["nce_layers"] = list(model.nce_layers)
            del model
            torch.cuda.empty_cache()
            ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                                "latest_net_G_A.pth")
            out_dir = os.path.join(wd, "out")
            os.makedirs(out_dir)
            req = _serve_gan(ckpt, os.path.join(opt.dataroot, "trainA",
                                                "0000.png"), out_dir, 1)
            if req["launches"] != _attention_only(
                    req["launches"], {"flash_attention_fwd": k1_req}):
                raise AssertionError(f"{name} request launched "
                                     f"{req['launches']}")
            log(f"{name}: batch {opt.train_batch_size}, NCE taps "
                f"{rec['nce_layers']}, a request {req['request_s'][0]:.4f} "
                f"s, launches {req['launches']}")
            rec["requests"] = req
            recs[name] = rec
            paths[f"{name}_training"] = rec["launches"]
            paths[f"{name}_request"] = req["launches"]
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    return recs, paths


def palette_zoo_phase(workdir):
    """Palette (the example config at 128 px) with the uvit and
    resnet_attn denoisers and with ``--train_feat_wavelet`` (PALETTE_ZOO):
    ZOO_STEPS steps and a DDIM-10 ``--mask_in`` request each. Returns
    (records, launch counts per path)."""
    import torch
    from joligen_tpu_torch.models.modules.resnet_generator import \
        ResnetGeneratorAttnDiff
    from joligen_tpu_torch.models.modules.unet_mha import UNetMHA
    from joligen_tpu_torch.tools.synthetic_datasets import write_labeled

    recs, paths = {}, {}
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    for name, args, count, per_call in PALETTE_ZOO:
        wd = _shm_workdir(workdir, name)
        try:
            opt = _example_opt(IMAGE_EXAMPLE, wd, name, args)
            write_labeled(opt.dataroot, ZOO_STEPS * opt.train_batch_size,
                          128, seed=SEED + 83)
            model, opt, rec = _train_run(
                opt, ZOO_STEPS, 1, f"{name} training", count,
                attention_per_step=dict.fromkeys(kernels, per_call))
            inner = model.nets["G_A"].inner
            trunk = (ResnetGeneratorAttnDiff if "resnet" in name
                     else UNetMHA)
            if not (isinstance(inner, trunk) and opt.data_crop_size == 128
                    and getattr(inner, "freq_space", False)
                    == ("wavelet" in name)
                    and ("uvit" not in name or inner._mid is None)):
                raise AssertionError(f"{name} did not train as configured")
            ema = {k: v.detach().cpu().clone()
                   for k, v in model.ema_nets["G_A"].state_dict().items()}
            del model, inner
            torch.cuda.empty_cache()
            ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                                "latest_net_G_A.pth")
            rec["request"] = _serve_masked(
                ckpt, wd, 1, [10 * per_call], name, trained_ema=ema,
                extra=[["--sampling_method", "ddim", "--sampling_steps",
                        "10"]], wire=True)
            recs[name] = rec
            paths[f"{name}_training"] = rec["launches"]
            paths[f"{name}_request"] = rec["request"]["launches"]
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    return recs, paths


def gan_zoo_cross_check():
    """fp32 at full width, batch 1, TF32 off, card against CPU to ZOO_TOL
    of the largest output: CycleGAN's G (resnet_attn, 256 px) and its Ds
    (projected_d and basic) on a 256 px image, at the model's own init
    (the scheme; the Ds' frozen trunk at flax's law); HAT (128 px: windows
    of 16, odd blocks shifted), ITTR (256 px, dim_head 64: both top-k
    prunings) and palette's UViT denoiser (128 px, the mask embedding; its
    zero-initialised layers seeded small), their raw leaves drawn as
    flax's."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.cut_model import (init_discriminator,
                                                    init_generator)
    from joligen_tpu_torch.models.diffusion_networks import (define_G,
                                                             init_weights)
    from joligen_tpu_torch.models.gan_networks import define_D
    from joligen_tpu_torch.options import TrainOptions

    rng = np.random.default_rng(SEED + 84)
    recs = {}

    def image(size):
        return torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3))
                                .astype(np.float32))

    def gan_opt(*args):
        return _fp32(TrainOptions().parse_cli([
            "--config_json", os.path.join(ROOT, "examples", GAN_EXAMPLE),
            "--model_type", "cycle_gan", *args]))
    opt = gan_opt()
    runs = [("cyclegan_G", lambda: init_generator(
        opt, torch.Generator().manual_seed(SEED + 85)), (image(256),), {})]
    for dname in opt.D_netDs:
        runs.append((f"cyclegan_D_B_{dname}", lambda dname=dname:
                     init_discriminator(
                         f"D_B_{dname}", define_D(opt, [dname])[
                             f"D_B_{dname}"],
                         torch.Generator().manual_seed(SEED + 86), opt),
                     (image(256),), {}))
    for netg, size in (("hat", 128), ("ittr", 256)):
        zopt = gan_opt("--G_netG", netg, "--data_crop_size", str(size))
        runs.append((netg, lambda zopt=zopt: init_generator(
            zopt, torch.Generator().manual_seed(SEED + 87)),
            (image(size),), {}))
    popt = _fp32(TrainOptions().parse_cli(["--config_json", EXAMPLE,
                                           "--G_netG", "uvit"]))
    mask = torch.zeros(1, 128, 128, 1, dtype=torch.int32)
    mask[:, 32:96, 40:88] = 1
    x6 = torch.from_numpy(rng.uniform(-1, 1, (1, 128, 128, 6)).astype(
        np.float32))
    runs.append(("palette_uvit", lambda: init_weights(
        define_G(popt), torch.Generator().manual_seed(SEED + 88),
        zero_init_std=0.01), (x6, torch.tensor([0.37])), {"mask": mask}))
    for label, build, args, kwargs in runs:
        err, out = _card_vs_cpu(build, args, kwargs, label, k1=0,
                                tol=float("inf"))
        scale = out.abs().max().item()
        recs[label] = {"max_abs_err": err, "max_abs_output": scale,
                       "tol": ZOO_TOL}
        if not (scale > 0 and err <= ZOO_TOL * scale):
            raise AssertionError(f"{label} cross-check: {recs[label]}")
    log("GAN zoo cross-checks fp32 card vs CPU: " + json.dumps(recs))
    return recs


def _glasses_opt(example, workdir, n_images, size, name):
    """A glasses config over a synthetic ``unaligned_labeled_mask`` dataset
    of ``n_images`` a domain, ``size`` px, written here (``_example_opt``;
    ``latest`` alone is saved: each D checkpoint holds the 172.8M frozen
    tower parameters)."""
    from joligen_tpu_torch.tools.synthetic_datasets import \
        write_unaligned_labeled

    opt = _example_opt(example, workdir, name)
    write_unaligned_labeled(opt.dataroot, n_images, size, seed=SEED + 17)
    return opt


def _glasses_widths(name, opt, model, size):
    """The trained glasses model at full width: the JAX modules' parameter
    counts (G is checked by ``_train_run``), its nets, the config's crop,
    widths and batch, the semantic branch. Returns (counts per net, counts
    per tower)."""
    counts = model.param_count()
    netD = model.nets["D_B_vision_aided"]
    towers = {t: sum(p.numel() for p in getattr(netD, t).parameters())
              for t in EXPECTED_PARAMS_TOWERS}
    if ({k: counts.get(k) for k in EXPECTED_PARAMS_GLASSES}
            != EXPECTED_PARAMS_GLASSES or towers != EXPECTED_PARAMS_TOWERS
            or set(counts) != {"G_A", "F", "D_B_projected_d", "D_B_basic",
                               "D_B_vision_aided", "f_s"}
            or opt.data_crop_size != size or opt.G_ngf != 64
            or opt.G_nblocks != 9 or opt.train_batch_size != 2
            or not model.semantic_mask
            or model.out_mask != (name == "noglasses2glasses")):
        raise AssertionError(f"{name} is not at full width: {counts}, "
                             f"towers {towers}")
    return counts, towers


def _frozen_check(before, model):
    """Which tower parameters of the vision-aided D changed since
    ``before`` (a ``_snapshot``), and which head or f_s parameters did not,
    but for clip's ``glob0.weight``: without a weights file CLIP's
    embedding is exactly 0 (its ``proj`` is), so that kernel's gradient is
    exactly 0 too and it must not move."""
    import torch
    from joligen_tpu_torch.utils.clip_vit import clip_weights_path
    still = set() if clip_weights_path() else {"D_B_vision_aided.glob0.weight"}
    out = {"towers_changed": [], "heads_or_f_s_unchanged": []}
    for net in ("D_B_vision_aided", "f_s"):
        named = model.nets[net].named_parameters()
        for (k, p), p0 in zip(named, before[net]):
            same = torch.equal(p0, p)
            if k.startswith("freezenet_") and not same:
                out["towers_changed"].append(k)
            elif not k.startswith("freezenet_") and same:
                out["heads_or_f_s_unchanged"].append(f"{net}.{k}")
    out["heads_or_f_s_unchanged"] = sorted(
        set(out["heads_or_f_s_unchanged"]) ^ still)
    return out


def glasses_phase(workdir):
    """CUT's semantic-mask branch and the vision-aided D on the glasses
    configs: ``example_gan_noglasses2glasses.json`` at full width
    (mobile_resnet_attn G, ngf 64, 9 blocks; projected, basic and
    vision-aided Ds, the last with its frozen CLIP ViT-B/16 and DINOv2
    ViT-B/14 towers at a seeded init; the unet f_s; the L1 out-mask loss; G
    EMA; batch 2, 256 px, bf16) for GLASSES_STEPS steps over a synthetic
    dataset with masks of both domains, then GLASSES_REQUESTS requests from
    the trained checkpoint; the parameter counts of the JAX modules; the
    towers bit for bit as they started (adam gives them zero updates), every
    head and f_s changed. Then ``example_gan_glasses2noglasses.json`` (128
    px) GLASSES2_STEPS steps and one request. No kernel of the port runs on
    these paths. Returns (records, launch counts per path)."""
    import torch
    from joligen_tpu_torch.models.cut_model import CUTModel

    recs, paths, snaps = {}, {}, []
    plain = CUTModel.optimize_prepared

    def first_snapshot(self, dev, draws=None):
        if not snaps:
            snaps.append(_snapshot(self))
        return plain(self, dev, draws)

    for name, example, size, steps, n_req in (
            ("noglasses2glasses", "example_gan_noglasses2glasses.json", 256,
             GLASSES_STEPS, GLASSES_REQUESTS),
            ("glasses2noglasses", "example_gan_glasses2noglasses.json", 128,
             GLASSES2_STEPS, 1)):
        opt = _glasses_opt(example, workdir, 2 * steps, size, name)
        CUTModel.optimize_prepared = first_snapshot
        try:
            model, opt, rec = _train_run(opt, steps, 1, f"{name} training",
                                         EXPECTED_PARAMS_GLASSES_G,
                                         attention_per_step=0)
        finally:
            CUTModel.optimize_prepared = plain
        rec["parameters_per_net"], rec["tower_parameters"] = \
            _glasses_widths(name, opt, model, size)
        frozen = _frozen_check(snaps.pop(), model)
        rec["frozen_check"] = frozen
        log(f"{name}: parameters per net {rec['parameters_per_net']}, "
            f"towers {rec['tower_parameters']}, frozen check {frozen}")
        if any(frozen.values()):
            raise AssertionError(f"{name}: {frozen}")
        del model
        torch.cuda.empty_cache()
        paths[f"{name}_training"] = rec["launches"]
        ckpt = os.path.join(opt.checkpoints_dir, opt.name,
                            "latest_net_G_A.pth")
        out_dir = os.path.join(workdir, f"out_{name}")
        os.makedirs(out_dir)
        req = _serve_gan(ckpt, os.path.join(opt.dataroot, "trainA", "imgs",
                                            "0000.png"), out_dir, n_req)
        log(f"{name}: {n_req} requests from the trained checkpoint, "
            f"{[round(s, 4) for s in req['request_s']]} s, launches "
            f"{req['launches']}")
        rec["requests"] = req
        paths[f"{name}_requests"] = req["launches"]
        recs[name] = rec
    return recs, paths


def vision_aided_cross_check():
    """The full-width vision-aided D of noglasses2glasses in fp32, TF32 off,
    batch 1 at 256 px (the resize shrinks), the card against the CPU on the
    same seeded weights: flax's default init with the zero-initialised
    tables (CLIP's ``proj`` among them) filled with N(0, 0.02), so that both
    towers' embeddings count; to CROSS_CHECK_TOL of the largest logit."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.gan_networks import (ZERO_INIT, define_D,
                                                       flax_default_init)
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.utils.clip_vit import preprocess

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(os.path.join(ROOT, "examples",
                           "example_gan_noglasses2glasses.json")) as f:
        opt = TrainOptions().parse_json(json.load(f), verbose=False)
    opt.tpu_bf16 = False
    gen = torch.Generator().manual_seed(SEED + 19)
    net = flax_default_init(
        define_D(opt, ["vision_aided"])["D_B_vision_aided"], gen)
    with torch.no_grad():
        for k, p in net.named_parameters():
            if k.rsplit(".", 1)[-1] in ZERO_INIT:
                p.normal_(0.0, 0.02, generator=gen)
    size = opt.data_crop_size
    x = torch.from_numpy(np.random.default_rng(SEED + 20).uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32))
    outs, emb = {}, 0.0
    for dev in ("cuda", "cpu"):
        net = net.to(dev).eval()
        with torch.inference_mode():
            outs[dev] = net(x.to(dev)).cpu()
            if dev == "cpu":
                emb = net.freezenet_clip(preprocess(x))[0].abs().max().item()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    rec = {"shape": list(outs["cuda"].shape), "max_abs_err": err,
           "max_abs_logit": scale, "clip_embedding_max": emb,
           "tol": CROSS_CHECK_TOL}
    log("vision-aided D fp32 card vs CPU: " + json.dumps(rec))
    if not (torch.isfinite(outs["cuda"]).all() and rec["shape"] == [1, 115]
            and emb > 0 and err <= CROSS_CHECK_TOL * scale):
        raise AssertionError("card and CPU vision-aided Ds disagree")
    return rec


def _cm_opt(example, workdir, n_images, name, model_type=None):
    """A cm example config (``model_type`` in place of the config's, if
    given) over the first ``n_images`` of a synthetic labeled-mask dataset
    of CM_IMAGES images at the crop size, written here once: one epoch, the
    loss every step, no display inference."""
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.tools.synthetic_datasets import write_labeled

    with open(os.path.join(ROOT, "examples", example)) as f:
        cfg = json.load(f)
    if model_type:
        cfg["model_type"] = model_type
    opt = TrainOptions().parse_json(cfg, verbose=False)
    opt.dataroot = os.path.join(workdir, "data_cm")
    if not os.path.exists(opt.dataroot):
        write_labeled(opt.dataroot, CM_IMAGES, opt.data_crop_size,
                      seed=SEED + 17)
    opt.data_max_dataset_size = n_images
    opt.checkpoints_dir = os.path.join(workdir, "cm_ckpt")
    opt.name = f"smoke_{name}"
    opt.train_n_epochs, opt.train_n_epochs_decay = 1, 0
    opt.output_print_freq = opt.train_batch_size
    opt.output_display_freq = 0
    return opt


def _serve_masked(ckpt, workdir, n, k1, label, trained_ema=None, extra=None,
                  infer_kw=None, wire=False):
    """``n`` requests through ``scripts/gen_single_image_diffusion`` from
    one load of ``ckpt`` (its EMA equal to ``trained_ema`` bit for bit, when
    given), with the launch counters at 0 just before them and read just
    after: ``k1`` K1 launches a request (or ``k1[i]`` for request i) and no
    other kernel; each output finite, and equal to the input crop outside
    the mask to 1e-6. ``extra[i]``: request i's further arguments;
    ``infer_kw``: arguments of the model's ``inference`` besides the
    script's; ``wire``: the model takes its batch through the uint8 wire
    step (palette), so its known pixels are the quantised crop's."""
    import numpy as np
    import torch
    from PIL import Image
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import (load_model_from_file,
                                                  to_m1p1)

    served, sopt = load_model_from_file(ckpt)
    if trained_ema is not None:
        for k, v in served.ema_nets["G_A"].state_dict().items():
            if not torch.equal(v.cpu(), trained_ema[k]):
                raise AssertionError(f"{label}: reloaded EMA differs at {k}")
    outputs, infer = [], served.inference

    def recording_inference(*a, **kw):
        outputs.append(infer(*a, **kw, **(infer_kw or {})))
        return outputs[-1]
    served.inference = recording_inference
    img = _write_inputs(workdir)
    size = sopt.data_crop_size
    crop = (_expected_crop(img, size) if wire else to_m1p1(np.asarray(
        Image.fromarray(img).resize((size, size), Image.BICUBIC))))
    keep = np.asarray(Image.open(os.path.join(workdir, "mask.png")).convert(
        "L").resize((size, size), Image.NEAREST)) == 0
    secs = []
    reset_launches()                             # the requests start here
    for i in range(n):
        args = gen.build_parser().parse_args([
            "--model_in_file", ckpt,
            "--img_in", os.path.join(workdir, "img.png"),
            "--mask_in", os.path.join(workdir, "mask.png"),
            "--dir_out", os.path.join(workdir, f"out_{label}"),
            "--name", f"req{i}", "--seed", str(i),
            *(extra[i] if extra else [])])
        before = read_launches()
        t0 = time.perf_counter()
        full, _, _ = gen.inference(args, lmodel=served, lopt=sopt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = read_launches()
        got = {k: after[k] - before[k] for k in after}
        out = outputs[-1][0]
        err = float(np.abs(out[keep] - crop[keep]).max())
        log(f"{label} request {i}: {secs[-1]:.4f} s, launches {got}, "
            f"outside the mask max abs err {err:.1e}")
        want = k1[i] if isinstance(k1, list) else k1
        if got != _attention_only(got, {"flash_attention_fwd": want}) or not (
                np.isfinite(out).all() and out.shape == (size, size, 3)
                and full.shape == img.shape and err <= 1e-6):
            raise AssertionError(f"{label} request {i} failed")
    launches = read_launches()                   # and end here
    del served
    torch.cuda.empty_cache()
    return {"request_s": secs, "launches": launches}


def cm_cross_check(opt):
    """cm's full-width denoiser (``CMDenoiser``) in fp32 at batch 1, card
    against CPU (``_card_vs_cpu``), with the training scalings, seeded
    weights and small values in the zero-initialised output layers (trained
    ones are still near 0 after a few steps, and the output would be the
    skip term alone)."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.cm_model import (is_conditional,
                                                   trunk_in_channels)
    from joligen_tpu_torch.models.diffusion_networks import (define_inner_G,
                                                             init_weights)
    from joligen_tpu_torch.models.modules.cm import CMDenoiser, skip_scaling

    opt32 = _fp32(opt)
    size = opt32.data_crop_size
    rng = np.random.default_rng(SEED + 19)
    x, cond = (torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3))
                                .astype(np.float32)) for _ in range(2))
    sigma = torch.tensor([2.5])
    cin = trunk_in_channels(opt32, is_conditional(opt32, "inpainting"))

    def build():
        net = CMDenoiser(define_inner_G(opt32, cin),
                         opt32.alg_diffusion_cond_embed_dim)
        return init_weights(net, torch.Generator().manual_seed(SEED + 20),
                            zero_init_std=0.01)
    err, out = _card_vs_cpu(build, (x, sigma), {"x_cond": cond},
                            "cm denoiser")
    skip = (skip_scaling(sigma, True) * x).abs().max().item()
    if not out.abs().max().item() > 2 * skip:
        raise AssertionError("the cm cross-check's output is its skip term")
    return err


def _snapshot(model):
    return {n: [p.detach().clone() for p in net.parameters()]
            for n, net in model.nets.items()}


def cm_phase(workdir):
    """The consistency and shortcut models at full width over a synthetic
    labeled-mask dataset (128 px): cm (``example_cm_noglasses2glasses``:
    63,084,611 parameters, trunk input [A, x] of 6 channels, bf16, batch 16,
    AdamW, EMA) CM_STEPS steps, its checkpoint reloaded, CM_REQUESTS
    5-sigma requests, the fp32 denoiser card against the CPU; cm_gan
    (``example_cm_gan_noglasses2glasses``: the same G, the projected and
    basic Ds, batch 4, iter_size 16) CM_GAN_STEPS micro-steps, each net
    changing on the 16th only, one request; sc (the cm config with
    ``model_type sc``, 62,822,083 parameters) SC_STEPS steps and one
    16-step request. Returns (records, launch counts per path)."""
    import torch
    from joligen_tpu_torch.models.cm_model import CMModel

    recs, paths = {}, {}
    final = {}

    def keep_ema(model, iters, steps):
        if iters == steps * model.opt.train_batch_size:
            final.update({k: v.detach().cpu() for k, v in
                          model.ema_nets["G_A"].state_dict().items()})

    opt = _cm_opt(CM_EXAMPLE, workdir, CM_STEPS * 16, "cm")
    model, opt, rec = _train_run(opt, CM_STEPS, 1, "cm training",
                                 EXPECTED_PARAMS_CM, keep_ema, CM_PER_STEP)
    net = model.nets["G_A"]
    leaves = len(list(net.parameters()))
    if (net.inner.in_conv.weight.shape[1] != 6 or leaves != EXPECTED_LEAVES
            or opt.train_batch_size != 16 or opt.data_crop_size != 128):
        raise AssertionError(f"cm is not the example config: {leaves} "
                             f"leaves, in_conv "
                             f"{tuple(net.inner.in_conv.weight.shape)}")
    rec["leaves"] = leaves
    del model, net
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    rec["requests"] = _serve_masked(ckpt, workdir, CM_REQUESTS,
                                    CM_REQUEST_K1, "cm", trained_ema=final)
    rec["cross_check_fp32_max_abs_err"] = cm_cross_check(opt)
    recs["cm"] = rec
    paths["cm_training"] = rec["launches"]
    paths["cm_requests"] = rec["requests"]["launches"]

    # cm_gan: snapshot the nets before the first micro-step, then compare
    # after each (outside the step times)
    snaps, moved = [], []
    plain = CMModel.optimize_prepared

    def first_snapshot(self, dev, draws=None):
        if not snaps:
            snaps.append(_snapshot(self))
        return plain(self, dev, draws)

    def watch(model, iters, steps):
        cur = _snapshot(model)
        moved.append({n: bool(torch.stack([
            (a != b).any() for a, b in zip(snaps[-1][n], cur[n])]).any())
            for n in cur})
        snaps[-1] = cur

    opt = _cm_opt(CM_GAN_EXAMPLE, workdir, CM_GAN_STEPS * 4, "cm_gan")
    CMModel.optimize_prepared = first_snapshot
    try:
        model, opt, rec = _train_run(opt, CM_GAN_STEPS, 1, "cm_gan training",
                                     EXPECTED_PARAMS_CM, watch, CM_PER_STEP)
    finally:
        CMModel.optimize_prepared = plain
    rec["parameters_per_net"] = model.param_count()
    every = opt.train_iter_size
    updates = [i + 1 for i, m in enumerate(moved) if any(m.values())]
    log(f"cm_gan: parameters per net {rec['parameters_per_net']}, nets "
        f"changed at micro-steps {updates} (iter_size {every})")
    want = {"G_A": EXPECTED_PARAMS_CM, **EXPECTED_PARAMS_CM_D}
    if rec["parameters_per_net"] != want or opt.train_batch_size != 4:
        raise AssertionError(f"cm_gan is not the example config: "
                             f"{rec['parameters_per_net']}")
    for i, m in enumerate(moved):
        if set(m.values()) != {(i + 1) % every == 0}:
            raise AssertionError(f"cm_gan micro-step {i + 1}: nets changed "
                                 f"{m}, iter_size {every}")
    rec["updates_at_micro_steps"] = updates
    snaps.clear()
    del model
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    rec["requests"] = _serve_masked(ckpt, workdir, 1, CM_REQUEST_K1,
                                    "cm_gan")
    recs["cm_gan"] = rec
    paths["cm_gan_training"] = rec["launches"]
    paths["cm_gan_requests"] = rec["requests"]["launches"]

    opt = _cm_opt(CM_EXAMPLE, workdir, SC_STEPS * 16, "sc", "sc")
    model, opt, rec = _train_run(opt, SC_STEPS, 1, "sc training",
                                 EXPECTED_PARAMS_SC, None, SC_PER_STEP)
    del model
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    rec["requests"] = _serve_masked(ckpt, workdir, 1, SC_REQUEST_K1, "sc")
    recs["sc"] = rec
    paths["sc_training"] = rec["launches"]
    paths["sc_requests"] = rec["requests"]["launches"]
    return recs, paths


def mario2sonic_phase(workdir):
    """``example_gan_mario2sonic.json`` as it is (segformer_attn_conv G,
    3,931,824 parameters; the unet f_s of 7 classes; the projected, basic
    and vision-aided Ds, CLIP and DINOv2 at a seeded init; batch 2, 128 px
    online crops of MARIO_IMAGE px images in both domains, boxes of classes
    1 to 6; bf16) for MARIO_STEPS steps, then MARIO_REQUESTS requests
    through ``scripts/gen_single_image`` from the trained checkpoint. No
    kernel of the port runs on this path. Returns (record, launch counts
    per path)."""
    import torch
    from joligen_tpu_torch.tools.synthetic_datasets import write_online_ab

    opt = _example_opt("example_gan_mario2sonic.json", workdir,
                       "mario2sonic")
    write_online_ab(opt.dataroot, MARIO_STEPS * opt.train_batch_size,
                    MARIO_IMAGE, seed=SEED + 23)
    model, opt, rec = _train_run(opt, MARIO_STEPS, 1, "mario2sonic training",
                                 EXPECTED_PARAMS_MARIO_G,
                                 attention_per_step=0)
    counts = rec["parameters_per_net"] = model.param_count()
    f_s = model.nets["f_s"]
    log(f"mario2sonic: parameters per net {counts}, NCE taps "
        f"{model.nce_layers}")
    if (set(counts) != {"G_A", "F", "D_B_projected_d", "D_B_basic",
                        "D_B_vision_aided", "f_s"}
            or type(model.nets["G_A"]).__name__ != "SegformerGeneratorAttn"
            or type(f_s).__name__ != "UNetSegmenter"
            or f_s.Conv_7.weight.shape[0] != 7
            or model.nce_layers != [0, 1, 2, 3] or not model.semantic_mask
            or opt.data_crop_size != 128 or opt.train_batch_size != 2):
        raise AssertionError("mario2sonic is not the example config")
    del model, f_s
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    out_dir = os.path.join(workdir, "out_mario2sonic")
    os.makedirs(out_dir)
    req = rec["requests"] = _serve_gan(
        ckpt, os.path.join(opt.dataroot, "trainA", "imgs", "0000.png"),
        out_dir, MARIO_REQUESTS)
    log(f"mario2sonic: {MARIO_REQUESTS} requests from the trained "
        f"checkpoint, {[round(t, 4) for t in req['request_s']]} s, launches "
        f"{req['launches']}")
    return rec, {"mario2sonic_training": rec["launches"],
                 "mario2sonic_requests": req["launches"]}


def mit_cross_check():
    """mario2sonic's segformer G (128 px) and a segformer f_s at bdd100k's
    width (512 px, 19 classes) in fp32, TF32 off, batch 1, flax's default
    init from a seed: the card against the CPU to MIT_TOL of the largest
    output."""
    import copy
    import numpy as np
    import torch
    from joligen_tpu_torch.models.gan_networks import (define_G,
                                                       flax_default_init)
    from joligen_tpu_torch.models.modules.semantic_networks import define_f

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    opt = _fp32(_example_opt("example_gan_mario2sonic.json",
                             tempfile.gettempdir(), "mit"))
    opt_fs = copy.copy(opt)
    opt_fs.f_s_net, opt_fs.f_s_semantic_nclasses = "segformer", 19
    recs = {}
    for label, build, size in (("segformer_G", lambda: define_G(opt), 128),
                               ("segformer_f_s", lambda: define_f(opt_fs),
                                512)):
        net = flax_default_init(build(),
                                torch.Generator().manual_seed(SEED + 29))
        x = torch.from_numpy(np.random.default_rng(SEED + 30).uniform(
            -1, 1, (1, size, size, 3)).astype(np.float32))
        outs = {}
        for dev in ("cuda", "cpu"):
            net = net.to(dev).eval()
            with torch.inference_mode():
                outs[dev] = net(x.to(dev)).float().cpu()
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        scale = outs["cpu"].abs().max().item()
        recs[label] = {"shape": list(outs["cpu"].shape), "max_abs_err": err,
                       "max_abs_output": scale, "tol": MIT_TOL}
        log(f"cross-check fp32 {label} card vs CPU: " + json.dumps(
            recs[label]))
        if not (torch.isfinite(outs["cuda"]).all() and scale > 0
                and err <= MIT_TOL * scale):
            raise AssertionError(f"card and CPU {label}s disagree")
        del net
    return recs


def _serve_ref(ckpt, root, out_dir, n, extra, label, cut_schedule=False):
    """``n`` ``--bbox_in`` ``--ref_in`` requests (image, box and reference
    ``i`` of the dataset) through ``scripts/gen_single_image_diffusion``
    from one load of ``ckpt``, with ``extra`` sampler arguments, the launch
    counters at 0 just before them and read just after: no kernel of the
    port runs. Each request carries its reference to the model, its crop
    output is finite and the image is unchanged outside the crop window.
    ``cut_schedule`` cuts the model's test schedule (``cut_test_schedule``).
    Returns latencies, launches and the sampler that ran."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_single_image_diffusion as gen
    from joligen_tpu_torch.scripts.common import load_model_from_file

    served, sopt = load_model_from_file(ckpt)
    if cut_schedule:
        cut_test_schedule(served, sopt)
    seen, infer = [], served.inference

    def recording_inference(batch, **kw):
        seen.append(("ref_A" in batch, kw, infer(batch, **kw)))
        return seen[-1][2]
    served.inference = recording_inference
    secs = []
    reset_launches()                             # the requests start here
    for i in range(n):
        img = os.path.join(root, "trainA", "imgs", f"{i:04d}.png")
        args = gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--img_in", img,
            "--bbox_in", os.path.join(root, "trainA", "bbox", f"{i:04d}.txt"),
            "--ref_in", os.path.join(root, "trainA", "ref", f"{i:04d}.png"),
            "--dir_out", out_dir, "--name", f"{label}{i}", "--seed", str(i),
            *extra])
        t0 = time.perf_counter()
        full, _, _ = gen.inference(args, lmodel=served, lopt=sopt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        with open(os.path.join(out_dir, f"{label}{i}_orig_bbox.json")) as f:
            _check_outside_window(full, img, json.load(f), label)
        had_ref, _, out = seen[-1]
        size = sopt.data_crop_size
        if not (had_ref and out.shape == (1, size, size, 3)
                and np.isfinite(out).all()):
            raise AssertionError(f"{label} request {i} failed")
    launches = read_launches()                   # and end here
    kw = seen[-1][1]
    method, steps, _ = served._sampling_args(kw.get("sampling_method"),
                                             kw.get("num_steps"), None)
    if method == "ddpm":
        steps = served.sched_test.num_timesteps
    log(f"{label}: {n} --ref_in requests ({method}, {steps} steps) "
        f"{[round(t, 4) for t in secs]} s, launches {launches}")
    if launches != _attention_only(launches, 0):
        raise AssertionError(f"{label}: launches {launches}")
    del served
    torch.cuda.empty_cache()
    return {"request_s": secs, "launches": launches, "sampler": method,
            "steps": steps}


def legacy_attention_memory():
    """The ref UNet's legacy attention at ds 4 of a 128 px batch of 16 in
    bf16, without a graph: the bytes of its fp32 logits, and the peak the
    call adds on the card."""
    import torch
    from joligen_tpu_torch.models.modules.unet_ref_attn import \
        legacy_attention

    b, w, n = UNETREF_ATTN_QKV
    heads = w // (3 * 32)
    qkv = torch.randn(UNETREF_ATTN_QKV, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = legacy_attention(qkv, heads)
    torch.cuda.synchronize()
    rec = {"qkv": list(UNETREF_ATTN_QKV), "heads": heads,
           "logits_bytes": b * heads * n * n * 4,
           "peak_added_bytes": torch.cuda.max_memory_allocated() - base}
    log("ref UNet legacy attention at ds 4, batch 16: " + json.dumps(rec))
    del out, qkv
    return rec


def unetref_phase(workdir):
    """``example_ddpm_unetref_viton.json`` as it is (unet_mha_ref_attn,
    147,557,059 parameters; batch 16, 128 px online crops of ONLINE_SIZE px
    images, a reference each from ``trainA/conditions.txt``; EMA; bf16) for
    UNETREF_STEPS steps, then UNETREF_REQUESTS DDIM-10 ``--ref_in``
    requests and one with the config's DDPM sampler on its test schedule
    cut to DDPM_TEST_STEPS steps, from the trained checkpoint. No kernel
    of the port runs on this path
    (the legacy attention is plain torch). Returns (record, launch counts
    per path)."""
    import torch
    from joligen_tpu_torch.models.modules.unet_ref_attn import UNetRefAttn
    from joligen_tpu_torch.tools.synthetic_datasets import write_online_ref

    opt = _example_opt("example_ddpm_unetref_viton.json", workdir,
                       "unetref")
    write_online_ref(opt.dataroot, UNETREF_STEPS * opt.train_batch_size,
                     ONLINE_SIZE, seed=SEED + 31)
    seen, undo = _capture_set_input()
    try:
        model, opt, rec = _train_run(opt, UNETREF_STEPS, 1,
                                     "unetref_viton training",
                                     EXPECTED_PARAMS_UNETREF,
                                     attention_per_step=0)
    finally:
        undo()
    (batch, built), = seen
    if not (isinstance(model.nets["G_A"].inner, UNetRefAttn)
            and model.use_ref and model.use_ema
            and "ref_A" in batch and built["ref"].shape == (16, 128, 128, 3)
            and opt.train_batch_size == 16 and opt.data_crop_size == 128):
        raise AssertionError("unetref_viton is not the example config")
    del model
    torch.cuda.empty_cache()
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    out_dir = os.path.join(workdir, "out_unetref")
    os.makedirs(out_dir)
    rec["requests_ddim"] = _serve_ref(
        ckpt, opt.dataroot, out_dir, UNETREF_REQUESTS,
        ["--sampling_method", "ddim", "--sampling_steps", "10"],
        "unetref_ddim")
    rec["request_ddpm"] = _serve_ref(ckpt, opt.dataroot, out_dir, 1, [],
                                     "unetref_ddpm", cut_schedule=True)
    if (rec["request_ddpm"]["sampler"], rec["request_ddpm"]["steps"]) != (
            "ddpm", DDPM_TEST_STEPS):
        raise AssertionError("the DDPM request did not run the config's "
                             "sampler at the cut test schedule")
    rec["legacy_attention"] = legacy_attention_memory()
    return rec, {"unetref_training": rec["launches"],
                 "unetref_ddim_requests": rec["requests_ddim"]["launches"],
                 "unetref_ddpm_request": rec["request_ddpm"]["launches"]}


def unetref_cross_check():
    """unetref_viton's UNetRefAttn at full width in fp32, batch 1 at 128 px,
    the card against the CPU (``_card_vs_cpu``, no K1), on seeded weights
    with small seeded values in the zero-initialised layers (``proj_out``,
    ``out_proj``, each ResBlock's ``out_conv``): zero layers would leave
    the attention sites and the output out of the check."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import (define_inner_G,
                                                             init_weights)

    opt = _fp32(_example_opt("example_ddpm_unetref_viton.json",
                             tempfile.gettempdir(), "unetref_xcheck"))
    rng = np.random.default_rng(SEED + 33)
    x, ref = (torch.from_numpy(rng.uniform(-1, 1, (1, 128, 128, c)).astype(
        np.float32)) for c in (6, 3))
    emb = torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32))

    def build():
        return init_weights(define_inner_G(opt),
                            torch.Generator().manual_seed(SEED + 34),
                            zero_init_std=0.01)
    err, out = _card_vs_cpu(build, (x, emb), {"ref": ref}, "ref UNet", k1=0)
    if not out.abs().max().item() > 0:
        raise AssertionError("the ref UNet cross-check's output is 0")
    return err


def _vid_opt(example, workdir, name, n_series, frames):
    """A video example config (``_example_opt``) over a synthetic video
    dataset of ``n_series`` series of ``frames`` frames of VID_IMAGE px,
    written here (its test split too); where the config has its train-time
    metrics on (the _ft configs), they run over one test clip
    (``train_nb_img_max_fid``: its frames; ``_metric_test_split``)."""
    from joligen_tpu_torch.tools.synthetic_datasets import write_video

    opt = _example_opt(example, workdir, name)
    write_video(opt.dataroot, frames, VID_IMAGE, seed=SEED + 41,
                n_series=n_series)
    if opt.train_compute_metrics_test:
        opt.train_nb_img_max_fid = opt.data_temporal_number_frames
        _metric_test_split(opt, "video", VID_IMAGE,
                           frames // opt.train_batch_size)
    return opt


def _k1_per_call(opt):
    """K1 launches a denoiser call of ``opt``'s model (and K2 and K3 as
    many a training micro-step): its attention sites, counted on the meta
    device."""
    import torch
    from joligen_tpu_torch.models.diffusion_networks import define_G
    from joligen_tpu_torch.models.modules.motion import TemporalSelfAttention
    from joligen_tpu_torch.models.modules.unet_mha import AttentionBlock

    with torch.device("meta"):
        net = define_G(opt)
    return sum(isinstance(m, (TemporalSelfAttention, AttentionBlock))
               for m in net.modules())


def _serve_vid(ckpt, served, sopt, frames_dir, out_dir, n, extra, label,
               per_call):
    """``n`` clip requests through ``scripts/gen_vid_diffusion`` with the
    loaded model, ``extra`` arguments, the launch counters at 0 just before
    them and read just after: ``per_call`` K1 launches a denoiser call and
    no other kernel. Each writes one clip of frames, finite, of the input
    frames' size. Returns latencies, launches and the sampler that ran."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_vid_diffusion as gen

    nf = sopt.data_temporal_number_frames
    seen, infer = [], served.inference

    def recording_inference(batch, **kw):
        seen.append((kw, infer(batch, **kw)))
        return seen[-1][1]
    served.inference = recording_inference
    secs = []
    reset_launches()                             # the requests start here
    for i in range(n):
        args = gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--dir_in", frames_dir,
            "--dir_out", os.path.join(out_dir, f"{label}{i}"),
            "--max_frames", str(nf), "--seed", str(i), *extra])
        t0 = time.perf_counter()
        written = gen.inference(args, lmodel=served, lopt=sopt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        kw, out = seen[-1]
        size = sopt.data_crop_size
        if not (len(written) == nf and written[0].shape == (VID_IMAGE,
                                                            VID_IMAGE, 3)
                and out.shape == (1, nf, size, size, 3)
                and np.isfinite(out).all()):
            raise AssertionError(f"{label} request {i} failed")
    launches = read_launches()                   # and end here
    served.inference = infer
    method, steps, _ = served._sampling_args(kw.get("sampling_method"),
                                             kw.get("num_steps"), None)
    if method == "ddpm":
        steps = served.sched_test.num_timesteps
    log(f"{label}: {n} clip requests of {nf} frames ({method}, {steps} "
        f"steps) {[round(t, 4) for t in secs]} s, launches {launches}")
    want = _attention_only(launches, {"flash_attention_fwd":
                                      n * steps * per_call})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return {"request_s": secs, "launches": launches, "sampler": method,
            "steps": steps}


def vid_phase(workdir):
    """``example_ddpm_vid_mario.json`` (unet_vid, 132,645,763 parameters;
    clips of 8 frames at 64 px, batch 1; EMA; bf16) with its iter_size of
    32 cut to VID_ITER_SIZE, for VID_STEPS micro-steps, the parameters
    still until the last and moved at it (one update), its checkpoint
    reloaded (the EMA bit
    for bit), VID_DDIM_REQUESTS DDIM-10 clip requests and one with the
    config's DDPM sampler at its test schedule; then the two _ft configs
    (canny sketches with per-frame dropout) one epoch and one DDIM-10
    ``--cond_canny`` request each. Returns (record, launch counts per
    path)."""
    import torch
    from joligen_tpu_torch.models.modules.unet_vid import UNetVid
    from joligen_tpu_torch.scripts.common import load_model_from_file

    opt = _vid_opt(VID_EXAMPLES[0], workdir, "vid", VID_SERIES, VID_FRAMES)
    if opt.train_iter_size != 32:
        raise AssertionError("vid_mario is not the example config")
    opt.train_iter_size = VID_ITER_SIZE
    # the one leaf with a gradient before the first update: every other
    # gradient flows through the zero-initialised out_proj
    watched = "inner.out_proj.weight"
    every = opt.train_iter_size       # micro-steps an update
    marks = {}

    def watch(model, iters, steps):
        if iters in (1, every - 1, every):
            marks[iters] = model.nets["G_A"].state_dict()[watched].clone()
    seen, undo = _capture_set_input()
    try:
        model, opt, rec = _train_run(opt, VID_STEPS, 1, "vid_mario training",
                                     EXPECTED_PARAMS_VID, watch,
                                     attention_per_step=VID_K1_PER_CALL)
    finally:
        undo()
    (batch, built), = seen
    if not (isinstance(model.nets["G_A"].inner, UNetVid) and model.is_video
            and model.use_ema and _k1_per_call(opt) == VID_K1_PER_CALL
            and built["gt"].shape == (1, 8, 64, 64, 3)
            and built["mask"].shape == (1, 8, 64, 64, 1)):
        raise AssertionError("vid_mario is not the example config")
    if not (torch.equal(marks[1], marks[every - 1])
            and not torch.equal(marks[every - 1], marks[every])):
        raise AssertionError(
            f"vid_mario's {watched} did not move at micro-step {every} "
            f"alone: steps 1 to {every - 1} moved it by "
            f"{(marks[every - 1] - marks[1]).abs().max().item()}, step "
            f"{every} by {(marks[every] - marks[every - 1]).abs().max().item()}")
    rec["frames_per_s"] = 8 * opt.train_batch_size / rec["median_warm_step_s"]
    ema = {k: v.detach().cpu().clone()
           for k, v in model.ema_nets["G_A"].state_dict().items()}
    del model
    torch.cuda.empty_cache()

    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    served, sopt = load_model_from_file(ckpt)
    if not all(torch.equal(v.cpu(), ema[k]) for k, v in
               served.ema_nets["G_A"].state_dict().items()):
        raise AssertionError("the reloaded EMA differs from the trained one")
    del ema
    frames_dir = os.path.join(opt.dataroot, "trainA", "vid0")
    out_dir = os.path.join(workdir, "out_vid")
    rec["requests_ddim"] = _serve_vid(
        ckpt, served, sopt, frames_dir, out_dir, VID_DDIM_REQUESTS,
        ["--sampling_steps", "10"], "vid_ddim", VID_K1_PER_CALL)
    cut_test_schedule(served, sopt)
    rec["request_ddpm"] = _serve_vid(ckpt, served, sopt, frames_dir, out_dir,
                                     1, [], "vid_ddpm", VID_K1_PER_CALL)
    if (rec["request_ddpm"]["sampler"], rec["request_ddpm"]["steps"]) != (
            "ddpm", DDPM_TEST_STEPS):
        raise AssertionError("the DDPM request did not run the config's "
                             "sampler at its test schedule")
    del served
    torch.cuda.empty_cache()
    paths = {"vid_training": rec["launches"],
             "vid_ddim_requests": rec["requests_ddim"]["launches"],
             "vid_ddpm_request": rec["request_ddpm"]["launches"]}

    for example, name, n_params in (
            (VID_EXAMPLES[1], "vid_ft", EXPECTED_PARAMS_VID),
            (VID_EXAMPLES[2], "vid_ft_from_image",
             EXPECTED_PARAMS_VID_FT_FROM_IMAGE)):
        with open(os.path.join(ROOT, "examples", example)) as f:
            frames = json.load(f)["data"]["temporal_number_frames"]
        # one series of one clip's frames: an epoch of frames // batch
        # micro-steps
        opt = _vid_opt(example, workdir, name, 1, frames)
        steps = frames // opt.train_batch_size
        per_call = _k1_per_call(opt)
        model, opt, sub = _train_run(opt, steps, 1, f"{name} training",
                                     n_params, attention_per_step=per_call,
                                     eval_k1=_metric_evals_k1(opt, per_call,
                                                              1))
        sub["eval_results"] = _check_eval_results(
            opt, name, model.loop_times["metrics_s"])
        # served from the trained model (vid_mario's run holds the
        # checkpoint round trip)
        sub["request"] = _serve_vid(
            os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth"),
            model, opt, os.path.join(opt.dataroot, "trainA", "vid0"),
            os.path.join(workdir, f"out_{name}"), 1,
            ["--sampling_steps", "10", "--cond_canny"], name, per_call)
        del model
        torch.cuda.empty_cache()
        rec[name] = sub
        paths[f"{name}_training"] = sub["launches"]
        paths[f"{name}_request"] = sub["request"]["launches"]
    return rec, paths


def vid_cross_check():
    """vid_mario's UNetVid at full width in fp32, one clip of 8 frames at
    64 px, the card (K1 81 times, at head dims 8 to 64 on the packed tiling
    and 32 on the plain one) against the CPU (plain attention), on seeded
    weights with small seeded values in the zero-initialised layers (the
    motion modules' ``proj_out``, ``out_proj``, each ResBlock's
    ``out_conv``): zero layers would leave the motion modules out of the
    check."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import (define_inner_G,
                                                             init_weights)

    opt = _fp32(_example_opt(VID_EXAMPLES[0], tempfile.gettempdir(),
                             "vid_xcheck"))
    rng = np.random.default_rng(SEED + 43)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 64, 64, 6)).astype(
        np.float32))
    emb = torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32))

    def build():
        return init_weights(define_inner_G(opt),
                            torch.Generator().manual_seed(SEED + 44),
                            zero_init_std=0.01)
    err, out = _card_vs_cpu(build, (x, emb), {}, "UNetVid",
                            k1=VID_K1_PER_CALL)
    if not out.abs().max().item() > 0:
        raise AssertionError("the UNetVid cross-check's output is 0")
    return err


def _b2b_k1_per_call(opt):
    """K1 launches a b2b denoiser call (and K2 and K3 a step): its JiT
    blocks and temporal attentions, counted on the meta device."""
    import torch
    from joligen_tpu_torch.models.diffusion_networks import define_inner_G
    from joligen_tpu_torch.models.modules.jit import JiTBlock
    from joligen_tpu_torch.models.modules.motion import TemporalSelfAttention

    with torch.device("meta"):
        net = define_inner_G(opt, 6)
    return sum(isinstance(m, (JiTBlock, TemporalSelfAttention))
               for m in net.modules())


def _serve_b2b(ckpt, served, sopt, frames_dir, out_dir, n, clips, extra,
               label, per_call=B2B_K1_PER_CALL):
    """``n`` requests of ``clips`` clips each through
    ``scripts/gen_vid_diffusion`` with the loaded b2b model, ``extra``
    arguments, the launch counters at 0 just before them and read just
    after: ``per_call`` K1 launches a denoiser call (2 * steps - 1 calls
    a clip) and no other kernel. Each writes its frames, finite, of the
    input frames' size; outside each clip's mask the model's output is its
    input (to 1e-6). Returns latencies and launches."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_vid_diffusion as gen

    nf = sopt.data_temporal_number_frames
    seen, infer = [], served.inference

    def recording_inference(batch, **kw):
        seen.append((batch, infer(batch, **kw)))
        return seen[-1][1]
    served.inference = recording_inference
    secs = []
    reset_launches()                             # the requests start here
    for i in range(n):
        args = gen.build_parser().parse_args([
            "--model_in_file", ckpt, "--dir_in", frames_dir,
            "--dir_out", os.path.join(out_dir, f"{label}{i}"),
            "--max_frames", str(nf * clips), "--seed", str(i), *extra])
        t0 = time.perf_counter()
        written = gen.inference(args, lmodel=served, lopt=sopt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not (len(written) == nf * clips
                and written[0].shape == (B2B_IMAGE, B2B_IMAGE, 3)):
            raise AssertionError(f"{label} request {i} wrote "
                                 f"{len(written)} frames")
    launches = read_launches()                   # and end here
    served.inference = infer
    size = sopt.data_crop_size
    kept = 0.0
    for batch, out in seen:
        keep = np.broadcast_to(batch["B_label_mask"] == 0, out.shape)
        if not (out.shape == (1, nf, size, size, 3)
                and np.isfinite(out).all()):
            raise AssertionError(f"{label}: output {out.shape}")
        kept = max(kept, float(np.abs(out - batch["B"])[keep].max()))
    if kept > 1e-6:
        raise AssertionError(f"{label}: the output moved {kept} outside "
                             "the mask")
    calls = n * clips * (2 * served.denoise_timesteps - 1)
    log(f"{label}: {n} requests of {clips} clips of {nf} frames "
        f"({served.denoise_timesteps} Heun steps, {calls} denoiser calls) "
        f"{[round(t, 4) for t in secs]} s, launches {launches}, outside "
        f"the mask moved {kept:.2e}")
    want = _attention_only(launches, {"flash_attention_fwd":
                                      calls * per_call})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return {"request_s": secs, "launches": launches, "clips": clips,
            "denoiser_calls": calls, "outside_mask_max_abs": kept}


def b2b_phase(workdir):
    """``example_b2b_vid_mario.json`` at full width (see the module doc,
    item 11). Returns (record, launch counts per path)."""
    import torch
    from joligen_tpu_torch.models.modules.vit_vid import JiTViD
    from joligen_tpu_torch.scripts.common import load_model_from_file
    from joligen_tpu_torch.tools.synthetic_datasets import write_video

    opt = _example_opt(B2B_EXAMPLE, workdir, "b2b")
    if not (opt.tpu_mesh_fsdp == 2 and opt.data_crop_size == 128
            and opt.data_online_creation_crop_delta_A == 16
            and opt.alg_b2b_denoise_timesteps == 50):
        raise AssertionError("b2b_vid_mario is not the example config")
    opt.tpu_mesh_fsdp = 1                        # one card
    nf = opt.data_temporal_number_frames
    write_video(opt.dataroot, B2B_STEPS * opt.train_batch_size, B2B_IMAGE,
                seed=SEED + 51, n_series=1)
    if _b2b_k1_per_call(opt) != B2B_K1_PER_CALL:
        raise AssertionError("the b2b denoiser's attention sites changed")
    model, opt, rec = _train_run(opt, B2B_STEPS, 1, "b2b_vid_mario training",
                                 EXPECTED_PARAMS_B2B,
                                 attention_per_step=B2B_K1_PER_CALL)
    if not (isinstance(model.nets["G_A"], JiTViD) and model.use_ema
            and model.use_gt_prob == 0.1 and model.lambda_ref_copy == 0.1
            and "G_ref_copy" in rec["losses_last"]):
        raise AssertionError("b2b_vid_mario did not train as configured")
    rec["frames_per_s"] = nf * opt.train_batch_size / \
        rec["median_warm_step_s"]
    ema = {k: v.detach().cpu().clone()
           for k, v in model.ema_nets["G_A"].state_dict().items()}
    del model
    torch.cuda.empty_cache()

    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    served, sopt = load_model_from_file(ckpt)
    if not all(torch.equal(v.cpu(), ema[k]) for k, v in
               served.ema_nets["G_A"].state_dict().items()):
        raise AssertionError("the reloaded EMA differs from the trained one")
    del ema
    # requests over a series of two clips' frames
    serve_root = os.path.join(workdir, "b2b_serve")
    write_video(serve_root, 2 * nf, B2B_IMAGE, seed=SEED + 52, n_series=1)
    frames_dir = os.path.join(serve_root, "trainA", "vid0")
    out_dir = os.path.join(workdir, "out_b2b")
    rec["requests"] = _serve_b2b(ckpt, served, sopt, frames_dir, out_dir,
                                 B2B_REQUESTS, 1, [], "b2b_requests")
    rec["request_autoregressive"] = _serve_b2b(
        ckpt, served, sopt, frames_dir, out_dir, 1, 2, ["--autoregressive"],
        "b2b_autoregressive")
    del served
    torch.cuda.empty_cache()
    return rec, {"b2b_training": rec["launches"],
                 "b2b_requests": rec["requests"]["launches"],
                 "b2b_autoregressive_request":
                     rec["request_autoregressive"]["launches"]}


def b2b_cross_check():
    """b2b_vid_mario's JiTViD at full width in fp32, one clip of 8 frames at
    128 px with per-frame t, the mask descriptor and a frame step, the card
    (K1 16 times: D = 96 on the packed tiling, D = 64 on the plain one)
    against the CPU (plain attention), on seeded weights with small seeded
    values in the zero-initialised layers (adaLN, final_adaLN, final_proj,
    ms_1, fs_1, the motion module's proj_out): zero layers would leave the
    blocks and the motion module out of the check."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import (define_inner_G,
                                                             init_weights)
    from joligen_tpu_torch.models.modules.b2b import mask_size_condition

    opt = _fp32(_example_opt(B2B_EXAMPLE, tempfile.gettempdir(),
                             "b2b_xcheck"))
    rng = np.random.default_rng(SEED + 53)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 128, 128, 6)).astype(
        np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, (1, 8)).astype(np.float32))
    mask = torch.zeros(1, 8, 128, 128, 1)
    mask[:, :, 30:90, 40:100] = 1
    ms = mask_size_condition(mask, 128, 128)

    def build():
        return init_weights(define_inner_G(opt, 6),
                            torch.Generator().manual_seed(SEED + 54),
                            zero_init_std=0.01)
    err, out = _card_vs_cpu(build, (x, t), {
        "mask_size": ms, "temporal_frame_step": torch.tensor([2.0])},
        "JiTViD", k1=B2B_K1_PER_CALL)
    if not out.abs().max().item() > 0:
        raise AssertionError("the JiTViD cross-check's output is 0")
    return err


def _write_ref_png(path, size, seed):
    """A seeded noise image of ``size``² px with a flat square: an object
    reference."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    img[size // 4:3 * size // 4, size // 4:3 * size // 4] = rng.integers(
        0, 256, 3, dtype=np.uint8)
    Image.fromarray(img).save(path)
    return path


def _first_batch(opt):
    """The first batch of ``opt``'s training loader (collated numpy)."""
    from joligen_tpu_torch.data import create_dataloader, create_dataset
    return next(iter(create_dataloader(opt, create_dataset(opt, "train"))))


def b2b_context_phase(workdir):
    """b2b_vid_gc_tokens and b2b_vid_gc_adaln (see the module doc, item 21).
    Returns (record, launch counts per path)."""
    import gc

    import numpy as np
    import torch
    from joligen_tpu_torch.models.modules.vit_vid import JiTViD
    from joligen_tpu_torch.tools.synthetic_datasets import write_video

    ref = _write_ref_png(os.path.join(workdir, "object_ref.png"),
                         B2B_GC_REF_SIZE, SEED + 91)
    per_step = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"), B2B_K1_PER_CALL)
    recs, paths = {}, {}
    for mode, steps in (("tokens", B2B_GC_STEPS),
                        ("adaln", B2B_GC_ADALN_STEPS)):
        # a served model's patched inference is a reference cycle (the b2b
        # phase's, this loop's): collect it, so that a run's peak holds its
        # own model alone
        gc.collect()
        torch.cuda.empty_cache()
        name = f"b2b_vid_gc_{mode}"
        args = ["--tpu_mesh_fsdp", "1", "--alg_b2b_global_context_mode",
                mode]
        if mode == "tokens":
            args += ["--alg_b2b_object_ref_paths", ref]
        opt = _example_opt(B2B_EXAMPLE, workdir, name, args)
        write_video(opt.dataroot, 8, B2B_IMAGE, seed=SEED + 92, n_series=1,
                    phases=("train",))
        if _b2b_k1_per_call(opt) != B2B_K1_PER_CALL:
            raise AssertionError(f"{name}: the denoiser's attention sites "
                                 "changed")
        model, rec = _model_steps(opt, steps, f"{name} training",
                                  EXPECTED_PARAMS_B2B_GC[mode], per_step)
        net = model.nets["G_A"]
        nf = opt.data_temporal_number_frames
        batch = _first_batch(opt)
        if not (isinstance(net, JiTViD) and net.global_context_mode == mode
                and batch["B_global_context"].shape == (1, nf, 128, 128, 3)
                and (mode == "adaln" or (
                    model.object_refs.shape == (1, 1, 64, 64, 3)
                    and net.oref_posemb.shape[1] == 16
                    and net.gc_posemb.shape[1] == 64))):
            raise AssertionError(f"{name} did not build as configured")
        secs = rec["step_s"][1:]
        rec["median_warm_step_s"] = float(np.median(secs))
        rec["frames_per_s"] = nf * opt.train_batch_size / \
            rec["median_warm_step_s"]
        rec["profiled_step"] = _profiled_step(model, opt, batch)
        log(f"{name}: profiled step {rec['profiled_step']}")
        paths[f"{name}_training"] = rec["launches"]
        if mode == "tokens":
            # a dataset batch through model.inference, its context with it
            calls = 2 * model.denoise_timesteps - 1
            reset_launches()
            t0 = time.perf_counter()
            out = model.inference(batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
            want = _attention_only(launches, {"flash_attention_fwd":
                                              calls * B2B_K1_PER_CALL})
            keep = np.broadcast_to(batch["B_label_mask"] == 0, out.shape)
            kept = float(np.abs(out - batch["B"])[keep].max())
            if not (out.shape == batch["B"].shape and np.isfinite(out).all()
                    and launches == want and kept <= 1e-6):
                raise AssertionError(f"{name}: inference with its context "
                                     f"{out.shape}, launches {launches}, "
                                     f"outside the mask moved {kept}")
            rec["inference_with_context"] = {"request_s": secs,
                                             "launches": launches,
                                             "denoiser_calls": calls}
            log(f"{name}: model.inference with the batch's context, "
                f"{calls} denoiser calls, {secs:.3f} s, launches {launches}")
            paths[f"{name}_inference"] = launches
            # a clip request through the script, from the trained model
            rec["request"] = _serve_b2b(
                os.path.join(opt.checkpoints_dir, "unsaved.pth"), model, opt,
                os.path.join(opt.dataroot, "trainA", "vid0"),
                os.path.join(workdir, f"out_{name}"), 1, 1, [],
                f"{name}_request")
            paths[f"{name}_request"] = rec["request"]["launches"]
        recs[name] = rec
        del model, net
    gc.collect()
    torch.cuda.empty_cache()
    return recs, paths


def cut_video_phase(workdir):
    """The video variant of the bdd100k tutorial (see the module doc, item
    21). Returns (record, launch counts per path)."""
    import numpy as np
    import torch
    from joligen_tpu_torch.options import TrainOptions
    from joligen_tpu_torch.scripts import gen_single_image as gen

    root = _video_series(workdir)
    os.makedirs(os.path.join(root, "trainB"), exist_ok=True)
    shutil.copy(os.path.join(root, "trainA", "paths.txt"),
                os.path.join(root, "trainB", "paths.txt"))
    opt = TrainOptions().parse_cli([
        *CUT_VIDEO_ARGS, "--train_batch_size", str(CUT_VIDEO_BATCH),
        "--dataroot", root, "--data_relative_paths",
        "--checkpoints_dir", os.path.join(workdir, "cut_video_ckpt"),
        "--name", "cut_video"])
    if not (opt.data_temporal_number_frames == 5
            and opt.D_temporal_every == 4 and opt.f_s_net == "vgg"
            and opt.data_temporal_frame_step == 30):
        raise AssertionError("cut_video_clear2snowy is not at the "
                             "options' defaults")
    model, rec = _model_steps(opt, CUT_VIDEO_STEPS,
                              "cut_video_clear2snowy training",
                              EXPECTED_PARAMS_CUT_VIDEO["G_A"], {})
    counts = model.param_count()
    rec["parameters_per_net"] = counts
    if any(counts[k] != v for k, v in EXPECTED_PARAMS_CUT_VIDEO.items()):
        raise AssertionError(f"cut_video_clear2snowy: parameters "
                             f"{counts}")
    frames = opt.train_batch_size * opt.data_temporal_number_frames
    on = [i for i in range(CUT_VIDEO_STEPS) if i % 4 == 0]
    d_temporal = [d["D_D_B_temporal"] for d in rec["losses_per_step"]]
    if not (all(d_temporal[i] > 0 for i in on) and all(
            d_temporal[i] == 0 for i in range(CUT_VIDEO_STEPS)
            if i not in on)):
        raise AssertionError(f"the temporal D's cadence: {d_temporal}")
    rec["temporal_d_steps"] = on
    rec["step_s_with_temporal_d"] = [rec["step_s"][i] for i in on]
    rec["step_s_without_temporal_d"] = [
        rec["step_s"][i] for i in range(CUT_VIDEO_STEPS) if i not in on]
    rec["frames_per_s_without_temporal_d"] = frames / float(
        np.median(rec["step_s_without_temporal_d"]))
    batch = _first_batch(opt)
    # G's step count is 5: the profiled step's warm, timed and traced
    # steps are 5-7, off the cadence; step 8, timed below, is on it
    rec["profiled_step_without_temporal_d"] = _profiled_step(
        model, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.optimize_parameters(batch)            # step 8: with it
    torch.cuda.synchronize()
    rec["warm_step_s_with_temporal_d"] = time.perf_counter() - t0
    if not float(model.loss_log["D_D_B_temporal"]) > 0:
        raise AssertionError("step 8 did not train the temporal D")
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"cut_video_clear2snowy: {frames} frames a step, steps "
        f"{[round(t, 4) for t in rec['step_s']]} s (the temporal D at "
        f"{on}), warm step with it "
        f"{rec['warm_step_s_with_temporal_d']:.4f} s, profiled step "
        f"without it {rec['profiled_step_without_temporal_d']}, peak "
        f"{rec['max_memory_allocated']} B")
    img = os.path.join(root, "trainA", "vid0", "frame_000.png")
    reset_launches()
    t0 = time.perf_counter()
    out = gen.inference(gen.parser().parse_args([
        "--model_in_file", "unsaved.pth", "--img_in", img,
        "--img_out", os.path.join(workdir, "out_cut_video.png")]), model,
        opt)
    torch.cuda.synchronize()
    req = {"request_s": time.perf_counter() - t0,
           "launches": read_launches()}
    if not (out.shape == (MAT_VIDEO_IMAGE, MAT_VIDEO_IMAGE, 3)
            and np.isfinite(out).all()):
        raise AssertionError(f"cut_video request: {out.shape}")
    rec["request"] = req
    log(f"cut_video_clear2snowy: a request on one frame "
        f"{req['request_s']:.4f} s, launches {req['launches']}")
    del model
    torch.cuda.empty_cache()
    return {"cut_video_clear2snowy": rec}, {
        "cut_video_training": rec["launches"],
        "cut_video_request": req["launches"]}


def video_context_cross_check():
    """The fp32 nets of this phase at full width, card against CPU: JiTViD
    in ``tokens`` mode with one reference (K1 16 times: S = 176 on the
    plain tiling), one clip of 8 frames at 128 px with a context a frame,
    on seeded weights with small seeded values in the zero-initialised
    layers; the temporal D at 256 px on one clip of CUT_VIDEO_FRAMES frames
    (no kernel), its LSTM biases seeded too."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import (define_inner_G,
                                                             init_weights)
    from joligen_tpu_torch.models.gan_networks import define_D
    from joligen_tpu_torch.models.cut_model import init_discriminator
    from joligen_tpu_torch.options import TrainOptions

    opt = _fp32(_example_opt(B2B_EXAMPLE, tempfile.gettempdir(),
                             "b2b_gc_xcheck", [
                                 "--alg_b2b_global_context_mode", "tokens",
                                 "--alg_b2b_object_ref_paths", "ref.png"]))
    rng = np.random.default_rng(SEED + 94)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    x, gc = uniform(1, 8, 128, 128, 6), uniform(1, 8, 128, 128, 3)
    ref = uniform(1, 1, 64, 64, 3)
    t = torch.from_numpy(rng.uniform(0, 1, (1, 8)).astype(np.float32))

    def build():
        return init_weights(define_inner_G(opt, 6),
                            torch.Generator().manual_seed(SEED + 95),
                            zero_init_std=0.01)
    err_g, out = _card_vs_cpu(build, (x, t), {
        "global_context": gc, "object_ref": ref}, "JiTViD with context",
        k1=B2B_K1_PER_CALL)
    if not out.abs().max().item() > 0:
        raise AssertionError("the JiTViD cross-check's output is 0")

    dopt = TrainOptions().parse_cli([*CUT_VIDEO_ARGS, "--dataroot", "x",
                                     "--tpu_bf16", "false"])
    clip = uniform(1, CUT_VIDEO_FRAMES, 256, 256, 3)

    def build_d():
        net = define_D(dopt, ["temporal"])["D_B_temporal"]
        init_discriminator("D_B_temporal", net,
                           torch.Generator().manual_seed(SEED + 96), dopt)
        with torch.no_grad():
            for i in range(net.n_scales):
                getattr(net, f"lstm_b{i}").normal_(
                    0.0, 0.1, generator=torch.Generator().manual_seed(i))
        return net
    err_d, out_d = _card_vs_cpu(build_d, (clip,), {}, "temporal D", k1=0)
    return {"jitvid_tokens_ref_max_abs_err": err_g,
            "temporal_d_max_abs_err": err_d,
            "temporal_d_logits": list(out_d.shape)}


def _mat_steps(model, dev, r1, n):
    """``n`` synchronized steps of ``model`` on the prepared batch ``dev``,
    each with (``r1``) or without R1: D's step count is set to a multiple
    of ``d_reg_every`` or past one. Returns the times (s)."""
    import torch
    secs = []
    for _ in range(n):
        state = model.states["D"]
        k = state.step // model.r1_every + 1
        state.step = k * model.r1_every + (0 if r1 else 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model.optimize_prepared(dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if (float(losses["D_r1"]) > 0) != r1:
            raise AssertionError(f"MAT step with r1={r1}: D_r1 "
                                 f"{float(losses['D_r1'])}")
    return secs


def _serve_mat(ckpt, data, out_dir):
    """Two image requests (truncation 1.0 and 0.7, seed 0) through
    ``scripts/gen_single_image_mat`` and one of MAT_FRAMES frames through
    ``scripts/gen_video_mat`` from one load of ``ckpt``, the launch counters
    at 0 just before them and read just after (no kernel of the port runs).
    At ``model.inference`` every known pixel is the input's to
    MAT_KNOWN_TOL and every output finite."""
    import numpy as np
    import torch
    from joligen_tpu_torch.scripts import gen_single_image_mat as gen_img
    from joligen_tpu_torch.scripts import gen_video_mat as gen_vid
    from joligen_tpu_torch.scripts.common import load_model_from_file

    served, sopt = load_model_from_file(ckpt)
    infer, errs = served.inference, []

    def checked_inference(batch, **kw):
        out = infer(batch, **kw)
        keep = np.broadcast_to(np.asarray(batch["B_label_mask"]) == 0,
                               out.shape)
        errs.append(float(np.abs(out - batch["B"])[keep].max()))
        if not (np.isfinite(out).all() and errs[-1] <= MAT_KNOWN_TOL):
            raise AssertionError(f"MAT request: known pixels off by "
                                 f"{errs[-1]}")
        return out
    served.inference = checked_inference
    imgs = os.path.join(data, "trainA", "imgs")
    masks = os.path.join(data, "trainA", "masks")
    frames = os.path.join(out_dir, "frames")
    frame_masks = os.path.join(out_dir, "frame_masks")
    os.makedirs(frames)
    os.makedirs(frame_masks)
    for i in range(MAT_FRAMES):
        shutil.copy(os.path.join(imgs, f"{i:04d}.png"), frames)
        shutil.copy(os.path.join(masks, f"{i:04d}.png"), frame_masks)
    rec = {"image_request_s": {}}
    reset_launches()                             # the requests start here
    for psi in ("1.0", "0.7"):
        args = gen_img.parser().parse_args([
            "--model_in_file", ckpt,
            "--img_in", os.path.join(imgs, "0000.png"),
            "--mask_in", os.path.join(masks, "0000.png"),
            "--img_out", os.path.join(out_dir, f"req_{psi}.png"),
            "--truncation_psi", psi, "--seed", "0"])
        t0 = time.perf_counter()
        out = gen_img.inference(args, served, sopt)
        torch.cuda.synchronize()
        rec["image_request_s"][psi] = time.perf_counter() - t0
        size = sopt.data_crop_size
        if out.shape != (size, size, 3):
            raise AssertionError(f"MAT request: output {out.shape}")
    args = gen_vid.build_parser().parse_args([
        "--model_in_file", ckpt, "--dir_in", frames,
        "--mask_dir_in", frame_masks,
        "--dir_out", os.path.join(out_dir, "video"), "--seed", "0"])
    t0 = time.perf_counter()
    outs = gen_vid.inference(args, served, sopt)
    torch.cuda.synchronize()
    rec["video_request_s"] = time.perf_counter() - t0
    rec["launches"] = read_launches()            # and end here
    if len(outs) != MAT_FRAMES or any(rec["launches"].values()):
        raise AssertionError(f"MAT video request: {len(outs)} frames, "
                             f"launches {rec['launches']}")
    rec["known_pixel_max_abs_err"] = max(errs)
    rec["model_inference_calls"] = len(errs)
    served.inference = infer
    del served
    torch.cuda.empty_cache()
    log("mat requests: " + json.dumps(rec))
    return rec


def mat_phase(workdir):
    """``example_mat_inpainting.json`` at full width (see the module doc,
    item 12). Returns (record, launch counts per path)."""
    import torch
    from joligen_tpu_torch.tools.synthetic_datasets import write_labeled

    opt = _example_opt(MAT_EXAMPLE, workdir, "mat")
    if not (opt.data_crop_size == 256 and opt.train_batch_size == 8
            and opt.G_ngf == 64 and opt.D_ndf == 64 and opt.tpu_bf16
            and opt.alg_mat_first_stage_dim == 180
            and opt.alg_mat_d_reg_every == 16):
        raise AssertionError("mat_inpainting is not the example config")
    write_labeled(opt.dataroot, MAT_STEPS * opt.train_batch_size, 256,
                  seed=SEED + 61)
    r1_losses = []

    def watch(model, iters, steps):
        r1_losses.append(float(model.loss_log["D_r1"]))
    model, opt, rec = _train_run(opt, MAT_STEPS, 1, "mat_inpainting training",
                                 EXPECTED_PARAMS_MAT["G_A"], hook=watch,
                                 attention_per_step=0)
    rec["parameters_per_net"] = model.param_count()
    if rec["parameters_per_net"] != EXPECTED_PARAMS_MAT:
        raise AssertionError(f"MAT parameters {rec['parameters_per_net']}")
    if not (r1_losses[0] > 0 and not any(r1_losses[1:])):
        raise AssertionError(f"MAT R1 losses by step {r1_losses}")
    rec["D_r1_by_step"] = r1_losses
    # the R1 and the non-R1 step again, warm, on one batch
    from joligen_tpu_torch.data import create_dataloader, create_dataset
    loader = create_dataloader(opt, create_dataset(opt, "train"))
    dev = model.prepare_batch(next(iter(loader)))
    torch.cuda.reset_peak_memory_stats()
    _mat_steps(model, dev, True, 1)
    rec["r1_step_s"] = _mat_steps(model, dev, True, MAT_TIMED)
    rec["non_r1_step_s"] = _mat_steps(model, dev, False, MAT_TIMED)
    rec["max_memory_allocated_r1"] = torch.cuda.max_memory_allocated()
    log(f"mat_inpainting: warm R1 steps {rec['r1_step_s']} s, non-R1 "
        f"{rec['non_r1_step_s']} s, peak {rec['max_memory_allocated_r1']} B")
    del model, dev
    torch.cuda.empty_cache()

    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    out_dir = os.path.join(workdir, "out_mat")
    os.makedirs(out_dir)
    rec["requests"] = _serve_mat(ckpt, opt.dataroot, out_dir)
    return rec, {"mat_training": rec["launches"],
                 "mat_requests": rec["requests"]["launches"]}


def mat_cross_check():
    """The fp32 MAT generator (noise mode none: no draw, the mul_maps 0.5)
    and D at full width, batch 1 at 256 px, TF32 off, card against CPU on
    the same seeded weights (the ToRGB weights scaled by 0.1, so that the
    composed output is not clamped), to MAT_TOL of the largest output; the
    R1 penalty's D gradient at MAT_R1_SIZE px, base 16, batch 4, card
    against CPU, to MAT_TOL of the largest gradient."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.mat_model import r1_penalty
    from joligen_tpu_torch.models.modules.mat import (MATDiscriminator,
                                                      MATGenerator, init_mat)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(SEED + 62)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(
        np.float32))
    mask = torch.ones(1, 256, 256, 1)
    mask[:, 40:150, 60:200] = 0.0
    z = torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32))
    g = torch.Generator().manual_seed(SEED + 63)
    netG = init_mat(MATGenerator(256, 3, 64, 512, 512, stage1_dim=180), g)
    netD = init_mat(MATDiscriminator(256, 3, 64), g)
    with torch.no_grad():
        for n, p in netG.named_parameters():
            if "rgb" in n and n.endswith("weight"):
                p.mul_(0.1)
    outs = {}
    for dev in ("cpu", "cuda"):
        netG, netD = netG.to(dev), netD.to(dev)
        a = [t.to(dev) for t in (img, mask, z)]
        with torch.inference_mode():
            fake, stg1 = netG(*a, return_stg1=True)
            lg = torch.cat(netD(fake, a[1], stg1), dim=-1)
        outs[dev] = [t.cpu() for t in (fake, stg1, lg)]
    rec = {}
    for i, name in enumerate(("G_output", "G_stage1", "D_logits")):
        want, got = outs["cpu"][i], outs["cuda"][i]
        rec[name] = {"max_abs_err": (got - want).abs().max().item(),
                     "max_abs": want.abs().max().item()}
        if not (torch.isfinite(got).all() and rec[name]["max_abs_err"]
                <= MAT_TOL * rec[name]["max_abs"]):
            raise AssertionError(f"MAT cross-check {name}: {rec[name]}")
    hole = (mask[..., 0] == 0)[..., None].expand_as(outs["cpu"][0])
    rec["G_unclamped_hole_share"] = (outs["cpu"][0][hole].abs() < 0.999) \
        .float().mean().item()
    del netG, netD
    # the R1 penalty's D gradient
    d = init_mat(MATDiscriminator(MAT_R1_SIZE, 3, 16), g)
    real = torch.from_numpy(rng.uniform(-1, 1, (4, MAT_R1_SIZE, MAT_R1_SIZE,
                                                3)).astype(np.float32))
    m = torch.ones(4, MAT_R1_SIZE, MAT_R1_SIZE, 1)
    m[:, 10:40, 20:50] = 0.0
    grads = {}
    for dev in ("cpu", "cuda"):
        d = d.to(dev)
        x = real.to(dev).requires_grad_(True)
        lr_, lr1 = d(x, m.to(dev), x)
        pen = r1_penalty(lr_.sum() + lr1.sum(), x)
        # the last dense bias leaves the input gradient, so the penalty,
        # as it is: its gradient is 0, as in JAX
        gs = torch.autograd.grad(pen, list(d.parameters()), allow_unused=True)
        grads[dev] = (pen.item(), [torch.zeros(p.shape) if t is None
                                   else t.cpu()
                                   for t, p in zip(gs, d.parameters())])
    scale = max(t.abs().max().item() for t in grads["cpu"][1])
    err = max((a - b).abs().max().item()
              for a, b in zip(grads["cuda"][1], grads["cpu"][1]))
    rec["r1"] = {"penalty_cuda": grads["cuda"][0],
                 "penalty_cpu": grads["cpu"][0],
                 "grad_max_abs_err": err, "grad_max_abs": scale}
    log("mat cross-check fp32 card vs CPU: " + json.dumps(rec))
    if not (err <= MAT_TOL * scale and abs(grads["cuda"][0] - grads["cpu"][0])
            <= MAT_TOL * abs(grads["cpu"][0])):
        raise AssertionError(f"MAT cross-check R1: {rec['r1']}")
    return rec


def _model_steps(opt, n, label, expected_params, per_step):
    """``create_model(opt)`` and ``n`` of its own steps
    (``optimize_parameters``) over the first ``n`` batches of its dataset,
    with no save: the launch counters at 0 just before the steps and read
    just after, ``per_step`` launches of each attention kernel a step; the
    parameter count, bf16 and finite losses checked. Returns (model,
    record)."""
    import numpy as np
    import torch
    from joligen_tpu_torch.data import create_dataloader, create_dataset
    from joligen_tpu_torch.models import create_model

    loader = create_dataloader(opt, create_dataset(opt, "train"))
    opt.steps_per_epoch = max(1, len(loader))
    torch.cuda.reset_peak_memory_stats()
    model = create_model(opt, phase="train")
    n_params = model.param_count()["G_A"]
    if n_params != expected_params or model.device_dtype != torch.bfloat16:
        raise AssertionError(f"{label}: {n_params} parameters in "
                             f"{model.device_dtype}")
    batches, secs, losses = iter(loader), [], []
    reset_launches()                             # the steps start here
    for _ in range(n):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.optimize_parameters(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in model.loss_log.items()})
    launches = read_launches()                   # and end here
    want = _attention_only(launches, {k: n * v for k, v in per_step.items()})
    if launches != want or not all(np.isfinite(v) for d in losses
                                   for v in d.values()):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}; losses {losses}")
    rec = {"batch": opt.train_batch_size, "steps": n,
           "parameters": n_params, "launches": launches, "step_s": secs,
           "losses_last": losses[-1], "losses_per_step": losses,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"{label}: {n} steps of the model, {n_params} parameters, "
        f"launches {launches}, steps {[round(t, 4) for t in secs]} s, "
        f"peak {rec['max_memory_allocated']} B, losses {losses[-1]}")
    return model, rec


def _mat_video_opt(workdir, name, args=()):
    """``example_mat_inpainting.json`` + MAT_VIDEO_ARGS (+ ``args``) over
    ``_video_series(workdir)``."""
    opt = _example_opt(MAT_EXAMPLE, workdir, "mat_video",
                       MAT_VIDEO_ARGS + list(args))
    opt.name = f"smoke_{name}"
    if not (opt.data_crop_size == 256 and opt.train_batch_size == 8
            and opt.G_ngf == 64 and opt.tpu_bf16
            and opt.data_temporal_number_frames == 5
            and opt.alg_mat_motion_num_transformer_blocks == 2
            and opt.alg_mat_motion_max_frames == 8
            and opt.alg_mat_d_reg_every == 16):
        raise AssertionError("mat_video is not the example config at the "
                             "options' defaults")
    opt.train_batch_size = MAT_VIDEO_BATCH
    opt.dataroot = _video_series(workdir)
    return opt


def _video_series(workdir):
    """One synthetic series of MAT_VIDEO_SERIES frames of MAT_VIDEO_IMAGE px
    with a box file each, under ``workdir``, written by the first phase
    that reads it (cut video's, then video MAT's)."""
    from joligen_tpu_torch.tools.synthetic_datasets import write_video

    root = os.path.join(workdir, "data_mat_video")
    if not os.path.isdir(root):
        write_video(root, MAT_VIDEO_SERIES, MAT_VIDEO_IMAGE, seed=SEED + 81,
                    n_series=1, phases=("train",))
    return root


def mat_video_phase(workdir):
    """Video MAT at full width (see the module doc, item 17): an epoch
    through ``launch_training``, a clip through ``model.inference`` and one
    through ``scripts/gen_video_mat``. Returns (record, launch counts per
    path)."""
    import numpy as np
    import torch
    from PIL import Image
    from joligen_tpu_torch.data import create_dataloader, create_dataset
    from joligen_tpu_torch.scripts import gen_video_mat as gen_vid
    from joligen_tpu_torch.scripts.common import load_model_from_file

    opt = _mat_video_opt(workdir, "mat_video")
    if opt.alg_mat_motion_num_attention_heads != 8:
        raise AssertionError("mat_video: not the options' 8 motion heads")
    steps = MAT_VIDEO_SERIES // opt.train_batch_size
    r1_losses = []

    def watch(model, iters, n):
        r1_losses.append(float(model.loss_log["D_r1"]))
    model, opt, rec = _train_run(opt, steps, 1, "mat_video training",
                                 EXPECTED_PARAMS_MAT_VIDEO["G_A"],
                                 hook=watch, attention_per_step=MAT_VIDEO_K1)
    rec["parameters_per_net"] = model.param_count()
    net = model.nets["G_A"]
    if not (rec["parameters_per_net"] == EXPECTED_PARAMS_MAT_VIDEO
            and net.frames == 5 and net.motion.n_blocks == 2
            and net.motion.block0.attn0.heads == 8):
        raise AssertionError(f"mat_video: {rec['parameters_per_net']}")
    if not (r1_losses[0] > 0 and not any(r1_losses[1:])):
        raise AssertionError(f"mat_video R1 losses by step {r1_losses}")
    rec["D_r1_by_step"] = r1_losses
    rec["frames_per_s"] = 5 * opt.train_batch_size / rec["median_warm_step_s"]
    del model, net
    torch.cuda.empty_cache()

    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "latest_net_G_A.pth")
    served, sopt = load_model_from_file(ckpt)
    clip = next(iter(create_dataloader(sopt, create_dataset(sopt, "train"),
                                       batch_size=1)))
    reset_launches()                             # the requests start here
    t0 = time.perf_counter()
    out = served.inference(clip, seed=0)
    torch.cuda.synchronize()
    rec["clip_request_s"] = time.perf_counter() - t0
    clip_launches = read_launches()
    keep = np.broadcast_to(np.asarray(clip["B_label_mask"])[:, -1] == 0,
                           out[:, -1].shape)
    rec["clip_known_max_abs_err"] = float(
        np.abs(out[:, -1] - clip["B"][:, -1])[keep].max())
    if not (out.shape == (1, 5, 256, 256, 3) and np.isfinite(out).all()
            and np.array_equal(out[:, :-1], clip["B"][:, :-1])
            and rec["clip_known_max_abs_err"] <= MAT_KNOWN_TOL
            and clip_launches == _attention_only(
                clip_launches, {"flash_attention_fwd": MAT_VIDEO_K1})):
        raise AssertionError(f"mat_video clip request: {out.shape}, "
                             f"launches {clip_launches}")
    # the same checkpoint frame by frame through the script
    frames_dir = os.path.join(sopt.dataroot, "trainA", "vid0")
    masks_dir = os.path.join(workdir, "mat_video_masks")
    os.makedirs(masks_dir)
    for i in range(MAT_FRAMES):
        m = np.zeros((MAT_VIDEO_IMAGE, MAT_VIDEO_IMAGE), np.uint8)
        m[200:360, 180 + 10 * i:380 + 10 * i] = 255
        Image.fromarray(m).save(os.path.join(masks_dir, f"m{i:03d}.png"))
    args = gen_vid.build_parser().parse_args([
        "--model_in_file", ckpt, "--dir_in", frames_dir,
        "--mask_dir_in", masks_dir, "--max_frames", str(MAT_FRAMES),
        "--dir_out", os.path.join(workdir, "out_mat_video"), "--seed", "0"])
    reset_launches()
    t0 = time.perf_counter()
    outs = gen_vid.inference(args, served, sopt)
    torch.cuda.synchronize()
    rec["script_request_s"] = time.perf_counter() - t0
    script_launches = read_launches()
    if len(outs) != MAT_FRAMES or any(script_launches.values()):
        raise AssertionError(f"mat_video script: {len(outs)} frames, "
                             f"launches {script_launches}")
    del served
    torch.cuda.empty_cache()
    log(f"mat_video: clip request {rec['clip_request_s']:.4f} s (K1 "
        f"{clip_launches['flash_attention_fwd']}), known pixels "
        f"{rec['clip_known_max_abs_err']:.2e}; {MAT_FRAMES} frames through "
        f"gen_video_mat {rec['script_request_s']:.4f} s")
    return rec, {"mat_video_training": rec["launches"],
                 "mat_video_clip_request": clip_launches,
                 "mat_video_script_request": script_launches}


def mat_video_cross_check():
    """The fp32 video MAT generator at full width (base 64, 8 motion
    heads, 2 blocks) on one clip of 5 frames at 256 px, noise mode none,
    and D on its last frame, TF32 off, card (K1 MAT_VIDEO_K1 times) against
    CPU on the same seeded weights (the ToRGB weights scaled by 0.1, the
    motion module's zero proj_out seeded small), to MAT_TOL of the largest
    output."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.modules.mat import (MATDiscriminator,
                                                      MATGenerator, init_mat)
    from joligen_tpu_torch.ops import flash_attention as fa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(SEED + 82)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 256, 256, 3)).astype(
        np.float32))
    mask = torch.ones(1, 5, 256, 256, 1)
    mask[:, -1, 40:150, 60:200] = 0.0
    z = torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32))
    g = torch.Generator().manual_seed(SEED + 83)
    netG = init_mat(MATGenerator(256, 3, 64, 512, 512, stage1_dim=180,
                                 frames=5, motion_heads=8, motion_blocks=2,
                                 motion_max_frames=8), g)
    netD = init_mat(MATDiscriminator(256, 3, 64), g)
    with torch.no_grad():
        for n, p in netG.named_parameters():
            if "rgb" in n and n.endswith("weight"):
                p.mul_(0.1)
        for p in netG.motion.proj_out.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.01)
    outs = {}
    for dev in ("cpu", "cuda"):
        netG, netD = netG.to(dev), netD.to(dev)
        a = [t.to(dev) for t in (img, mask, z)]
        before = fa.LAUNCHES["flash_attention_fwd"]
        with torch.inference_mode():
            fake, stg1 = netG(*a, return_stg1=True)
            lg = torch.cat(netD(fake[:, -1], a[1][:, -1], stg1[:, -1]),
                           dim=-1)
        launched = fa.LAUNCHES["flash_attention_fwd"] - before
        if launched != (MAT_VIDEO_K1 if dev == "cuda" else 0):
            raise AssertionError(f"mat_video cross-check: {dev} launched "
                                 f"K1 {launched} times")
        outs[dev] = [t.cpu() for t in (fake[:, -1], stg1[:, -1], lg)]
    rec = {}
    for i, name in enumerate(("G_output", "G_stage1", "D_logits")):
        want, got = outs["cpu"][i], outs["cuda"][i]
        rec[name] = {"max_abs_err": (got - want).abs().max().item(),
                     "max_abs": want.abs().max().item()}
        if not (torch.isfinite(got).all() and rec[name]["max_abs_err"]
                <= MAT_TOL * rec[name]["max_abs"]):
            raise AssertionError(f"mat_video cross-check {name}: "
                                 f"{rec[name]}")
    log("mat_video cross-check fp32 card vs CPU: " + json.dumps(rec))
    return rec


def wide_transformer_phase(workdir):
    """The wide head dims on their paths (see the module doc, item 17):
    b2b_vid_jith (its steps and a clip request), then the short runs of
    video MAT at 4 motion heads, b2b_vid_mario with JiT-L/16 and the image
    JiT-H/16 under b2b at 256 px. Their data under ``/dev/shm`` where the
    machine has it. Returns (records, launch counts per path)."""
    shm = _shm_workdir(workdir, "wide")
    try:
        return _wide_runs(workdir, shm)
    finally:
        shutil.rmtree(shm, ignore_errors=True)


def _wide_runs(workdir, shm):
    import torch
    from joligen_tpu_torch.tools.synthetic_datasets import (write_labeled,
                                                            write_video)

    recs, paths = {}, {}

    def each(k1):
        return {"flash_attention_fwd": k1, "flash_attention_bwd_dq": k1,
                "flash_attention_bwd_dkv": k1}

    # b2b_vid_jith: the b2b example with JiT-H/16, WIDE_STEPS steps and a
    # 50-step clip request from the trained model
    opt = _example_opt(B2B_EXAMPLE, shm, "b2b_jith",
                       ["--tpu_mesh_fsdp", "1", "--G_vit_variant",
                        "JiT-H/16"])
    if _b2b_k1_per_call(opt) != JITH_VID_K1:
        raise AssertionError("b2b_vid_jith's attention sites changed")
    write_video(opt.dataroot, B2B_STEPS * opt.train_batch_size, B2B_IMAGE,
                seed=SEED + 91, n_series=1)
    model, rec = _model_steps(opt, WIDE_STEPS, "b2b_vid_jith",
                              EXPECTED_PARAMS_JITH_VID, each(JITH_VID_K1))
    net = model.nets["G_A"]
    if not (net.hidden_size // net.num_heads == 80
            and net.hidden_size // net.motion.block0.attn0.heads == 160):
        raise AssertionError("b2b_vid_jith: not head dims 80 and 160")
    serve_root = os.path.join(shm, "b2b_jith_serve")
    write_video(serve_root, opt.data_temporal_number_frames, B2B_IMAGE,
                seed=SEED + 92, n_series=1)
    rec["request"] = _serve_b2b(
        "unused", model, opt, os.path.join(serve_root, "trainA", "vid0"),
        os.path.join(shm, "out_b2b_jith"), 1, 1, [], "b2b_vid_jith_request",
        per_call=JITH_VID_K1)
    del model, net
    torch.cuda.empty_cache()
    recs["b2b_vid_jith"] = rec
    paths["b2b_vid_jith_steps"] = rec["launches"]
    paths["b2b_vid_jith_request"] = rec["request"]["launches"]

    # b2b_vid_mario with JiT-L/16: SHORT_STEPS steps on the same clips
    lopt = _example_opt(B2B_EXAMPLE, shm, "b2b_jitl",
                        ["--tpu_mesh_fsdp", "1", "--G_vit_variant",
                         "JiT-L/16"])
    lopt.dataroot = opt.dataroot
    if _b2b_k1_per_call(lopt) != JITL_VID_K1:
        raise AssertionError("b2b_vid_jitl's attention sites changed")
    model, rec = _model_steps(lopt, SHORT_STEPS, "b2b_vid_jitl",
                              EXPECTED_PARAMS_JITL_VID, each(JITL_VID_K1))
    del model
    torch.cuda.empty_cache()
    recs["b2b_vid_jitl"] = rec
    paths["b2b_vid_jitl_steps"] = rec["launches"]

    # the image JiT-H/16 under b2b at 256 px
    iopt = _example_opt(IMAGE_EXAMPLE, shm, "b2b_image_jith",
                        B2B_IMAGE_ARGS + ["--G_vit_variant", "JiT-H/16"])
    write_labeled(iopt.dataroot, SHORT_STEPS * iopt.train_batch_size, 256,
                  seed=SEED + 93)
    model, rec = _model_steps(iopt, SHORT_STEPS, "b2b_image_jith",
                              EXPECTED_PARAMS_JITH_IMAGE, each(JITH_IMAGE_K1))
    del model
    torch.cuda.empty_cache()
    recs["b2b_image_jith"] = rec
    paths["b2b_image_jith_steps"] = rec["launches"]

    # video MAT at 4 motion heads (D = 128) on mat_video's clips
    mopt = _mat_video_opt(workdir, "mat_video_4h", [
        "--alg_mat_motion_num_attention_heads", "4"])
    model, rec = _model_steps(mopt, SHORT_STEPS, "mat_video_4h",
                              EXPECTED_PARAMS_MAT_VIDEO["G_A"],
                              each(MAT_VIDEO_K1))
    if model.nets["G_A"].motion.block0.attn0.heads != 4:
        raise AssertionError("mat_video_4h: not 4 motion heads")
    del model
    torch.cuda.empty_cache()
    recs["mat_video_4h"] = rec
    paths["mat_video_4h_steps"] = rec["launches"]
    return recs, paths


def _jit_k1_per_call(net):
    """K1 launches a JiT call: one a block."""
    from joligen_tpu_torch.models.modules.jit import JiTBlock
    return sum(isinstance(m, JiTBlock) for m in net.modules())


def image_transformer_phase(workdir):
    """The image transformer trunks (see the module doc, item 13):
    b2b_image_256, b2b_lora, palette_vit_128, palette_hdit_128. Their data
    and checkpoints (~2 GB a save of a 130M-parameter run, twice at a
    run's end) go under ``/dev/shm`` where the machine has it, in RAM, so
    that they do not add to the disk's writes, and each run's go once its
    requests are served. Returns (records, launch counts per path)."""
    workdir = _shm_workdir(workdir, "images")
    try:
        return _image_transformer_runs(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _image_transformer_runs(workdir):
    """``image_transformer_phase``'s four runs, their files in
    ``workdir``."""
    import torch
    from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
    from joligen_tpu_torch.models.modules.hdit import HDiT
    from joligen_tpu_torch.models.modules.jit import JiT
    from joligen_tpu_torch.tools.synthetic_datasets import write_labeled
    from joligen_tpu_torch.utils import checkpoint_io

    recs, paths = {}, {}
    k1 = {"flash_attention_fwd": JIT_K1_PER_CALL,
          "flash_attention_bwd_dq": JIT_K1_PER_CALL,
          "flash_attention_bwd_dkv": JIT_K1_PER_CALL}

    # b2b_image_256: 8 steps, then a 50-step and a 10-step request
    opt = _example_opt(IMAGE_EXAMPLE, workdir, "b2b_image", B2B_IMAGE_ARGS)
    write_labeled(opt.dataroot, IMAGE_STEPS * opt.train_batch_size, 256,
                  seed=SEED + 71)
    model, opt, rec = _train_run(opt, IMAGE_STEPS, 1, "b2b_image_256 "
                                 "training", EXPECTED_PARAMS_B2B_IMAGE,
                                 attention_per_step=k1)
    net = model.nets["G_A"]
    if not (isinstance(net, JiT) and not model.is_video and model.use_ema
            and model.denoise_timesteps == B2B_IMAGE_HEUN_STEPS
            and _jit_k1_per_call(net) == JIT_K1_PER_CALL
            and opt.train_batch_size == 8 and opt.data_crop_size == 256):
        raise AssertionError("b2b_image_256 did not train as configured")
    ema = {k: v.detach().cpu().clone()
           for k, v in model.ema_nets["G_A"].state_dict().items()}
    del model, net
    torch.cuda.empty_cache()
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.name)
    ckpt = os.path.join(ckpt_dir, "latest_net_G_A.pth")
    calls = [2 * B2B_IMAGE_HEUN_STEPS - 1, 2 * 10 - 1]
    rec["requests"] = _serve_masked(
        ckpt, workdir, 2, [c * JIT_K1_PER_CALL for c in calls],
        "b2b_image", trained_ema=ema, extra=[[], ["--sampling_steps", "10"]])
    rec["requests"]["denoiser_calls"] = calls
    recs["b2b_image_256"] = rec
    paths["b2b_image_training"] = rec["launches"]
    paths["b2b_image_requests"] = rec["requests"]["launches"]

    # b2b_lora: LORA_STEPS LoRA steps continued from that checkpoint
    lopt = _example_opt(IMAGE_EXAMPLE, workdir, "b2b_lora", B2B_LORA_ARGS + [
        "--train_continue_from", ckpt_dir])
    lopt.dataroot = opt.dataroot
    lopt.data_max_dataset_size = LORA_STEPS * lopt.train_batch_size
    base = flax_to_torch(checkpoint_io.load(ckpt))
    model, lopt, rec = _train_run(lopt, LORA_STEPS, 1, "b2b_lora training",
                                  EXPECTED_PARAMS_B2B_IMAGE,
                                  attention_per_step=k1)
    adapters = model.nets["G_lora"]
    rec["adapter_leaves"] = len(adapters.paths)
    rec["adapter_parameters"] = adapters.count()
    if (rec["adapter_leaves"], rec["adapter_parameters"]) != EXPECTED_LORA:
        raise AssertionError(f"b2b_lora adapters {rec['adapter_leaves']} "
                             f"leaves, {rec['adapter_parameters']}")
    frozen = all(torch.equal(v.cpu(), base[k]) for k, v in
                 model.nets["G_A"].state_dict().items())
    moved = [bool(b.detach().abs().max() > 0)
             for _, _, b in adapters.factors()]
    if not (frozen and all(moved) and model.states["G_A"].step == 0):
        raise AssertionError(f"b2b_lora: base frozen {frozen}, adapter Bs "
                             f"moved {moved}")
    model.merge_lora_checkpoint()
    changed = sum(not torch.equal(v.cpu(), base[k]) for k, v in
                  model.nets["G_A"].state_dict().items())
    want = sum(len(n) for n in adapters.sites.values())
    if changed != want:
        raise AssertionError(f"b2b_lora merge changed {changed} weights, "
                             f"expected {want}")
    # the merged G alone: its request samples with these weights
    merged = os.path.join(lopt.checkpoints_dir, lopt.name,
                          "merged_net_G_A.pth")
    checkpoint_io.save(merged, torch_to_flax(model.nets["G_A"].state_dict()))
    rec["base_bit_for_bit"], rec["merged_weights"] = frozen, changed
    log(f"b2b_lora: {rec['adapter_leaves']} adapter leaves, "
        f"{rec['adapter_parameters']} adapter parameters; the base bit for "
        f"bit after {LORA_STEPS} steps, every B moved; the merge changed "
        f"{changed} weights")
    del model, adapters
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir)
    # the merged base weights (the merge leaves the EMA as it is, as the
    # JAX package's does, and no EMA file is written with them)
    rec["request"] = _serve_masked(
        merged, workdir, 1, [19 * JIT_K1_PER_CALL], "b2b_lora",
        extra=[["--sampling_steps", "10"]], infer_kw={"use_ema": False})
    shutil.rmtree(os.path.dirname(merged))
    recs["b2b_lora"] = rec
    paths["b2b_lora_training"] = rec["launches"]
    paths["b2b_lora_request"] = rec["request"]["launches"]

    # palette with the JiT and with HDiT, 128 px: steps, a DDIM-10 request
    for name, args, count, trunk, per_call in (
            ("palette_vit_128", ["--G_netG", "vit"],
             EXPECTED_PARAMS_PALETTE_VIT, JiT, JIT_K1_PER_CALL),
            ("palette_hdit_128", ["--G_netG", "hdit"],
             EXPECTED_PARAMS_PALETTE_HDIT, HDiT, 0)):
        popt = _example_opt(IMAGE_EXAMPLE, workdir, name, args)
        write_labeled(popt.dataroot, IMAGE_STEPS * popt.train_batch_size,
                      128, seed=SEED + 72)
        model, popt, rec = _train_run(
            popt, IMAGE_STEPS, 1, f"{name} training", count,
            attention_per_step=dict.fromkeys(k1, per_call))
        if not (isinstance(model.nets["G_A"].inner, trunk)
                and model.nets["G_A"].raw_t and popt.data_crop_size == 128
                and popt.train_batch_size == 8):
            raise AssertionError(f"{name} did not train as configured")
        ema = {k: v.detach().cpu().clone()
               for k, v in model.ema_nets["G_A"].state_dict().items()}
        del model
        torch.cuda.empty_cache()
        ckpt = os.path.join(popt.checkpoints_dir, popt.name,
                            "latest_net_G_A.pth")
        rec["request"] = _serve_masked(
            ckpt, workdir, 1, [10 * per_call], name, trained_ema=ema,
            extra=[["--sampling_method", "ddim", "--sampling_steps", "10"]],
            wire=True)
        shutil.rmtree(os.path.dirname(ckpt))
        recs[name] = rec
        paths[f"{name}_training"] = rec["launches"]
        paths[f"{name}_request"] = rec["request"]["launches"]
    return recs, paths


def image_transformer_cross_check():
    """JiT-B/16 (b2b_image_256's, 6 input channels, 256 px) and HDiT
    (palette_hdit_128's, 7 input channels, 128 px) at full width in fp32,
    batch 1, on seeded weights with small seeded values in the
    zero-initialised layers, the card (K1 12 times for the JiT) against the
    CPU to IMAGE_TOL of the largest output; one LoRA merge (rank 8, B
    seeded non-zero) of JiT-B/16, card against CPU, bit for bit."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.diffusion_networks import (define_G,
                                                             init_weights)
    from joligen_tpu_torch.models.lora import LoRAAdapters, merge_deltas
    from joligen_tpu_torch.models.modules.jit import JiT
    from joligen_tpu_torch.options import TrainOptions

    rng = np.random.default_rng(SEED + 73)
    recs = {}
    opt = _fp32(TrainOptions().parse_cli(["--config_json", EXAMPLE,
                                          *B2B_IMAGE_ARGS]))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 6)).astype(
        np.float32))
    t = torch.tensor([0.43])

    def jit():
        return init_weights(JiT.from_opt(opt, 6),
                            torch.Generator().manual_seed(SEED + 74),
                            zero_init_std=0.01)
    hopt = _fp32(TrainOptions().parse_cli(["--config_json", EXAMPLE,
                                           "--G_netG", "hdit"]))
    xh = torch.from_numpy(rng.uniform(-1, 1, (1, 128, 128, 6)).astype(
        np.float32))
    mask = torch.zeros(1, 128, 128, 1, dtype=torch.int32)
    mask[:, 32:96, 40:88] = 1

    def hdit():
        return init_weights(define_G(hopt),
                            torch.Generator().manual_seed(SEED + 75),
                            zero_init_std=0.01)
    for label, build, args, kwargs, n_k1 in (
            ("JiT-B/16", jit, (x, t), {}, JIT_K1_PER_CALL),
            ("HDiT", hdit, (xh, torch.tensor([0.43])), {"mask": mask}, 0)):
        err, out = _card_vs_cpu(build, args, kwargs, label, k1=n_k1,
                                tol=float("inf"))
        scale = out.abs().max().item()
        recs[label] = {"max_abs_err": err, "max_abs_output": scale,
                       "tol": IMAGE_TOL}
        if not (scale > 0 and err <= IMAGE_TOL * scale):
            raise AssertionError(f"{label} cross-check: {recs[label]}")
    net = jit()
    adapters = LoRAAdapters(net, 8, generator=torch.Generator().manual_seed(
        SEED + 76))
    with torch.no_grad():
        for _, _, b in adapters.factors():
            b.normal_(0.0, 0.01, generator=torch.Generator().manual_seed(
                SEED + 77))
    with torch.no_grad():
        cpu = merge_deltas(net, adapters)
        net, adapters = net.cuda(), adapters.cuda()
        card = merge_deltas(net, adapters)
    same = all(torch.equal(card[k].cpu(), v) for k, v in cpu.items())
    recs["lora_merge"] = {"weights": len(cpu), "bit_for_bit": same}
    log("image transformer cross-checks fp32 card vs CPU: "
        + json.dumps(recs))
    if not same:
        raise AssertionError("the LoRA merge differs between card and CPU")
    return recs


def _timed_peak(fn, iters):
    """(ms a call by ``wall_ms``, peak bytes allocated across the calls)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = wall_ms(fn, iters)
    return ms, torch.cuda.max_memory_allocated()


def metrics_phase():
    """The metric networks at full width on the card, each built from a
    seeded tree (the fallbacks' own generator; the real-size InceptionV3
    and I3D, whose weights files are not in the repository, in flax's
    default law from CPU generators): ``RandomConvFeatures`` (2048-d) at
    128 px, ``InceptionV3FID`` at 299 px, the VGG16 trunk with LPIPS and
    DISTS at 256 px, ``I3D`` on 8 frames of 224 px and the DINOv2 fallback,
    each timed (ms a batch of METRIC_BATCH, clips: METRIC_CLIPS) with its
    peak memory, and its card output held against the port's CPU output
    (TF32 off) to METRIC_TOL of the largest; then FID, KID, PSNR, SSIM and
    LPIPS of one fixed pair of sets, card against CPU. No kernel of the
    port runs here."""
    import numpy as np
    import torch
    from joligen_tpu_torch.models.gan_networks import flax_default_init
    from joligen_tpu_torch.utils import metrics as M
    from joligen_tpu_torch.utils.i3d import I3D
    from joligen_tpu_torch.utils.inception import InceptionV3FID

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(SEED + 91)
    imgs = rng.uniform(-1, 1, (METRIC_BATCH, 256, 256, 3)).astype(np.float32)
    others = np.clip(imgs + 0.3 * rng.standard_normal(imgs.shape), -1,
                     1).astype(np.float32)
    clips = rng.uniform(-1, 1, (METRIC_CLIPS, 8, 224, 224, 3)).astype(
        np.float32)

    def seeded(net, seed):
        return flax_default_init(net, torch.Generator().manual_seed(seed))

    def vgg_distances(net):
        def run(x, y):
            fa, fb = net(x), net(y)
            return torch.stack([M.lpips_from_feats(fa, fb),
                                M.dists_from_feats(fa, fb)], -1)
        return run

    def normalised(net):
        def run(x):
            f = net(M._resized(x, 128))
            return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        return run

    cases = {   # name: (net, its call, inputs, CPU rows)
        "random_conv_2048_128px": (
            M._seeded(M.RandomConvFeatures(), 0),
            lambda net: lambda x: net(M._resized(x, 128)), (imgs,), 4),
        "inception_v3_299px": (
            seeded(InceptionV3FID(), SEED + 92),
            lambda net: lambda x: net(M._resized(x, 299)), (imgs,), 2),
        "vgg16_lpips_dists_256px": (
            M._VGGish(generator=torch.Generator().manual_seed(0)),
            vgg_distances, (imgs, others), 2),
        "i3d_8x224px": (seeded(I3D(), SEED + 93), lambda net: net, (clips,),
                        1),
        "dinov2_fallback_128px": (M._seeded(M.RandomConvFeatures(), 1),
                                  normalised, (imgs,), 4),
    }
    recs = {}
    for name, (net, call, inputs, n_cpu) in cases.items():
        net = net.eval().requires_grad_(False)
        dev_in = [torch.from_numpy(a).cuda() for a in inputs]
        fn = call(net.cuda())
        with torch.inference_mode():
            ms, peak = _timed_peak(lambda: fn(*dev_in), METRIC_ITERS)
            card = fn(*(a[:n_cpu] for a in dev_in)).float().cpu()
            cpu = call(net.cpu())(*(torch.from_numpy(a[:n_cpu])
                                    for a in inputs)).float()
        err = (card - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        recs[name] = {"batch": inputs[0].shape[0], "ms_a_batch": ms,
                      "max_memory_allocated": peak,
                      "card_vs_cpu_max_abs_err": err, "output_max": scale,
                      "output_shape": list(card.shape)}
        log(f"metric net {name}: {ms:.2f} ms a batch of "
            f"{inputs[0].shape[0]}, max_memory_allocated {peak} B; card vs "
            f"CPU on {n_cpu}: max abs err {err:.3e} of {scale:.3e} (tol "
            f"{METRIC_TOL} of the largest)")
        if not (torch.isfinite(card).all() and scale > 0
                and err <= METRIC_TOL * scale):
            raise AssertionError(f"{name}: card and CPU disagree")
        del net, fn
        torch.cuda.empty_cache()
    # one fixed pair of sets, card against CPU, the seeded fallbacks
    fakes, reals = imgs[:, ::2, ::2], others[:, ::2, ::2]
    want = M.compute_metrics(fakes, reals, METRIC_LIST, device="cpu")
    t0 = time.perf_counter()
    got = M.compute_metrics(fakes, reals, METRIC_LIST, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errs = {k: abs(got[k] - v) / max(abs(v), METRIC_FLOOR.get(
        k.split("(")[0], 1e-12)) for k, v in want.items()}
    recs["compute_metrics"] = {"card": got, "cpu": want, "rel_err": errs,
                               "wall_s": wall, "images": len(fakes)}
    log(f"compute_metrics of {len(fakes)} pairs at 128 px on the card in "
        f"{wall:.2f} s: {json.dumps(got)}; against the CPU (relative; KID "
        f"of 1): {json.dumps(errs)} (tol {METRIC_SET_TOL})")
    if list(got) != list(want) or max(errs.values()) > METRIC_SET_TOL:
        raise AssertionError("compute_metrics: card and CPU disagree")
    return recs


def perceptual_phase(workdir):
    """cm (``example_cm_noglasses2glasses``, 128 px, batch 16) and
    b2b_image_256 (the image transformer phase's config) with
    ``alg_*_perceptual_loss LPIPS DISTS``, PERCEPTUAL_STEPS steps each: the
    VGG16 trunk frozen in fp32, ``G_perceptual`` among the finite losses,
    the warm step time; their files in RAM (``/dev/shm``) where the
    machine has it. Returns (records, launch counts per path)."""
    import torch
    from joligen_tpu_torch.tools.synthetic_datasets import write_labeled

    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_perc_", dir="/dev/shm")
    else:
        workdir = tempfile.mkdtemp(prefix="perc_", dir=workdir)
    recs, paths = {}, {}
    k1 = {"flash_attention_fwd": JIT_K1_PER_CALL,
          "flash_attention_bwd_dq": JIT_K1_PER_CALL,
          "flash_attention_bwd_dkv": JIT_K1_PER_CALL}
    try:
        runs = (("cm_perceptual", CM_EXAMPLE, ["--alg_cm_perceptual_loss",
                                               "LPIPS", "DISTS"], 128,
                 CM_PER_STEP),
                ("b2b_image_perceptual", IMAGE_EXAMPLE, B2B_IMAGE_ARGS + [
                    "--alg_b2b_perceptual_loss", "LPIPS", "DISTS"], 256, k1))
        for name, example, args, size, per_step in runs:
            opt = _example_opt(example, workdir, name, args)
            write_labeled(opt.dataroot, PERCEPTUAL_STEPS
                          * opt.train_batch_size, size, seed=SEED + 95)
            model, opt, rec = _train_run(opt, PERCEPTUAL_STEPS, 1,
                                         f"{name} training",
                                         attention_per_step=per_step)
            trunk = model._perc_feats.trunk
            frozen = not any(p.requires_grad for p in trunk.parameters())
            perc_losses = rec["losses_last"].get("G_perceptual")
            log(f"{name}: G_perceptual {perc_losses} (last step), trunk "
                f"frozen {frozen}, median warm step "
                f"{rec['median_warm_step_s'] * 1e3:.1f} ms")
            if not (perc_losses and perc_losses > 0 and frozen):
                raise AssertionError(f"{name}: no perceptual term")
            del model
            torch.cuda.empty_cache()
            recs[name] = rec
            paths[f"{name}_training"] = rec["launches"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return recs, paths


def ptxas_spills(ptxas):
    """The functions of a ``-Xptxas=-v`` log whose registers spill, each
    with its log line."""
    spilled, fn = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            spilled[fn] = line.strip()
    return spilled


def ptxas_injected_waits(ptxas):
    """The functions of a ``-Xptxas=-v`` log where ptxas injected a
    ``warpgroup.wait`` (C7517) because a register defined by a wgmma was
    used before its wait, each with its log line."""
    injected = {}
    for line in ptxas.splitlines():
        if "(C7517)" in line:
            m = re.search(r"in function '(\w+)'", line)
            injected[m.group(1) if m else line.strip()] = line.strip()
    return injected


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from joligen_tpu_torch import card_line
    from joligen_tpu_torch.ops import _build

    t_start = time.perf_counter()
    log(card_line(0))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    def check_build(built):
        for name, (secs, ptxas) in built.items():
            log(f"build {name}: nvcc {secs:.2f} s")
            for line in ptxas.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill", "(C7")):
                    log("  " + line.strip())
            # the tensor-core kernels keep every value in registers; the
            # fp32 FMA kernels spill (at D >= 128 much: Queue 2 item 4)
            spilled = [f for f in ptxas_spills(ptxas) if "wgmma" in f]
            if spilled:
                raise AssertionError(f"{name}: ptxas spilled in {spilled}")
            # a wait ptxas injects serialises what the source overlaps
            injected = sorted(ptxas_injected_waits(ptxas))
            if injected:
                raise AssertionError(f"{name}: ptxas injected "
                                     f"warpgroup.wait (C7517) in {injected}")

    # the attention backward (72 kernels, its fp32 ones at D = 128 and 160
    # spilling) builds for minutes, the three other sources for ~40 s: both
    # nvcc runs go beside the phases that launch no kernel of the port
    pool = concurrent.futures.ThreadPoolExecutor(2)
    builds = [pool.submit(_build.build, ["flash_attention_bwd"]),
              pool.submit(_build.build, ["flash_attention_fwd",
                                         "conv3x3_tap", "dma_copy"])]

    seconds = {}                       # the smoke's time, phase by phase

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # no kernel of the port on these paths (the kernels still build)
        gans, gan_paths = phase("CUT", cut_phase, workdir)
        cyclegan, cyclegan_paths = phase("CycleGAN", cyclegan_phase,
                                         workdir)
        glasses, glasses_paths = phase("glasses", glasses_phase, workdir)
        mario, mario_paths = phase("mario2sonic", mario2sonic_phase, workdir)
        unetref, unetref_paths = phase("unetref", unetref_phase, workdir)
        mario["cross_check_fp32"] = phase("MiT cross-check", mit_cross_check)
        unetref["cross_check_fp32_max_abs_err"] = phase(
            "ref cross-check", unetref_cross_check)
        gans["horse2zebra"]["cross_check_fp32"] = phase(
            "CUT cross-check", cut_cross_check)
        glasses["noglasses2glasses"]["cross_check_fp32"] = phase(
            "vision-aided cross-check", vision_aided_cross_check)
        zoo_cross_check = phase("GAN zoo cross-check", gan_zoo_cross_check)
        sem_runs, sem_paths = phase("semantic nets", semantic_phase,
                                    workdir)
        sem_runs["cross_check"] = phase("semantic cross-check",
                                        semantic_cross_check)
        cut_video, cut_video_paths = phase("cut video", cut_video_phase,
                                           workdir)

        def await_build(job):
            t0 = time.perf_counter()
            built = job.result()
            log(f"build: waited {time.perf_counter() - t0:.2f} s more for "
                f"{sorted(built)}")
            check_build(built)
        await_build(builds[1])
        k1 = phase("K1", kernel_phase)
        await_build(builds[0])
        pool.shutdown()
        k2, k3 = phase("K2/K3", backward_kernel_phase)
        p1, p2, p3 = phase("P1-P3", probe_kernel_phase)
        model, serving = phase("serving", slice_phase, workdir)
        k1["cross_check_fp32_max_abs_err"] = phase(
            "serving cross-check", cross_check, model.opt,
            {k: v.detach().cpu() for k, v in
             model.ema_nets["G_A"].state_dict().items()})
        del model
        training = phase("training", training_phase, workdir)
        training_256 = phase("training 256 px", training_256px_phase,
                             workdir, {
            "K1": k1["timings"]["256px_batch8"]["ms"],
            "K2": k2["timings"]["256px_batch8"]["dq_ms"],
            "K3": k3["timings"]["256px_batch8"]["dkv_ms"]})
        xview = phase("xview", xview_phase, workdir, {
            "K1": k1["timings"]["xview_128px_batch16"]["ms"],
            "K2": k2["timings"]["xview_128px_batch16"]["dq_ms"],
            "K3": k3["timings"]["xview_128px_batch16"]["dkv_ms"]})
        configs, config_paths = phase("other configs", other_configs_phase,
                                      workdir)
        cms, cm_paths = phase("cm", cm_phase, workdir)
        vid, vid_paths = phase("video", vid_phase, workdir)
        b2b, b2b_paths = phase("b2b", b2b_phase, workdir)
        b2b_gc, b2b_gc_paths = phase("b2b context", b2b_context_phase,
                                     workdir)
        mat, mat_paths = phase("mat", mat_phase, workdir)
        mat_video, mat_video_paths = phase("mat video", mat_video_phase,
                                           workdir)
        images, image_paths = phase("image transformers",
                                    image_transformer_phase, workdir)
        wide, wide_paths = phase("wide head dims", wide_transformer_phase,
                                 workdir)
        percs, perc_paths = phase("perceptual steps", perceptual_phase,
                                  workdir)
        cyclegan_unet, cyclegan_unet_paths = phase(
            "CycleGAN unet_256", cyclegan_phase, workdir, True)
        zoo, zoo_paths = phase("GAN zoo", gan_zoo_phase, workdir)
        palette_zoo, palette_zoo_paths = phase("palette zoo",
                                               palette_zoo_phase, workdir)
        re_runs, re_paths = phase("ReCycleGAN and ReCUT", re_phase, workdir)
    metric_nets = phase("metrics", metrics_phase)
    grad_check = phase("gradient cross-check", gradient_cross_check)
    vid["cross_check_fp32_max_abs_err"] = phase("video cross-check",
                                                vid_cross_check)
    b2b["cross_check_fp32_max_abs_err"] = phase("b2b cross-check",
                                                b2b_cross_check)
    b2b_gc["cross_check_fp32"] = phase("video context cross-check",
                                       video_context_cross_check)
    mat["cross_check_fp32"] = phase("mat cross-check", mat_cross_check)
    mat_video["cross_check_fp32"] = phase("mat video cross-check",
                                          mat_video_cross_check)
    images["cross_check_fp32"] = phase("image transformer cross-check",
                                       image_transformer_cross_check)
    probe_launches, probes = phase("probes", probe_paths)
    paths = {"serving": serving, "training": training["launches"],
             "trained_checkpoint_request":
                 training["trained_request_launches"],
             "training_256px": training_256["launches"], **xview["paths"],
             **config_paths, **gan_paths, **glasses_paths, **cm_paths,
             **mario_paths, **unetref_paths, **vid_paths, **b2b_paths,
             **mat_paths, **mat_video_paths, **image_paths, **wide_paths,
             **perc_paths, **cyclegan_paths, **cyclegan_unet_paths,
             **zoo_paths, **palette_zoo_paths, **re_paths, **sem_paths,
             **cut_video_paths, **b2b_gc_paths, **probe_launches}
    kernels = [k1, k2, k3, p1, p2, p3]
    for k in kernels:
        per_path = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(per_path.values())
        k["launches_per_path"] = per_path
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its path")
    log("training: " + json.dumps(training))
    log("training 256 px: " + json.dumps(training_256))
    log("xview: " + json.dumps(xview))
    log("configs: " + json.dumps(configs))
    log("gans: " + json.dumps(gans))
    log("glasses: " + json.dumps(glasses))
    log("cm, cm_gan, sc: " + json.dumps(cms))
    log("mario2sonic: " + json.dumps(mario))
    log("unetref_viton: " + json.dumps(unetref))
    log("vid_mario: " + json.dumps(vid))
    log("b2b_vid_mario: " + json.dumps(b2b))
    log("mat_inpainting: " + json.dumps(mat))
    log("mat_video: " + json.dumps(mat_video))
    log("wide head dims: " + json.dumps(wide))
    log("image transformers: " + json.dumps(images))
    log("perceptual steps: " + json.dumps(percs))
    log("cyclegan: " + json.dumps({**cyclegan, **cyclegan_unet,
                                   "cross_check_fp32": zoo_cross_check}))
    log("GAN zoo: " + json.dumps(zoo))
    log("palette zoo: " + json.dumps(palette_zoo))
    log("ReCycleGAN and ReCUT: " + json.dumps(re_runs))
    log("semantic nets: " + json.dumps(sem_runs))
    log("video context: " + json.dumps({**b2b_gc, **cut_video}))
    log("metrics: " + json.dumps(metric_nets))
    log("phases (s): " + json.dumps(seconds))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    k1["training_gradient_cross_check"] = grad_check
    stage_a = probes["fused_resblock_probe"]
    for k in (p1, p2):
        k["stage_a"] = stage_a
    p3["probe_cases"] = probes["bw_probe3"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
