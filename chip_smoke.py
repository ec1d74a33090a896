#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths at full width, DefectGAN-256 in bf16 with each of
its three decoders and StarGAN v2 at 256^2 (AdaIN and SEANv2), with random
weights from a seed, and shows that the AdaIN and SEAN paths ran through
the hand-written CUDA kernels (forward and backward of the modulated
instance norm) and the SPADE path through none:

  * serving: ``DefectGanSteps.generate`` on batches of 8;
  * training: ``DefectGanSteps.super_step``, 5 D steps and one G step on
    batches of 8 (the fused 2B generator forwards give the kernels batches
    of 16), also through the train CLI with each input feed;
  * StarGAN v2 serving: ``StarGANv2Solver`` requests of 32 (the style code,
    then the EMA generator; 12 forward-kernel calls a G forward);
  * StarGAN v2 training: ``StarGANv2Solver.train_step`` on batches of 8 with
    the upstream README's AFHQ flags (AdaIN, FusedProp, SEANv2), also
    through ``cli.starganv2_main`` (train, resume, sample);
  * MAE-GAN pretraining: ``MAESteps.super_step`` at the MAE CLI's defaults
    (batch 32, one critic, AdamW), through ``cli.train_mae`` on each input
    feed, ``cli.test_mae``, DefectGAN warm-started from the MAE run, and
    StarGAN v2's ``--mode pretrain`` and ``--pretrain_dir``;
  * pix2pix: ``Pix2PixSteps.super_step`` at the pix2pix CLI's defaults
    (256², batch 1, 4 iterations a super-step, the SPADE generator, a
    2-scale PatchGAN, EMA), with FusedProp, with remat and at 512², through
    ``cli.train_pix2pix`` on each feed and ``cli.test_pix2pix``;
  * WGAN: ``WGanSteps.super_step`` at the WGAN CLI's defaults (64², batch
    128, 5 critics, RMSprop), with weight clipping and with the gradient
    penalty, through ``cli.train_wgan`` on each feed;
  * height-sharded folder inference: ``cli.translate_folder --spatial 2``
    at 1024^2 on two ranks sharing the card, through the split forward's
    kernels; the reference ``.pth`` import;
  * the frozen nets: ViT-B/16 embedding requests, ``cli.train_vit`` and
    ``cli.test_vit`` and their bank as DefectGAN SEAN's ``--embed_path``,
    StarGAN v2 SEAN with lambda_sty through the solver and through
    ``cli.starganv2_main --vit_path`` and ``--mode update_stats``; FAN, the
    CelebA-HQ command (``w_hpf 1``) with ``--wing_ckpt`` and ``--mode
    align``.

AdaIN takes the style code from E; SEAN takes ViT-sized (8, 5, 768) style
embeddings made on the card, tracks its running statistics and adds its
distillation terms in training; SPADE runs with spectral norm and noise
injection. SEAN and SPADE train with DiffAugment on every policy.

Phases, each of which raises on failure:

  1. device   card name, count, torch/CUDA versions, nvidia-smi name + power
  2. build    nvcc builds both kernels, one library, from the checkout;
              ptxas's lines for every instantiation, failing on any spill;
              each tier's occupancy at the paths' row lengths (blocks an SM,
              and cudaOccupancyMaxActiveClusters for each cluster plan)
  3a. fwd     the forward kernel against its plain version at the serving
              and the training shapes, float32 and bfloat16, every
              activation, a ragged shape and the planner's tier boundaries
              (the longest row of a warp, of a block and of each cluster
              size, and the next aligned lengths), in every tier the
              planner can run there: W (a warp a row), B (a block a row),
              C (a cluster a row), S (streaming)
  3b. bwd     the backward kernel the same way at the training shapes, a
              ragged shape and the boundaries; mean and inv come from the
              forward kernel and are first checked against the plain
              forward's; each tier run twice, dx, dgamma and dbeta
              bit-identical
  4. serving  a small f32 input against the port on the CPU, then 2 warm-up
              + 5 timed requests (the serving path's launch counts); the
              same batches with use_pallas=False agree within a stated band
     profile  torch.profiler breakdown of a serving forward's kernels
  5. timing   forward kernel at each serving and training shape: tier S,
              the planned tier, every other tier the planner could run
              there, the planned tier, tier S in turns, beside the plain
              version, F.instance_norm and the memory bound
  6c. small   a tiny f32 super-step through both kernels on the card against
              the same super-step on the CPU (plain version): losses and
              (after - before) / lr under SGD
  6d. train   2 warm-up + 5 timed full-width super-steps (the training
              path's launch counts), peak memory; then G's parameter deltas
              after one SGD super-step, kernel path against the
              use_pallas=False path, in bf16 and in an f32 control run
  6e. profile torch.profiler breakdown of one super-step, and the busy share
              of the unprofiled super-step
  6f. timing  backward kernel at each training shape as in 5, beside the
              plain version, autograd of F.instance_norm and the bound
  6g. remat   one full-width f32 AdaIN super-step (SGD) with remat on
              against remat off: the kernels run again in the
              recomputation (exactly 2 more G forwards' launches, the same
              backward launches), losses, G's and E's deltas within 6c's
              band, G's within 6d's f32 band, G's BatchNorm statistics,
              peak memory of both
  7a. sean    serving: 2 warm-up + 5 timed requests (the path's launch
              counts), against the use_pallas=False path within the band
              of phase 4; profile
  7b. sean    training (running statistics, distillation, DiffAugment):
              a tiny f32 super-step with spectral norm on the card against
              the CPU; 2 warm-up + 5 timed full-width super-steps (the
              path's launch counts), peak memory, profile; the epoch update
              of the statistics and one request that samples them, against
              the use_pallas=False path within phase 4's band; G's SGD
              deltas kernel path vs plain path as in 6d
  7c. spade   serving and training with spectral norm, noise injection and
              DiffAugment: times, peak memory, profiles; no kernel launches
  8a. cli     ``cli.train_defectgan.main`` in-process, AdaIN on the synthetic
              dataset for one epoch (12 super-steps, fed by device_prefetch):
              exactly 56 forward and 16 backward launches a super-step,
              checkpoints and iter.txt written, loader-fed host-clock time
              per super-step against phase 6d's preloaded one, the busy share
              over 3 profiled trainer super-steps, peak memory, and the
              super-batch copies pinned and on a side stream (profile)
  8d. cli     ``cli.test_defectgan.main`` on 8a's epoch-1 checkpoint: grids,
              diverse images and classifier accuracy; the PNGs counted, 8
              forward launches a G forward
  8b. cli     ``--continue_training`` to epoch 2: the state loaded at resume
              equals the saved one tensor for tensor, epochs and iterations
              go on as the JAX trainer's do, launches exact
  8c. cli     SEAN with running statistics, distillation and an embedding
              bank (``--embed_path``, an .npz made from a seed): launches
              exact, statistics finalized
  8e. feed    the CLI's super-batches through device_prefetch equal the
              host's bit for bit; the loader's pace with and without the copies
  8f. native  the train CLI with ``--native_loader`` for one epoch: exactly
              56/16 launches a super-step, u8 super-batches at the step,
              pinned copies on the prefetch stream (profile), loader-fed time
              and busy share beside 8a's; the C++ feed's u8 super-batches
              through device_prefetch equal the host's bit for bit (one
              thread); its pace with the CLI's four threads
  9a. sgv2    the forward kernel against its plain version at StarGAN v2's
              five decoder shapes (batch 32), float32 and bfloat16, in every
              tier; timed as in 5
  9b. sgv2    AdaIN serving: 2 warm-up + 5 timed requests of 32 with latent
              styles, then with reference styles; exactly 12 forward launches
              a G forward at the five shapes; peak memory, profile; a
              request, kernel path vs the plain version swapped in: f32
              control (TF32 off) within relative L2 1e-4, bf16 no further
              from the f32 plain path than 1.5x the bf16 plain path
  9c. sgv2    SEANv2 serving with (32, 5, 768) embeddings: 2 warm-up + 5
              timed requests, track_stats_step over 4 batches,
              finalize_ema_stats, one inference_stats request; the same
              launch and agreement checks as 9b
  10a. sgv2   both kernels against their plain versions at StarGAN v2's five
       train  batch-8 shapes, float32 and bfloat16, in every tier; each timed
              as in 5 beside its bound, its plain version and F.instance_norm
              (its autograd); a launch with next to no work, timed the same
              way (the floor under the short rows)
  10b.        2 warm-up + 5 timed AFHQ ``train_step``s on preloaded batches
              (AdaIN: exactly 96 forward and 48 backward launches an
              iteration at the five shapes), host-clock and profiler device
              time an iteration, peak memory, finite losses; the same with
              FusedProp (72/48) and with SEANv2 and (8, 5, 768) embeddings,
              its statistics finalized every iteration (48/24)
  10c.        G's, M's and S's gradients of one latent G loss, kernel path
              against the plain version swapped in, relative L2 per net: f32
              control (TF32 off) within 5e-3 + 2x the distance the f32 plain
              path moves with its norm computed in float64; bf16 within 1.5x
              the bf16 plain path's distance from the f32 plain path, + 5e-3
  10d. cli    ``cli.starganv2_main.main`` on an image tree of 3 domains x 24
              PNGs at 256^2 made from a seed: ``--mode train`` for 12
              iterations (exact launches, loader-fed iteration time, the busy
              share of 3 profiled iterations, a debug grid, checkpoints
              000012 and latest), a resume with ``--resume_iter 12`` whose
              loaded state equals the saved one, ``--mode sample`` from it
              (grids of the expected sizes, finite pixels)
  11. mae     both kernels timed at the batch-32 MAE shapes as in 5 and 6f
              (3a/3b hold every tier there against the plain version), with
              the planned tier against tier S
  11a.        a tiny f32 ``MAESteps.super_step`` (2 critics, SGD, a fixed
              mask) on the card against the CPU: losses rtol 2e-4, G's, the
              token's, E's and D's (after - before) / lr within 6c's band
  11b.        2 warm-up + 5 timed full-width MAE super-steps on preloaded
              batches of 32 (exactly 16 forward and 8 backward launches a
              super-step at the batch-32 shapes), peak memory, a profiled
              super-step; ``eval_losses`` and ``repair_grid`` (8 forward
              launches each) as a path of their own
  11c. cli    ``cli.train_mae.main`` for one epoch (the synthetic dataset's
              512 fusion images: 16 super-steps of 32) on the Python loader
              and with ``--native_loader``: exact launches, ``latest``
              written, loader-fed time, busy share of 3 profiled
              super-steps, the copies on a side stream; ``cli.test_mae.main``
              on the run: the loss line, a repair grid PNG of 4 x 5 panels
              from finite pixels
  11d.        ``cli.train_defectgan.main --load_model_name`` the MAE run: G, E
              and D at the start equal the run's tensor for tensor, then one
              super-step with exactly 56/16 launches
  11e. sgv2   ``cli.starganv2_main --mode pretrain`` with the AFHQ flags on
              10d's image tree for 12 iterations (exactly 48/24 launches an
              iteration at the batch-8 shapes, loader-fed time, busy share),
              then ``--mode train --pretrain_dir`` for 2 iterations, whose G
              and ema_G at load equal the pretrain run's
  12a. p2p    a tiny f32 ``train_step`` and ``fused_train_step`` (SGD) on the
              card against the CPU: losses rtol 2e-4, G's and D's (after -
              before) / lr within 6c's band
  12b.        2 warm-up + 5 timed full-width pix2pix super-steps (4
              iterations of batch 1 at 256²) on preloaded batches, with
              ``train_step``, with FusedProp and with the U-Net generator
              (``--netG unet``): host clock, a profiled
              super-step's device time, peak memory, finite losses, exactly
              0 launches of either norm kernel (SPADE, instance norm)
  12c.        the same with remat: peak memory beside remat off's; one f32
              SGD iteration, remat on vs off on the card: losses, G's and
              D's deltas within 12a's band, BatchNorm statistics equal; the
              remat-off iteration run twice, its spread printed beside on
              vs off's (whether cuDNN alone moves the step that far)
  12d.        one super-step at 512² (pix2pixHD's multi-scale D with feature
              matching)
  12e. cli    ``cli.train_pix2pix.main`` for one epoch (48 synthetic pairs,
              12 super-steps) on the Python loader and with
              ``--native_loader`` (u8 ``pair`` batches): loader-fed time,
              busy share of 3 profiled super-steps, the copies' stream, a
              panel; ``--continue_training`` whose loaded state equals the
              saved one; ``cli.test_pix2pix.main``: ``results.json``, panels
              of 256 x 768 from finite pixels
  13a. wgan   a tiny f32 clipping super-step and a GP super-step (noise and
              eps handed in) on the card against the CPU, as 12a
  13b.        full-width WGAN super-steps (5 critic steps of 128 at 64², one
              G step), clipping and GP: timed, profiled, peak memory, 0
              norm-kernel launches, the critic's weights within the clip
  13c. cli    ``cli.train_wgan.main`` for one epoch on each feed, then a
              resume whose loaded state (RMSprop's nu with it) equals the
              saved one; the 4x4 sample grid

  14a. vit    ViT-B/16 from a seed (hidden 768, 12 layers, 224^2 from
              256^2): the card against the CPU, f32 with TF32 off, relative
              L2 within 1e-4; batch-32 embedding requests in bf16: host and
              device time, peak memory, no norm-kernel launch
  14b. cli    ``cli.train_vit`` for one epoch on the synthetic DefectGAN
              data (batch 32), ``cli.test_vit --save_embeddings
              --calc_classifier_acc``; the bank as ``cli.train_defectgan
              --embed_path`` with SEAN for an epoch: exactly 56/16 launches
              a super-step
  14c. sgv2   StarGAN v2 SEAN with lambda_sty through the solver
              (``set_frozen_nets`` on ViT-B), AFHQ flags, batch 8, 256^2,
              bf16: exactly 48/24 launches an iteration, the style term
              live, peak memory, a profiled iteration and the ViT's share of
              its device time; G's gradient of the lambda_sty term alone,
              kernel path vs plain, in 10c's bands
  14d. cli    ``cli.starganv2_main --norm_type sean --vit_path`` (a .bin
              with HF key names written from the seed) for 4 loader-fed
              iterations (48/24 each), then ``--mode update_stats``
  15a. fan    FAN from a seed at 256^2: the heatmaps before the threshold,
              card vs CPU (f32, TF32 off, relative L2 within 1e-4); the
              masks of a batch of 8 timed on the card
  15b. sgv2   the upstream README's CelebA-HQ command (w_hpf 1, AdaIN,
              batch 8, bf16) with ``--wing_ckpt`` for 8 loader-fed
              iterations: the FAN masks of x_src and of each pass's x_fake,
              exactly 14 forward launches a masked G forward and each
              iteration's launches G's passes times that, the iteration's
              device time and the FAN's share of it
  15c. align  ``--mode align`` on 3 synthetic faces with ``--lm_path`` mean
              landmarks written from a seed: the aligned PNGs
  16a. ops    ``torch.library.opcheck`` of both kernels' custom ops on the
              card at a DefectGAN training shape and a StarGAN v2 one, f32
              and bf16; the host microseconds of one eager call of the
              forward op at 16^2, beside the ctypes wrapper's alone and the
              device time of the call back to back
  16b. export ``serving.py`` at full width in bf16: DefectGAN-256 AdaIN and
              SEAN, StarGAN v2-256 AdaIN (generator, style encoder, mapping)
              and SEANv2 (generator); each graph holds exactly 8 / 12 / 0
              forward-op nodes; saved, loaded and served at batch 8 or 32
              and at batch 1 from the same artifact with exactly that many
              launches a call; max and mean |d| against eager, request
              latency and kernel time beside eager's, the artifact's size;
              ``cli.export_model --validate`` on 8a's and 10d's checkpoints
  16c. folder ``cli.translate_folder`` at 1024^2 (BASELINE.json config #5),
              full width, SEAN, batch 4, over 9 PNGs (the last batch
              padded): 8 forward launches a G forward at the shapes and
              tiers of FOLDER_SHAPES (the last norm's rows stream, tier S),
              a batch of 4 timed (ms, images/s, peak memory), the kernel
              path against the plain version within phase 4's band, each
              shape timed as in 5 beside its bound and F.instance_norm
  16d. video  ``cli.starganv2_main --mode sample --make_video`` on 10d's
              checkpoint (31 G forwards a same-domain transition, 10 held
              frames), then ``translate_with_alpha_control`` and
              ``translate_with_layer_split`` through a SEANv2 solver, with
              exact launches
  17a. nets   InceptionV3 and LPIPS drawn from a seed, card vs CPU (f32,
              TF32 off, relative L2 within 1e-4); a batch-32 Inception
              feature request at 299^2 (device time, peak memory); the host
              time of one 2048-wide Frechet distance
  17b. cli    every metric flag through its CLI at ``--dims 768``:
              ``cli.test_defectgan --metrics fid is lpips --save_stats``,
              ``--cal_mfid``, ``cli.train_defectgan --val_metrics`` for an
              epoch, ``cli.test_pix2pix --metrics fid`` (8 pairs), ``cli.fid`` on two
              folders, ``cli.starganv2_main --mode eval``: exact launches a
              G forward, finite numbers, the time of each and Inception's
              share of its kernel time. The metric nets are drawn from a
              seed: their numbers mean nothing
  18a. dp     data parallel, NCCL as a group of one (the machine has one
              card): a full-width f32 AdaIN super-step with the group
              attached against the same step without it (56/16 launches,
              losses rtol 2e-4, deltas per tensor within 6c's band + 2x a
              float64-BatchNorm control, G's within 6d's f32 band); the
              reductions' cost in bf16 super-steps (host clock in turns,
              device time, the ranges parallel.grad_all_reduce and
              parallel.batch_norm)
  18b.        two ranks on cuda:0 over gloo (one launch for 18b-18d):
              DefectGAN AdaIN at full width, global batch 8, one SGD
              super-step against one process on the same batch (f32 with
              TF32 off within 6d's f32 band, bf16 printed), 56/16 launches
              a rank, the ranks' states equal bit for bit; the host clock
              of a bf16 super-step and its share inside the collectives
  18c.        StarGAN v2 AdaIN (AFHQ flags, batch 8, f32) with each
              update's gradients against one process's within 10c's band,
              96/48 a rank; MAE at batch 32 (16/8), WGAN clipping at 128
              and pix2pix at batch 2 (0); states equal
  18d. cli    ``cli.train_defectgan --gpu_ids 0,0 --data_parallel on`` at
              batch 32 on two ranks: an epoch, then ``--continue_training``
              from its checkpoint, exact launches, states equal
  19a. split  the split forward's kernels (moments, apply) against their
              plain versions at the bands of 16c's forward over two ranks
              (each norm input halved in H), a ragged band and an unaligned
              one, f32 and bf16, every activation; each band shape timed
              beside its bound, the plain version, ``torch.var_mean`` and
              eval-mode ``F.batch_norm``
  19b.        ``cli.translate_folder --spatial 2 --gpu_ids 0,0`` on two
              ranks sharing cuda:0 (gloo, one launch): 16c's 9 PNGs in bf16
              and in an f32 control with TF32 off, SPADE at 256^2 with
              spectral norm and noise; exactly 8 moments + 8 apply launches
              a G forward a rank and no fused one (SPADE: none); f32 within
              1 count of one process's PNGs, bf16's mean |d| from one f32
              process within 1.5x one bf16 process's; a batch of 4's host
              clock, images/s, the halo's and the moments' shares, the peak
  19c. pth    a reference-keyed ``.pth`` pair written from a seeded SEAN G
              and D, imported onto the card (``train/torch_import.py``):
              every tensor equal; 8 forward launches a G forward, kernel vs
              plain within phase 4's band

Then each timed shape's planned tier against tier S and the fastest tier,
and each path's share of the bound. The line before the last two holds the
kernels' JSON record (per shape: the tier, its cluster size, tier S's time
as ``streaming_ms`` and the other tiers' as ``other_tiers_ms``), the next
the card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the package beside it, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the
# tensor cores (the kernels' math runs there, in f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_FLOPS_PER_ELEMENT = 5  # pass 1: add + fma; pass 2: fma (+ act)
BWD_FLOPS_PER_ELEMENT = 12  # each pass: xhat (sub, mul), gate fma; sums 2;
#                             dx: sub, fma, mul

SEED = 0
BATCH = 8
CRITICS = 5
# decoder call sites of the modulated instance norm at 256^2:
# (N, C, H, W) -> calls per generator forward. Serving runs batches of 8;
# training's fused forwards run 2B = 16.
SLICE_SHAPES = {(8, 256, 64, 64): 6, (8, 256, 128, 128): 1, (8, 128, 256, 256): 1}
TRAIN_SHAPES = {(16, 256, 64, 64): 6, (16, 256, 128, 128): 1,
                (16, 128, 256, 256): 1}
RAGGED = (3, 5, 7, 9)  # scalar loops: H*W not a multiple of the vector
FWD_PER_FORWARD = sum(SLICE_SHAPES.values())
# one super-step: CRITICS eval forwards (D steps) + 2 train forwards (G
# step), and the backward of the 2 train forwards
G_FORWARDS_PER_SUPER_STEP = CRITICS + 2
G_BACKWARDS_PER_SUPER_STEP = 2
# forward kernel vs plain: f32 within the JAX suite's 2e-5; bf16 y within
# atol 3e-2 + rtol 1.6e-2 (one bf16 ulp at |y| < 16: the two round the same
# f32 value, up to the last bit of a sum taken in another order); mean/inv f32
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 3e-2, 1.6e-2
# backward kernel vs plain: f32 dx within the JAX suite's 3e-4; bf16 dx
# within one bf16 ulp of the plain version's (+ 1e-5 for the f32 math before
# the rounding); dgamma/dbeta, f32 sums over H*W in another order, within
# 1e-5 of the sum of the absolute terms
BWD_F32_TOL = 3e-4
BWD_BF16_ATOL = 1e-5
SUM_BAND = 1e-5
# the library call's dgamma/dbeta (autograd of F.instance_norm in bf16)
# against the plain sums, to show it computes the same function; at
# StarGAN v2's 256-element rows its sums land 1.6e-3 off (H100 80GB HBM3):
# there the band is half a bf16 ulp
LIBRARY_SUM_BAND = 1e-3
SGV2_LIBRARY_SUM_BAND = 2.0 ** -8
# serving end to end, kernel path vs plain path, bf16: 4 bf16 ulps at 1
OUT_BAND = 3.2e-2
MEAN_BAND = 1e-3
# small super-step, card vs CPU, f32: losses within the JAX suite's rtol
# 2e-4; gradients per tensor within 1e-3 of their L2 norm + atol 1e-5 per
# element in L2 (element-wise figures against the suite's rtol 2e-4 / atol
# 1e-5 are reported)
LOSS_RTOL = 2e-4
DISTILL_ATOL = 1e-5
GRAD_REL_L2 = 1e-3
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
# full-width G deltas, kernel path vs plain path (relative L2 norm): within
# F32_DELTA_BAND in the f32 control run; in bf16 the kernel path must be as
# close to the f32 plain path as the bf16 plain path is, within a factor
F32_DELTA_BAND = 1e-3
BF16_DELTA_FACTOR = 1.5
# SEAN's style embeddings: num_embeds ViT CLS tokens of embed_nc
EMBEDS = (5, 768)
DIFF_AUG = "color,translation,cutout"
# phases 8a-8e: the entry points at full width (the CLI's DefectGAN
# defaults at 256^2, batch 8, 5 critics, bf16), run files under build/
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
CLI_IMAGE = 256
CLI_BASE = ["--dataset_name", "synthetic", "--image_size", str(CLI_IMAGE),
            "--batch_size", str(BATCH)]
CARD = "cuda"  # the device type the entry points run on (--gpu_ids 0)
CLI_SEED = 123  # the CLI's default --seed
PROFILE_AT = 6  # the first of the trainer's profiled super-steps
PROFILED_SUPER_STEPS = 2
# phases 9a-9c: StarGAN v2 serving at the CLI's defaults, 256^2, requests of
# --val_batch_size 32, w_hpf=0. The modulated instance norm's call sites of
# one G forward: (N, C, H, W) -> calls (models/starganv2.py, decoder)
SGV2_BATCH = 32
SGV2_IMAGE = 256
SGV2_SHAPES = {(32, 512, 16, 16): 5, (32, 512, 32, 32): 2, (32, 256, 64, 64): 2,
               (32, 128, 128, 128): 2, (32, 64, 256, 256): 1}
SGV2_FWD_PER_FORWARD = sum(SGV2_SHAPES.values())  # 12
# a request, kernel path vs plain path, f32 control with TF32 off: relative L2
SGV2_F32_BAND = 1e-4
SGV2_TRACK_BATCHES = 4
# phases 10a-10d: StarGAN v2 training, the upstream README's AFHQ command
# (clova-ai/stargan-v2, "Training networks") at the CLI's other defaults
SGV2_AFHQ = ["--num_domains", "3", "--w_hpf", "0", "--lambda_reg", "1",
             "--lambda_sty", "1", "--lambda_ds", "2", "--lambda_cyc", "1"]
SGV2_TRAIN_BATCH = 8
SGV2_TRAIN_SHAPES = {(SGV2_TRAIN_BATCH, *s[1:]): c for s, c in SGV2_SHAPES.items()}
# G forwards and G backwards an iteration: AdaIN 2 D passes x 1 fake forward
# without gradients + 2 G passes x 3 (x_fake, x_fake2 without gradients,
# x_rec) and the backward of x_fake's and x_rec's; SEAN the reference
# passes alone; FusedProp a pair a pass (the shared fake, x_fake2, x_rec)
SGV2_G_PASSES = {"adain": (8, 4), "sean": (4, 2), "fused": (6, 4)}
# a latent G loss's gradients, kernel path vs plain path, f32 control (TF32
# off): relative L2 per net within this + F32_CONTROL_FACTOR x the distance
# the plain path moves when only its norm is rounded otherwise (computed in
# float64). G's gradient is ill-conditioned (its cycle term runs G twice,
# its L1 terms have near-ties): the kernel's other summation order alone
# moved it by 1.488e-3 (H100 80GB HBM3), and on the CPU the port's own G loss
# gradients move by up to 5.8e-3 a tensor against the JAX package's
# (tests/test_torch_starganv2_train.py)
SGV2_TRAIN_F32_BAND = 5e-3
F32_CONTROL_FACTOR = 2.0
SGV2_CLI_ITERS = 12
SGV2_CLI_IMAGES = 24  # a domain
# phase 11: MAE-GAN pretraining at the MAE CLI's defaults (batch 32, one
# critic, AdamW (0.9, 0.95), cosine schedule, lr 1.5e-4, loss_weight [10, 3,
# 1], position token, mask ratio 0.75, patch 8) on the DefectGAN config of
# phases 6-8 (AdaIN, 256^2, bf16). The decoder's norm call sites of one G
# forward at batch 32:
MAE_BATCH = 32
MAE_SHAPES = {(32, 256, 64, 64): 6, (32, 256, 128, 128): 1,
              (32, 128, 256, 256): 1}
# a super-step: the D step's repair (a G forward without gradients), the G
# step's repair (a forward and its backward): 16 forward + 8 backward
MAE_G_PASSES = (2, 1)
MAE_SYNTHETIC = 512  # the MAE CLI's synthetic fusion images: 16 super-steps
# StarGAN v2 pretraining: two D passes, each a repair without gradients,
# and two G passes, each a repair with its backward: 48 + 24
SGV2_PRETRAIN_PASSES = (4, 2)
SGV2_PRETRAIN_ITERS = 12
# phase 12: pix2pix at its CLI's defaults (``add_pix2pix_args``: 256^2 crop
# from 286, batch 1, 4 iterations a super-step, resnet G (the DefectGAN
# generator with SPADE: no kernel), a 2-scale PatchGAN D of 3 layers, lsgan,
# lambda L1 100, lambda feat 10, EMA 0.999, Adam 2e-4, bf16, ngf=ndf=64,
# num_res 6, hidden_nc 128, label_nc 2); the CLI's epoch capped at 48 pairs
# (--max_dataset_size): 12 super-steps
P2P_IMAGE = 256
P2P_IPL = 4
P2P_PAIRS = 48
# phase 13: WGAN at ``add_wgan_args``' defaults (64^2, batch 128, noise 100,
# ngf=ndf=64, 3 layers, RMSprop 5e-5, clipping 0.03, 5 critics, bf16); the
# GP variant with gp_weight 10
WGAN_BATCH = 128
WGAN_GP = 10.0
# phase 14: the frozen ViT-B/16 (hidden 768, 12 layers, 224^2) from a seed;
# the card against the CPU, f32 with TF32 off: relative L2
VIT_F32_BAND = 1e-4
VIT_BATCH = 32  # an embedding request; the ViT CLIs' batch
VIT_TIMED = 10
SGV2_SEAN_ITERS = (2, 3)  # 14c: warm-up, timed iterations
SGV2_SEAN_CLI_ITERS = 4
SGV2_STATS_SAMPLES = 8  # 14d: update_stats' styles a domain
# phase 15: FAN at 256^2 from a seed, and the upstream README's CelebA-HQ
# command (clova-ai/stargan-v2, "Training networks")
FAN_BAND = 1e-4  # heatmaps, card vs CPU, relative L2
# the masks' steps on the same input, card vs CPU: the heatmaps' 64 -> 256
# upsample, preprocess_heatmaps, the generator's antialiased mask resize to
# 32/64/128 (f32 sums in another order, a pow a ulp apart)
MASK_ATOL = 1e-5
# the share of the pixels of each landmark channel that crosses
# preprocess_heatmaps' 0.1 threshold once 15a shifts the seeded FAN's head
# (with the seeded head every channel lights up and both masks clip to 1)
FAN_ACTIVE = 0.02
SGV2_CELEBA = ["--num_domains", "2", "--w_hpf", "1", "--lambda_reg", "1",
               "--lambda_sty", "1", "--lambda_ds", "1", "--lambda_cyc", "1"]
SGV2_CELEBA_ITERS = 8
CELEBA_PROFILE_AT = 3
# w_hpf 1 adds an encoder block down to 8^2 and its styled decoder block:
# 7 styled blocks of 2 norms, against 6 of AFHQ's w_hpf 0. The call sites
# of one G forward at batch 8: two bottleneck blocks and the first upsample
# block's first norm at 8^2, then each upsample block's two norms
CELEBA_TRAIN_SHAPES = {(SGV2_TRAIN_BATCH, 512, 8, 8): 5,
                       (SGV2_TRAIN_BATCH, 512, 16, 16): 2,
                       (SGV2_TRAIN_BATCH, 512, 32, 32): 2,
                       (SGV2_TRAIN_BATCH, 256, 64, 64): 2,
                       (SGV2_TRAIN_BATCH, 128, 128, 128): 2,
                       (SGV2_TRAIN_BATCH, 64, 256, 256): 1}
CELEBA_FWD_PER_FORWARD = sum(CELEBA_TRAIN_SHAPES.values())
ALIGN_FACES = 3

# phase 16: deployment. 16a: opcheck at a DefectGAN training shape and a
# StarGAN v2 one; 16b: the artifacts under build/chip_smoke/export
OPCHECK_SHAPES = ((16, 256, 64, 64), (32, 512, 16, 16))
EXPORT_DIR = CLI_DIR / "export"
EXPORT_TIMED = 5
SGV2_EXPORT_NET = ["--num_domains", "3", "--compute_dtype", "bfloat16"]
# 16c: BASELINE.json config #5, folder inference at 1024^2 with the
# defectgan_test defaults (batch 4, full width) and SEAN. The decoder's norm
# calls of one G forward (as SLICE_SHAPES at 256^2): three NormResBlocks of
# two norms at H/4, then a NormConvBlock at H/2 and one at H, each
# normalizing its input (256 and 128 channels) before it upsamples
FOLDER_IMAGE = 1024
FOLDER_BATCH = 4
FOLDER_FILES = 9  # 3 batches, the last padded
FOLDER_SHAPES = {(FOLDER_BATCH, 256, 256, 256): 6,
                 (FOLDER_BATCH, 256, 512, 512): 1,
                 (FOLDER_BATCH, 128, 1024, 1024): 1}
FOLDER_BASE = ["--image_size", str(FOLDER_IMAGE), "--style_norm_block_type",
               "sean"]
GRID_SOURCES = 4  # 16d: the SEAN grids' sources
# phase 17: the metric nets card vs CPU (f32, TF32 off): relative L2; a
# feature request's batch; the metric CLIs' --dims (a 2048-wide FID spends
# seconds in scipy's sqrtm on the host, timed in 17a) and --num_imgs
METRIC_BAND = 1e-4
INCEPTION_BATCH = 32
METRIC_DIMS = 768
METRIC_IMGS = 16
METRIC_P2P_PAIRS = 8

# phase 18: data-parallel training. The card's machine has one H100, so NCCL
# forms a group of one there (18a); two ranks share cuda:0 over gloo
# (18b-18d, one launch), which is no scaling figure. 18b: 1 timed
# super-step after the agreement's; pix2pix's default batch of 1 does not
# split over 2 ranks; 18d trains at batch 32 (3 super-steps an epoch a
# rank)
DP_DIR = CLI_DIR / "dp"
DP_RANKS = ("cuda:0", "cuda:0")
DP_TIMED = (0, 1)
DP_P2P_BATCH = 2
DP_CLI_BATCH = 32
DP_RANGES = ("parallel.grad_all_reduce", "parallel.batch_norm")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def make_norm_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dtype)
    g = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    b = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    return x, g, b


def full_config(**kw):
    from de_i2i_gan_torch.config import DefectGanConfig
    cfg = DefectGanConfig(image_size=256, label_nc=6, ngf=64, ndf=64,
                          num_scales=2, num_res=6, num_layers=5, hidden_nc=128,
                          style_norm_block_type="adain", use_pallas=True,
                          sean_alpha=None, compute_dtype="bfloat16",
                          fused_g_forward=True)
    return cfg.replace(**kw)


def sean_config(**kw):
    """The SEAN decoder with its running statistics and distillation."""
    return full_config(style_norm_block_type="sean", embed_nc=EMBEDS[1],
                       num_embeds=EMBEDS[0], use_running_stats=True,
                       style_distill=True, **kw)


def spade_config(**kw):
    """The default decoder, with spectral norm and noise injection."""
    return full_config(style_norm_block_type="spade", use_spectral=True,
                       add_noise=True, **kw)


def small_config(**kw):
    from de_i2i_gan_torch.config import DefectGanConfig
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain", use_pallas=True)
    return cfg.replace(**kw)


def style_input(cfg, gen, *lead):
    """The style input the decoder takes beside the labels: SEAN's
    embeddings, made on the card; none for AdaIN (E makes it) and SPADE."""
    if cfg.style_norm_block_type != "sean":
        return None
    return torch.randn((*lead, cfg.num_embeds, cfg.embed_nc), generator=gen,
                       device="cuda")


def expected_launches(cfg, forwards, backwards):
    """Kernel launches of ``forwards`` G forwards and ``backwards`` G
    backwards: one per style norm of the decoder, none for SPADE."""
    if cfg.style_norm_block_type == "spade" or not cfg.use_pallas:
        return 0, 0
    per_g = 2 * (cfg.num_res // 2) + cfg.num_scales
    return forwards * per_g, backwards * per_g


# ------------------------------------------------------------- 2. build


def phase_build_report(nk, info, smi):
    """ptxas's lines for every kernel instantiation (failing on any spill),
    and the occupancy of each tier the planner can run at the paths' row
    lengths: blocks resident on an SM and, for a cluster plan, the clusters
    cudaOccupancyMaxActiveClusters finds room for on the card."""
    entries = spills = 0
    for line in info.log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")
        entries += "Compiling entry" in line
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills += 1
            check(m.group(1) == m.group(2) == "0", f"ptxas spilled: {line.strip()}")
    check(entries > 0 and spills >= entries,
          f"ptxas reported spills for {spills} of {entries} kernels")
    print(f"build: {entries} kernel instantiations, 0 spill bytes in each")
    lengths = sorted({h * w for shapes in (SLICE_SHAPES, SGV2_SHAPES)
                      for _, _, h, w in shapes})
    for op in ("fwd", "bwd"):
        for dt in (torch.bfloat16, torch.float32):
            for hw in lengths:
                for tier in nk.feasible_tiers(op, hw, dt):
                    p, blocks, clusters = nk.occupancy(op, hw, dt, tier=tier)
                    planned = p == nk.plan(op, hw, dt, True)
                    check(blocks >= (2 if p.tier == "C" else 1),
                          f"{op} {p} at rows of {hw}: {blocks} blocks an SM")
                    check(p.cluster == 1 or clusters > 0,
                          f"{op} {p}: no cluster fits the card")
                    cl = (f", {clusters} clusters of {p.cluster} resident on the "
                          f"card" if p.tier == "C" else "")
                    print(f"occupancy {op} {str(dt)[6:]} rows of {hw}: tier "
                          f"{tier_label(p)}{' (planned)' if planned else ''}, "
                          f"{p.smem} B shared, {blocks} blocks an SM{cl} [{smi}]")


# ------------------------------------------------------------ 3. kernels


def boundary_shapes(nk, op, dtype):
    """Rows at the planner's tier boundaries, 12 of them: the longest a warp
    holds and the next aligned length; the same for a block; the longest
    each cluster size holds and the next (the next cluster size, or
    streaming past 8)."""
    v = nk.VECTOR_ELEMS[dtype]
    lengths = [nk.WARP_ROW_MAX, nk.WARP_ROW_MAX + v,
               nk.BLOCK_ROW_VECTORS * v, (nk.BLOCK_ROW_VECTORS + 1) * v]
    for cs in nk.CLUSTER_SIZES:
        longest = nk.longest_cluster_row(op, dtype, cs)
        lengths += [longest, longest + v]
    return [(2, 3, 1, hw) for hw in lengths]


def tier_label(p):
    return f"{p.tier}{p.cluster}" if p.tier == "C" else p.tier


def phase_fwd_vs_plain(nk, fused, smi,
                       shapes=(*SLICE_SHAPES, *TRAIN_SHAPES, *MAE_SHAPES,
                               RAGGED),
                       acts=(None, "relu", "leaky_relu"), boundaries=True):
    """Every tier the planner can run at each shape (the planned one first,
    tier S last) against the plain version; with ``boundaries`` also at the
    tier boundaries of each dtype."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(s, dt, act) for s in shapes for dt in dtypes for act in acts]
    if boundaries:
        cases += [(s, dt, act) for dt in dtypes
                  for s in boundary_shapes(nk, "fwd", dt) for act in acts]
    worst = 0.0
    for i, (shape, dt, act) in enumerate(cases):
        x, g, b = make_norm_inputs(shape, dt, SEED + i)
        ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
        tol = (dict(atol=F32_TOL, rtol=F32_TOL) if dt == torch.float32
               else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
        hw = shape[2] * shape[3]
        errs = []
        for tier in nk.feasible_tiers("fwd", hw, dt, x.data_ptr() % 16 == 0):
            p = nk.plan("fwd", hw, dt, True, tier)
            y, mean, inv = nk.modulated_instance_norm_fwd(x, g, b, act, tier=tier)
            torch.cuda.synchronize()
            check(y.dtype == dt and y.shape == x.shape, "kernel output dtype/shape")
            torch.testing.assert_close(y.float(), ry.float(), **tol)
            torch.testing.assert_close(mean, rmean, atol=F32_TOL, rtol=F32_TOL)
            torch.testing.assert_close(inv, rinv, atol=F32_TOL, rtol=F32_TOL)
            err = (y.float() - ry.float()).abs().max().item()
            worst = max(worst, err)
            errs.append(f"{tier_label(p)} max|dy|={err:.3e} max|dmean|="
                        f"{(mean - rmean).abs().max().item():.3e} max|dinv|="
                        f"{(inv - rinv).abs().max().item():.3e}")
            del y
        print(f"fwd kernel-vs-plain {tuple(shape)} {str(dt)[6:]} act={act}: "
              f"{'; '.join(errs)} tol={tol} [{smi}]")
        del x, ry
    free_memory()
    return worst


def bf16_ulp(t):
    """One bf16 ulp at |t| (2**-133 below the normal range)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def phase_bwd_vs_plain(nk, fused, smi,
                       shapes=(*TRAIN_SHAPES, *MAE_SHAPES, RAGGED),
                       acts=(None, "relu", "leaky_relu"), boundaries=True):
    """Every tier the planner can run at each shape against the plain
    version, each run twice: dx, dgamma and dbeta bit-identical from run to
    run; with ``boundaries`` also at the tier boundaries of each dtype."""
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(s, dt, act) for s in shapes for dt in dtypes for act in acts]
    if boundaries:
        cases += [(s, dt, act) for dt in dtypes
                  for s in boundary_shapes(nk, "bwd", dt) for act in acts]
    worst = 0.0
    for i, (shape, dt, act) in enumerate(cases):
        x, g, b = make_norm_inputs(shape, dt, SEED + 100 + i)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 200 + i)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
        # the residuals the training path hands the backward kernel: the
        # forward kernel's, checked against the plain forward's first
        _, mean, inv = nk.modulated_instance_norm_fwd(x, g, b, act)
        _, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
        torch.testing.assert_close(mean, rmean, atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(inv, rinv, atol=F32_TOL, rtol=F32_TOL)
        rdx, rdg, rdb = fused.modulated_instance_norm_bwd_ref(x, g, b, mean,
                                                              inv, dy, act)
        # the sums' scale: sum |dy| and sum |dy * xhat| (the gate only shrinks
        # terms), from the plain backward fed |dy| and |x - mean|
        m = mean[:, :, None, None]
        _, abs_dg, abs_db = fused.modulated_instance_norm_bwd_ref(
            (x.float() - m).abs() + m, g, b, mean, inv, dy.float().abs())
        hw = shape[2] * shape[3]
        errs = []
        for tier in nk.feasible_tiers("bwd", hw, dt, x.data_ptr() % 16 == 0):
            p = nk.plan("bwd", hw, dt, True, tier)
            dx, dg, db = nk.modulated_instance_norm_bwd(x, g, b, mean, inv, dy,
                                                        act, tier=tier)
            dx2, dg2, db2 = nk.modulated_instance_norm_bwd(x, g, b, mean, inv,
                                                           dy, act, tier=tier)
            torch.cuda.synchronize()
            check(torch.equal(dg, dg2) and torch.equal(db, db2)
                  and torch.equal(dx, dx2),
                  f"tier {tier_label(p)} at {shape}: two runs differ")
            check(dx.dtype == dt and dx.shape == x.shape and dg.shape == (
                shape[0], shape[1]), "backward kernel output dtype/shape")
            if dt == torch.float32:
                tol = f"atol = rtol = {BWD_F32_TOL}"
                torch.testing.assert_close(dx, rdx, atol=BWD_F32_TOL,
                                           rtol=BWD_F32_TOL)
            else:
                tol = f"1 bf16 ulp + {BWD_BF16_ATOL}"
                used = ((dx.float() - rdx.float()).abs() /
                        (bf16_ulp(rdx) + BWD_BF16_ATOL)).max().item()
                check(used <= 1.0, f"bf16 dx differs from the plain version's "
                      f"by {used:.2f} x (1 bf16 ulp + {BWD_BF16_ATOL}), tier "
                      f"{tier_label(p)} at {shape}")
            dg_rel = ((dg - rdg).abs() / abs_dg.clamp_min(1e-30)).max().item()
            db_rel = ((db - rdb).abs() / abs_db.clamp_min(1e-30)).max().item()
            check(dg_rel <= SUM_BAND and db_rel <= SUM_BAND,
                  f"dgamma/dbeta outside the band: {dg_rel:.3e} {db_rel:.3e} of "
                  f"the absolute sums (band {SUM_BAND}), tier {tier_label(p)} "
                  f"at {shape}")
            err = (dx.float() - rdx.float()).abs().max().item()
            worst = max(worst, err)
            used_s = f" ({used:.2f} of the tolerance)" if dt == torch.bfloat16 else ""
            errs.append(f"{tier_label(p)} max|ddx|={err:.3e}{used_s} max|ddgamma|="
                        f"{(dg - rdg).abs().max().item():.3e} ({dg_rel:.2e} of "
                        f"sum|.|) max|ddbeta|={(db - rdb).abs().max().item():.3e}"
                        f" ({db_rel:.2e})")
            del dx, dx2
        print(f"bwd kernel-vs-plain {tuple(shape)} {str(dt)[6:]} act={act}: "
              f"{'; '.join(errs)}; bit-identical over 2 runs; dx tol {tol} [{smi}]")
        del x, dy, rdx
    free_memory()
    return worst


# ----------------------------------------------------------- 4. serving


def phase_reference(nk, smi):
    """The card's kernel path against the port on the CPU (which
    tests/test_torch_generator.py holds against the JAX package) on a small
    float32 input: forward tolerance 5e-4 (DESIGN.md section 7)."""
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    cfg = small_config()
    card, cpu = DefectGanSteps(cfg, device="cuda"), DefectGanSteps(cfg, device="cpu")
    init_weights(card, SEED)
    init_weights(cpu, SEED)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    labels = torch.eye(4)[:2]
    before = nk.LAUNCHES
    out, prob = card.generate(x, labels)
    check(nk.LAUNCHES - before == 4, "small config did not launch the kernel 4 times")
    rout, rprob = cpu.generate(x, labels)
    torch.testing.assert_close(out.cpu(), rout, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(prob.cpu(), rprob, atol=5e-4, rtol=5e-4)
    print(f"reference: card kernel path vs CPU plain path, 32x32 f32: "
          f"max|dout|={(out.cpu() - rout).abs().max().item():.3e} "
          f"max|dprob|={(prob.cpu() - rprob).abs().max().item():.3e} tol 5e-4 "
          f"[{smi}]")


def phase_serving(nk, smi, cfg, label, compare=True):
    """Serving ``cfg``: 2 warm-up + 5 timed requests of a batch of 8, the
    path's launch counts; with ``compare``, the same requests through the
    plain version (cfg.use_pallas=False) agree within the band."""
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    steps = DefectGanSteps(cfg, device="cuda")
    init_weights(steps, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    requests = []
    size = cfg.image_size
    for _ in range(7):
        data = torch.rand((BATCH, size, size, 3), generator=gen,
                          device="cuda") * 2 - 1
        idx = torch.randint(0, cfg.label_nc, (BATCH,), generator=gen,
                            device="cuda")
        requests.append((data, F.one_hot(idx, cfg.label_nc).float(),
                         style_input(cfg, gen, BATCH)))
    noise = torch.Generator(device="cuda").manual_seed(SEED + 5)
    want_fwd, _ = expected_launches(cfg, 1, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the serving path's run starts here
    latencies = []
    outputs = []
    for i, (data, labels, style) in enumerate(requests):
        before = nk.LAUNCHES
        t0 = time.perf_counter()
        out, prob = steps.generate(data, labels, style, generator=noise)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        check(nk.LAUNCHES - before == want_fwd,
              f"{label} forward {i} launched the kernel {nk.LAUNCHES - before} "
              f"times, expected {want_fwd}")
        if i >= 2:
            latencies.append(dt_ms)
        outputs.append((out, prob))
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(launches["bwd"] == 0,
          f"{label} serving launched the backward kernel {launches['bwd']} times")

    for out, prob in outputs:
        check_images(out, prob, BATCH, size)
    check(steps.D is None and steps.tx_G is None,
          "serving built the training state")
    mean_ms = sum(latencies) / len(latencies)
    print(f"serving DefectGAN-256 {label} bf16 batch {BATCH}: latency ms "
          f"{[round(v, 3) for v in latencies]} mean {mean_ms:.3f} "
          f"({BATCH * 1e3 / mean_ms:.1f} img/s), peak memory "
          f"{peak_mb:.1f} MiB, forward kernel launches {launches['fwd']}, "
          f"backward kernel launches {launches['bwd']} over {len(requests)} "
          f"forwards [{smi}]")
    result = dict(launches=launches, ms=mean_ms, plain_ms=None,
                  peak_mb=peak_mb, steps=steps, request=requests[2])
    if not compare:
        return result

    # the same requests through the plain version (cfg.use_pallas=False)
    plain = DefectGanSteps(cfg.replace(use_pallas=False), device="cuda")
    plain.G.load_state_dict(steps.G.state_dict())
    if steps.E is not None:
        plain.E.load_state_dict(steps.E.state_dict())
    plain_lat = []
    for i, (data, labels, style) in enumerate(requests):
        t0 = time.perf_counter()
        pout, pprob = plain.generate(data, labels, style)
        torch.cuda.synchronize()
        if i >= 2:
            plain_lat.append((time.perf_counter() - t0) * 1e3)
        out, prob = outputs[i]
        for a, b, name in ((out, pout, "out"), (prob, pprob, "prob")):
            d = (a.float() - b.float()).abs()
            check(d.max().item() <= OUT_BAND and d.mean().item() <= MEAN_BAND,
                  f"{label} request {i} {name}: kernel vs plain max "
                  f"{d.max().item():.3e} mean {d.mean().item():.3e} outside "
                  f"the band (max {OUT_BAND}, mean {MEAN_BAND})")
        if i == 0:
            print(f"{label} kernel path vs plain path, request 0: max|dout|="
                  f"{(out.float() - pout.float()).abs().max().item():.3e} "
                  f"max|dprob|={(prob.float() - pprob.float()).abs().max().item():.3e}"
                  f" band max {OUT_BAND} mean {MEAN_BAND}")
    check(nk.LAUNCHES == launches["fwd"], "the use_pallas=False run launched the kernel")
    pmean = sum(plain_lat) / len(plain_lat)
    print(f"serving {label}, plain version (use_pallas=False): latency ms "
          f"{[round(v, 3) for v in plain_lat]} mean {pmean:.3f} "
          f"({BATCH * 1e3 / pmean:.1f} img/s) [{smi}]")
    result["plain_ms"] = pmean
    return result


def check_images(out, prob, n, size):
    """Generated NHWC bf16 images in [-1, 1] and probabilities in [0, 1]."""
    check(out.shape == (n, size, size, 3) and prob.shape == (n, size, size, 1),
          f"output shapes {tuple(out.shape)} {tuple(prob.shape)}")
    check(out.dtype == torch.bfloat16 and prob.dtype == torch.bfloat16,
          "outputs are not bf16")
    check(bool(torch.isfinite(out).all() and torch.isfinite(prob).all()),
          "non-finite output")
    check(bool((prob >= 0).all() and (prob <= 1).all()), "prob outside [0, 1]")
    check(out.abs().max().item() <= 1.01, "out outside [-1, 1]")


@contextlib.contextmanager
def tally_calls(nk):
    """Counts the kernels' calls by x's shape while the block runs (the
    autograd node reaches both wrappers through the module)."""
    calls = {"fwd": Counter(), "bwd": Counter()}
    fwd, bwd = nk.modulated_instance_norm_fwd, nk.modulated_instance_norm_bwd

    def counted_fwd(x, *args, **kw):
        calls["fwd"][tuple(x.shape)] += 1
        return fwd(x, *args, **kw)

    def counted_bwd(x, *args, **kw):
        calls["bwd"][tuple(x.shape)] += 1
        return bwd(x, *args, **kw)

    nk.modulated_instance_norm_fwd = counted_fwd
    nk.modulated_instance_norm_bwd = counted_bwd
    try:
        yield calls
    finally:
        nk.modulated_instance_norm_fwd = fwd
        nk.modulated_instance_norm_bwd = bwd


def profiled(fn, runs, record_shapes=False):
    """torch.profiler over ``runs`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return prof


def profile_device(fn, runs, label, wall_ms, smi, conv_shapes=False):
    """Where the device time of ``fn`` goes: torch.profiler over ``runs``
    calls, device kernels summed by name; with ``conv_shapes`` also the
    convolution ops with the most device time, by their input shapes."""
    return report_profile(profiled(fn, runs, conv_shapes), runs, label,
                          wall_ms, smi, conv_shapes)


def device_kernels(prof):
    """The device events of ``prof`` summed by name, without the device
    spans of ``record_function`` ranges (``Optimizer.step``, the solver's
    frozen nets), which cover the kernels inside them and the gaps between."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_ms(prof, runs):
    """Device ms of ``prof``'s kernels a run."""
    return sum(e.self_device_time_total for e in device_kernels(prof)) / (
        1e3 * runs)


def report_profile(prof, runs, label, wall_ms, smi, conv_shapes=False):
    """Prints the device kernels of ``prof`` summed by name; returns their
    device ms a run (None where the profiler saw none)."""
    kernels = sorted(device_kernels(prof), key=lambda e: e.self_device_time_total,
                     reverse=True)
    dev_ms = kernel_ms(prof, runs)
    if dev_ms == 0:
        print(f"profile {label}: the profiler saw no device time (not measured)")
        return None
    print(f"profile {label}: {dev_ms:.3f} ms of kernels, "
          f"{sum(e.count for e in kernels) // runs} launches; busy share "
          f"{dev_ms / wall_ms:.1%} of the {wall_ms:.3f} ms unprofiled "
          f"{label} [{smi}]")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / (1e3 * runs):8.3f} ms "
              f"x{e.count // runs:<4d} {e.key[:100]}")
    if conv_shapes:
        convs = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                        if e.key in ("aten::convolution",
                                     "aten::convolution_backward")),
                       key=lambda e: e.device_time_total, reverse=True)
        for e in convs[:6]:
            print(f"  conv op {e.device_time_total / (1e3 * runs):8.3f} ms "
                  f"x{e.count // runs:<4d} {e.key} {str(e.input_shapes)[:160]}")
    return dev_ms


def range_device_ms(prof, name, runs):
    """Device ms a run of the kernels launched inside the profiler range
    ``name`` (``torch.profiler.record_function``), and of the backward of
    the autograd nodes made inside it: autograd's ``evaluate_function``
    events whose forward thread and sequence number are those of a forward
    op inside the range and of none outside it (an op records the next
    node's number, and makes no node under ``no_grad``). Returns (forward
    ms, backward ms)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.thread, e.time_range.start, e.time_range.end)
             for e in events if e.name == name]
    fwd_us = sum(e.device_time_total for e in events if e.name == name)
    def in_backward(e):
        while e is not None:
            if e.name.startswith("autograd::engine"):
                return True
            e = e.cpu_parent
        return False

    inside, outside = set(), set()
    for e in events:
        if e.sequence_nr < 0 or in_backward(e):
            continue
        within = any(t == e.thread and a <= e.time_range.start
                     and e.time_range.end <= b for t, a, b in spans)
        (inside if within else outside).add((e.thread, e.sequence_nr))
    nodes = inside - outside
    bwd_us = sum(e.device_time_total for e in events
                 if e.name.startswith("autograd::engine::evaluate_function:")
                 and (e.fwd_thread, e.sequence_nr) in nodes)
    return fwd_us / (1e3 * runs), bwd_us / (1e3 * runs)


# ------------------------------------------------------------ 5. timing


def device_ms(fn, iters):
    """Device time per call: a sleep kernel holds the stream while the host
    queues every call, so the events time the device, not the enqueue."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at H100 clocks
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def other_tiers(nk, op, hw, dtype, planned, time_tier):
    """Device ms of each tier the planner could also run here, besides the
    planned one and S: the record of whether it chose the fastest."""
    return {tier_label(nk.plan(op, hw, dtype, True, t)): time_tier(t)
            for t in nk.feasible_tiers(op, hw, dtype)
            if t not in (planned.tier, "S")}


def phase_launch_floor(nk, smi, iters=200):
    """Device ms of a launch with next to no work (one tier-W block of 8
    rows of 256), back to back as device_ms times every kernel: the floor
    under the short rows' times."""
    x, g, b = make_norm_inputs((1, 8, 16, 16), torch.bfloat16, SEED)
    fwd = device_ms(lambda i: nk.modulated_instance_norm_fwd(x, g, b), iters)
    _, mean, inv = nk.modulated_instance_norm_fwd(x, g, b)
    bwd = device_ms(lambda i: nk.modulated_instance_norm_bwd(x, g, b, mean, inv,
                                                             x), iters)
    print(f"launch floor: a forward of 8 rows of 256 takes {fwd:.4f} ms, a "
          f"backward {bwd:.4f} ms, back to back [{smi}]")
    return {"fwd_ms": fwd, "bwd_ms": bwd}


def phase_fwd_timing(nk, fused, shapes, smi):
    rows = []
    for shape in shapes:
        n, c, h, w = shape
        x, g, b = make_norm_inputs(shape, torch.bfloat16, SEED)
        io_bytes = 2 * x.numel() * x.element_size()
        # rotate through copies so the working set exceeds the 50 MB L2
        copies = max(2, math.ceil(256e6 / io_bytes))
        xs = [x.clone() for _ in range(copies)]
        w1 = (1.0 + g).reshape(-1).contiguous()
        b1 = b.reshape(-1).contiguous()
        iters = 4 * copies

        def kernel(i):
            nk.modulated_instance_norm_fwd(xs[i % copies], g, b)

        def forced(tier):
            return lambda i: nk.modulated_instance_norm_fwd(xs[i % copies], g,
                                                            b, tier=tier)

        def plain(i):
            fused.modulated_instance_norm_ref(xs[i % copies], g, b)

        def library(i):
            F.instance_norm(xs[i % copies].view(1, n * c, h, w),
                            weight=w1, bias=b1, eps=1e-5)

        # the library call computes the same function
        lib = F.instance_norm(x.view(1, n * c, h, w), weight=w1, bias=b1,
                              eps=1e-5).view(shape)
        torch.testing.assert_close(lib.float(), fused.modulated_instance_norm_ref(
            x, g, b)[0].float(), atol=BF16_ATOL, rtol=BF16_RTOL)
        # plain, streaming, planned, the other tiers, planned, streaming,
        # plain (and the library call between)
        p = nk.plan("fwd", h * w, x.dtype, True)
        p1 = device_ms(plain, iters)
        s1 = device_ms(forced("S"), iters)
        k1 = device_ms(kernel, iters)
        others = other_tiers(nk, "fwd", h * w, x.dtype, p,
                             lambda t: device_ms(forced(t), iters))
        l1 = device_ms(library, iters)
        k2 = device_ms(kernel, iters)
        s2 = device_ms(forced("S"), iters)
        p2 = device_ms(plain, iters)
        nbytes = io_bytes + 4 * n * c * 4  # + gamma, beta in; mean, inv out
        bound_ms, bound_by = bound(nbytes, FWD_FLOPS_PER_ELEMENT * x.numel())
        row = dict(shape=list(shape), tier=p.tier, cluster=p.cluster,
                   ms=(k1 + k2) / 2, streaming_ms=(s1 + s2) / 2,
                   other_tiers_ms=others, plain_ms=(p1 + p2) / 2,
                   library_ms=l1, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        print(f"fwd timing {shape} bf16: tier {tier_label(p)} {k1:.4f}/{k2:.4f} "
              f"ms, tier S {s1:.4f}/{s2:.4f} ms, other tiers {others}, plain "
              f"{p1:.4f}/{p2:.4f} ms, "
              f"F.instance_norm {l1:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s), roofline share "
              f"{bound_ms / row['ms']:.1%} (tier S "
              f"{bound_ms / row['streaming_ms']:.1%}), {copies} rotating "
              f"copies [{smi}]")
        del xs, x, lib
    free_memory()
    return rows


# ----------------------------------------------------------- 6. training


def make_batches(cfg, gen, critics=CRITICS, batch=BATCH):
    shape = (critics, batch, cfg.image_size, cfg.image_size, cfg.input_nc)
    idx = torch.randint(0, cfg.label_nc, (critics, batch), generator=gen,
                        device="cuda")
    batches = {"bg": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
               "df": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
               "df_labels": F.one_hot(idx, cfg.label_nc).float()}
    if cfg.style_norm_block_type == "sean":
        batches["nm_embeds"] = style_input(cfg, gen, critics, batch)
        batches["df_embeds"] = style_input(cfg, gen, critics, batch)
    return batches


def training_steps(cfg, tcfg, device="cuda"):
    """Steps with D and the optimizers built, weights from SEED."""
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    steps = DefectGanSteps(cfg, tcfg, device=device)
    steps.init_training()
    init_weights(steps, SEED)
    return steps


def nets(steps):
    return [n for n in ("G", "E", "D") if getattr(steps, n) is not None]


def param_snapshot(steps):
    return {n: {k: v.detach().float().cpu().clone()
                for k, v in getattr(steps, n).named_parameters()}
            for n in nets(steps)}


def phase_train_small(nk, smi, cfg, label):
    """Tiny f32 config, SGD: the card's kernel path against the CPU's plain
    path on one super-step; losses, and (after - before) / lr per tensor as
    a relative L2 difference. The card's plain path (use_pallas=False) is
    the control: a ReLU gate whose input lies within rounding of 0 can fall
    either way on two devices and move an upstream gradient element past an
    element-wise tolerance, kernel or no kernel. The path must draw no
    random numbers (no noise, no DiffAugment): the two devices' streams
    differ."""
    from de_i2i_gan_torch.config import TrainConfig

    tcfg = TrainConfig(batch_size=2, num_critics=2, lr=(2e-2, 1e-2),
                       optimizer="sgd")
    cpu = training_steps(cfg, tcfg, "cpu")
    before = param_snapshot(cpu)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = make_batches(cfg, gen, critics=2, batch=2)
    rmetrics = cpu.super_step({k: v.cpu() for k, v in batches.items()})
    results, deltas = {}, {}
    for use_pallas in (True, False):
        card = training_steps(cfg.replace(use_pallas=use_pallas), tcfg)
        fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
        metrics = card.super_step(batches)
        torch.cuda.synchronize()
        want = expected_launches(card.cfg, 4, 2)
        got_launches = (nk.LAUNCHES - fwd0, nk.BWD_LAUNCHES - bwd0)
        check(got_launches == want, f"small {label} super-step use_pallas="
              f"{use_pallas} launched {got_launches} kernels (forward, "
              f"backward), expected {want}")
        check(sorted(metrics) == sorted(rmetrics), f"loss terms {sorted(metrics)}")
        # x the band: rtol, and for the distillation terms (KL divergences
        # of nearly equal distributions) an atol besides
        loss = max(abs(metrics[k].item() - v.item()) / (
            LOSS_RTOL * abs(v.item()) + (DISTILL_ATOL if "distill" in k else 0))
            for k, v in rmetrics.items())
        rel, elem = 0.0, 0.0
        for n in nets(cpu):
            lr = tcfg.lr_d if n == "D" else tcfg.lr_g
            got = dict(getattr(card, n).named_parameters())
            for k, ref in getattr(cpu, n).named_parameters():
                gk = (got[k].detach().cpu() - before[n][k]) / lr
                rk = (ref.detach() - before[n][k]) / lr
                deltas[use_pallas, n, k] = gk
                # a tensor whose gradient is zero in exact arithmetic (the BN
                # bias before an instance norm) gets the element-wise atol
                rel = max(rel, ((gk - rk).norm() / (
                    GRAD_REL_L2 * rk.norm() + GRAD_ATOL * rk.numel() ** 0.5)
                ).item())
                elem = max(elem, ((gk - rk).abs() / (
                    GRAD_ATOL + GRAD_RTOL * rk.abs())).max().item())
        results[use_pallas] = (loss, rel, elem)
        state = max((b.cpu().float() - a.float()).abs().max().item()
                    for a, b in zip(cpu.G.buffers(), card.G.buffers()))
        check(state <= 1e-3, f"small {label} super-step: G's state (BN "
              f"statistics, spectral u/v, SEAN statistics) differs by {state:.2e}")
        print(f"small {label} super-step, card {'kernel' if use_pallas else 'plain'} "
              f"path vs CPU plain path, 32x32 f32 SGD: max loss diff "
              f"{loss:.3f} x (rtol {LOSS_RTOL}, distillation terms + atol "
              f"{DISTILL_ATOL}); (after-before)/lr: max per-tensor "
              f"L2 diff {rel:.3f} x (band {GRAD_REL_L2} |ref| + atol "
              f"{GRAD_ATOL} sqrt(n)), max element "
              f"diff {elem:.3f} x (atol {GRAD_ATOL} + rtol {GRAD_RTOL} |ref|), "
              f"G state max diff {state:.2e} (band 1e-3) [{smi}]")
        del card
    # the kernel alone: the card's two paths, element-wise
    alone = max(((deltas[True, n, k] - deltas[False, n, k]).abs() / (
        GRAD_ATOL + GRAD_RTOL * deltas[False, n, k].abs())).max().item()
        for _, n, k in deltas if _)
    print(f"small {label} super-step, card kernel path vs card plain path: max element "
          f"diff of (after-before)/lr {alone:.3f} x (atol {GRAD_ATOL} + rtol "
          f"{GRAD_RTOL} |ref|) [{smi}]")
    check(alone <= 1.0, f"the card's kernel and plain paths differ: {alone:.3f}")
    loss, rel, _ = results[True]
    check(loss <= 1.0, f"small super-step losses outside the band: {loss:.3f}")
    check(rel <= 1.0, f"small super-step gradients outside the band: {rel:.3f}")


def phase_training(nk, smi, cfg, label, diff_aug="", warmup=2, timed=5):
    """The training path of ``cfg``: full-width super-steps with the
    configuration's optimizer settings (Adam 0.5/0.999, lr (2e-4, 1e-4),
    step schedule) and DiffAugment policy, random draws from a seeded
    generator on the card."""
    from de_i2i_gan_torch.config import TrainConfig

    tcfg = TrainConfig(batch_size=BATCH, num_critics=CRITICS, lr=(2e-4, 1e-4),
                       diff_aug=diff_aug)
    steps = training_steps(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batches = [make_batches(cfg, gen) for _ in range(warmup + timed)]
    draws = torch.Generator(device="cuda").manual_seed(SEED + 6)
    per_fwd, per_bwd = expected_launches(cfg, G_FORWARDS_PER_SUPER_STEP,
                                         G_BACKWARDS_PER_SUPER_STEP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the training path's run starts here
    times, metrics = [], []
    for i, batch in enumerate(batches):
        fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
        t0 = time.perf_counter()
        m = steps.super_step(batch, draws)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        check(nk.LAUNCHES - fwd0 == per_fwd and nk.BWD_LAUNCHES - bwd0 == per_bwd,
              f"{label} super-step {i} launched {nk.LAUNCHES - fwd0} forward and "
              f"{nk.BWD_LAUNCHES - bwd0} backward kernels, expected {per_fwd} "
              f"and {per_bwd}")
        if i >= warmup:
            times.append(dt_ms)
        metrics.append({k: v.item() for k, v in m.items()})
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()),
              f"{label} super-step {i}: non-finite loss {m}")
    for n in nets(steps):
        for k, p in getattr(steps, n).named_parameters():
            check(bool(torch.isfinite(p).all()), f"{label} {n} {k} is not finite")
    check(steps.step == CRITICS * len(batches) and steps.tx_G.count == len(batches),
          "update counts")
    mean_ms = sum(times) / len(times)
    print(f"training DefectGAN-256 {label} bf16 batch {BATCH}, {CRITICS} "
          f"critics, diff_aug={diff_aug!r}: super-step ms "
          f"{[round(v, 3) for v in times]} mean {mean_ms:.3f} "
          f"({BATCH * 1e3 / mean_ms:.1f} img/s through G), peak memory "
          f"{peak_mb:.1f} MiB, launches over {len(batches)} super-steps: "
          f"forward {launches['fwd']}, backward {launches['bwd']} [{smi}]")
    print(f"{label} losses, super-step 1: "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[0].items()})}")
    print(f"{label} losses, super-step {len(metrics)}: "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[-1].items()})}")
    return dict(launches=launches, ms=mean_ms, peak_mb=peak_mb, steps=steps,
                batch=batches[-1], draws=draws, super_steps=len(batches))


def phase_sean_stats_request(nk, steps, smi):
    """The epoch update of SEAN's running statistics after training, then
    one request that samples them (``inference_stats``) with noise, held
    against the same request through the use_pallas=False path within the
    serving band of phase 4."""
    from de_i2i_gan_torch.nn.normalization import SEAN
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    seans = [m for m in steps.G.modules() if isinstance(m, SEAN)]
    tracked = sum(m.count.sum().item() for m in seans)
    check(tracked > 0, "SEAN training tracked no statistics")
    steps.update_per_epoch()
    seen = 0
    for m in seans:
        check(m.count.sum().item() == 0, "accumulators not reset")
        check(bool(torch.isfinite(m.mean).all() and torch.isfinite(m.std).all()),
              "non-finite SEAN statistics")
        seen += int((m.std > 0).all(dim=1).sum().item())
    check(seen > 0, "no label combination has statistics")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    size = steps.cfg.image_size
    data = torch.rand((BATCH, size, size, 3), generator=gen, device="cuda") * 2 - 1
    labels = make_batches(steps.cfg, gen, 1)["df_labels"][0]
    noise = torch.randn((BATCH, steps.cfg.hidden_nc), generator=gen,
                        device="cuda")
    before = nk.LAUNCHES
    out, prob = steps.generate(data, labels, noise, inference_stats=True)
    torch.cuda.synchronize()
    want, _ = expected_launches(steps.cfg, 1, 0)
    check(nk.LAUNCHES - before == want,
          f"the inference_stats request launched {nk.LAUNCHES - before} kernels")
    check_images(out, prob, BATCH, size)
    plain = DefectGanSteps(steps.cfg.replace(use_pallas=False), device="cuda")
    plain.G.load_state_dict(steps.G.state_dict())  # weights and statistics
    plain.G.train(steps.G.training)
    launched = nk.LAUNCHES
    pout, pprob = plain.generate(data, labels, noise, inference_stats=True)
    check(nk.LAUNCHES == launched, "the use_pallas=False request launched the kernel")
    diffs = {}
    for a, b, name in ((out, pout, "out"), (prob, pprob, "prob")):
        d = (a.float() - b.float()).abs()
        diffs[name] = (d.max().item(), d.mean().item())
        check(diffs[name][0] <= OUT_BAND and diffs[name][1] <= MEAN_BAND,
              f"sean inference_stats request {name}: kernel vs plain max "
              f"{diffs[name][0]:.3e} mean {diffs[name][1]:.3e} outside the "
              f"band (max {OUT_BAND}, mean {MEAN_BAND})")
    del plain
    print(f"sean statistics: {tracked:.0f} style codes tracked over "
          f"{len(seans)} layers, finalized ({seen} (layer, label combination) "
          f"rows with statistics); one inference_stats request: {want} "
          f"forward kernel launches, outputs finite and in range; against the "
          f"use_pallas=False path max|dout|={diffs['out'][0]:.3e} (mean "
          f"{diffs['out'][1]:.3e}) max|dprob|={diffs['prob'][0]:.3e} (mean "
          f"{diffs['prob'][1]:.3e}), band max {OUT_BAND} mean {MEAN_BAND} "
          f"[{smi}]")


def phase_train_compare(smi, make_cfg, label, diff_aug=""):
    """G's parameter deltas after one super-step, kernel path against the
    use_pallas=False path, at full width. SGD (lr_g 1e-2, so the deltas sit
    far above the f32 ulp of the weights) makes a delta -lr * gradient. An
    f32 control run sets what agreement means: there the two paths differ
    only by summation order; in bf16 the kernel path must land as close to
    the f32 plain path as the bf16 plain path does. Every run takes the
    same DiffAugment draws from a generator seeded alike."""
    from de_i2i_gan_torch.config import TrainConfig

    tcfg = TrainConfig(batch_size=BATCH, num_critics=CRITICS, lr=(2e-4, 1e-2),
                       optimizer="sgd", diff_aug=diff_aug)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = make_batches(make_cfg(), gen)
    deltas, losses = {}, {}
    for dtype in ("bfloat16", "float32"):
        for use_pallas in (True, False):
            steps = training_steps(
                make_cfg(compute_dtype=dtype, use_pallas=use_pallas), tcfg)
            before = [p.detach().clone() for p in steps.G.parameters()]
            m = steps.super_step(batch, torch.Generator(device="cuda")
                                 .manual_seed(SEED + 8))
            deltas[dtype, use_pallas] = torch.cat(
                [((p.detach() - b) / tcfg.lr_g).reshape(-1)
                 for p, b in zip(steps.G.parameters(), before)])
            losses[dtype, use_pallas] = {k: v.item() for k, v in m.items()}
            del steps, before, m
            free_memory()

    def rel(a, b):
        return ((deltas[a] - deltas[b]).norm() / deltas[b].norm()).item()

    f32 = rel(("float32", True), ("float32", False))
    k16 = rel(("bfloat16", True), ("float32", False))
    p16 = rel(("bfloat16", False), ("float32", False))
    kp16 = rel(("bfloat16", True), ("bfloat16", False))
    band = BF16_DELTA_FACTOR * p16 + F32_DELTA_BAND
    print(f"{label} G deltas after one SGD super-step, relative L2 difference: "
          f"f32 kernel vs f32 plain {f32:.3e} (band {F32_DELTA_BAND}); bf16 "
          f"kernel vs f32 plain {k16:.3e}, bf16 plain vs f32 plain {p16:.3e} "
          f"(band {BF16_DELTA_FACTOR} x that + {F32_DELTA_BAND} = {band:.3e}); "
          f"bf16 kernel vs bf16 plain {kp16:.3e} [{smi}]")
    for key, m in losses.items():
        print(f"  losses {key[0]} use_pallas={key[1]}: "
              f"{json.dumps({k: round(v, 5) for k, v in m.items()})}")
    check(f32 <= F32_DELTA_BAND,
          f"{label} f32 kernel path G deltas differ from the plain path by {f32:.3e}")
    check(k16 <= band,
          f"{label} bf16 kernel path G deltas differ from the f32 plain path by "
          f"{k16:.3e}, outside {band:.3e}")
    return dict(f32=f32, k16=k16, p16=p16, kp16=kp16)


def phase_train_remat(nk, smi):
    """6g. DefectGAN-256 AdaIN with remat: one f32 SGD super-step from one
    state and one batch, remat on against off, each path's launches counted
    from 0. The G step's two fused G forwards keep no activations and rerun
    in the backward pass, kernels included: exactly G_BACKWARDS_PER_SUPER_STEP
    more G forwards' launches, the same backward launches. Losses within
    rtol 2e-4; G's and E's (after - before) / lr per tensor within 6c's
    band, G's as a whole within 6d's f32 band; G's BatchNorm statistics
    within 1e-3 (6c's; a second update in the rerun would move them by
    about a tenth of their distance from the batch's). D's update does not
    pass through remat."""
    from de_i2i_gan_torch.config import TrainConfig

    tcfg = TrainConfig(batch_size=BATCH, num_critics=CRITICS, lr=(2e-4, 1e-2),
                       optimizer="sgd")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batch = make_batches(full_config(), gen)
    out = {}
    for remat in (False, True):
        cfg = full_config(compute_dtype="float32", remat=remat)
        steps = training_steps(cfg, tcfg)
        before = param_snapshot(steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
        m = steps.super_step(batch, torch.Generator(device="cuda")
                             .manual_seed(SEED + 10))
        torch.cuda.synchronize()
        launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        fwd, bwd = expected_launches(
            cfg, G_FORWARDS_PER_SUPER_STEP
            + (G_BACKWARDS_PER_SUPER_STEP if remat else 0),
            G_BACKWARDS_PER_SUPER_STEP)
        check(launches == {"fwd": fwd, "bwd": bwd},
              f"adain super-step remat={remat} launched {launches}, expected "
              f"{fwd} forward and {bwd} backward")
        metrics = {k: v.item() for k, v in m.items()}
        check(all(math.isfinite(v) for v in metrics.values()),
              f"adain super-step remat={remat}: non-finite loss {metrics}")
        out[remat] = dict(steps=steps, metrics=metrics, launches=launches,
                          peak_mb=peak_mb)
        del steps, m
        free_memory()
    on, off = out[True], out[False]
    loss = loss_gap(on["metrics"], off["metrics"])
    lr = {"G": tcfg.lr_g, "E": tcfg.lr_g}
    rel = delta_gap(on["steps"], off["steps"], before, lr)

    def g_delta(steps):
        return torch.cat([((p.detach().float().cpu() - before["G"][k])
                           / tcfg.lr_g).reshape(-1)
                          for k, p in steps.G.named_parameters()])

    whole = ((g_delta(on["steps"]) - g_delta(off["steps"])).norm()
             / g_delta(off["steps"]).norm()).item()
    stats = max((a.float() - b.float()).abs().max().item() for a, b in zip(
        on["steps"].G.buffers(), off["steps"].G.buffers()))
    print(f"adain remat on vs off, one full-width f32 SGD super-step on the "
          f"card: launches {on['launches']} vs {off['launches']}; max loss "
          f"diff {loss:.3f} x (rtol {LOSS_RTOL}); (after-before)/lr of G and "
          f"E: max per-tensor L2 diff {rel:.3f} x (band {GRAD_REL_L2} |ref| + "
          f"atol {GRAD_ATOL} sqrt(n)); G's deltas relative L2 {whole:.3e} "
          f"(band {F32_DELTA_BAND}); G's BatchNorm statistics max diff "
          f"{stats:.2e} (band 1e-3); peak memory {on['peak_mb']:.1f} MiB vs "
          f"{off['peak_mb']:.1f} MiB [{smi}]")
    check(loss <= 1.0 and rel <= 1.0 and whole <= F32_DELTA_BAND
          and stats <= 1e-3,
          f"remat changed the adain super-step: losses {loss:.3f}, deltas "
          f"{rel:.3f}, G {whole:.3e}, statistics {stats:.2e}")
    result = dict(launches=on["launches"], peak_mb=on["peak_mb"],
                  off_peak_mb=off["peak_mb"])
    del out, on, off
    free_memory()
    return result


def phase_bwd_timing(nk, fused, smi, shapes=TRAIN_SHAPES,
                     library_band=LIBRARY_SUM_BAND):
    rows = []
    for shape in shapes:
        n, c, h, w = shape
        x, g, b = make_norm_inputs(shape, torch.bfloat16, SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        dy = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        _, mean, inv = nk.modulated_instance_norm_fwd(x, g, b)
        slab = x.numel() * x.element_size()
        # rotate through copies so the working set exceeds the 50 MB L2
        copies = max(2, math.ceil(256e6 / (3 * slab)))
        xs = [x.clone() for _ in range(copies)]
        dys = [dy.clone() for _ in range(copies)]
        # the library call: autograd of F.instance_norm over (1, N*C, H, W)
        # with the per-(n, c) affine (1 + gamma, beta), one graph per copy
        w1 = (1.0 + g).reshape(-1).detach().requires_grad_()
        b1 = b.reshape(-1).detach().requires_grad_()
        lxs = [t.view(1, n * c, h, w).detach().requires_grad_() for t in xs]
        lys = [F.instance_norm(t, weight=w1, bias=b1, eps=1e-5) for t in lxs]
        iters = 4 * copies

        def kernel(i):
            nk.modulated_instance_norm_bwd(xs[i % copies], g, b, mean, inv,
                                           dys[i % copies])

        def forced(tier):
            return lambda i: nk.modulated_instance_norm_bwd(
                xs[i % copies], g, b, mean, inv, dys[i % copies], tier=tier)

        def plain(i):
            fused.modulated_instance_norm_bwd_ref(xs[i % copies], g, b, mean,
                                                  inv, dys[i % copies])

        def library(i):
            j = i % copies
            torch.autograd.grad(lys[j], (lxs[j], w1, b1),
                                dys[j].view(1, n * c, h, w), retain_graph=True)

        # the library call computes the same function
        ldx, ldg, ldb = torch.autograd.grad(lys[0], (lxs[0], w1, b1),
                                            dys[0].view(1, n * c, h, w),
                                            retain_graph=True)
        rdx, rdg, rdb = fused.modulated_instance_norm_bwd_ref(x, g, b, mean,
                                                              inv, dy)
        torch.testing.assert_close(ldx.view(shape).float(), rdx.float(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
        # its dgamma/dbeta against the plain sums, relative to the sums of
        # the absolute terms (it does not hold to SUM_BAND in bf16)
        m = mean[:, :, None, None]
        _, abs_dg, abs_db = fused.modulated_instance_norm_bwd_ref(
            (x.float() - m).abs() + m, g, b, mean, inv, dy.float().abs())
        lib_rel = max(((ldg.view(n, c) - rdg).abs() / abs_dg).max().item(),
                      ((ldb.view(n, c) - rdb).abs() / abs_db).max().item())
        check(lib_rel <= library_band, f"the library's dgamma/dbeta differ "
              f"by {lib_rel:.2e} of the absolute sums (band {library_band:.2e})")
        p = nk.plan("bwd", h * w, x.dtype, True)
        p1 = device_ms(plain, iters)
        s1 = device_ms(forced("S"), iters)
        k1 = device_ms(kernel, iters)
        others = other_tiers(nk, "bwd", h * w, x.dtype, p,
                             lambda t: device_ms(forced(t), iters))
        l1 = device_ms(library, iters)
        k2 = device_ms(kernel, iters)
        s2 = device_ms(forced("S"), iters)
        p2 = device_ms(plain, iters)
        # x and dy read, dx written; gamma, beta, mean, inv in, dgamma, dbeta out
        nbytes = 3 * slab + 6 * n * c * 4
        bound_ms, bound_by = bound(nbytes, BWD_FLOPS_PER_ELEMENT * x.numel())
        row = dict(shape=list(shape), tier=p.tier, cluster=p.cluster,
                   ms=(k1 + k2) / 2, streaming_ms=(s1 + s2) / 2,
                   other_tiers_ms=others, plain_ms=(p1 + p2) / 2,
                   library_ms=l1, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        print(f"bwd timing {shape} bf16: tier {tier_label(p)} "
              f"{k1:.4f}/{k2:.4f} ms, tier S {s1:.4f}/{s2:.4f} ms, other "
              f"tiers {others}, plain "
              f"{p1:.4f}/{p2:.4f} ms, autograd of "
              f"F.instance_norm {l1:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s), roofline share "
              f"{bound_ms / row['ms']:.1%} (tier S "
              f"{bound_ms / row['streaming_ms']:.1%}), {copies} rotating copies; the "
              f"library's dgamma/dbeta within {lib_rel:.2e} of the absolute "
              f"sums [{smi}]")
        del xs, dys, lxs, lys, x, dy
    free_memory()
    return rows


def profile_super_step(run, label, smi):
    return profile_device(lambda: run["steps"].super_step(run["batch"],
                                                          run["draws"]),
                          1, f"{label} super-step", run["ms"], smi)


def check_train_calls(calls, label):
    """A super-step's kernel calls at each training shape: one per style
    norm of every G forward and backward."""
    check(calls["fwd"] == Counter(
        {s: G_FORWARDS_PER_SUPER_STEP * c for s, c in TRAIN_SHAPES.items()})
        and calls["bwd"] == Counter(
        {s: G_BACKWARDS_PER_SUPER_STEP * c for s, c in TRAIN_SHAPES.items()}),
        f"{label} super-step calls by shape {calls}")


def launches_by_path(paths, kind):
    """Each path's launches of one kernel, as counted while it ran."""
    return {name: run["launches"][kind] for name, run in paths.items()}


def with_calls(rows, calls, runs):
    """Per-call rows with the calls a run made at each shape, counted while
    ``runs`` passes of the path ran."""
    out = []
    for r in rows:
        n = calls[tuple(r["shape"])]
        check(n % runs == 0, f"{n} calls at {r['shape']} over {runs} runs")
        out.append({**r, "calls": n // runs})
    return out


# a timing row's device times, summed over a path's calls
SUMMED = ("ms", "streaming_ms", "plain_ms", "bound_ms", "library_ms")


def summed(rows, key):
    """A kernel's time over its calls in one pass of the path."""
    return sum(r[key] * r["calls"] for r in rows)


def kernel_record(name, replaces, rows, launches_by_path, worst, unit,
                  extra=None):
    per_step = {"calls": sum(r["calls"] for r in rows),
                **{k: summed(rows, k) for k in SUMMED}}
    record = {
        "name": name,
        "route": "cuda",
        "source": "de_i2i_gan_torch/csrc/modulated_instance_norm.cu",
        "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": worst,
        "unit": unit,
        **{k: per_step[k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": per_step["library_ms"],
        "per_super_step": per_step,
        "per_call": rows,
    }
    record.update(extra or {})
    return record


# --------------------------------------------- 8. the entry points a user calls


def report_tiers(record, smi):
    """Each timed shape's planned tier against tier S (the streaming design)
    from the same call, and each path's share of its bound."""
    for kernel in record["kernels"]:
        paths = {"per_super_step": kernel["per_call"],
                 **{k: v["per_call"] for k, v in kernel.items()
                    if k.startswith("per_") and isinstance(v, dict)
                    and "per_call" in v}}
        for path, rows in paths.items():
            for r in rows:
                speedup = r["streaming_ms"] / r["ms"]
                tier = r["tier"] + (str(r["cluster"]) if r["tier"] == "C" else "")
                times = {tier: r["ms"], "S": r["streaming_ms"], **r["other_tiers_ms"]}
                fastest = min(times, key=times.get)
                print(f"{kernel['name']} {path} {tuple(r['shape'])}: tier "
                      f"{tier} {r['ms']:.4f} ms (roofline share "
                      f"{r['bound_ms'] / r['ms']:.1%}), tier S "
                      f"{r['streaming_ms']:.4f} ms "
                      f"({r['bound_ms'] / r['streaming_ms']:.1%}): {speedup:.2f}x"
                      f", {'no slower' if r['ms'] <= 1.015 * r['streaming_ms'] else 'slower'}"
                      f" than tier S within the 1.5% spread; the fastest tier "
                      f"here {fastest} ({times[fastest]:.4f} ms) [{smi}]")
        for path in ("per_super_step", "per_serving_forward", "per_sgv2_forward",
                     "per_sgv2_train_iteration", "per_mae_super_step",
                     "per_sgv2_pretrain_iteration"):
            if path in kernel:
                t = kernel[path]
                print(f"{kernel['name']} {path}: {t['ms']:.4f} ms, roofline "
                      f"share {t['bound_ms'] / t['ms']:.1%} of the "
                      f"{t['bound_ms']:.4f} ms bound; tier S "
                      f"{t['streaming_ms']:.4f} ms, "
                      f"{t['bound_ms'] / t['streaming_ms']:.1%} [{smi}]")


def cli_args(name, *extra):
    return ["--name", name, "--ckpt_dir", str(CLI_DIR / "ckpt"), "--log_dir",
            str(CLI_DIR / "logs"), *CLI_BASE, *extra]


def cli_loader():
    """The super-batches the train CLI feeds (its datasets and seeds)."""
    from de_i2i_gan_torch.data.pipeline import DataLoader, DualStreamLoader
    from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset

    df, bg = (SyntheticDefectDataset(CLI_IMAGE, 6, 512, dt, seed=CLI_SEED)
              for dt in ("defects", "background"))
    return DualStreamLoader(DataLoader(df, BATCH, seed=CLI_SEED),
                            DataLoader(bg, BATCH, seed=CLI_SEED + 1), CRITICS)


class SuperStepClock:
    """Wraps ``DefectGanSteps.super_step`` (or ``target``, a (class, method
    name) pair whose method takes a batch dict and a generator) while an
    entry point runs: every call ends in ``torch.cuda.synchronize()``, and
    its end on the host clock, the kernels' launch counts and its batch's
    keys and devices are kept; calls ``profile_at`` .. ``profile_at +
    PROFILED_SUPER_STEPS - 1`` run under torch.profiler."""

    def __init__(self, nk, profile_at=None, target=None):
        self.nk, self.profile_at = nk, profile_at
        self.target = target
        self.ends, self.launches, self.keys, self.on_card = [], [], [], []
        self.dtypes = []
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        if self.target is None:
            from de_i2i_gan_torch.train.steps import DefectGanSteps
            self.target = (DefectGanSteps, "super_step")
        cls, method = self.target
        self._real = real = getattr(cls, method)
        last = (None if self.profile_at is None
                else self.profile_at + PROFILED_SUPER_STEPS - 1)

        def timed(steps, batches, generator=None):
            i = len(self.ends)
            if i == self.profile_at:
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
            out = real(steps, batches, generator)
            torch.cuda.synchronize()
            if i == last:
                self.prof.__exit__(None, None, None)
            self.ends.append(time.perf_counter())
            self.launches.append((self.nk.LAUNCHES, self.nk.BWD_LAUNCHES))
            self.keys.append(sorted(batches))
            self.dtypes.append({k: v.dtype for k, v in batches.items()})
            self.on_card.append(all(v.device.type == CARD
                                    for v in batches.values()))
            return out

        setattr(cls, method, timed)
        return self

    def __exit__(self, *exc):
        setattr(*self.target, self._real)

    def steady_ms(self):
        """Host-clock ms between the ends of consecutive super-steps (data
        wait included), from the third on, the profiled ones left out."""
        skip = (range(0) if self.profile_at is None else
                range(self.profile_at, self.profile_at + PROFILED_SUPER_STEPS))
        return [(self.ends[i] - self.ends[i - 1]) * 1e3
                for i in range(2, len(self.ends)) if i not in skip]


def check_trainer_launches(nk, clock, label, cfg):
    """Exact launches: 56 forward and 16 backward a super-step, no other."""
    n = len(clock.ends)
    per_fwd, per_bwd = expected_launches(cfg, G_FORWARDS_PER_SUPER_STEP,
                                         G_BACKWARDS_PER_SUPER_STEP)
    check(n > 0 and (nk.LAUNCHES, nk.BWD_LAUNCHES) == (per_fwd * n, per_bwd * n),
          f"{label}: {nk.LAUNCHES} forward and {nk.BWD_LAUNCHES} backward "
          f"launches over {n} super-steps, expected {per_fwd} and {per_bwd} each")
    prev = (0, 0)
    for i, cur in enumerate(clock.launches):
        check((cur[0] - prev[0], cur[1] - prev[1]) == (per_fwd, per_bwd),
              f"{label} super-step {i} launched {cur[0] - prev[0]}/"
              f"{cur[1] - prev[1]} kernels")
        prev = cur
    check(all(clock.on_card), f"{label}: a super-batch reached the step "
          "off the card")
    return {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}


def check_trained(trainer, label):
    """A finished run: no rollback, finite weights."""
    check(trainer._guard.restores == 0,
          f"{label}: the NaN guard rolled back {trainer._guard.restores} times")
    for n in nets(trainer.steps):
        for k, p in getattr(trainer.steps, n).named_parameters():
            check(bool(torch.isfinite(p).all()), f"{label}: {n} {k} not finite")


def h2d_copies(prof, path):
    """The host-to-device copies of a profile (name, stream, bytes) and the
    streams its kernels ran on, from its chrome trace."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = [(e["name"], e["args"].get("stream"), e["args"].get("bytes", 0))
              for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    streams = {e["args"].get("stream") for e in events if e.get("cat") == "kernel"}
    return copies, streams


def flat_state(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_state(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def cpu_state(steps):
    """A copy on the host of the steps' train state, flattened."""
    from de_i2i_gan_torch.train.checkpoint import train_state
    return {k: (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                else v) for k, v in flat_state(train_state(steps)).items()}


def same_state(a, b):
    """Tensor for tensor equality of two train states on the host; None, or
    the first entry that differs."""
    fa, fb = flat_state(a), flat_state(b)
    if fa.keys() != fb.keys():
        return f"keys differ: {sorted(fa.keys() ^ fb.keys())[:5]}"
    for k, v in fa.items():
        same = (torch.equal(v, fb[k]) if isinstance(v, torch.Tensor)
                else v == fb[k])
        if not same:
            return k
    return None


def phase_cli_train(nk, smi, preloaded_ms, name="adain", *extra):
    """8a (8f with ``--native_loader``). ``cli.train_defectgan.main``
    in-process: AdaIN on the synthetic dataset at full width for one epoch,
    through device_prefetch; run ``name`` with the ``extra`` flags."""
    from de_i2i_gan_torch.cli.train_defectgan import main as train_main
    from de_i2i_gan_torch.train.checkpoint import read_iter_record

    label = f"train CLI {name}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the trainer's run starts here
    t0 = time.perf_counter()
    with SuperStepClock(nk, profile_at=PROFILE_AT) as clock:
        trainer = train_main(cli_args(name, "--style_norm_block_type",
                                      "adain", "--num_epochs", "1",
                                      "--save_ckpt_freq", "1", *extra))
    wall_s = time.perf_counter() - t0
    launches = check_trainer_launches(nk, clock, label,
                                      trainer.cfg)  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check_trained(trainer, label)
    n = len(clock.ends)
    check(n == 512 // BATCH // CRITICS and trainer.iters == n * CRITICS,
          f"{n} super-steps, {trainer.iters} iterations")
    run = CLI_DIR / "ckpt" / name
    for f in ("latest_state.pt", "1_state.pt", "iter.txt", "opt.json"):
        check((run / f).exists(), f"the train CLI wrote no {f}")
    check(read_iter_record(CLI_DIR / "ckpt", name) == (1, n * CRITICS),
          "iter.txt")
    image_dtypes = {d[k] for d in clock.dtypes for k in ("df", "bg")}
    steady = clock.steady_ms()
    fed_ms = statistics.median(steady)
    dev_ms = kernel_ms(clock.prof, PROFILED_SUPER_STEPS)
    # every host-to-device copy in the window is a super-batch's, pinned and
    # on the prefetch stream: the step's own torch.as_tensor copied nothing
    copies, streams = h2d_copies(clock.prof, CLI_DIR / f"{name}_trace.json")
    keys = len(clock.keys[0])
    check(len(copies) >= keys and all("Pinned" in c[0] and c[1] not in streams
                                      for c in copies),
          f"host-to-device copies {copies} vs kernel streams {streams}")
    print(f"{label}, 1 epoch: {n} super-steps in {wall_s:.1f} s "
          f"(set-up, checkpoints and all); loader-fed super-step ms, host "
          f"clock, median of {len(steady)} steady: {fed_ms:.3f} "
          f"{[round(v, 3) for v in steady]}; preloaded super_step (phase 6d, "
          f"mean of 5): {preloaded_ms:.3f}; kernels a super-step over "
          f"{PROFILED_SUPER_STEPS} profiled trainer super-steps {dev_ms:.3f} "
          f"ms, busy share {dev_ms / fed_ms:.1%} of the loader-fed time; peak "
          f"memory {peak_mb:.1f} MiB; launches {launches}; images reach the "
          f"step as {sorted(map(str, image_dtypes))} [{smi}]")
    print(f"{label} host-to-device copies in the profiled window: "
          f"{len(copies)} ({len(copies) / keys:.0f} super-batches of {keys} "
          f"arrays, {sum(c[2] for c in copies) / 2**20:.1f} MiB), all from "
          f"pinned memory, on stream(s) {sorted({c[1] for c in copies})}; the "
          f"kernels on stream(s) {sorted(streams)}: the copies ran on a side "
          f"stream and the step copied nothing itself")
    result = dict(launches=launches, ms=fed_ms, dev_ms=dev_ms, peak_mb=peak_mb,
                  super_steps=n, state=cpu_state(trainer.steps),
                  image_dtypes=image_dtypes,
                  copy_mb=sum(c[2] for c in copies) / 2**20 / (len(copies) / keys))
    del trainer, clock
    free_memory()
    return result


def phase_cli_test(nk, smi):
    """8d. ``cli.test_defectgan.main`` on 8a's epoch-1 checkpoint: grids,
    diverse images, classifier accuracy."""
    import numpy as np

    from de_i2i_gan_torch.cli.test_defectgan import main as test_main
    from de_i2i_gan_torch.data.pipeline import DataLoader
    from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset

    # the multi-label combinations of the first test batch, counted apart:
    # the batch of the loader's second pass (--cal_clf makes the first)
    loader = DataLoader(SyntheticDefectDataset(CLI_IMAGE, 6, 64, "defects",
                                               seed=CLI_SEED), BATCH,
                        seed=CLI_SEED)
    for _ in loader:
        pass
    _, labels, _ = next(iter(loader))
    n_multi = len(np.unique(labels[labels.sum(axis=1) > 1], axis=0))
    g_forwards = 1 + n_multi + 5  # the grid request, one a diverse grid
    res = CLI_DIR / "results"
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the test CLI's run starts here
    t0 = time.perf_counter()
    out = test_main(cli_args("adain", "--style_norm_block_type", "adain",
                             "--which_epoch", "1", "--results_dir", str(res),
                             "--save_img_grid", "--save_diverse_images",
                             "--cal_clf"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    want, _ = expected_launches(full_config(), g_forwards, 0)
    check(launches == {"fwd": want, "bwd": 0},
          f"test CLI launches {launches}, expected {want} forward "
          f"({g_forwards} G forwards) and 0 backward")
    pngs = sorted(res.rglob("*.png"))
    check(len(pngs) == BATCH + n_multi + 5 and sorted(out["pngs"]) == pngs,
          f"{len(pngs)} PNGs, expected {BATCH} grids + {n_multi} + 5")
    for p in pngs:
        head = p.read_bytes()[:24]
        w, h = struct.unpack(">II", head[16:24])
        check(head[:8] == b"\x89PNG\r\n\x1a\n" and h == CLI_IMAGE, f"{p.name}")
        if p.name.startswith("grid_"):
            check(w == CLI_IMAGE * (1 + 2 * 5), f"{p.name} is {w} wide")
    acc = out["classifier_accuracy"]
    check(0.0 <= acc <= 1.0, f"accuracy {acc}")
    print(f"test CLI on the epoch-1 checkpoint: {len(pngs)} PNGs ({BATCH} "
          f"grids, {n_multi} multi-label + 5 single-label), classifier "
          f"accuracy {acc:.4f} (D after one epoch of random-weight training "
          f"on synthetic data), {launches['fwd']} forward kernel launches over "
          f"{g_forwards} G forwards, {wall_s:.1f} s [{smi}]")
    free_memory()
    return dict(launches=launches)


def phase_cli_resume(nk, smi, trained):
    """8b. ``--continue_training`` to epoch 2: the state loaded at resume is
    the one saved, and the epoch and iteration counts go on as in JAX."""
    from de_i2i_gan_torch.cli.train_defectgan import main as train_main
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint, read_iter_record
    from de_i2i_gan_torch.train.trainer import DefectGanTrainer

    saved = read_checkpoint(CLI_DIR / "ckpt", "adain", "latest")
    diff = same_state(saved, trained["state"])
    check(diff is None, f"the latest checkpoint differs from the trained state at {diff}")
    entry = {}
    real_train = DefectGanTrainer.train

    def capture(self, *args, **kw):
        entry.update(first_epoch=self.first_epoch, iters=self.iters,
                     state=cpu_state(self.steps))
        return real_train(self, *args, **kw)

    n = trained["super_steps"]
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the resumed run starts here
    DefectGanTrainer.train = capture
    try:
        with SuperStepClock(nk) as clock:
            trainer = train_main(cli_args("adain", "--continue_training",
                                          "--num_epochs", "2",
                                          "--save_ckpt_freq", "4"))
    finally:
        DefectGanTrainer.train = real_train
    launches = check_trainer_launches(nk, clock, "resumed train CLI",
                                      trainer.cfg)  # ... ends here
    check_trained(trainer, "resumed train CLI")
    diff = same_state(entry["state"], saved)
    check(diff is None, f"the state loaded at resume differs at {diff}")
    # as the JAX trainer: the run restarts at the recorded epoch
    check((entry["first_epoch"], entry["iters"]) == (1, n * CRITICS)
          and len(clock.ends) == 2 * n
          and trainer.iters == 3 * n * CRITICS
          and read_iter_record(CLI_DIR / "ckpt", "adain") == (2, 3 * n * CRITICS),
          f"resume: first_epoch {entry['first_epoch']}, iters {entry['iters']} "
          f"-> {trainer.iters}, {len(clock.ends)} super-steps")
    steady = clock.steady_ms()
    print(f"resumed train CLI: state at resume equals the saved one in all "
          f"{len(flat_state(saved))} entries; first_epoch 1, iters "
          f"{entry['iters']} -> {trainer.iters} over {len(clock.ends)} "
          f"super-steps, iter.txt (2, {trainer.iters}); loader-fed super-step "
          f"ms median {statistics.median(steady):.3f}; launches {launches} "
          f"[{smi}]")
    del trainer, clock, entry, saved
    free_memory()
    return dict(launches=launches)


def phase_cli_sean(nk, smi):
    """8c. SEAN with running statistics, distillation and an embedding bank
    (``--embed_path``, an .npz made here from a seed)."""
    import numpy as np

    from de_i2i_gan_torch.cli.train_defectgan import main as train_main
    from de_i2i_gan_torch.data.embeddings import EmbeddingBank
    from de_i2i_gan_torch.nn.normalization import SEAN

    rng = np.random.default_rng(SEED)
    bank = EmbeddingBank(6, EMBEDS[1], capacity=8)
    for idx in range(2 ** 6):
        for _ in range(4):
            bank.add([(idx >> i) & 1 for i in range(6)],
                     rng.normal(0, 1, EMBEDS[1]).astype(np.float32))
    path = CLI_DIR / "bank.npz"
    bank.save(path)
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the SEAN trainer's run starts here
    with SuperStepClock(nk) as clock:
        trainer = train_main(cli_args(
            "sean", "--style_norm_block_type", "sean", "--use_running_stats",
            "--style_distill", "--embed_path", str(path), "--num_epochs", "1"))
    launches = check_trainer_launches(nk, clock, "train CLI sean",
                                      trainer.cfg)  # ... ends here
    check_trained(trainer, "train CLI sean")
    check(all("df_embeds" in k and "nm_embeds" in k for k in clock.keys),
          "the bank's embeddings did not reach the step")
    seans = [m for m in trainer.steps.G.modules() if isinstance(m, SEAN)]
    rows = sum(int((m.std > 0).all(dim=1).sum().item()) for m in seans)
    check(rows > 0 and all(m.count.sum().item() == 0 for m in seans),
          "the epoch update did not finalize SEAN's statistics")
    steady = clock.steady_ms()
    print(f"train CLI sean (--use_running_stats --style_distill --embed_path "
          f"bank of {int(bank.counts.sum())} embeddings): {len(clock.ends)} "
          f"super-steps, loader-fed super-step ms median "
          f"{statistics.median(steady):.3f}, {rows} (layer, label) rows of "
          f"finalized statistics, launches {launches} [{smi}]")
    del trainer, clock
    free_memory()
    return dict(launches=launches)


def loader_pace(make_loader):
    """Host-clock ms a super-batch of a fresh loader: alone, then through
    device_prefetch with the pinned copies to the card; returns both times
    and the batches of each run."""
    from de_i2i_gan_torch.data.pipeline import device_prefetch

    runs = []
    for fed in (False, True):
        loader = make_loader()
        t0 = time.perf_counter()
        if fed:
            batches = []
            for batch in device_prefetch(loader, CARD):
                torch.cuda.current_stream().synchronize()
                batches.append(batch)
        else:
            batches = list(loader)
        runs.append(((time.perf_counter() - t0) * 1e3 / max(len(batches), 1),
                     batches))
        if hasattr(loader, "close"):  # the native feed's C++ threads
            loader.close()
    (host_ms, host), (fed_ms, fed) = runs
    check(len(fed) == len(host) > 0, f"{len(fed)} of {len(host)} super-batches")
    return host_ms, fed_ms, host, fed


def phase_prefetch(smi, make_loader, label):
    """8e (and 8f's feed). Super-batches out of device_prefetch equal the
    host's bit for bit (two loaders made alike); the loader's own pace with
    and without the copies."""
    host_ms, fed_ms, host, fed = loader_pace(make_loader)
    for i, (f, h) in enumerate(zip(fed, host)):
        check(sorted(f) == sorted(h), f"super-batch {i} keys")
        for k, v in h.items():
            check(f[k].device.type == CARD and f[k].dtype == torch.from_numpy(v).dtype
                  and torch.equal(f[k].cpu(), torch.from_numpy(v)),
                  f"{label} super-batch {i} {k} differs from the host's")
    mb = sum(v.nbytes for v in host[0].values()) / 2**20
    dtypes = sorted({str(v.dtype) for v in host[0].values()})
    print(f"device_prefetch, {label}: {len(fed)} super-batches ({mb:.1f} MiB "
          f"each, {dtypes}) equal the host's bit for bit; the loader alone "
          f"makes one in {host_ms:.1f} ms of host clock, with the pinned "
          f"copies to the card in {fed_ms:.1f} ms [{smi}]")
    result = dict(host_ms=host_ms, fed_ms=fed_ms, mb=mb)
    del fed, host
    free_memory()
    return result


def native_cli_loader(num_threads):
    """The super-batches of the train CLI's ``--native_loader`` feed (8f's
    cache, datasets and seed), from ``num_threads`` C++ threads."""
    from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
    from de_i2i_gan_torch.runtime.native_loader import make_native_dual_stream

    df, bg = (SyntheticDefectDataset(CLI_IMAGE, 6, 512, dt, seed=CLI_SEED)
              for dt in ("defects", "background"))
    return make_native_dual_stream(df, bg, CLI_DIR / "ckpt" / "native_cache"
                                   / "native", CLI_IMAGE, BATCH, CRITICS,
                                   seed=CLI_SEED, num_threads=num_threads)


def phase_native_feed(nk, smi, preloaded_ms, synthetic):
    """8f. ``--native_loader``: the train CLI for one epoch on the C++
    feed; its u8 super-batches through device_prefetch equal the host's (one
    C++ thread, so two loaders give the same stream); the feed's pace with
    the CLI's four threads."""
    run = phase_cli_train(nk, smi, preloaded_ms, "native", "--native_loader")
    check(run["image_dtypes"] == {torch.uint8},
          f"the native feed reached the step as {run['image_dtypes']}")
    check((CLI_DIR / "ckpt" / "native_cache" / "native" / "defects" /
           "images.u8").exists(), "no native cache under ckpt/native_cache")
    feed = phase_prefetch(smi, lambda: native_cli_loader(1), "native, 1 thread")
    host_ms, fed_ms, _, _ = loader_pace(lambda: native_cli_loader(4))
    print(f"native feed, 4 threads (the CLI's): a super-batch in {host_ms:.1f} "
          f"ms alone, {fed_ms:.1f} ms with the pinned copies [{smi}]")
    print(f"trainer-fed AdaIN, synthetic loader (8a) vs native feed (8f): "
          f"loader-fed super-step {synthetic['ms']:.3f} vs {run['ms']:.3f} ms "
          f"(host clock, median of steady); busy share "
          f"{synthetic['dev_ms'] / synthetic['ms']:.1%} vs "
          f"{run['dev_ms'] / run['ms']:.1%}; kernels {synthetic['dev_ms']:.3f} "
          f"vs {run['dev_ms']:.3f} ms a super-step; copied {synthetic['copy_mb']:.1f} "
          f"vs {run['copy_mb']:.1f} MiB a super-batch; peak {synthetic['peak_mb']:.1f} "
          f"vs {run['peak_mb']:.1f} MiB [{smi}]")
    del run["state"]
    free_memory()
    return dict(run, native_1t_ms=feed["host_ms"], native_host_ms=host_ms,
                native_fed_ms=fed_ms)


# ------------------------------------------- 9. StarGAN v2 serving at 256^2


def sgv2_config(**kw):
    """The StarGAN v2 CLI's defaults (cli/starganv2_main.py) at 256^2 in
    bf16, with w_hpf=0 (AFHQ: no FAN masks)."""
    from de_i2i_gan_torch.train.solver import StarGANv2Config
    return StarGANv2Config(img_size=SGV2_IMAGE, num_domains=2, latent_dim=16,
                           hidden_nc=256, style_dim=64, embed_nc=EMBEDS[1],
                           num_embeds=EMBEDS[0], max_conv_dim=512, w_hpf=0.0,
                           compute_dtype="bfloat16").replace(**kw)


def sgv2_solver(cfg):
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    from de_i2i_gan_torch.train.solver import StarGANv2Solver
    solver = StarGANv2Solver(cfg, device="cuda")
    init_starganv2_weights(solver, SEED)
    return solver


def sgv2_requests(cfg, n, seed):
    """``n`` requests of SGV2_BATCH made on the card: source and reference
    images, target domains, latents, and ViT-sized reference embeddings."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (SGV2_BATCH, cfg.img_size, cfg.img_size, 3)
    return [{"x_src": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "x_ref": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "y": torch.randint(0, cfg.num_domains, (SGV2_BATCH,), generator=gen,
                                device="cuda"),
             "z_ref": torch.randn((SGV2_BATCH, cfg.latent_dim), generator=gen,
                                  device="cuda"),
             "s_ref": torch.randn((SGV2_BATCH, *EMBEDS), generator=gen,
                                  device="cuda")}
            for _ in range(n)]


def sgv2_request(solver, req, latent=False):
    """One request as sampling serves it: the style code from the EMA M
    (latent) or S (reference), or the request's embeddings (SEAN), then the
    EMA generator."""
    s = solver.style(req, req["y"], which="ref", latent=latent, use_ema=True)
    return solver.generate(req["x_src"], s, req["y"])


def check_sgv2_images(out, label):
    check(out.shape == (SGV2_BATCH, SGV2_IMAGE, SGV2_IMAGE, 3)
          and out.dtype == torch.bfloat16,
          f"{label}: output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")


def check_sgv2_calls(calls, forwards, label):
    """Exactly 12 forward-kernel calls a G forward, at the five shapes."""
    want = Counter({s: forwards * c for s, c in SGV2_SHAPES.items()})
    check(calls["fwd"] == want and not calls["bwd"],
          f"{label}: calls by shape {dict(calls['fwd'])} (backward "
          f"{dict(calls['bwd'])}), expected {dict(want)}")


@contextlib.contextmanager
def sgv2_norm(fn):
    """StarGAN v2's styled norms through ``fn``: the script swaps it into the
    name ``models/starganv2.py`` calls (``StyleAdaIN`` and ``SEANv2`` have
    no switch for the kernel)."""
    from de_i2i_gan_torch.models import starganv2 as sg
    real = sg.modulated_instance_norm
    sg.modulated_instance_norm = fn
    try:
        yield
    finally:
        sg.modulated_instance_norm = real


def plain_sgv2_norm(fused):
    """StarGAN v2's styled norms through the plain version."""
    return sgv2_norm(lambda x, g, b, act=None, eps=1e-5:
                     fused.modulated_instance_norm_ref(x, g, b, act, eps)[0])


def sgv2_agreement(nk, fused, solver, run, label, smi):
    """The kernel path against the plain path on one request: in an f32
    control run (TF32 off) within SGV2_F32_BAND relative L2; in bf16 the
    kernel path no further from the f32 plain path than BF16_DELTA_FACTOR
    times the bf16 plain path is. ``run(solver)`` serves the request."""
    f32 = sgv2_solver_like(solver, "float32")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = {}
    for dt, sv in (("bfloat16", solver), ("float32", f32)):
        outs[dt, True] = run(sv).float()
        before = nk.LAUNCHES
        with plain_sgv2_norm(fused):
            outs[dt, False] = run(sv).float()
        check(nk.LAUNCHES == before, f"{label}: the plain path launched the kernel")
    torch.cuda.synchronize()

    def rel(a, b):
        return ((outs[a] - outs[b]).norm() / outs[b].norm()).item()

    f32_rel = rel(("float32", True), ("float32", False))
    k16 = rel(("bfloat16", True), ("float32", False))
    p16 = rel(("bfloat16", False), ("float32", False))
    kp16 = rel(("bfloat16", True), ("bfloat16", False))
    print(f"{label} kernel path vs plain path, relative L2: f32 (TF32 off) "
          f"{f32_rel:.3e} (band {SGV2_F32_BAND}); bf16 kernel vs f32 plain "
          f"{k16:.3e}, bf16 plain vs f32 plain {p16:.3e} (band "
          f"{BF16_DELTA_FACTOR} x that = {BF16_DELTA_FACTOR * p16:.3e}); bf16 "
          f"kernel vs bf16 plain {kp16:.3e} [{smi}]")
    check(f32_rel <= SGV2_F32_BAND,
          f"{label}: f32 kernel path differs from the plain path by {f32_rel:.3e}")
    check(k16 <= BF16_DELTA_FACTOR * p16,
          f"{label}: bf16 kernel path {k16:.3e} from the f32 plain path, "
          f"outside {BF16_DELTA_FACTOR} x {p16:.3e}")
    del f32, outs
    free_memory()
    return dict(f32=f32_rel, k16=k16, p16=p16, kp16=kp16)


def sgv2_solver_like(solver, compute_dtype):
    """A solver of another compute dtype with ``solver``'s weights and
    running styles."""
    from de_i2i_gan_torch.train.solver import StarGANv2Solver
    other = StarGANv2Solver(solver.cfg.replace(compute_dtype=compute_dtype),
                            device="cuda")
    for name, net in solver.nets().items():
        getattr(other, name).load_state_dict(net.state_dict())
    return other


def timed_requests(serve, requests, label, smi, warmup=2):
    """Host-clock ms of each request (ending in a synchronize), the first
    ``warmup`` left out; every output checked."""
    times = []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        out = serve(req)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        check_sgv2_images(out, f"{label} request {i}")
    mean_ms = sum(times) / len(times)
    print(f"{label}: {len(requests)} requests of {SGV2_BATCH} at {SGV2_IMAGE}^2, "
          f"latency "
          f"ms {[round(v, 3) for v in times]} mean {mean_ms:.3f} "
          f"({SGV2_BATCH * 1e3 / mean_ms:.1f} img/s) [{smi}]")
    return mean_ms


def phase_sgv2_adain(nk, fused, smi):
    """9b. StarGAN v2 AdaIN serving: 2 warm-up + 5 timed requests of 32 with
    latent styles (EMA M), then with reference styles (EMA S); the exact
    launch tally by shape, peak memory, a profile, and the kernel path
    against the plain path in bf16 and in an f32 control run."""
    cfg = sgv2_config(norm_type="adain")
    solver = sgv2_solver(cfg)
    reqs = sgv2_requests(cfg, 7, SEED + 11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    with tally_calls(nk) as calls:
        ms = {mode: timed_requests(
            lambda r, latent=(mode == "latent"): sgv2_request(solver, r, latent),
            reqs, f"sgv2 adain {mode} styles", smi)
            for mode in ("latent", "reference")}
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check_sgv2_calls(calls, 2 * len(reqs), "sgv2 adain")
    check(launches == {"fwd": SGV2_FWD_PER_FORWARD * 2 * len(reqs), "bwd": 0},
          f"sgv2 adain launches {launches}")
    print(f"sgv2 adain serving: peak memory {peak_mb:.1f} MiB, launches "
          f"{launches} over {2 * len(reqs)} G forwards, calls by shape "
          f"{dict(calls['fwd'])} [{smi}]")
    dev_ms = profile_device(lambda: sgv2_request(solver, reqs[2], True), 2,
                            "sgv2 adain request", ms["latent"], smi)
    agree = {mode: sgv2_agreement(
        nk, fused, solver, lambda sv, latent=(mode == "latent"):
        sgv2_request(sv, reqs[0], latent), f"sgv2 adain {mode}", smi)
        for mode in ("latent", "reference")}
    del solver, reqs
    free_memory()
    return dict(launches=launches, ms=ms, peak_mb=peak_mb, dev_ms=dev_ms,
                agree=agree, calls=calls["fwd"], forwards=2 * 7)


def phase_sgv2_sean(nk, fused, smi):
    """9c. StarGAN v2 SEANv2 serving with (32, 5, 768) embeddings made on the
    card: 2 warm-up + 5 timed requests; the update_stats sweep
    (``track_stats_step`` over 4 batches, ``finalize_ema_stats``) and one
    ``inference_stats`` request; the launch tally, peak memory, a profile,
    and both kinds of request against the plain path as in 9b."""
    from de_i2i_gan_torch.models.starganv2 import SEANv2

    cfg = sgv2_config(norm_type="sean")
    solver = sgv2_solver(cfg)
    reqs = sgv2_requests(cfg, 7 + SGV2_TRACK_BATCHES + 1, SEED + 12)
    serve, track, last = (reqs[:7], reqs[7:7 + SGV2_TRACK_BATCHES], reqs[-1])
    noise = torch.randn((SGV2_BATCH, cfg.hidden_nc), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(SEED + 13))
    seans = [m for m in solver.ema_G.modules() if isinstance(m, SEANv2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    with tally_calls(nk) as calls:
        ms = timed_requests(lambda r: sgv2_request(solver, r), serve,
                            "sgv2 sean reference embeddings", smi)
        for req in track:
            solver.track_stats_step(req["x_ref"], req["s_ref"], req["y"])
        tracked = sum(m.count.sum().item() for m in seans)
        solver.finalize_ema_stats()
        t0 = time.perf_counter()
        out = solver.generate(last["x_src"], noise, last["y"],
                              inference_stats=True)
        torch.cuda.synchronize()
        stats_ms = (time.perf_counter() - t0) * 1e3
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    forwards = len(serve) + len(track) + 1
    check_sgv2_calls(calls, forwards, "sgv2 sean")
    check(launches == {"fwd": SGV2_FWD_PER_FORWARD * forwards, "bwd": 0},
          f"sgv2 sean launches {launches}")
    check_sgv2_images(out, "sgv2 sean inference_stats request")
    check(tracked == SGV2_TRACK_BATCHES * SGV2_BATCH * len(seans),
          f"{tracked} style codes tracked")
    for m in seans:
        check(m.count.sum().item() == 0 and bool((m.std > 0).all())
              and bool(torch.isfinite(m.mean).all()),
              "the EMA running styles were not finalized for every domain")
    check(all(m.count.sum().item() == 0 and not m.std.any()
              for m in solver.G.modules() if isinstance(m, SEANv2)),
          "the sweep touched G's own statistics")
    print(f"sgv2 sean: update_stats over {len(track)} batches tracked "
          f"{tracked:.0f} codes in {len(seans)} layers, finalized for both "
          f"domains; inference_stats request {stats_ms:.3f} ms; peak memory "
          f"{peak_mb:.1f} MiB, launches {launches} over {forwards} G forwards "
          f"[{smi}]")
    dev_ms = profile_device(lambda: sgv2_request(solver, serve[2]), 2,
                            "sgv2 sean request", ms, smi)
    agree = {
        "embeddings": sgv2_agreement(nk, fused, solver,
                                     lambda sv: sgv2_request(sv, serve[0]),
                                     "sgv2 sean embeddings", smi),
        "inference_stats": sgv2_agreement(
            nk, fused, solver, lambda sv: sv.generate(
                last["x_src"], noise, last["y"], inference_stats=True),
            "sgv2 sean inference_stats", smi)}
    del solver, reqs, serve, track, last
    free_memory()
    return dict(launches=launches, ms=ms, stats_ms=stats_ms, peak_mb=peak_mb,
                dev_ms=dev_ms, agree=agree, calls=calls["fwd"],
                forwards=forwards)


# ------------------------------------------ 10. StarGAN v2 training at 256^2


def sgv2_train_config(norm_type="adain", **kw):
    """The upstream README's AFHQ training command (SGV2_AFHQ) at the CLI's
    other defaults: 256^2, batch 8, latent_dim 16, style_dim 64,
    max_conv_dim 512, Adam (0, 0.99), lr 1e-4, f_lr 1e-6, weight decay
    1e-4, EMA 0.999, bf16. SEAN (no frozen ViT: its style term inactive)
    takes ViT-sized embeddings made on the card."""
    from de_i2i_gan_torch.train.solver import StarGANv2Config
    return StarGANv2Config(
        img_size=SGV2_IMAGE, num_domains=3, latent_dim=16, hidden_nc=256,
        style_dim=64, embed_nc=EMBEDS[1], num_embeds=EMBEDS[0],
        max_conv_dim=512, w_hpf=0.0, lambda_reg=1.0, lambda_sty=1.0,
        lambda_ds=2.0, lambda_cyc=1.0, batch_size=SGV2_TRAIN_BATCH,
        compute_dtype="bfloat16", norm_type=norm_type,
        allow_degraded_losses=norm_type == "sean").replace(**kw)


def sgv2_trainer(cfg):
    """A solver with D and the optimizers built, weights from SEED."""
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    from de_i2i_gan_torch.train.solver import StarGANv2Solver
    solver = StarGANv2Solver(cfg, device="cuda")
    solver.init_training()
    init_starganv2_weights(solver, SEED)
    return solver


def sgv2_train_batches(cfg, n, seed):
    """``n`` training batches made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, size = SGV2_TRAIN_BATCH, cfg.img_size

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def domains():
        return torch.randint(0, cfg.num_domains, (b,), generator=gen,
                             device="cuda")

    batches = []
    for _ in range(n):
        batch = {k: rand(b, size, size, 3) * 2 - 1
                 for k in ("x_src", "x_ref", "x_ref2")}
        batch.update(y_src=domains(), y_ref=domains(),
                     z_ref=randn(b, cfg.latent_dim),
                     z_ref2=randn(b, cfg.latent_dim))
        if cfg.norm_type == "sean":
            batch.update({k: randn(b, *EMBEDS)
                          for k in ("s_ref", "s_ref2", "s_src")})
        batches.append(batch)
    return batches


def check_sgv2_train_calls(calls, kind, iterations, label):
    """Exactly 12 kernel calls a G forward and a G backward, at the five
    batch-8 shapes."""
    fwd, bwd = SGV2_G_PASSES[kind]
    want = (Counter({s: iterations * fwd * c for s, c in SGV2_TRAIN_SHAPES.items()}),
            Counter({s: iterations * bwd * c for s, c in SGV2_TRAIN_SHAPES.items()}))
    check((calls["fwd"], calls["bwd"]) == want,
          f"{label}: calls by shape {dict(calls['fwd'])} / "
          f"{dict(calls['bwd'])}, expected {dict(want[0])} / {dict(want[1])}")


def phase_sgv2_train(nk, smi, kind, warmup=2, timed=5):
    """10b. Timed StarGAN v2 ``train_step``s on preloaded batches: AdaIN
    (``kind`` adain), FusedProp (fused) or SEANv2 with its statistics
    finalized every iteration, as the CLI does (sean). The exact launch
    tally by shape, host-clock and profiler device time an iteration, peak
    memory, finite losses and weights, the update counts."""
    cfg = sgv2_train_config("sean" if kind == "sean" else "adain",
                            fused_prop=kind == "fused")
    solver = sgv2_trainer(cfg)
    batches = sgv2_train_batches(cfg, warmup + timed, SEED + 20)
    draws = torch.Generator(device="cuda").manual_seed(SEED + 21)
    per_fwd, per_bwd = (SGV2_FWD_PER_FORWARD * n for n in SGV2_G_PASSES[kind])
    label = f"sgv2 train {kind}"

    def step(batch):
        metrics = solver.train_step(batch, draws)
        if kind == "sean":
            solver.update_sean_stats()
        return metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    times, metrics = [], []
    with tally_calls(nk) as calls:
        for i, batch in enumerate(batches):
            fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            dt_ms = (time.perf_counter() - t0) * 1e3
            check((nk.LAUNCHES - fwd0, nk.BWD_LAUNCHES - bwd0) == (per_fwd, per_bwd),
                  f"{label} iteration {i} launched {nk.LAUNCHES - fwd0} forward "
                  f"and {nk.BWD_LAUNCHES - bwd0} backward kernels, expected "
                  f"{per_fwd} and {per_bwd}")
            if i >= warmup:
                times.append(dt_ms)
            metrics.append({k: v.item() for k, v in m.items()})
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = len(batches)
    check_sgv2_train_calls(calls, kind, n, label)
    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()),
              f"{label} iteration {i}: non-finite loss {m}")
    for name in ("G", "D", "M", "S"):
        net = getattr(solver, name)
        for k, p in ([] if net is None else net.named_parameters()):
            check(bool(torch.isfinite(p).all()), f"{label} {name} {k} is not finite")
    passes = 1 if kind == "sean" else 2
    check(solver.step == n and solver.tx_G.count == solver.tx_D.count == passes * n
          and (kind == "sean" or solver.tx_M.count == solver.tx_S.count == n),
          f"{label}: update counts")
    mean_ms = sum(times) / len(times)
    print(f"training StarGAN v2 AFHQ {kind} {SGV2_IMAGE}^2 bf16 batch "
          f"{SGV2_TRAIN_BATCH}: iteration ms {[round(v, 3) for v in times]} "
          f"mean {mean_ms:.3f} ({SGV2_TRAIN_BATCH * 1e3 / mean_ms:.1f} img/s), "
          f"peak memory {peak_mb:.1f} MiB, launches over {n} iterations: "
          f"forward {launches['fwd']}, backward {launches['bwd']} "
          f"({per_fwd}/{per_bwd} an iteration) [{smi}]")
    print(f"{label} losses, iteration 1: "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[0].items()})}")
    print(f"{label} losses, iteration {n}: "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[-1].items()})}")
    dev_ms = profile_device(lambda: step(batches[-1]), 1, f"{label} iteration",
                            mean_ms, smi, conv_shapes=kind == "adain")
    del solver, batches
    free_memory()
    return dict(launches=launches, ms=mean_ms, dev_ms=dev_ms, peak_mb=peak_mb,
                calls=calls, iterations=n)


def sgv2_trainer_like(solver, compute_dtype):
    """A training solver of another compute dtype with ``solver``'s weights."""
    from de_i2i_gan_torch.train.solver import StarGANv2Solver
    other = StarGANv2Solver(solver.cfg.replace(compute_dtype=compute_dtype),
                            device="cuda")
    other.init_training()
    for name in solver.STATE_NETS:
        net = getattr(solver, name)
        if net is not None:
            getattr(other, name).load_state_dict(net.state_dict())
    return other


def norm_in_float64(x, g, b, act=None, eps=1e-5):
    """The modulated instance norm computed in float64 and rounded to x's
    dtype once: the plain version with only the norm's rounding changed."""
    xd = x.double()
    mean = xd.mean(dim=(2, 3), keepdim=True)
    var = (xd - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xd - mean) * torch.rsqrt(var + eps) * (1.0 + g.double()[:, :, None, None])
         + b.double()[:, :, None, None])
    if act == "leaky_relu":
        y = torch.where(y >= 0, y, 0.2 * y)
    elif act == "relu":
        y = y.clamp_min(0.0)
    return y.to(x.dtype)


def phase_sgv2_train_agreement(nk, fused, smi, kind="adain"):
    """10c (``kind`` adain): G's, M's and S's gradients of one latent G loss
    at full width; 14c (``sty``): G's gradient of SEAN's lambda_sty term
    alone (the frozen ViT's embedding of x_fake against the references'),
    one reference-pass G loss. Kernel path against the plain version swapped
    into ``models/starganv2.py``'s name, relative L2 per net: the f32
    control (TF32 off) within SGV2_TRAIN_F32_BAND + F32_CONTROL_FACTOR x the
    f32 plain path's distance from itself with the norm computed in float64;
    in bf16 the kernel path no further from the f32 plain path than
    BF16_DELTA_FACTOR times the bf16 plain path is, + SGV2_TRAIN_F32_BAND."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f = SGV2_FWD_PER_FORWARD
    if kind == "adain":
        cfg = sgv2_train_config("adain")
        net_names, latent, want = ("G", "M", "S"), True, (3 * f, 2 * f)
    else:  # the G forwards of x_fake, x_fake2 and x_rec; x_fake's backward
        cfg = sgv2_train_config("sean", allow_degraded_losses=False)
        net_names, latent, want = ("G",), False, (3 * f, f)
    solvers = {"bfloat16": sgv2_trainer(cfg)}
    solvers["float32"] = sgv2_trainer_like(solvers["bfloat16"], "float32")
    if kind == "sty":
        vit = seeded_vit("cuda")
        for solver in solvers.values():
            solver.set_frozen_nets(vit=vit)
    raw = sgv2_train_batches(cfg, 1, SEED + 22)[0]
    grads, losses = {}, {}
    paths = {"kernel": contextlib.nullcontext, "plain": lambda: plain_sgv2_norm(fused),
             "plain64": lambda: sgv2_norm(norm_in_float64)}
    for dt, solver in solvers.items():
        batch = solver._batch(raw)
        nets = {n: list(getattr(solver, n).parameters()) for n in net_names}
        for path, ctx in paths.items():
            if dt == "bfloat16" and path == "plain64":
                continue
            fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
            with ctx():
                loss, m = solver.g_loss_fn(batch, latent=latent)
                if kind == "sty":
                    loss = m["sty"]
                flat = torch.autograd.grad(
                    loss, [p for ps in nets.values() for p in ps],
                    allow_unused=True, materialize_grads=True)
            torch.cuda.synchronize()
            expect = want if path == "kernel" else (0, 0)
            check((nk.LAUNCHES - fwd0, nk.BWD_LAUNCHES - bwd0) == expect,
                  f"sgv2 {kind} G loss {dt} {path} path: launches "
                  f"{nk.LAUNCHES - fwd0}/{nk.BWD_LAUNCHES - bwd0}, expected "
                  f"{expect}")
            start = 0
            for name, ps in nets.items():
                grads[dt, path, name] = torch.cat(
                    [g.float().reshape(-1) for g in flat[start:start + len(ps)]])
                start += len(ps)
            losses[dt, path] = loss.item()
            del flat, loss, m
    label = "latent G loss" if kind == "adain" else "lambda_sty term"
    result = {}
    for name in net_names:
        def rel(a, b):
            return ((grads[(*a, name)] - grads[(*b, name)]).norm()
                    / grads[(*b, name)].norm()).item()

        f32 = rel(("float32", "kernel"), ("float32", "plain"))
        c32 = rel(("float32", "plain64"), ("float32", "plain"))
        k16 = rel(("bfloat16", "kernel"), ("float32", "plain"))
        p16 = rel(("bfloat16", "plain"), ("float32", "plain"))
        band32 = SGV2_TRAIN_F32_BAND + F32_CONTROL_FACTOR * c32
        band = BF16_DELTA_FACTOR * p16 + SGV2_TRAIN_F32_BAND
        result[name] = dict(f32=f32, c32=c32, k16=k16, p16=p16)
        print(f"sgv2 {label}, {name}'s gradient, kernel path vs plain "
              f"path, relative L2: f32 (TF32 off) {f32:.3e}, the f32 plain "
              f"path with the norm in float64 vs the f32 plain path {c32:.3e} "
              f"(band {SGV2_TRAIN_F32_BAND} + {F32_CONTROL_FACTOR} x that = "
              f"{band32:.3e}); bf16 kernel vs f32 plain {k16:.3e}, "
              f"bf16 plain vs f32 plain {p16:.3e} (band {BF16_DELTA_FACTOR} x "
              f"that + {SGV2_TRAIN_F32_BAND} = {band:.3e}) [{smi}]")
        check(f32 <= band32,
              f"sgv2 {kind} {name} f32 kernel path gradient differs by "
              f"{f32:.3e}, outside {band32:.3e}")
        check(k16 <= band, f"sgv2 {kind} {name} bf16 kernel path gradient "
              f"{k16:.3e} from the f32 plain path, outside {band:.3e}")
    print(f"  losses: {json.dumps({f'{k[0]} {k[1]}': round(v, 6) for k, v in losses.items()})}")
    del solvers, grads
    free_memory()
    return result


def sgv2_image_tree(root, seed, domains=("cat", "dog", "wild"),
                    count=SGV2_CLI_IMAGES):
    """``count`` PNGs of 256^2 in each of ``domains``, smooth random images
    from a seed."""
    from de_i2i_gan_torch.utils.png import write_png
    gen = torch.Generator().manual_seed(seed)
    for domain in domains:
        (root / domain).mkdir(parents=True)
        for i in range(count):
            low = torch.rand((1, 3, 8, 8), generator=gen)
            img = F.interpolate(low, size=(SGV2_IMAGE, SGV2_IMAGE),
                                mode="bilinear", align_corners=False)[0]
            img = img + 0.05 * torch.randn(img.shape, generator=gen)
            write_png(root / domain / f"{i:03d}.png",
                      (img.clamp(0, 1) * 255).byte().permute(1, 2, 0).numpy())
    return root


@contextlib.contextmanager
def grids_checked():
    """Every grid the sample code assembles holds finite pixels (a NaN
    would not survive the PNG's uint8 cast)."""
    from de_i2i_gan_torch.utils import translate
    real, seen = translate.make_grid, []

    def checked(images, *args, **kw):
        seen.append(bool(torch.isfinite(torch.as_tensor(images)).all()))
        return real(images, *args, **kw)

    translate.make_grid = checked
    try:
        yield seen
    finally:
        translate.make_grid = real


def png_shape(path):
    """(H, W) of a PNG, from its header."""
    head = Path(path).read_bytes()[16:24]
    w, h = struct.unpack(">II", head)
    return h, w


def phase_sgv2_cli(nk, smi, preloaded_ms):
    """10d. ``cli.starganv2_main.main`` in-process on an image tree of 3
    domains x SGV2_CLI_IMAGES PNGs: ``--mode train`` for SGV2_CLI_ITERS
    iterations with the AFHQ flags (exact launches, loader-fed iteration
    time, the busy share of 3 profiled iterations, one debug grid, the
    checkpoints), a resume with ``--resume_iter`` whose loaded state equals
    the saved one, then ``--mode sample`` from it."""
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint
    from de_i2i_gan_torch.train.solver import StarGANv2Solver

    started = time.perf_counter()
    root = CLI_DIR / "sgv2"
    shutil.rmtree(root, ignore_errors=True)
    tree = sgv2_image_tree(root / "afhq", SEED + 23)
    tag = f"{SGV2_CLI_ITERS:06d}"
    base = [*SGV2_AFHQ, "--img_size", str(SGV2_IMAGE), "--batch_size",
            str(SGV2_TRAIN_BATCH), "--train_img_dir", str(tree), "--val_img_dir",
            str(tree), "--checkpoint_dir", str(root / "ckpt"), "--sample_dir",
            str(root / "samples"), "--device", CARD]
    per_fwd, per_bwd = (SGV2_FWD_PER_FORWARD * n for n in SGV2_G_PASSES["adain"])
    val_calls = Counter({(SGV2_BATCH, *s[1:]): c for s, c in SGV2_SHAPES.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's runs start here
    t0 = time.perf_counter()
    with SuperStepClock(nk, profile_at=PROFILE_AT,
                        target=(StarGANv2Solver, "train_step")) as clock, \
            tally_calls(nk) as calls:
        solver = sgv2_cli.main(base + [
            "--mode", "train", "--total_iters", str(SGV2_CLI_ITERS),
            "--save_every", str(SGV2_CLI_ITERS), "--sample_every",
            str(SGV2_CLI_ITERS), "--print_every", str(SGV2_CLI_ITERS)])
    wall_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = len(clock.ends)
    check(n == SGV2_CLI_ITERS and solver.step == n, f"{n} iterations")
    tree_s = t0 - started
    prev = (0, 0)
    for i, cur in enumerate(clock.launches):
        check((cur[0] - prev[0], cur[1] - prev[1]) == (per_fwd, per_bwd),
              f"sgv2 CLI iteration {i} launched {cur[0] - prev[0]}/"
              f"{cur[1] - prev[1]} kernels, expected {per_fwd}/{per_bwd}")
        prev = cur
    check(all(clock.on_card), "sgv2 CLI: a batch reached the step off the card")
    # the iterations, then the debug grid's two G forwards of the val batch
    want = Counter({s: n * 8 * c for s, c in SGV2_TRAIN_SHAPES.items()})
    want.update({s: 2 * c for s, c in val_calls.items()})
    check(calls["fwd"] == want and calls["bwd"] == Counter(
        {s: n * 4 * c for s, c in SGV2_TRAIN_SHAPES.items()}),
        f"sgv2 CLI calls by shape {dict(calls['fwd'])} / {dict(calls['bwd'])}")
    for name in ("G", "D", "M", "S"):
        for k, p in getattr(solver, name).named_parameters():
            check(bool(torch.isfinite(p).all()), f"sgv2 CLI {name} {k} not finite")
    run = root / "ckpt" / "starganv2"
    for f in (f"{tag}_state.pt", "latest_state.pt"):
        check((run / f).exists(), f"the sgv2 CLI wrote no {f}")
    cycle = root / "samples" / f"{tag}_cycle.png"
    check(png_shape(cycle) == (4 * (SGV2_IMAGE + 2) + 2,
                               SGV2_BATCH * (SGV2_IMAGE + 2) + 2),
          f"debug grid {png_shape(cycle)}")
    steady = clock.steady_ms()
    fed_ms = statistics.median(steady)
    dev_ms = kernel_ms(clock.prof, PROFILED_SUPER_STEPS)
    train_launches = (nk.LAUNCHES, nk.BWD_LAUNCHES)
    print(f"sgv2 train CLI (AFHQ flags, {SGV2_CLI_ITERS} iterations, batch "
          f"{SGV2_TRAIN_BATCH}, {SGV2_IMAGE}^2, bf16) in {wall_s:.1f} s: loader-fed "
          f"iteration, median of {len(steady)} steady "
          f"{fed_ms:.3f} ms ({[round(v, 1) for v in steady]}); preloaded "
          f"iteration (10b, this call) {preloaded_ms:.3f} ms; kernels "
          f"{dev_ms:.3f} ms an iteration over {PROFILED_SUPER_STEPS} profiled "
          f"iterations, busy share {dev_ms / fed_ms:.1%}; peak "
          f"{peak_mb:.1f} MiB; launches {train_launches[0]}/{train_launches[1]} "
          f"({per_fwd}/{per_bwd} an iteration + {2 * SGV2_FWD_PER_FORWARD} "
          f"for the debug grid) [{smi}]")
    del solver
    free_memory()

    # the resume: the state the loop starts from is the one saved
    loaded, real_train = [], sgv2_cli.train

    def spy(args, solver_):
        loaded.append(cpu_state(solver_))
        real_train(args, solver_)

    sgv2_cli.train = spy
    before = (nk.LAUNCHES, nk.BWD_LAUNCHES)
    t1 = time.perf_counter()
    try:
        resumed = sgv2_cli.main(base + [
            "--mode", "train", "--resume_iter", str(SGV2_CLI_ITERS),
            "--total_iters", str(SGV2_CLI_ITERS + 1), "--save_every", "1000",
            "--sample_every", "1000", "--print_every", "1"])
    finally:
        sgv2_cli.train = real_train
    torch.cuda.synchronize()
    differs = same_state(read_checkpoint(root / "ckpt", "starganv2", tag),
                         loaded[0])
    check(differs is None, f"sgv2 resume: the loaded state differs at {differs}")
    check(resumed.step == SGV2_CLI_ITERS + 1 and
          (nk.LAUNCHES - before[0], nk.BWD_LAUNCHES - before[1]) == (per_fwd, per_bwd),
          "sgv2 resume: one more iteration")
    del resumed, loaded
    free_memory()

    # sampling from the checkpoint: the cycle grid (2 G forwards of the val
    # batch) and the latent grid (3 latents x 3 domains of 4 sources)
    before = (nk.LAUNCHES, nk.BWD_LAUNCHES)
    t2 = time.perf_counter()
    out = root / "sample"
    with grids_checked() as finite:
        sgv2_cli.main(base + ["--mode", "sample", "--resume_iter",
                              str(SGV2_CLI_ITERS), "--result_dir", str(out)])
    torch.cuda.synchronize()
    sample_launches = (nk.LAUNCHES - before[0], nk.BWD_LAUNCHES - before[1])
    check(sample_launches == (2 * SGV2_FWD_PER_FORWARD + 9 * SGV2_FWD_PER_FORWARD, 0),
          f"sgv2 sample launches {sample_launches}")
    check(finite == [True, True], f"sgv2 sample grids finite: {finite}")
    shapes = {f: png_shape(out / f) for f in (f"{tag}_cycle.png", "latent_grid.png")}
    check(shapes == {f"{tag}_cycle.png": (4 * (SGV2_IMAGE + 2) + 2,
                                          SGV2_BATCH * (SGV2_IMAGE + 2) + 2),
                     "latent_grid.png": (10 * (SGV2_IMAGE + 2) + 2,
                                         4 * (SGV2_IMAGE + 2) + 2)},
          f"sgv2 sample grids {shapes}")
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    print(f"sgv2 CLI resume at {tag}: the loaded state equals the saved one "
          f"tensor for tensor; one more iteration; sample: grids {shapes}, "
          f"finite, {sample_launches[0]} forward launches; the CLI's launches "
          f"{launches}; host seconds: image tree {tree_s:.1f}, train "
          f"{wall_s:.1f}, resume {t2 - t1:.1f}, sample "
          f"{time.perf_counter() - t2:.1f} [{smi}]")
    return dict(launches=launches, ms=fed_ms, dev_ms=dev_ms, peak_mb=peak_mb,
                preloaded_ms=preloaded_ms)


# ------------------------------------------------ 11. MAE-GAN pretraining


@contextlib.contextmanager
def fixed_mae_mask(mask):
    """``MAESteps`` repairs with ``mask`` ((N, H, W, 1), on the host) where
    it would draw a shifted patch mask."""
    from de_i2i_gan_torch.train import mae_steps
    real = mae_steps.generate_shifted_mask
    mae_steps.generate_shifted_mask = (
        lambda b, h, w, p, r, generator=None, device="cpu": mask[:b].to(device))
    try:
        yield
    finally:
        mae_steps.generate_shifted_mask = real


MAE_NETS = ("G", "token", "E", "D")


def phase_mae_small(nk, smi):
    """11a. A tiny f32 ``MAESteps.super_step`` (2 critics, SGD) with a fixed
    mask on the card through both kernels, against the same super-step on
    the CPU: the losses within rtol 2e-4; (after - before) / lr per tensor
    within 1e-3 of its L2 norm + 1e-5 sqrt(n), as 6c holds DefectGAN's."""
    from de_i2i_gan_torch.config import MAEConfig, TrainConfig
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.mae_steps import MAESteps

    cfg = small_config()
    tcfg = TrainConfig(batch_size=2, num_critics=2, lr=(2e-2, 1e-2),
                       optimizer="sgd", scheduler="cos", loss_weight=(10, 3, 1))
    gen = torch.Generator().manual_seed(SEED + 30)
    batch = {"imgs": torch.rand((2, 2, 32, 32, 3), generator=gen) * 2 - 1,
             "labels": F.one_hot(torch.randint(0, 4, (2, 2), generator=gen),
                                 4).float()}
    mask = (torch.rand((2, 4, 4, 1), generator=gen) < 0.25).float()
    mask = mask.repeat_interleave(8, 1).repeat_interleave(8, 2)
    runs = {}
    with fixed_mae_mask(mask):
        for device in ("cpu", "cuda"):
            steps = MAESteps(cfg, MAEConfig(), tcfg, device=device)
            steps.init_training()
            init_weights(steps, SEED)
            before = {n: {k: v.detach().float().cpu().clone()
                          for k, v in getattr(steps, n).named_parameters()}
                      for n in MAE_NETS}
            fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
            metrics = steps.super_step(batch)
            if device == "cuda":
                torch.cuda.synchronize()
            runs[device] = (steps, before, metrics,
                            (nk.LAUNCHES - fwd0, nk.BWD_LAUNCHES - bwd0))
    cpu, before, rmetrics, cpu_launches = runs["cpu"]
    card, _, metrics, launches = runs["cuda"]
    want = expected_launches(cfg, 3, 1)
    check(cpu_launches == (0, 0) and launches == want,
          f"small MAE super-step launched {launches} kernels, expected {want}")
    loss = max(abs(metrics[k].item() - v.item()) / (LOSS_RTOL * abs(v.item()))
               for k, v in rmetrics.items())
    rel = 0.0
    for n in MAE_NETS:
        lr = tcfg.lr_d if n == "D" else tcfg.lr_g
        got = dict(getattr(card, n).named_parameters())
        for k, ref in getattr(cpu, n).named_parameters():
            gk = (got[k].detach().cpu() - before[n][k]) / lr
            rk = (ref.detach() - before[n][k]) / lr
            rel = max(rel, ((gk - rk).norm() / (
                GRAD_REL_L2 * rk.norm() + GRAD_ATOL * rk.numel() ** 0.5)).item())
    print(f"small MAE super-step (2 critics, fixed mask), card kernel path vs "
          f"CPU plain path, 32x32 f32 SGD: launches {launches}; max loss diff "
          f"{loss:.3f} x (rtol {LOSS_RTOL}); (after-before)/lr of G, the token, "
          f"E and D: max per-tensor L2 diff {rel:.3f} x (band {GRAD_REL_L2} "
          f"|ref| + atol {GRAD_ATOL} sqrt(n)) [{smi}]")
    check(loss <= 1.0, f"small MAE super-step losses outside the band: {loss:.3f}")
    check(rel <= 1.0, f"small MAE super-step deltas outside the band: {rel:.3f}")


def mae_train_config():
    """The MAE CLI's optimizer defaults at batch MAE_BATCH, one critic."""
    from de_i2i_gan_torch.config import TrainConfig
    return TrainConfig(batch_size=MAE_BATCH, num_critics=1, lr=(1.5e-4,),
                       lr_decay=0.05, scheduler="cos", optimizer="adamw",
                       loss_weight=(10, 3, 1))


def check_mae_calls(calls, n, label):
    """Exactly MAE_G_PASSES G forwards and backwards a super-step, 8 kernel
    calls each, at the batch-32 shapes."""
    fwd, bwd = MAE_G_PASSES
    want = (Counter({s: n * fwd * c for s, c in MAE_SHAPES.items()}),
            Counter({s: n * bwd * c for s, c in MAE_SHAPES.items()}))
    check((calls["fwd"], calls["bwd"]) == want,
          f"{label}: calls by shape {dict(calls['fwd'])} / {dict(calls['bwd'])}")


def phase_mae_train(nk, smi, warmup=2, timed=5):
    """11b. Full-width MAE super-steps on preloaded batches: exact launches
    (16/8 a super-step) at the batch-32 shapes, host-clock time, peak
    memory, finite losses; a profiled super-step (device time, busy share);
    then ``eval_losses`` and ``repair_grid`` (8 forward launches each) as
    their own path."""
    from de_i2i_gan_torch.config import MAEConfig
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.mae_steps import MAESteps

    cfg = full_config()
    steps = MAESteps(cfg, MAEConfig(), mae_train_config(), device="cuda",
                     iters_per_epoch=MAE_SYNTHETIC // MAE_BATCH, num_epochs=200)
    steps.init_training()
    init_weights(steps, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    shape = (1, MAE_BATCH, cfg.image_size, cfg.image_size, 3)
    batches = [{"imgs": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
                "labels": F.one_hot(torch.randint(0, cfg.label_nc, (1, MAE_BATCH),
                                                  generator=gen, device="cuda"),
                                    cfg.label_nc).float()}
               for _ in range(warmup + timed)]
    draws = torch.Generator(device="cuda").manual_seed(SEED + 32)
    per_fwd, per_bwd = expected_launches(cfg, *MAE_G_PASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the MAE path's run starts here
    times, metrics = [], []
    with tally_calls(nk) as calls:
        for i, batch in enumerate(batches):
            fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
            t0 = time.perf_counter()
            m = steps.super_step(batch, draws)
            torch.cuda.synchronize()
            dt_ms = (time.perf_counter() - t0) * 1e3
            check((nk.LAUNCHES - fwd0, nk.BWD_LAUNCHES - bwd0) == (per_fwd, per_bwd),
                  f"MAE super-step {i} launched {nk.LAUNCHES - fwd0}/"
                  f"{nk.BWD_LAUNCHES - bwd0} kernels, expected {per_fwd}/{per_bwd}")
            if i >= warmup:
                times.append(dt_ms)
            metrics.append({k: v.item() for k, v in m.items()})
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = len(batches)
    check_mae_calls(calls, n, "MAE super-steps")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()),
              f"MAE super-step {i}: non-finite loss {m}")
    for name in MAE_NETS:
        for k, p in getattr(steps, name).named_parameters():
            check(bool(torch.isfinite(p).all()), f"MAE {name} {k} is not finite")
    check(steps.step == n and steps.tx_G.count == steps.tx_E.count == n,
          "MAE update counts")
    mean_ms = sum(times) / len(times)
    print(f"MAE pretraining DefectGAN-256 adain bf16 batch {MAE_BATCH}, 1 "
          f"critic, AdamW: super-step ms {[round(v, 3) for v in times]} mean "
          f"{mean_ms:.3f} ({MAE_BATCH * 1e3 / mean_ms:.1f} img/s), peak memory "
          f"{peak_mb:.1f} MiB, launches over {n} super-steps: forward "
          f"{launches['fwd']}, backward {launches['bwd']} ({per_fwd}/{per_bwd} "
          f"a super-step) [{smi}]")
    print(f"MAE losses, super-step 1: "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[0].items()})}; "
          f"super-step {n}: "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[-1].items()})}")
    dev_ms = profile_device(lambda: steps.super_step(batches[-1], draws), 1,
                            "MAE super-step", mean_ms, smi, conv_shapes=True)

    # eval_losses and repair_grid: the test CLI's calls
    last = {k: v[0] for k, v in batches[-1].items()}
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the evaluation path starts here
    ev = steps.eval_losses(last, draws)
    grid = steps.repair_grid(last["imgs"][:4], last["labels"][:4], draws)
    torch.cuda.synchronize()
    eval_launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check(eval_launches == {"fwd": expected_launches(cfg, 2, 0)[0], "bwd": 0},
          f"MAE eval_losses + repair_grid launches {eval_launches}")
    check(all(math.isfinite(v.item()) for v in ev.values())
          and grid.shape == (4, 5, cfg.image_size, cfg.image_size, 3)
          and bool(torch.isfinite(grid).all()),
          f"MAE evaluation: losses {ev}, grid {tuple(grid.shape)}")
    print(f"MAE eval_losses {json.dumps({k: round(v.item(), 5) for k, v in ev.items()})}"
          f", repair_grid {tuple(grid.shape)} finite; launches {eval_launches}")
    del steps, batches, grid
    free_memory()
    return dict(launches=launches, ms=mean_ms, dev_ms=dev_ms, peak_mb=peak_mb,
                calls=calls, super_steps=n, eval=dict(launches=eval_launches))


def mae_cli_args(name, *extra):
    """The MAE CLIs' arguments: 8a's, at the MAE default batch."""
    return cli_args(name, "--batch_size", str(MAE_BATCH),
                    "--style_norm_block_type", "adain", *extra)


def phase_mae_cli(nk, smi, preloaded_ms, name, *extra):
    """11c. ``cli.train_mae.main`` in-process for one epoch at the MAE
    CLI's defaults (the synthetic dataset's 512 fusion images: 16
    super-steps of 32), on the Python loader or ``--native_loader``: exact
    launches, ``latest`` written, loader-fed host-clock time, the busy
    share over 3 profiled super-steps, peak memory, the copies pinned and on
    a side stream."""
    from de_i2i_gan_torch.cli.train_mae import main as mae_main
    from de_i2i_gan_torch.train.checkpoint import read_iter_record
    from de_i2i_gan_torch.train.mae_steps import MAESteps

    label = f"MAE CLI {name}"
    per_fwd, per_bwd = expected_launches(full_config(), *MAE_G_PASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the MAE trainer's run starts here
    t0 = time.perf_counter()
    with SuperStepClock(nk, profile_at=PROFILE_AT,
                        target=(MAESteps, "super_step")) as clock:
        trainer = mae_main(mae_cli_args(name, "--num_epochs", "1", *extra))
    wall_s = time.perf_counter() - t0
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = len(clock.ends)
    check(n == MAE_SYNTHETIC // MAE_BATCH and trainer.iters == n
          and launches == {"fwd": per_fwd * n, "bwd": per_bwd * n},
          f"{label}: {n} super-steps, {trainer.iters} iterations, launches "
          f"{launches}")
    prev = (0, 0)
    for i, cur in enumerate(clock.launches):
        check((cur[0] - prev[0], cur[1] - prev[1]) == (per_fwd, per_bwd),
              f"{label} super-step {i} launched {cur[0] - prev[0]}/"
              f"{cur[1] - prev[1]} kernels")
        prev = cur
    check(all(clock.on_card), f"{label}: a super-batch reached the step off "
          "the card")
    for k, p in trainer.steps.G.named_parameters():
        check(bool(torch.isfinite(p).all()), f"{label}: G {k} not finite")
    run = CLI_DIR / "ckpt" / name
    for f in ("latest_state.pt", "iter.txt", "opt.json"):
        check((run / f).exists(), f"the MAE CLI wrote no {f}")
    check(read_iter_record(CLI_DIR / "ckpt", name) == (1, n), "iter.txt")
    steady = clock.steady_ms()
    fed_ms = statistics.median(steady)
    dev_ms = kernel_ms(clock.prof, PROFILED_SUPER_STEPS)
    copies, streams = h2d_copies(clock.prof, CLI_DIR / f"mae_{name}_trace.json")
    keys = len(clock.keys[0])
    check(len(copies) >= keys and all("Pinned" in c[0] and c[1] not in streams
                                      for c in copies),
          f"{label}: host-to-device copies {copies} vs kernel streams {streams}")
    image_dtypes = {d["imgs"] for d in clock.dtypes}
    print(f"{label}, 1 epoch: {n} super-steps in {wall_s:.1f} s; loader-fed "
          f"super-step ms, host clock, median of {len(steady)} steady: "
          f"{fed_ms:.3f} {[round(v, 3) for v in steady]}; preloaded (11b) "
          f"{preloaded_ms:.3f}; kernels a super-step over {PROFILED_SUPER_STEPS} "
          f"profiled {dev_ms:.3f} ms, busy share {dev_ms / fed_ms:.1%}; peak "
          f"{peak_mb:.1f} MiB; launches {launches}; images reach the step as "
          f"{sorted(map(str, image_dtypes))}; {len(copies)} pinned copies on "
          f"stream(s) {sorted({c[1] for c in copies})}, kernels on "
          f"{sorted(streams)} [{smi}]")
    del trainer, clock
    free_memory()
    return dict(launches=launches, ms=fed_ms, dev_ms=dev_ms, peak_mb=peak_mb,
                super_steps=n, image_dtypes=image_dtypes)


def phase_mae_test_cli(nk, smi):
    """11c. ``cli.test_mae.main`` on the MAE run: the loss line, the repair
    grid PNG (4 rows of 5 panels of 256^2) from finite pixels; 8 forward
    launches for each of the 2 evaluation batches of 32 and the grid."""
    from de_i2i_gan_torch.cli.test_mae import main as test_main
    from de_i2i_gan_torch.train.mae_steps import MAESteps

    finite, real = [], MAESteps.repair_grid

    def checked(self, *args, **kw):
        grid = real(self, *args, **kw)
        finite.append(bool(torch.isfinite(grid).all()))
        return grid

    per_fwd, _ = expected_launches(full_config(), 1, 0)
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the MAE test CLI's run starts here
    MAESteps.repair_grid = checked
    try:
        out = test_main(mae_cli_args("mae", "--results_dir",
                                     str(CLI_DIR / "mae_results")))
    finally:
        MAESteps.repair_grid = real
    torch.cuda.synchronize()
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check(launches == {"fwd": 3 * per_fwd, "bwd": 0},
          f"MAE test CLI launches {launches}")
    check(sorted(out["losses"]) == ["clf", "gan", "rec"]
          and all(math.isfinite(v) for v in out["losses"].values()),
          f"MAE test CLI losses {out['losses']}")
    check(finite == [True] and png_shape(out["grid"]) == (4 * CLI_IMAGE,
                                                          5 * CLI_IMAGE),
          f"repair grid {png_shape(out['grid'])}, finite {finite}")
    print(f"MAE test CLI: losses {json.dumps({k: round(v, 5) for k, v in out['losses'].items()})}"
          f", {out['grid'].name} {png_shape(out['grid'])} from finite pixels, "
          f"launches {launches} [{smi}]")
    return dict(launches=launches)


class _FirstSuperBatch:
    """One super-batch of ``loader``: the warm-started run's single step."""

    def __init__(self, loader):
        self.batch = next(iter(loader))

    def __len__(self):
        return 1

    def __iter__(self):
        return iter([self.batch])


def phase_mae_warm_start(nk, smi):
    """11d. ``cli.train_defectgan.main --load_model_name mae``: the G, E and
    D it starts from equal the MAE run's, tensor for tensor; then one
    super-step with the usual 56/16 launches."""
    from de_i2i_gan_torch.cli.train_defectgan import main as train_main
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint
    from de_i2i_gan_torch.train.trainer import DefectGanTrainer

    saved = read_checkpoint(CLI_DIR / "ckpt", "mae", "latest")
    entry, real_train = {}, DefectGanTrainer.train

    def one_step(self, loader, *args, **kw):
        entry["state"] = cpu_state(self.steps)
        return real_train(self, _FirstSuperBatch(loader), *args, **kw)

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the warm-started run starts here
    DefectGanTrainer.train = one_step
    try:
        with SuperStepClock(nk) as clock:
            trainer = train_main(cli_args("warm", "--style_norm_block_type",
                                          "adain", "--load_model_name", "mae",
                                          "--num_epochs", "1"))
    finally:
        DefectGanTrainer.train = real_train
    launches = check_trainer_launches(nk, clock, "warm-started train CLI",
                                      trainer.cfg)  # ... ends here
    check(len(clock.ends) == 1, f"{len(clock.ends)} super-steps")
    state, counts = entry["state"], {}
    for net in ("G", "E", "D"):
        for k, v in saved[net].items():
            check(torch.equal(state[f"{net}/{k}"], v),
                  f"the warm start's {net} {k} differs from the MAE run's")
        counts[net] = len(saved[net])
    check(not any(k.startswith("token") for k in state), "a token was restored")
    print(f"warm-started train CLI from the MAE run: G, E and D equal the MAE "
          f"checkpoint's in all {counts} tensors; one super-step, launches "
          f"{launches} [{smi}]")
    del trainer, clock, entry, saved
    free_memory()
    return dict(launches=launches)


def phase_sgv2_pretrain(nk, smi, tree):
    """11e. ``cli.starganv2_main --mode pretrain`` with the AFHQ flags on
    10d's image tree for SGV2_PRETRAIN_ITERS iterations (exact launches,
    48/24 an iteration at the batch-8 shapes; loader-fed iteration time, the
    busy share of 3 profiled iterations; checkpoints), then ``--mode train
    --pretrain_dir`` for 2 iterations, whose G and ema_G at load equal the
    pretrain run's."""
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint
    from de_i2i_gan_torch.train.solver import StarGANv2Solver

    root = CLI_DIR / "sgv2_mae"
    shutil.rmtree(root, ignore_errors=True)
    base = [*SGV2_AFHQ, "--img_size", str(SGV2_IMAGE), "--batch_size",
            str(SGV2_TRAIN_BATCH), "--train_img_dir", str(tree), "--val_img_dir",
            str(tree), "--checkpoint_dir", str(root / "ckpt"), "--sample_dir",
            str(root / "samples"), "--device", CARD]
    per_fwd, per_bwd = (SGV2_FWD_PER_FORWARD * p for p in SGV2_PRETRAIN_PASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the pretrain run starts here
    t0 = time.perf_counter()
    with SuperStepClock(nk, profile_at=PROFILE_AT,
                        target=(StarGANv2Solver, "pretrain_step")) as clock, \
            tally_calls(nk) as calls:
        solver = sgv2_cli.main(base + [
            "--mode", "pretrain", "--total_iters", str(SGV2_PRETRAIN_ITERS),
            "--save_every", str(SGV2_PRETRAIN_ITERS), "--print_every",
            str(SGV2_PRETRAIN_ITERS)])
    wall_s = time.perf_counter() - t0
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = len(clock.ends)
    check(n == SGV2_PRETRAIN_ITERS and solver.step == n
          and launches == {"fwd": per_fwd * n, "bwd": per_bwd * n},
          f"sgv2 pretrain: {n} iterations, launches {launches}")
    prev = (0, 0)
    for i, cur in enumerate(clock.launches):
        check((cur[0] - prev[0], cur[1] - prev[1]) == (per_fwd, per_bwd),
              f"sgv2 pretrain iteration {i} launched {cur[0] - prev[0]}/"
              f"{cur[1] - prev[1]} kernels, expected {per_fwd}/{per_bwd}")
        prev = cur
    fwd, bwd = SGV2_PRETRAIN_PASSES
    check(calls["fwd"] == Counter({s: n * fwd * c for s, c in SGV2_TRAIN_SHAPES.items()})
          and calls["bwd"] == Counter({s: n * bwd * c
                                       for s, c in SGV2_TRAIN_SHAPES.items()}),
          f"sgv2 pretrain calls by shape {dict(calls['fwd'])} / {dict(calls['bwd'])}")
    check(all(clock.on_card), "sgv2 pretrain: a batch reached the step off the card")
    for name in ("G", "D", "M", "S", "token"):
        for k, p in getattr(solver, name).named_parameters():
            check(bool(torch.isfinite(p).all()), f"sgv2 pretrain {name} {k} not finite")
    run = root / "ckpt" / "starganv2_pretrain"
    tag = f"{SGV2_PRETRAIN_ITERS:06d}"
    for f in (f"{tag}_state.pt", "latest_state.pt"):
        check((run / f).exists(), f"the sgv2 pretrain wrote no {f}")
    steady = clock.steady_ms()
    fed_ms = statistics.median(steady)
    dev_ms = kernel_ms(clock.prof, PROFILED_SUPER_STEPS)
    print(f"sgv2 pretrain CLI (AFHQ flags, patch 32, mask ratio 0.65, "
          f"{n} iterations, batch {SGV2_TRAIN_BATCH}, {SGV2_IMAGE}^2, bf16) in "
          f"{wall_s:.1f} s: loader-fed iteration, median of {len(steady)} "
          f"steady {fed_ms:.3f} ms ({[round(v, 1) for v in steady]}); kernels "
          f"{dev_ms:.3f} ms an iteration over {PROFILED_SUPER_STEPS} profiled, "
          f"busy share {dev_ms / fed_ms:.1%}; peak {peak_mb:.1f} MiB; launches "
          f"{launches} ({per_fwd}/{per_bwd} an iteration) [{smi}]")
    del solver, clock
    free_memory()
    pretrain = dict(launches=launches, ms=fed_ms, dev_ms=dev_ms, peak_mb=peak_mb,
                    calls=calls, iterations=n)

    # --mode train --pretrain_dir: the state the loop starts from
    saved = read_checkpoint(root / "ckpt", "starganv2_pretrain", "latest")
    loaded, real_train = [], sgv2_cli.train

    def spy(args, solver_):
        loaded.append(cpu_state(solver_))
        real_train(args, solver_)

    t_per_fwd, t_per_bwd = (SGV2_FWD_PER_FORWARD * p for p in SGV2_G_PASSES["adain"])
    sgv2_cli.train = spy
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the warm-started run starts here
    try:
        trained = sgv2_cli.main(base + [
            "--mode", "train", "--pretrain_dir", str(root / "ckpt"),
            "--total_iters", "2", "--save_every", "1000", "--sample_every",
            "1000", "--print_every", "1"])
    finally:
        sgv2_cli.train = real_train
    torch.cuda.synchronize()
    warm_launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check(trained.step == saved["step"] + 2 and warm_launches == {
        "fwd": 2 * t_per_fwd, "bwd": 2 * t_per_bwd},
        f"sgv2 warm-started train: step {trained.step}, launches {warm_launches}")
    state = loaded[0]
    for net in ("G", "ema_G"):
        for k, v in saved[net].items():
            check(torch.equal(state[f"{net}/{k}"], v),
                  f"sgv2 warm start: {net} {k} differs from the pretrain run's")
    check(not any(k.startswith("token") for k in state), "a token was restored")
    print(f"sgv2 train --pretrain_dir: G and ema_G at load equal the pretrain "
          f"run's in all {len(saved['G'])} + {len(saved['ema_G'])} tensors, the "
          f"token left out; 2 iterations, launches {warm_launches} [{smi}]")
    del trained, loaded, saved
    free_memory()
    return pretrain, dict(launches=warm_launches)


# ------------------------------------------------------------ 12. pix2pix


def p2p_config(image=P2P_IMAGE, **kw):
    """The generator of ``to_pix2pix_config`` at the pix2pix CLI's defaults:
    SPADE (no kernel), cycle_gan (the raw tanh output), bf16."""
    from de_i2i_gan_torch.config import DefectGanConfig
    cfg = DefectGanConfig(image_size=image, label_nc=2, ngf=64, ndf=64,
                          num_scales=2, num_res=6, hidden_nc=128,
                          style_norm_block_type="spade", cycle_gan=True,
                          compute_dtype="bfloat16")
    return cfg.replace(**kw)


def p2p_train_config():
    """The pix2pix CLI's optimizer defaults: Adam (0.5, 0.999) at 2e-4, the
    step schedule over 200 epochs, EMA 0.999, batch 1."""
    from de_i2i_gan_torch.config import TrainConfig
    return TrainConfig(batch_size=1, num_critics=1, lr=(2e-4,),
                       ema_decay=0.999, num_epochs=200, num_iters=-1)


def p2p_steps(cfg, tcfg, device="cuda", **kw):
    """``Pix2PixSteps`` with the CLI's D (2 scales, 3 layers), weights from
    SEED."""
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps

    steps = Pix2PixSteps(cfg, tcfg, num_d_scales=2, n_layers_d=3,
                         iters_per_epoch=P2P_PAIRS, num_epochs=200,
                         device=device, **kw)
    init_weights(steps, SEED)
    return steps


def p2p_batches(image, n, gen, ipl=P2P_IPL, batch=1):
    shape = (ipl, batch, image, image, 3)
    return [{k: torch.rand(shape, generator=gen, device="cuda") * 2 - 1
             for k in ("input", "target")} for _ in range(n)]


def delta_gap(a, b, before, lr):
    """The largest per-tensor L2 distance between two steps' (after -
    before) / lr, in units of 6c's band (GRAD_REL_L2 of b's norm + GRAD_ATOL
    sqrt(n)); ``lr`` by net."""
    return max(delta_gaps(a, b, before, lr).values())


def delta_gaps(a, b, before, lr):
    """Each tensor's distance of ``delta_gap``, by net and name."""
    gaps = {}
    for n, rate in lr.items():
        got = dict(getattr(a, n).named_parameters())
        for k, ref in getattr(b, n).named_parameters():
            gk = (got[k].detach().float().cpu() - before[n][k]) / rate
            rk = (ref.detach().float().cpu() - before[n][k]) / rate
            gaps[f"{n}.{k}"] = ((gk - rk).norm() / (
                GRAD_REL_L2 * rk.norm() + GRAD_ATOL * rk.numel() ** 0.5)).item()
    return gaps


def loss_gap(m, ref):
    """The largest loss difference in units of LOSS_RTOL of the reference."""
    check(sorted(m) == sorted(ref), f"loss terms {sorted(m)} vs {sorted(ref)}")
    return max(abs(float(m[k]) - float(v)) / (LOSS_RTOL * abs(float(v)) + 1e-12)
               for k, v in ref.items())


def phase_p2p_small(smi):
    """12a. A tiny f32 ``train_step`` and ``fused_train_step`` (SGD, no
    noise) on the card against the same step on the CPU: losses within
    rtol 2e-4, G's and D's (after - before) / lr within 6c's band."""
    from de_i2i_gan_torch.config import TrainConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = p2p_config(32, ngf=8, ndf=8, num_res=2, hidden_nc=16,
                     compute_dtype="float32")
    tcfg = TrainConfig(batch_size=2, num_critics=1, lr=(2e-2, 1e-2),
                       optimizer="sgd", ema_decay=0.999)
    gen = torch.Generator().manual_seed(SEED + 40)
    batch = {k: torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
             for k in ("input", "target")}
    for fused in (False, True):
        runs = {}
        for device in ("cpu", "cuda"):
            steps = p2p_steps(cfg, tcfg, device, fused_prop=fused)
            before = param_snapshot(steps)
            m = steps.train_step({k: v.to(device) for k, v in batch.items()})
            runs[device] = (steps, before, {k: v.item() for k, v in m.items()})
        cpu, before, rm = runs["cpu"]
        card, _, m = runs["cuda"]
        loss = loss_gap(m, rm)
        rel = delta_gap(card, cpu, before, {"G": tcfg.lr_g, "D": tcfg.lr_d})
        label = "fused_train_step" if fused else "train_step"
        print(f"small pix2pix {label}, card vs CPU, 32x32 f32 SGD: max loss "
              f"diff {loss:.3f} x (rtol {LOSS_RTOL}); (after-before)/lr of G "
              f"and D: max per-tensor L2 diff {rel:.3f} x (band {GRAD_REL_L2} "
              f"|ref| + atol {GRAD_ATOL} sqrt(n)) [{smi}]")
        check(loss <= 1.0 and rel <= 1.0,
              f"small pix2pix {label}: losses {loss:.3f}, deltas {rel:.3f}")


def timed_super_steps(nk, steps, batches, label, warmup, smi, draws=None):
    """Super-steps on preloaded batches: host-clock ms of the timed ones,
    finite losses, no norm-kernel launch (the path has none), peak memory,
    then one profiled super-step's device time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    times, metrics = [], []
    with tally_calls(nk) as calls:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            m = steps.super_step(batch, draws)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(launches == {"fwd": 0, "bwd": 0} and not calls["fwd"]
          and not calls["bwd"], f"{label}: norm kernels launched {launches}")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()),
              f"{label} super-step {i}: non-finite loss {m}")
    for n in ("G", "D"):
        for k, p in getattr(steps, n).named_parameters():
            check(bool(torch.isfinite(p).all()), f"{label}: {n} {k} not finite")
    mean_ms = sum(times) / len(times)
    print(f"{label}: super-step ms {[round(v, 3) for v in times]} mean "
          f"{mean_ms:.3f}, peak memory {peak_mb:.1f} MiB, norm-kernel launches "
          f"{launches}; losses, first "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[0].items()})}, last "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[-1].items()})} "
          f"[{smi}]")
    dev_ms = profile_device(lambda: steps.super_step(batches[-1], draws), 1,
                            f"{label} super-step", mean_ms, smi,
                            conv_shapes=True)
    return dict(launches=launches, ms=mean_ms, dev_ms=dev_ms, peak_mb=peak_mb)


def phase_p2p_train(nk, smi, warmup=2, timed=5):
    """12b-12d. Full-width pix2pix super-steps (4 iterations of batch 1) on
    preloaded batches: ``train_step`` (12b), FusedProp (12b), the U-Net
    generator of ``--netG unet`` (12b, ``skip_conn``), remat (12c:
    also G's and D's SGD deltas of one iteration against remat off, f32 on
    the card, within 12a's band, and the same losses), one 512^2 super-step
    (12d). No norm-kernel launch on any of them."""
    from de_i2i_gan_torch.config import TrainConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    batches = p2p_batches(P2P_IMAGE, warmup + timed, gen)
    runs = {}
    for label, cfg_kw, kw in (("train_step", {}, {}),
                              ("fused", {}, dict(fused_prop=True)),
                              ("remat", dict(remat=True), {}),
                              ("unet", dict(skip_conn=True), {})):
        steps = p2p_steps(p2p_config(**cfg_kw), p2p_train_config(), **kw)
        runs[label] = timed_super_steps(
            nk, steps, batches, f"pix2pix-256 {label} (batch 1, {P2P_IPL} "
            "iterations a super-step, bf16)", warmup, smi)
        del steps
        free_memory()
    print(f"pix2pix-256 peak memory: remat off {runs['train_step']['peak_mb']:.1f}"
          f" MiB, remat on {runs['remat']['peak_mb']:.1f} MiB; super-step "
          f"{runs['train_step']['ms']:.3f} / {runs['remat']['ms']:.3f} ms [{smi}]")

    # 12c. remat on against off: one f32 SGD iteration on the card; the
    # remat-off step twice, so that the spread of off against off (cuDNN's
    # choices of algorithm, its non-deterministic backward kernels) stands
    # beside that of on against off (ROADMAP C.2)
    tcfg = TrainConfig(batch_size=1, num_critics=1, lr=(2e-2, 1e-2),
                       optimizer="sgd", ema_decay=0.999)
    batch = {k: v[0] for k, v in batches[0].items()}
    out = {}
    for label, remat in (("off", False), ("off again", False), ("on", True)):
        steps = p2p_steps(p2p_config(compute_dtype="float32", remat=remat),
                          tcfg)
        before = param_snapshot(steps)
        m = steps.train_step(batch)
        torch.cuda.synchronize()
        out[label] = (steps, {k: v.item() for k, v in m.items()})

    def spread(label, ref="off"):
        (a, ma), (b, mb) = out[label], out[ref]
        return (loss_gap(ma, mb),
                delta_gap(a, b, before, {"G": tcfg.lr_g, "D": tcfg.lr_d}),
                max((x.float() - y.float()).abs().max().item()
                    for x, y in zip(a.G.buffers(), b.G.buffers())))

    (loss, rel, stats), again = spread("on"), spread("off again")
    later = spread("on", "off again")
    remat_spread = {"on_vs_off": rel, "off_vs_off": again[1],
                    "on_vs_off_again": later[1], "loss_on_vs_off": loss,
                    "loss_off_vs_off": again[0],
                    "loss_on_vs_off_again": later[0]}
    print(f"pix2pix-256 remat on vs off, one f32 SGD iteration on the card: "
          f"max loss diff {loss:.3f} x (rtol {LOSS_RTOL}); (after-before)/lr "
          f"of G and D: max per-tensor L2 diff {rel:.3f} x (band "
          f"{GRAD_REL_L2} |ref| + atol {GRAD_ATOL} sqrt(n)); G's BatchNorm "
          f"statistics max diff {stats:.2e}; remat off vs off (the same step "
          f"twice): loss {again[0]:.3f} x, deltas {again[1]:.3f} x, "
          f"statistics {again[2]:.2e}; remat on vs the second off (both "
          f"after the first call): loss {later[0]:.3f} x, deltas "
          f"{later[1]:.3f} x, statistics {later[2]:.2e} (cuDNN benchmark "
          f"{torch.backends.cudnn.benchmark}, deterministic "
          f"{torch.backends.cudnn.deterministic}) [{smi}]")
    check(loss <= 1.0 and rel <= 1.0 and stats <= 1e-4,
          f"remat changed the step: losses {loss:.3f}, deltas {rel:.3f}, "
          f"statistics {stats:.2e}")
    runs["remat_spread"] = remat_spread
    del out, steps
    free_memory()

    # 12d. one super-step at 512^2 (pix2pixHD's multi-scale D with feature
    # matching at 512^2)
    steps = p2p_steps(p2p_config(512), p2p_train_config())
    runs["512"] = timed_super_steps(
        nk, steps, p2p_batches(512, 2, gen), f"pix2pix-512 train_step (batch "
        f"1, {P2P_IPL} iterations a super-step, bf16)", 1, smi)
    del steps, batches
    free_memory()
    return runs


def p2p_cli_args(name, *extra):
    return ["--name", name, "--ckpt_dir", str(CLI_DIR / "ckpt"), "--log_dir",
            str(CLI_DIR / "logs"), "--dataroot", "synthetic",
            "--max_dataset_size", str(P2P_PAIRS), *extra]


def phase_p2p_cli(nk, smi, preloaded_ms, name, *extra):
    """12e. ``cli.train_pix2pix.main`` for one epoch at its defaults (48
    synthetic pairs: 12 super-steps of 4 iterations), on the Python loader
    or ``--native_loader``: no norm-kernel launch, ``latest`` and a panel
    written, loader-fed host-clock time, the busy share over 3 profiled
    super-steps, peak memory, the copies pinned and on a side stream."""
    from de_i2i_gan_torch.cli.train_pix2pix import main as p2p_main
    from de_i2i_gan_torch.train.checkpoint import read_iter_record
    from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps

    label = f"pix2pix CLI {name}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the trainer's run starts here
    t0 = time.perf_counter()
    with SuperStepClock(nk, profile_at=PROFILE_AT,
                        target=(Pix2PixSteps, "super_step")) as clock:
        trainer = p2p_main(p2p_cli_args(name, "--num_epochs", "1",
                                        "--save_img_freq", "1", *extra))
    wall_s = time.perf_counter() - t0
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n = len(clock.ends)
    check(n == P2P_PAIRS // P2P_IPL and trainer.iters == n * P2P_IPL
          and launches == {"fwd": 0, "bwd": 0},
          f"{label}: {n} super-steps, {trainer.iters} iterations, launches "
          f"{launches}")
    check(all(clock.on_card), f"{label}: a batch reached the step off the card")
    check_trained(trainer, label)
    run = CLI_DIR / "ckpt" / name
    for f in ("latest_state.pt", "iter.txt", "opt.json"):
        check((run / f).exists(), f"the pix2pix CLI wrote no {f}")
    check(read_iter_record(CLI_DIR / "ckpt", name) == (1, n * P2P_IPL),
          "iter.txt")
    panel = CLI_DIR / "logs" / name / "Images_input_fake_target_1.png"
    # input | fake | target of the first batch's pairs (at most 4; batch 1)
    check(png_shape(panel) == (P2P_IMAGE, 3 * P2P_IMAGE),
          f"{label}: panel {png_shape(panel)}")
    steady = clock.steady_ms()
    fed_ms = statistics.median(steady)
    dev_ms = kernel_ms(clock.prof, PROFILED_SUPER_STEPS)
    copies, streams = h2d_copies(clock.prof, CLI_DIR / f"p2p_{name}_trace.json")
    check(len(copies) >= len(clock.keys[0])
          and all("Pinned" in c[0] and c[1] not in streams for c in copies),
          f"{label}: host-to-device copies {copies} vs kernel streams {streams}")
    dtypes = sorted({str(d[k]) for d in clock.dtypes for k in d})
    print(f"{label}, 1 epoch: {n} super-steps in {wall_s:.1f} s; loader-fed "
          f"super-step ms, host clock, median of {len(steady)} steady: "
          f"{fed_ms:.3f} {[round(v, 3) for v in steady]}; preloaded (12b) "
          f"{preloaded_ms:.3f}; kernels a super-step over {PROFILED_SUPER_STEPS} "
          f"profiled {dev_ms:.3f} ms, busy share {dev_ms / fed_ms:.1%}; peak "
          f"{peak_mb:.1f} MiB; launches {launches}; batches reach the step "
          f"as {clock.keys[0]} {dtypes}; {len(copies)} pinned copies on "
          f"stream(s) {sorted({c[1] for c in copies})}, kernels on "
          f"{sorted(streams)} [{smi}]")
    out = dict(launches=launches, ms=fed_ms, dev_ms=dev_ms, peak_mb=peak_mb,
               super_steps=n, state=cpu_state(trainer.steps),
               keys=clock.keys[0])
    del trainer, clock
    free_memory()
    return out


def phase_p2p_resume(nk, smi, trained):
    """12e. ``--continue_training`` to epoch 2: the state loaded at resume
    equals the saved one; the run restarts at the recorded epoch, as the
    JAX trainer does."""
    from de_i2i_gan_torch.cli.train_pix2pix import main as p2p_main
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint, read_iter_record
    from de_i2i_gan_torch.train.trainer import Pix2PixTrainer

    saved = read_checkpoint(CLI_DIR / "ckpt", "p2p", "latest")
    diff = same_state(saved, trained["state"])
    check(diff is None, f"pix2pix: the latest checkpoint differs at {diff}")
    entry, real_train = {}, Pix2PixTrainer.train

    def capture(self, *args, **kw):
        entry.update(first_epoch=self.first_epoch, iters=self.iters,
                     state=cpu_state(self.steps))
        return real_train(self, *args, **kw)

    n = trained["super_steps"]
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the resumed run starts here
    Pix2PixTrainer.train = capture
    try:
        trainer = p2p_main(p2p_cli_args("p2p", "--continue_training",
                                        "--num_epochs", "2"))
    finally:
        Pix2PixTrainer.train = real_train
    torch.cuda.synchronize()
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check_trained(trainer, "resumed pix2pix CLI")
    diff = same_state(entry["state"], saved)
    check(diff is None, f"pix2pix: the state loaded at resume differs at {diff}")
    check((entry["first_epoch"], entry["iters"]) == (1, n * P2P_IPL)
          and trainer.iters == 3 * n * P2P_IPL and launches == {"fwd": 0, "bwd": 0}
          and read_iter_record(CLI_DIR / "ckpt", "p2p") == (2, 3 * n * P2P_IPL),
          f"pix2pix resume: first_epoch {entry['first_epoch']}, iters "
          f"{entry['iters']} -> {trainer.iters}, launches {launches}")
    print(f"resumed pix2pix CLI: state at resume equals the saved one in all "
          f"{len(flat_state(saved))} entries; first_epoch 1, iters "
          f"{entry['iters']} -> {trainer.iters}; launches {launches} [{smi}]")
    del trainer, entry, saved
    free_memory()
    return dict(launches=launches)


def phase_p2p_test_cli(nk, smi):
    """12e. ``cli.test_pix2pix.main`` on the resumed run: ``results.json``
    with a finite ``l1`` over the test pairs (the synthetic test split's 64
    capped at P2P_PAIRS), one panel a pair of 256 x 768 from finite
    pixels."""
    from de_i2i_gan_torch.cli.test_pix2pix import main as test_main
    from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps

    finite, real = [], Pix2PixSteps.generate

    def checked(self, *args, **kw):
        out = real(self, *args, **kw)
        finite.append(bool(torch.isfinite(out).all()))
        return out

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the test CLI's run starts here
    Pix2PixSteps.generate = checked
    try:
        out = test_main(p2p_cli_args("p2p", "--results_dir",
                                     str(CLI_DIR / "p2p_results"), "--save_img"))
    finally:
        Pix2PixSteps.generate = real
    torch.cuda.synchronize()
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    saved = json.loads((CLI_DIR / "p2p_results" / "p2p" / "results.json").read_text())
    n = min(64, P2P_PAIRS)
    check(launches == {"fwd": 0, "bwd": 0} and all(finite) and finite
          and saved == {"l1": out["l1"], "num_images": n}
          and math.isfinite(saved["l1"]) and len(out["pngs"]) == n
          and all(png_shape(p) == (P2P_IMAGE, 3 * P2P_IMAGE) for p in out["pngs"]),
          f"pix2pix test CLI: results {saved}, {len(out['pngs'])} panels, "
          f"finite {set(finite)}, launches {launches}")
    print(f"pix2pix test CLI: results.json {saved}, {len(out['pngs'])} panels "
          f"of {png_shape(out['pngs'][0])} from finite pixels, launches "
          f"{launches} [{smi}]")
    return dict(launches=launches)


# ------------------------------------------------------------ 13. WGAN


def wgan_config():
    """``to_wgan_config`` at ``add_wgan_args``' defaults, bf16."""
    from de_i2i_gan_torch.config import WGanConfig
    return WGanConfig(image_size=64, noise_dim=100, ngf=64, ndf=64,
                      num_layers=3, clipping_limit=0.03, num_critics=5,
                      compute_dtype="bfloat16")


def wgan_steps(cfg, tcfg, device="cuda", gp_weight=0.0):
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.wgan_steps import WGanSteps

    steps = WGanSteps(cfg, tcfg, iters_per_epoch=40, num_epochs=120,
                      gp_weight=gp_weight, device=device)
    init_weights(steps, SEED)
    return steps


def phase_wgan_small(smi):
    """13a. A tiny f32 clipping super-step and a GP super-step (2 critics,
    SGD, the noise and eps drawn on the host and handed to both) on the
    card against the CPU: losses within rtol 2e-4, G's and D's (after -
    before) / lr within 6c's band."""
    from de_i2i_gan_torch.config import TrainConfig, WGanConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WGanConfig(image_size=32, noise_dim=16, ngf=8, ndf=8, num_layers=2,
                     num_critics=2)
    tcfg = TrainConfig(batch_size=4, num_critics=2, lr=(2e-2, 1e-2),
                       optimizer="sgd")
    gen = torch.Generator().manual_seed(SEED + 50)
    batch = {"imgs": torch.rand((2, 4, 32, 32, 3), generator=gen) * 2 - 1}
    z = torch.randn((3, 4, 16), generator=gen)
    eps = torch.rand((2, 4, 1, 1, 1), generator=gen)
    for gp in (0.0, WGAN_GP):
        runs = {}
        for device in ("cpu", "cuda"):
            steps = wgan_steps(cfg, tcfg, device, gp)
            before = param_snapshot(steps)
            m = steps.super_step({k: v.to(device) for k, v in batch.items()},
                                 z=z.to(device), eps=eps.to(device))
            runs[device] = (steps, before, {k: v.item() for k, v in m.items()})
        cpu, before, rm = runs["cpu"]
        card, _, m = runs["cuda"]
        loss = loss_gap(m, rm)
        rel = delta_gap(card, cpu, before, {"G": tcfg.lr_g, "D": tcfg.lr_d})
        stats = max((b.cpu() - a).abs().max().item() for a, b in zip(
            cpu.D.buffers(), card.D.buffers()))
        label = f"GP (weight {gp})" if gp else "clipping"
        print(f"small WGAN {label} super-step, card vs CPU, 32x32 f32 SGD: "
              f"max loss diff {loss:.3f} x (rtol {LOSS_RTOL}); (after-before)"
              f"/lr of G and D: max per-tensor L2 diff {rel:.3f} x (band "
              f"{GRAD_REL_L2} |ref| + atol {GRAD_ATOL} sqrt(n)); D's running "
              f"statistics max diff {stats:.2e} [{smi}]")
        check(loss <= 1.0 and rel <= 1.0 and stats <= 1e-4,
              f"small WGAN {label}: losses {loss:.3f}, deltas {rel:.3f}, "
              f"statistics {stats:.2e}")


def phase_wgan_train(nk, smi, warmup=2, timed=5):
    """13b. Full-width WGAN super-steps (5 critic steps of 128, then a G
    step) on preloaded batches, clipping and GP: host-clock time, a
    profiled super-step, peak memory, finite losses, no norm-kernel
    launch; the critic's weights within the clip after a clipping step."""
    from de_i2i_gan_torch.config import TrainConfig

    cfg = wgan_config()
    tcfg = TrainConfig(batch_size=WGAN_BATCH, num_critics=5, lr=(5e-5,),
                       optimizer="rmsprop", num_epochs=120)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    shape = (cfg.num_critics, WGAN_BATCH, 64, 64, 3)
    batches = [{"imgs": torch.rand(shape, generator=gen, device="cuda") * 2 - 1}
               for _ in range(warmup + timed)]
    draws = torch.Generator(device="cuda").manual_seed(SEED + 52)
    runs = {}
    for label, gp in (("clipping", 0.0), ("gp", WGAN_GP)):
        steps = wgan_steps(cfg, tcfg, gp_weight=gp)
        runs[label] = timed_super_steps(
            nk, steps, batches, f"WGAN-64 {label} (batch {WGAN_BATCH}, 5 "
            "critics, RMSprop, bf16)", warmup, smi, draws)
        check(steps.step == (warmup + timed + 1) * 5
              and steps.tx_G.count == warmup + timed + 1,
              f"WGAN {label}: update counts {steps.step} / {steps.tx_G.count}")
        if not gp:
            # the last D step clipped, then moved each weight by at most
            # lr * |g| / sqrt(nu + eps)
            steps.d_step({"imgs": batches[0]["imgs"][0]}, draws)
            worst = max(p.abs().max().item() for p in steps.D.parameters())
            print(f"WGAN clipping: the critic's largest weight after a D step "
                  f"{worst:.5f} (clip {cfg.clipping_limit}) [{smi}]")
            check(worst <= cfg.clipping_limit + 1e-2, f"clipped weight {worst}")
        del steps
        free_memory()
    del batches
    return runs


def wgan_cli_args(name, *extra):
    return ["--name", name, "--ckpt_dir", str(CLI_DIR / "ckpt"), "--log_dir",
            str(CLI_DIR / "logs"), "--dataset_name", "synthetic", *extra]


def phase_wgan_cli(nk, smi):
    """13c. ``cli.train_wgan.main`` at its defaults for one epoch (the
    synthetic dataset's 1024 images: 1 super-step of 5 x 128) on the Python
    loader and with ``--native_loader``, then a ``--continue_training``
    resume to epoch 2 whose loaded state equals the saved one: no
    norm-kernel launch, checkpoints and the 4x4 sample grid written."""
    from de_i2i_gan_torch.cli.train_wgan import main as wgan_main
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint, read_iter_record
    from de_i2i_gan_torch.train.trainer import WGanTrainer
    from de_i2i_gan_torch.train.wgan_steps import WGanSteps

    out = {}
    for name, extra in (("wgan", ()), ("wgan_native", ("--native_loader",))):
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the run starts here
        t0 = time.perf_counter()
        with SuperStepClock(nk, target=(WGanSteps, "super_step")) as clock:
            trainer = wgan_main(wgan_cli_args(name, "--num_epochs", "1", *extra))
        wall_s = time.perf_counter() - t0
        launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
        grid = CLI_DIR / "logs" / name / "Images_fixed_noise_1.png"
        check(len(clock.ends) == 1 and trainer.iters == 5
              and launches == {"fwd": 0, "bwd": 0} and all(clock.on_card)
              and read_iter_record(CLI_DIR / "ckpt", name) == (1, 5)
              and png_shape(grid) == (4 * 64, 4 * 64),
              f"WGAN CLI {name}: {len(clock.ends)} super-steps, launches "
              f"{launches}, grid {png_shape(grid)}")
        for n in ("G", "D"):
            for k, p in getattr(trainer.steps, n).named_parameters():
                check(bool(torch.isfinite(p).all()), f"WGAN CLI {name}: {n} {k}")
        dtypes = sorted({str(d[k]) for d in clock.dtypes for k in d})
        print(f"WGAN CLI {name}, 1 epoch: {len(clock.ends)} super-step in "
              f"{wall_s:.1f} s (imports, cache and first-call set-up "
              f"included); batches {clock.keys[0]} {dtypes}; grid "
              f"{png_shape(grid)}; launches {launches} [{smi}]")
        out[name] = dict(launches=launches, state=cpu_state(trainer.steps))
        del trainer, clock
        free_memory()
    saved = read_checkpoint(CLI_DIR / "ckpt", "wgan", "latest")
    check(same_state(saved, out["wgan"].pop("state")) is None,
          "WGAN: the latest checkpoint differs from the trained state")
    out["wgan_native"].pop("state")
    entry, real_train = {}, WGanTrainer.train

    def capture(self, *args, **kw):
        entry.update(first_epoch=self.first_epoch, iters=self.iters,
                     state=cpu_state(self.steps))
        return real_train(self, *args, **kw)

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the resumed run starts here
    WGanTrainer.train = capture
    try:
        trainer = wgan_main(wgan_cli_args("wgan", "--continue_training",
                                          "--num_epochs", "2"))
    finally:
        WGanTrainer.train = real_train
    torch.cuda.synchronize()
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    diff = same_state(entry["state"], saved)
    check(diff is None and (entry["first_epoch"], entry["iters"]) == (1, 5)
          and trainer.iters == 15 and launches == {"fwd": 0, "bwd": 0}
          and read_iter_record(CLI_DIR / "ckpt", "wgan") == (2, 15),
          f"WGAN resume: state differs at {diff}, first_epoch "
          f"{entry['first_epoch']}, iters {entry['iters']} -> {trainer.iters}")
    print(f"resumed WGAN CLI: state at resume equals the saved one in all "
          f"{len(flat_state(saved))} entries (RMSprop's nu included); "
          f"iters {entry['iters']} -> {trainer.iters}; launches {launches} "
          f"[{smi}]")
    out["wgan_resume"] = dict(launches=launches)
    del trainer, entry, saved
    free_memory()
    return out


# --------------------------------------------- 14. the frozen ViT (SEAN)


def seeded_vit(device, dtype=torch.float32):
    """ViT-B/16 (hidden 768, 12 layers, 224^2) with weights from SEED,
    drawn on ``device``."""
    from de_i2i_gan_torch.models.vit import ViTEncoder
    return ViTEncoder("base", dtype=dtype, device=device,
                      generator=torch.Generator(device).manual_seed(SEED))


def rel_l2(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm()).item()


def phase_vit(nk, smi):
    """14a. ViT-B/16 from a seed: the last hidden state of 2 images of
    256^2 (resized to 224^2) on the card against the CPU, f32 with TF32 off,
    relative L2 within VIT_F32_BAND; then batch-32 embedding requests in
    bf16 through ``FeatureExtractor``: host and device time, peak memory,
    no norm-kernel launch."""
    from de_i2i_gan_torch.models.vit import FeatureExtractor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(
        SEED + 60)) * 2 - 1
    cpu = seeded_vit("cpu")
    with torch.no_grad():
        ref = cpu(x)
        out = copy.deepcopy(cpu).to("cuda")(x.cuda())
    err = rel_l2(out, ref)
    print(f"ViT-B/16 at 224^2 from 256^2, f32 (TF32 off), card vs CPU: last "
          f"hidden state {tuple(out.shape)}, relative L2 {err:.3e} (band "
          f"{VIT_F32_BAND}) [{smi}]")
    check(out.shape == (2, 197, 768) and err <= VIT_F32_BAND,
          f"ViT card vs CPU: {tuple(out.shape)}, relative L2 {err:.3e}")
    del cpu, out
    free_memory()

    fe = FeatureExtractor(seeded_vit("cuda", torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    reqs = [torch.rand((VIT_BATCH, 256, 256, 3), generator=gen, device="cuda")
            * 2 - 1 for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    times = []
    for i in range(2 + VIT_TIMED):
        t0 = time.perf_counter()
        emb = fe.extract(reqs[i % 2], 1)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(emb.shape == (VIT_BATCH, 1, 768) and emb.dtype == torch.bfloat16
          and bool(torch.isfinite(emb).all()), f"ViT embeddings {emb.shape}")
    check(launches == {"fwd": 0, "bwd": 0}, f"the ViT launched {launches}")
    dev_ms = device_ms(lambda i: fe.extract(reqs[i % 2], 1), VIT_TIMED)
    ms = statistics.median(times)
    print(f"ViT-B/16 embedding request, batch {VIT_BATCH} of 256^2, bf16: "
          f"host {ms:.3f} ms (median of {len(times)}), device {dev_ms:.3f} ms "
          f"({VIT_BATCH * 1e3 / dev_ms:.1f} img/s), peak {peak_mb:.1f} MiB, "
          f"norm-kernel launches {launches} [{smi}]")
    del fe, reqs
    free_memory()
    return dict(launches=launches, ms=ms, dev_ms=dev_ms, peak_mb=peak_mb,
                err=err)


def phase_vit_cli(nk, smi):
    """14b. ``cli.train_vit`` for one epoch on the synthetic DefectGAN data
    (ViT-B from the CLI's seed, 224^2, batch VIT_BATCH), ``cli.test_vit
    --save_embeddings --calc_classifier_acc``, then that bank as DefectGAN
    SEAN's ``--embed_path`` through ``cli.train_defectgan`` for an epoch:
    exactly 56/16 launches a super-step, the bank's embeddings at the
    step."""
    from de_i2i_gan_torch.cli import test_vit, train_vit
    from de_i2i_gan_torch.cli.train_defectgan import main as train_main
    from de_i2i_gan_torch.data.embeddings import EmbeddingBank

    root = CLI_DIR / "vit"
    shutil.rmtree(root, ignore_errors=True)
    base = ["--name", "vit", "--dataset_name", "synthetic", "--batch_size",
            str(VIT_BATCH), "--ckpt_dir", str(root / "ckpt"), "--log_dir",
            str(root / "logs")]
    t0 = time.perf_counter()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the ViT CLIs' run starts here
    steps = train_vit.main(base + ["--num_epochs", "1"])
    t1 = time.perf_counter()
    out = test_vit.main(base + ["--results_dir", str(root / "results"),
                                "--save_embeddings", "--calc_classifier_acc"])
    vit_launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check(steps.step == 512 // VIT_BATCH and vit_launches == {"fwd": 0, "bwd": 0},
          f"train_vit: {steps.step} steps, launches {vit_launches}")
    bank = EmbeddingBank.load(out["embeddings_path"])
    check(bank.embed_nc == 768 and bank.label_nc == 6
          and int(bank.counts.sum()) == 64, f"the ViT bank: {bank.embed_nc} "
          f"wide, {int(bank.counts.sum())} embeddings")
    print(f"ViT CLIs: train_vit one epoch ({steps.step} head steps of "
          f"{VIT_BATCH}) {t1 - t0:.1f} s; test_vit accuracy "
          f"{out['accuracy']:.3f}, loss {out['loss']:.4f}, bank of "
          f"{int(bank.counts.sum())} embeddings over "
          f"{int((bank.counts > 0).sum())} labels in "
          f"{time.perf_counter() - t1:.1f} s [{smi}]")

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the SEAN trainer's run starts here
    with SuperStepClock(nk) as clock:
        trainer = train_main(cli_args(
            "vit_bank", "--style_norm_block_type", "sean", "--embed_path",
            str(out["embeddings_path"]), "--num_epochs", "1"))
    launches = check_trainer_launches(nk, clock, "train CLI sean with the "
                                      "ViT bank", trainer.cfg)  # ... ends here
    check_trained(trainer, "train CLI sean with the ViT bank")
    check(all("df_embeds" in k and "nm_embeds" in k for k in clock.keys),
          "the ViT bank's embeddings did not reach the step")
    print(f"train CLI sean --embed_path <the ViT bank>: {len(clock.ends)} "
          f"super-steps, loader-fed super-step ms median "
          f"{statistics.median(clock.steady_ms()):.3f}, launches {launches} "
          f"({launches['fwd'] // len(clock.ends)}/"
          f"{launches['bwd'] // len(clock.ends)} a super-step) [{smi}]")
    del trainer, clock, steps
    free_memory()
    return dict(launches=vit_launches), dict(launches=launches)


def phase_sgv2_sean_vit(nk, smi):
    """14c. StarGAN v2 SEAN with lambda_sty through the solver: the AFHQ
    flags at batch 8, 256^2, bf16, (8, 5, 768) embeddings made on the card,
    ViT-B attached by ``set_frozen_nets``. SGV2_SEAN_ITERS warm-up and timed
    iterations (exactly 48/24 launches each: the ViT adds none), the style
    term live, peak memory, a profiled iteration, and the ViT's share of its
    device time, read from that profile: the kernels of the solver's
    ``solver.embed_fake`` range and of their backward."""
    cfg = sgv2_train_config("sean", allow_degraded_losses=False)
    solver = sgv2_trainer(cfg)
    solver.set_frozen_nets(vit=seeded_vit("cuda"))
    warmup, timed = SGV2_SEAN_ITERS
    batches = sgv2_train_batches(cfg, warmup + timed, SEED + 62)
    draws = torch.Generator(device="cuda").manual_seed(SEED + 63)
    per_fwd, per_bwd = (SGV2_FWD_PER_FORWARD * n for n in SGV2_G_PASSES["sean"])

    def step(batch):
        m = solver.train_step(batch, draws)
        solver.update_sean_stats()
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    times, metrics = [], []
    for i, batch in enumerate(batches):
        fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        check((nk.LAUNCHES - fwd0, nk.BWD_LAUNCHES - bwd0) == (per_fwd, per_bwd),
              f"sgv2 sean+ViT iteration {i}: {nk.LAUNCHES - fwd0}/"
              f"{nk.BWD_LAUNCHES - bwd0} launches, expected {per_fwd}/{per_bwd}")
        metrics.append({k: v.item() for k, v in m.items()})
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(all(math.isfinite(v) for m in metrics for v in m.values())
          and all(m["G/ref_sty"] > 0 for m in metrics),
          f"sgv2 sean+ViT losses {metrics[-1]}")
    check(solver.vit.dtype == torch.bfloat16
          and not any(p.requires_grad for p in solver.vit.parameters()),
          "the solver's ViT is not the frozen bf16 copy")
    ms = sum(times) / len(times)
    prof = profiled(lambda: step(batches[-1]), 1)
    dev_ms = report_profile(prof, 1, "sgv2 sean+ViT iteration", ms, smi)
    vit_fwd, vit_bwd = range_device_ms(prof, "solver.embed_fake", 1)
    check(dev_ms is None or (vit_fwd > 0 and vit_bwd > 0 and not any(
        e.key == "solver.embed_fake" for e in device_kernels(prof))),
          f"the profiled iteration's ViT: forward {vit_fwd:.3f} ms, backward "
          f"{vit_bwd:.3f} ms, or its range summed as a kernel")
    share = None if dev_ms is None else (vit_fwd + vit_bwd) / dev_ms
    print(f"training StarGAN v2 AFHQ sean with lambda_sty (ViT-B/16 frozen, "
          f"bf16, batch {SGV2_TRAIN_BATCH}): iteration ms "
          f"{[round(v, 3) for v in times]} mean {ms:.3f}, kernels "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, of "
          f"which the ViT (profiled range solver.embed_fake) forward "
          f"{vit_fwd:.3f} ms + backward {vit_bwd:.3f} ms = "
          f"{'not measured' if share is None else f'{share:.1%}'}; peak "
          f"{peak_mb:.1f} MiB, launches "
          f"{launches} ({per_fwd}/{per_bwd} an iteration); losses, last "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[-1].items()})} "
          f"[{smi}]")
    del solver, batches
    free_memory()
    return dict(launches=launches, ms=ms, dev_ms=dev_ms, vit_fwd_ms=vit_fwd,
                vit_bwd_ms=vit_bwd, share=share, peak_mb=peak_mb)


def run_cli(main, argv):
    """``main(argv)`` with its standard output kept; returns (its result,
    the output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    out = buf.getvalue()
    print("\n".join(out.splitlines()[-6:]))
    return result, out


def logged_losses(out, prefix="Iteration ["):
    """{name: value} of the last line of ``out`` that starts with
    ``prefix``."""
    line = [ln for ln in out.splitlines() if ln.startswith(prefix)][-1]
    return {k: float(v) for k, v in re.findall(r"(\S+): \[([-\d.e]+)\]", line)}


def phase_sgv2_sean_cli(nk, smi):
    """14d. ``cli.starganv2_main --norm_type sean --vit_path <a .bin with
    HF key names, written here from ViT-B's seed>`` on 10d's image tree with
    the AFHQ flags: SGV2_SEAN_CLI_ITERS loader-fed iterations (exactly 48/24
    launches each; the fetcher's f32 ViT and the loss's bf16 copy launch no
    norm kernel), the style term live, then ``--mode update_stats`` from
    that checkpoint (12 forward launches a tracked batch)."""
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.models.vit import hf_state_dict
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint
    from de_i2i_gan_torch.train.solver import StarGANv2Solver

    root = CLI_DIR / "sgv2_sean"
    shutil.rmtree(root, ignore_errors=True)
    (root / "vit").mkdir(parents=True)
    torch.save({f"vit.{k}": v for k, v in hf_state_dict(seeded_vit("cuda")).items()},
               root / "vit" / "pytorch_model.bin")
    tree = CLI_DIR / "sgv2" / "afhq"
    n = SGV2_SEAN_CLI_ITERS
    base = [*SGV2_AFHQ, "--norm_type", "sean", "--vit_path", str(root / "vit"),
            "--img_size", str(SGV2_IMAGE), "--batch_size", str(SGV2_TRAIN_BATCH),
            "--train_img_dir", str(tree), "--val_img_dir", str(tree),
            "--checkpoint_dir", str(root / "ckpt"), "--sample_dir",
            str(root / "samples"), "--device", CARD]
    per_fwd, per_bwd = (SGV2_FWD_PER_FORWARD * k for k in SGV2_G_PASSES["sean"])
    t0 = time.perf_counter()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's runs start here
    with SuperStepClock(nk, target=(StarGANv2Solver, "train_step")) as clock:
        solver, out = run_cli(sgv2_cli.main, base + [
            "--mode", "train", "--total_iters", str(n), "--save_every", str(n),
            "--sample_every", "1000", "--print_every", str(n)])
    prev = (0, 0)
    for i, cur in enumerate(clock.launches):
        check((cur[0] - prev[0], cur[1] - prev[1]) == (per_fwd, per_bwd),
              f"sgv2 sean CLI iteration {i}: {cur[0] - prev[0]}/"
              f"{cur[1] - prev[1]} launches, expected {per_fwd}/{per_bwd}")
        prev = cur
    losses = logged_losses(out)
    check(len(clock.ends) == n and solver.step == n and solver.vit is not None
          and losses["G/ref_sty"] > 0 and all(clock.on_card),
          f"sgv2 sean CLI: {len(clock.ends)} iterations, losses {losses}")
    train_s = time.perf_counter() - t0
    del solver
    free_memory()
    fwd0, bwd0 = nk.LAUNCHES, nk.BWD_LAUNCHES
    run_cli(sgv2_cli.main, base + ["--mode", "update_stats", "--resume_iter",
                                   str(n), "--num_stats_samples",
                                   str(SGV2_STATS_SAMPLES)])
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    tracked = (launches["fwd"] - fwd0) // SGV2_FWD_PER_FORWARD
    check(tracked > 0 and launches["fwd"] - fwd0 == tracked * SGV2_FWD_PER_FORWARD
          and launches["bwd"] == bwd0, f"update_stats launches {launches}")
    saved = read_checkpoint(root / "ckpt", "starganv2", "stats_updated")
    means = [v for k, v in saved["ema_G"].items() if k.endswith(".mean")]
    check(means and all(bool(torch.isfinite(v).all()) for v in means),
          "update_stats: the finalized running styles")
    print(f"sgv2 CLI sean --vit_path (HF keys, ViT-B from a seed): {n} "
          f"iterations in {train_s:.1f} s, lambda_sty {losses['G/ref_sty']:.4f}"
          f", {per_fwd}/{per_bwd} launches an iteration; update_stats "
          f"{tracked} tracked batches of {SGV2_TRAIN_BATCH} "
          f"({SGV2_FWD_PER_FORWARD} forward launches each), "
          f"{time.perf_counter() - t0 - train_s:.1f} s; launches {launches} "
          f"[{smi}]")
    return dict(launches=launches)


# ------------------------------------------------ 15. the FAN (CelebA-HQ)


def sparse_fan(device):
    """The FAN from SEED (drawn on the CPU) with its landmark head shifted
    channel by channel so that FAN_ACTIVE of the pixels of a calibration
    image (drawn from SEED + 71) cross preprocess_heatmaps' 0.1 threshold;
    a channel's argmax, and so the landmarks, stay where they were."""
    from de_i2i_gan_torch.models import wing

    fan = wing.make_fan("cpu", SEED)
    x = torch.rand((1, 256, 256, 3), generator=torch.Generator().manual_seed(
        SEED + 71)) * 2 - 1
    with torch.no_grad():
        hm = wing.landmark_heatmaps(fan, x).reshape(-1, 98)
        fan.l0.bias[:98] += 0.1 - torch.quantile(hm, 1 - FAN_ACTIVE, dim=0)
    return fan.to(device)


def bump_heatmaps(seed, n=2, size=64):
    """Landmark-like FAN output (N, size, size, 98): one Gaussian bump a
    channel, peaks from 0.3 to 1.2, over noise below 0.02."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(8, size - 8, (2, 98))
        width = rng.uniform(2, 6, 98)
        hm = np.exp(-((yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2)
                    / (2 * width ** 2))
        out.append(hm * rng.uniform(0.3, 1.2, 98)
                   + rng.uniform(0, 0.02, hm.shape))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def check_masks_flat(masks, label):
    """Masks that neither clip to 1 nor vanish everywhere; returns their
    means."""
    means = [m.float().mean().item() for m in masks]
    check(all(0.01 < v < 0.99 for v in means), f"{label}: mask means {means}")
    return means


def phase_fan(nk, smi):
    """15a. FAN from a seed at 256^2, its head shifted by ``sparse_fan``:
    the 98 landmark heatmaps before the 0.1 threshold on the card against
    the CPU (f32, TF32 off, 2 images), relative L2 within FAN_BAND; the
    masks' steps on the same non-flat input on the card against the CPU,
    within MASK_ATOL (bump heatmaps from a seed: the 64 -> 256 upsample,
    preprocess_heatmaps on the CPU's upsample, the generator's antialiased
    resize of the masks to 32/64/128); the FAN's masks end to end, printed
    (the threshold can flip a pixel), not flat on either; then the two masks
    of a batch of 8 timed on the card, no norm-kernel launch."""
    from de_i2i_gan_torch.models import wing
    from de_i2i_gan_torch.models.vit import resize_bilinear

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = sparse_fan("cpu")
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(
        SEED + 65)) * 2 - 1
    with torch.no_grad():
        ref = wing.landmark_heatmaps(cpu, x)
        got = wing.landmark_heatmaps(card, x.cuda())
    err = rel_l2(got, ref)
    check(got.shape == (2, 64, 64, 98) and err <= FAN_BAND,
          f"FAN card vs CPU: relative L2 {err:.3e}")
    ends = [wing.fan_masks(cpu, x), wing.fan_masks(card, x.cuda())]
    flips = [[((a.cpu() - b).abs() > tol).float().mean().item()
              for a, b in zip(ends[1], ends[0])] for tol in (MASK_ATOL, 1e-2)]
    fan_means = [check_masks_flat(m, f"the FAN's masks on the {d}")
                 for m, d in zip(ends, ("CPU", "card"))]

    # the masks' steps on the same input
    hm = bump_heatmaps(SEED + 72).permute(0, 3, 1, 2)
    up = resize_bilinear(hm, 256)
    steps = {"upsample": (resize_bilinear(hm.cuda(), 256), up)}
    up = up.permute(0, 2, 3, 1)
    masks = wing.preprocess_heatmaps(up)
    steps.update(zip(("mask 1", "mask 2"),
                     zip(wing.preprocess_heatmaps(up.cuda()), masks)))
    for size in (32, 64, 128):
        m = masks[0] if size == 32 else masks[1]
        m = m.permute(0, 3, 1, 2)
        steps[f"resize to {size}"] = (resize_bilinear(m.cuda(), size),
                                      resize_bilinear(m, size))
    diffs = {k: (a.cpu() - b).abs().max().item() for k, (a, b) in steps.items()}
    bump_means = check_masks_flat(masks, "the bump heatmaps' masks")
    check(max(diffs.values()) <= MASK_ATOL,
          f"the masks' steps card vs CPU: {diffs} (atol {MASK_ATOL})")
    print(f"FAN at 256^2, f32 (TF32 off), card vs CPU: heatmaps "
          f"{tuple(got.shape)} relative L2 {err:.3e} (band {FAN_BAND}); its "
          f"masks end to end (the threshold flips pixels near 0.1): "
          f"{flips[0][0]:.2e} / {flips[0][1]:.2e} of the pixels differ by "
          f"more than {MASK_ATOL}, {flips[1][0]:.2e} / {flips[1][1]:.2e} by "
          f"more than 1e-2, means "
          f"{[round(v, 4) for v in fan_means[1]]}; the masks' steps on bump "
          f"heatmaps (mask means {[round(v, 4) for v in bump_means]}), max "
          f"abs diff {json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})}"
          f" (atol {MASK_ATOL}) [{smi}]")
    del cpu, ends, steps
    xb = torch.rand((SGV2_TRAIN_BATCH, 256, 256, 3), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED + 66))
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    m1, m2 = wing.fan_masks(card, xb)
    fan_ms = device_ms(lambda i: wing.fan_masks(card, xb), 5)
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check(launches == {"fwd": 0, "bwd": 0} and m1.shape == (8, 256, 256, 1)
          and bool(torch.isfinite(m1).all() and torch.isfinite(m2).all()),
          f"FAN masks: launches {launches}")
    print(f"FAN masks of a batch of {SGV2_TRAIN_BATCH} at 256^2 (f32): "
          f"{fan_ms:.3f} ms on the card; mask means {m1.mean().item():.4f} / "
          f"{m2.mean().item():.4f} [{smi}]")
    del xb
    free_memory()
    return dict(launches=launches, fan_ms=fan_ms, err=err, fan=card)


def phase_sgv2_celeba_cli(nk, smi, fan):
    """15b. The upstream README's CelebA-HQ command (SGV2_CELEBA: w_hpf 1,
    AdaIN) at batch 8, 256^2, bf16, with ``--wing_ckpt`` (15a's FAN under
    the reference's key names), on an image tree of 2 domains:
    SGV2_CELEBA_ITERS loader-fed iterations. Each takes the FAN's masks of
    x_src and of both passes' x_fake, none of them flat; the kernels' calls
    are counted by shape, the same each iteration, G's passes times one
    masked G forward's CELEBA_TRAIN_SHAPES; a profiled window gives the
    iteration's device time and the FAN's share of it (the kernels of the
    solver's ``solver.heatmaps`` range)."""
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.models import wing
    from de_i2i_gan_torch.train.solver import StarGANv2Solver

    root = CLI_DIR / "sgv2_celeba"
    shutil.rmtree(root, ignore_errors=True)
    tree = sgv2_image_tree(root / "celeba_hq", SEED + 67, ("female", "male"))
    wing_ckpt = root / "wing.ckpt"
    torch.save({"state_dict": wing.wing_state_dict(fan)}, wing_ckpt)
    n = SGV2_CELEBA_ITERS
    mask_calls, real = [], wing.fan_masks

    def counted(fan, x):
        masks = real(fan, x)  # their means read after the run (no sync)
        mask_calls.append((tuple(x.shape),
                           torch.stack([m.float().mean() for m in masks])))
        return masks

    wing.fan_masks = counted
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's run starts here
    try:
        with tally_calls(nk) as calls, SuperStepClock(
                nk, profile_at=CELEBA_PROFILE_AT,
                target=(StarGANv2Solver, "train_step")) as clock:
            solver, out = run_cli(sgv2_cli.main, [
                *SGV2_CELEBA, "--img_size", str(SGV2_IMAGE), "--batch_size",
                str(SGV2_TRAIN_BATCH), "--train_img_dir", str(tree),
                "--val_img_dir", str(tree), "--checkpoint_dir",
                str(root / "ckpt"), "--sample_dir", str(root / "samples"),
                "--device", CARD, "--wing_ckpt", str(wing_ckpt), "--mode",
                "train", "--total_iters", str(n), "--save_every", "1000",
                "--sample_every", "1000", "--print_every", str(n)])
    finally:
        wing.fan_masks = real
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    steps, prev = [], (0, 0)
    for cur in clock.launches:
        steps.append((cur[0] - prev[0], cur[1] - prev[1]))
        prev = cur
    check(len(steps) == n and len(set(steps)) == 1 and all(clock.on_card),
          f"CelebA-HQ CLI iterations' launches {steps}")
    check([c[0] for c in mask_calls]
          == [(SGV2_TRAIN_BATCH, SGV2_IMAGE, SGV2_IMAGE, 3)] * 3 * n,
          f"CelebA-HQ CLI: FAN mask calls {mask_calls[:4]}... ({len(mask_calls)})")
    means = [v for c in mask_calls for v in c[1].tolist()]
    check(all(0.01 < v < 0.99 for v in means),
          f"CelebA-HQ CLI: flat masks, means {min(means)} .. {max(means)}")
    g_fwd, g_bwd = SGV2_G_PASSES["adain"]
    check(calls["fwd"] == Counter({s: n * g_fwd * c
                                   for s, c in CELEBA_TRAIN_SHAPES.items()})
          and calls["bwd"] == Counter({s: n * g_bwd * c
                                       for s, c in CELEBA_TRAIN_SHAPES.items()}),
          f"CelebA-HQ CLI calls by shape over {n} iterations: {calls}")
    # one masked G forward, counted alone (outside the path's run)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 68)
    x = torch.rand((SGV2_TRAIN_BATCH, SGV2_IMAGE, SGV2_IMAGE, 3),
                   generator=gen, device="cuda") * 2 - 1
    y = torch.randint(0, 2, (SGV2_TRAIN_BATCH,), generator=gen, device="cuda")
    with torch.no_grad():
        s = solver.M(torch.randn((SGV2_TRAIN_BATCH, 16), generator=gen,
                                 device="cuda"), y)
        masks = solver._heatmaps(x)
        with tally_calls(nk) as one:
            fwd0 = nk.LAUNCHES
            solver.G(x, s, masks, labels=y)
            per_forward = nk.LAUNCHES - fwd0
    check(one["fwd"] == Counter(CELEBA_TRAIN_SHAPES) and not one["bwd"]
          and per_forward == CELEBA_FWD_PER_FORWARD
          and steps[0] == (g_fwd * per_forward, g_bwd * per_forward),
          f"CelebA-HQ: {per_forward} forward launches a masked G forward "
          f"({dict(one['fwd'])}), {steps[0]} an iteration")
    losses = logged_losses(out)
    check(all(math.isfinite(v) for v in losses.values()),
          f"CelebA-HQ CLI losses {losses}")
    dev_ms = kernel_ms(clock.prof, PROFILED_SUPER_STEPS)
    fan_ms, fan_bwd = range_device_ms(clock.prof, "solver.heatmaps",
                                      PROFILED_SUPER_STEPS)
    check(fan_bwd == 0 and (dev_ms == 0 or fan_ms > 0),
          f"the profiled FAN: {fan_ms:.3f} ms, backward {fan_bwd:.3f} ms")
    fed_ms = statistics.median(clock.steady_ms())
    share = fan_ms / dev_ms if dev_ms else None
    print(f"sgv2 CLI CelebA-HQ (w_hpf 1, --wing_ckpt, AdaIN, batch "
          f"{SGV2_TRAIN_BATCH}, bf16): {n} iterations, loader-fed iteration "
          f"median {fed_ms:.3f} ms, kernels {dev_ms:.3f} ms an iteration "
          f"(busy {dev_ms / fed_ms:.1%}), of which the FAN's 3 mask calls "
          f"(profiled range solver.heatmaps) {fan_ms:.3f} ms = "
          f"{'not measured' if share is None else f'{share:.1%}'}; mask means "
          f"{min(means):.4f} .. {max(means):.4f}; {per_forward} forward "
          f"launches a masked G forward ({dict(one['fwd'])}), "
          f"{steps[0][0]}/{steps[0][1]} an iteration; launches {launches} "
          f"[{smi}]")
    del solver
    free_memory()
    return dict(launches=launches, ms=fed_ms, dev_ms=dev_ms, fan_ms=fan_ms,
                share=share, per_forward=per_forward, per_iteration=steps[0],
                calls=calls, iterations=n, wing_ckpt=wing_ckpt)


def phase_align_cli(nk, smi, wing_ckpt):
    """15c. ``cli.starganv2_main --mode align`` on ALIGN_FACES synthetic
    faces of 256^2 with 15b's ``--wing_ckpt`` and an ``--lm_path`` of mean
    landmarks written here from a seed: the aligned PNGs, no launch."""
    import numpy as np

    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli

    root = CLI_DIR / "align"
    shutil.rmtree(root, ignore_errors=True)
    sgv2_image_tree(root / "in", SEED + 69, ("faces",), ALIGN_FACES)
    rng = np.random.default_rng(SEED + 70)
    np.savez(root / "lm.npz", mean=rng.uniform(60, 200, (98, 2)).astype(np.float32))
    faces = sorted((root / "in" / "faces").glob("*.png"))
    t0 = time.perf_counter()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
    written = sgv2_cli.main(["--mode", "align", "--device", CARD, "--img_size",
                             str(SGV2_IMAGE), "--inp_dir", str(root / "in" / "faces"),
                             "--out_dir", str(root / "out"), "--lm_path",
                             str(root / "lm.npz"), "--wing_ckpt", str(wing_ckpt)])
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
    check([p.name for p in written] == [p.name for p in faces]
          and all(png_shape(p) == (SGV2_IMAGE, SGV2_IMAGE) for p in written)
          and launches == {"fwd": 0, "bwd": 0},
          f"align: {[p.name for p in written]}, launches {launches}")
    print(f"sgv2 CLI --mode align: {len(written)} faces of {SGV2_IMAGE}^2 "
          f"aligned in {time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(launches=launches)


# ------------------------------------- 16-17. deployment and the metrics


def leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@contextlib.contextmanager
def counted_forwards(cls):
    """Counts the calls of ``cls.forward`` while the block runs (a G
    forward of any batch launches the forward kernel once a styled norm)."""
    real, n = cls.forward, [0]

    def forward(self, *args, **kw):
        n[0] += 1
        return real(self, *args, **kw)

    cls.forward = forward
    try:
        yield n
    finally:
        cls.forward = real


def host_us(fn, iters):
    """Host microseconds a call of ``fn``, queued back to back (the device
    runs behind; a synchronize before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def phase_ops(nk, fused, smi, iters=2000):
    """16a. ``torch.library.opcheck`` of both custom ops on the card, at a
    DefectGAN training shape and a StarGAN v2 one, in bf16 and f32; the
    host cost of one eager call of the forward op at 16^2 beside the
    wrapper's alone and beside the device time of the same call back to
    back (the launch floor)."""
    fwd_op = torch.ops.de_i2i_gan_torch.modulated_instance_norm_fwd
    bwd_op = torch.ops.de_i2i_gan_torch.modulated_instance_norm_bwd
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    checked = 0
    for shape in OPCHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, g, b = make_norm_inputs(shape, dtype, SEED)
            torch.library.opcheck(fwd_op.default, (x, g, b, None, 1e-5))
            grads = [t.clone().requires_grad_() for t in (x, g, b)]
            torch.library.opcheck(fwd_op.default, (*grads, "leaky_relu", 1e-5))
            _, mean, inv = fwd_op(x, g, b, None, 1e-5)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            torch.library.opcheck(bwd_op.default, (x, g, b, mean, inv, dy, None))
            checked += 3
            del x, g, b, grads, mean, inv, dy
    free_memory()
    x, g, b = make_norm_inputs((1, 8, 16, 16), torch.bfloat16, SEED)
    op_us = host_us(lambda: fwd_op(x, g, b, None, 1e-5), iters)
    wrapper_us = host_us(lambda: nk.modulated_instance_norm_fwd(x, g, b), iters)
    xg = x.clone().requires_grad_()
    autograd_us = host_us(lambda: nk.cuda_modulated_instance_norm(xg, g, b),
                          iters)
    op_dev_ms = device_ms(lambda i: fwd_op(x, g, b, None, 1e-5), 200)
    print(f"ops: opcheck passed {checked} times (both ops at "
          f"{list(OPCHECK_SHAPES)}, f32 and bf16, the forward with and "
          f"without gradients); an eager call at 16^2 (1, 8, 16, 16) bf16 "
          f"takes {op_us:.2f} us of host time through the custom op, "
          f"{autograd_us:.2f} us with autograd recording, {wrapper_us:.2f} us "
          f"through the ctypes wrapper alone; the device time of the same "
          f"call back to back {op_dev_ms * 1e3:.2f} us [{smi}]")
    return dict(op_us=op_us, wrapper_us=wrapper_us, autograd_us=autograd_us,
                op_device_us=op_dev_ms * 1e3)


def export_one(nk, name, export, live, args_of, batches, per_forward, smi):
    """Export one program, check its graph, save, load and serve it at each
    of ``batches``: exactly ``per_forward`` forward launches a call, max and
    mean |d| against the eager forward, host latency (mean of 5 ending in a
    synchronize) and kernel time beside eager's. Returns the artifact's
    numbers with its launches (its own runs, counted from 0)."""
    from de_i2i_gan_torch import serving

    t0 = time.perf_counter()
    program = export()
    export_s = time.perf_counter() - t0
    nodes = serving.kernel_nodes(program)
    check(nodes == per_forward, f"{name}: {nodes} forward-op nodes in the "
          f"graph, expected {per_forward}")
    path = serving.save_exported(program, EXPORT_DIR / f"{name}.pt2")
    served = serving.load_exported(path).module()
    size_mb = path.stat().st_size / 2**20
    args = {b: args_of(b) for b in batches}
    with torch.no_grad():
        want = {b: [t.clone() for t in leaves(live(*args[b]))] for b in batches}

        def timed(fn):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            ms = []
            for _ in range(EXPORT_TIMED):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return sum(ms) / len(ms)

        first = args[batches[0]]
        eager_ms = timed(lambda: live(*first))
        eager_dev = kernel_ms(profiled(lambda: live(*first), 2), 2)
        torch.cuda.synchronize()
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the artifact's runs start here

        def serve(*a):
            before = nk.LAUNCHES
            out = served(*a)
            check(nk.LAUNCHES - before == per_forward,
                  f"{name}: a call launched {nk.LAUNCHES - before} forward "
                  f"kernels, expected {per_forward}")
            return out

        worst = [0.0, 0.0]
        for b in batches:
            got = leaves(serve(*args[b]))
            torch.cuda.synchronize()
            check(len(got) == len(want[b]), f"{name}: {len(got)} outputs")
            for g, w in zip(got, want[b]):
                check(g.shape == w.shape and g.shape[0] == b
                      and bool(torch.isfinite(g).all()),
                      f"{name} batch {b}: {tuple(g.shape)} against "
                      f"{tuple(w.shape)}, finite {bool(torch.isfinite(g).all())}")
                d = (g.float() - w.float()).abs()
                worst = [max(worst[0], d.max().item()),
                         max(worst[1], d.mean().item())]
        served_ms = timed(lambda: serve(*first))
        served_dev = kernel_ms(profiled(lambda: serve(*first), 2), 2)
        torch.cuda.synchronize()
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    check(launches["bwd"] == 0, f"{name}: backward launches {launches}")
    check(worst[0] <= OUT_BAND and worst[1] <= MEAN_BAND,
          f"{name}: artifact vs eager max {worst[0]:.3e} mean {worst[1]:.3e}")
    print(f"export {name}: {nodes} forward-op nodes, exported in "
          f"{export_s:.1f} s, {size_mb:.1f} MiB; batches {list(batches)} from "
          f"one artifact, {per_forward} launches a call; artifact vs eager "
          f"max |d| {worst[0]:.3e} mean {worst[1]:.3e}; batch {batches[0]} "
          f"request {served_ms:.3f} ms (eager {eager_ms:.3f} ms), kernels "
          f"{served_dev:.3f} ms (eager {eager_dev:.3f} ms) [{smi}]")
    return dict(launches=launches, nodes=nodes, max_abs=worst[0],
                mean_abs=worst[1], ms=served_ms, eager_ms=eager_ms,
                dev_ms=served_dev, eager_dev_ms=eager_dev, size_mb=size_mb,
                export_s=export_s)


def summed_launches(runs):
    return {k: sum(r["launches"][k] for r in runs) for k in ("fwd", "bwd")}


def phase_export(nk, smi):
    """16b. ``serving.py`` at full width in bf16 on the card: DefectGAN-256
    AdaIN and SEAN (8 forward-op nodes, batches 8 and 1), StarGAN v2-256
    AdaIN (generator with 12 nodes, style encoder and mapping with none,
    batches 32 and 1) and SEANv2 (generator); then ``cli.export_model
    --validate`` on 8a's DefectGAN checkpoint and 10d's StarGAN v2 one."""
    from de_i2i_gan_torch import serving
    from de_i2i_gan_torch.cli import export_model
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    dg, sg = {}, {}
    for label, cfg in (("adain", full_config()), ("sean", sean_config())):
        steps = DefectGanSteps(cfg, device="cuda")
        init_weights(steps, SEED)
        gen = torch.Generator().manual_seed(SEED + 71)

        def args_of(batch, steps=steps, cfg=cfg, gen=gen):
            args = serving.defectgan_example_args(steps, batch, SEED, gen)
            if cfg.style_norm_block_type == "sean":
                args[2] = torch.randn(args[2].shape, generator=gen).cuda()
            return args

        dg[label] = export_one(
            nk, f"defectgan_{label}",
            lambda steps=steps: serving.export_defectgan_generator(steps),
            serving.defectgan_serving_module(steps), args_of, (BATCH, 1),
            FWD_PER_FORWARD, smi)
        del steps
        free_memory()
    for label in ("adain", "sean"):
        solver = sgv2_solver(sgv2_config(norm_type=label))
        req = sgv2_requests(solver.cfg, 1, SEED + 73)[0]
        # the program takes float32 styles, as the JAX export's specs
        style = (req["s_ref"] if label == "sean" else solver.style(
            req, req["y"], latent=True, use_ema=True)).float()

        def g_args(batch, req=req, style=style):
            return [req["x_src"][:batch], style[:batch], req["y"][:batch]]

        sg[f"{label}_generator"] = export_one(
            nk, f"sgv2_{label}_generator",
            lambda solver=solver: serving.export_sgv2_generator(solver),
            solver.generate, g_args, (SGV2_BATCH, 1), SGV2_FWD_PER_FORWARD,
            smi)
        if label == "adain":
            sg["style_encoder"] = export_one(
                nk, "sgv2_style_encoder",
                lambda: serving.export_sgv2_style_encoder(solver),
                solver.ema_S, lambda b: [req["x_ref"][:b], req["y"][:b]],
                (SGV2_BATCH, 1), 0, smi)
            sg["mapping"] = export_one(
                nk, "sgv2_mapping", lambda: serving.export_sgv2_mapping(solver),
                solver.ema_M, lambda b: [req["z_ref"][:b], req["y"][:b]],
                (SGV2_BATCH, 1), 0, smi)
        del solver, req, style
        free_memory()

    # the CLI on the runs' checkpoints: an export and a validation each
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's runs start here
    t0 = time.perf_counter()
    dg_cli, _ = run_cli(export_model.main, [
        "--model", "defectgan", "--validate", "--out",
        str(EXPORT_DIR / "cli_defectgan.pt2")] + cli_args(
            "adain", "--style_norm_block_type", "adain"))
    sg_cli, _ = run_cli(export_model.main, [
        "--model", "starganv2", "--checkpoint_dir",
        str(CLI_DIR / "sgv2" / "ckpt"), "--resume_iter", str(SGV2_CLI_ITERS),
        "--out_dir", str(EXPORT_DIR / "cli_sgv2"), "--validate",
        "--platforms", CARD, *SGV2_EXPORT_NET])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    # each validation: the artifact and the live forward at batch 3
    want = 2 * FWD_PER_FORWARD + 2 * SGV2_FWD_PER_FORWARD
    check(cli_launches == {"fwd": want, "bwd": 0},
          f"export CLI launches {cli_launches}, expected {want}/0")
    check(sorted(sg_cli[CARD]["paths"]) ==
          ["generator", "mapping", "style_encoder"],
          f"sgv2 export CLI wrote {sorted(sg_cli[CARD]['paths'])}")
    vals = {"defectgan": dg_cli[CARD]["validate"],
            "starganv2": sg_cli[CARD]["validate"]}
    print(f"export CLI --validate in {cli_s:.1f} s: " + "; ".join(
        f"{k} round trip max |d| {v['max_abs']:.3e}, mean {v['mean_abs']:.3e}"
        f" (bound {export_model.ATOL})" for k, v in vals.items()) +
        f"; launches {cli_launches} [{smi}]")
    return dict(dg=dg, sg=sg, cli=vals,
                paths={"export_dg": {"launches": summed_launches(dg.values())},
                       "export_sgv2": {"launches": summed_launches(sg.values())},
                       "export_cli": {"launches": cli_launches}})


def folder_images(root, seed, count, size):
    """``count`` smooth random PNGs of ``size``^2 from a seed."""
    from de_i2i_gan_torch.utils.png import write_png
    gen = torch.Generator().manual_seed(seed)
    root.mkdir(parents=True)
    for i in range(count):
        low = torch.rand((1, 3, 16, 16), generator=gen)
        img = F.interpolate(low, size=(size, size), mode="bilinear",
                            align_corners=False)[0]
        img = img + 0.05 * torch.randn(img.shape, generator=gen)
        write_png(root / f"{i:02d}.png",
                  (img.clamp(0, 1) * 255).byte().permute(1, 2, 0).numpy())


def phase_folder(nk, fused, smi):
    """16c. ``cli.translate_folder`` at 1024^2, full width, SEAN, batch 4,
    over 9 PNGs (3 batches, the last padded): 8 forward launches a G
    forward, by shape as FOLDER_SHAPES and by tier as the planner says;
    the PNGs; a batch of 4 timed (ms, images/s, peak memory, the norm
    kernels' device time against their bound); the kernel path against the
    plain version at 1024^2 within phase 4's band; each shape timed as in 5."""
    from de_i2i_gan_torch.cli import translate_folder
    from de_i2i_gan_torch.config.options import Options, to_defectgan_config
    from de_i2i_gan_torch.models.generator import DefectGanGenerator
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    root = CLI_DIR / "folder"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    folder_images(root / "in", SEED + 81, FOLDER_FILES, FOLDER_IMAGE)
    argv = ["--name", "folder", "--ckpt_dir", str(root / "ckpt"), *FOLDER_BASE]
    opt = Options("defectgan_test").parse(argv, save=False)
    cfg = to_defectgan_config(opt)
    steps = DefectGanSteps(cfg, device="cuda")
    init_weights(steps, SEED)
    save_checkpoint(root / "ckpt", "folder", "latest", steps)
    setup_s = time.perf_counter() - t0
    tiers = {}
    for (n, c, h, w) in FOLDER_SHAPES:
        p = nk.plan("fwd", h * w, torch.bfloat16, True)
        tiers[(n, c, h, w)] = tier_label(p)
    # the last decoder norm's rows (1024^2 elements) are longer than a
    # cluster of 8 holds: the streaming tier
    check(tiers[max(FOLDER_SHAPES, key=lambda s: s[2])] == "S",
          f"folder tiers {tiers}")
    batches = -(-FOLDER_FILES // FOLDER_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's run starts here
    t1 = time.perf_counter()
    with tally_calls(nk) as calls, counted_forwards(DefectGanGenerator) as g:
        out, _ = run_cli(translate_folder.main,
                         ["--input_dir", str(root / "in"), "--output_dir",
                          str(root / "out")] + argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    cli_peak = torch.cuda.max_memory_allocated() / 2**20
    want = Counter({s: batches * k for s, k in FOLDER_SHAPES.items()})
    per_forward = sum(FOLDER_SHAPES.values())
    check(g[0] == batches and launches == {"fwd": per_forward * batches,
                                           "bwd": 0}
          and calls["fwd"] == want and not calls["bwd"],
          f"folder: {g[0]} G forwards, launches {launches}, calls "
          f"{dict(calls['fwd'])}")
    pngs = sorted((root / "out").glob("*.png"))
    check([p.name for p in pngs] == [f"{i:02d}.png" for i in range(FOLDER_FILES)]
          and all(png_shape(p) == (FOLDER_IMAGE, FOLDER_IMAGE) for p in pngs),
          f"folder PNGs {[p.name for p in pngs]}")

    # a batch of 4 at 1024^2, the kernel path against the plain version
    gen = torch.Generator(device="cuda").manual_seed(SEED + 83)
    imgs = torch.rand((FOLDER_BATCH, FOLDER_IMAGE, FOLDER_IMAGE, 3),
                      generator=gen, device="cuda") * 2 - 1
    labels = torch.zeros((FOLDER_BATCH, cfg.label_nc), device="cuda")
    labels[:, 1] = 1.0
    noise = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        def forward():
            return steps.G(imgs, labels, None, generator=noise)[0]

        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            out_k = forward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        prof = profiled(forward, 2)
        dev_ms = kernel_ms(prof, 2)
        norm_ms = sum(e.self_device_time_total for e in device_kernels(prof)
                      if "modulated_instance_norm" in e.key) / 2e3
        check(bool(torch.isfinite(out_k).all()), "folder: non-finite output")
        kernel_out = out_k.float()
        for m in steps.G.modules():
            if hasattr(m, "use_pallas"):
                m.use_pallas = False
        before = nk.LAUNCHES
        plain_out = forward().float()
        torch.cuda.synchronize()
        check(nk.LAUNCHES == before, "the plain path launched the kernel")
        d = (kernel_out - plain_out).abs()
        agree = (d.max().item(), d.mean().item())
        check(agree[0] <= OUT_BAND and agree[1] <= MEAN_BAND,
              f"folder 1024^2: kernel vs plain max {agree[0]:.3e} mean "
              f"{agree[1]:.3e}")
    mean_ms = sum(ms) / len(ms)
    del steps, imgs, out_k, kernel_out, plain_out, d, prof
    free_memory()
    rows = phase_fwd_timing(nk, fused, FOLDER_SHAPES, smi)
    rows = with_calls(rows, calls["fwd"], batches)
    bound_ms = summed(rows, "bound_ms")
    print(f"folder 1024^2 (DefectGAN SEAN, full width, bf16): tiers {tiers}; "
          f"CLI over {FOLDER_FILES} PNGs in {cli_s:.1f} s ({batches} batches "
          f"of {FOLDER_BATCH}, setup {setup_s:.1f} s), peak {cli_peak:.1f} MiB, "
          f"launches {launches}; a batch of {FOLDER_BATCH}: {mean_ms:.3f} ms "
          f"({[round(v, 3) for v in ms]}), {FOLDER_BATCH * 1e3 / mean_ms:.2f} "
          f"images/s, peak {peak_mb:.1f} MiB, kernels {dev_ms:.3f} ms of which "
          f"norm kernels {norm_ms:.4f} ms (timed alone "
          f"{summed(rows, 'ms'):.4f} ms, bound {bound_ms:.4f} ms, "
          f"F.instance_norm {summed(rows, 'library_ms'):.4f} ms, plain "
          f"{summed(rows, 'plain_ms'):.4f} ms); kernel vs plain max "
          f"{agree[0]:.3e} mean {agree[1]:.3e} (band {OUT_BAND}, {MEAN_BAND}) "
          f"[{smi}]")
    return dict(launches=launches, rows=rows, forwards=batches, ms=mean_ms,
                peak_mb=peak_mb, cli_peak_mb=cli_peak, dev_ms=dev_ms,
                norm_ms=norm_ms, tiers=tiers, agree=agree)


def sgv2_cli_base(root):
    """10d's command line: the AFHQ flags on its image tree and runs."""
    tree = root / "afhq"
    return [*SGV2_AFHQ, "--img_size", str(SGV2_IMAGE), "--batch_size",
            str(SGV2_TRAIN_BATCH), "--train_img_dir", str(tree),
            "--val_img_dir", str(tree), "--checkpoint_dir", str(root / "ckpt"),
            "--sample_dir", str(root / "samples"), "--device", CARD]


def phase_sgv2_video(nk, smi):
    """16d. ``cli.starganv2_main --mode sample --make_video`` on 10d's
    checkpoint: the references of the val batch sorted by domain, the first
    4, a transition of 31 G forwards of the first 2 sources for each
    same-domain neighbour pair, then 10 held frames; 12 forward launches a
    G forward. Then ``translate_with_alpha_control`` (5 alphas) and
    ``translate_with_layer_split`` through a SEANv2 solver."""
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.models.starganv2 import Generator
    from de_i2i_gan_torch.utils import translate

    root = CLI_DIR / "sgv2"
    out = root / "video"
    shutil.rmtree(out, ignore_errors=True)
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the sample run starts here
    t0 = time.perf_counter()
    with counted_forwards(Generator) as g, grids_checked() as finite:
        _, printed = run_cli(sgv2_cli.main, sgv2_cli_base(root) + [
            "--mode", "sample", "--resume_iter", str(SGV2_CLI_ITERS),
            "--result_dir", str(out), "--make_video"])
    torch.cuda.synchronize()
    video_s = time.perf_counter() - t0
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    video_forwards = g[0] - 2 - 9  # the cycle grid, the latent grid
    transitions = video_forwards // 31
    frames_dir = out / "video_ref_frames"
    frames = len(list(frames_dir.glob("*.png")))
    encoded = (out / "video_ref.mp4").exists()
    check(launches == {"fwd": SGV2_FWD_PER_FORWARD * g[0], "bwd": 0}
          and transitions >= 1 and video_forwards == 31 * transitions
          and all(finite) and "video_ref ->" in printed
          and (encoded or frames == 31 * transitions + 10),
          f"sgv2 video: {g[0]} G forwards, launches {launches}, {frames} "
          f"frames, encoded {encoded}, grids finite {finite}")
    print(f"sgv2 sample --make_video in {video_s:.1f} s: {transitions} "
          f"same-domain transitions, {frames} frames "
          f"({'an mp4' if encoded else 'no ffmpeg: the frame directory'}), "
          f"{g[0]} G forwards, launches {launches} [{smi}]")

    # the SEAN grids: two references mixed by alpha, and a layer split
    solver = sgv2_solver(sgv2_config(norm_type="sean"))
    req = sgv2_requests(solver.cfg, 1, SEED + 91)[0]
    x = req["x_src"][:GRID_SOURCES]
    y = req["y"][:GRID_SOURCES]
    pair = torch.randn((GRID_SOURCES, 2, *EMBEDS), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           SEED + 93))
    torch.cuda.synchronize()
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the grids' runs start here
    with tally_calls(nk) as calls:
        alpha = translate.translate_with_alpha_control(solver, x, y, pair,
                                                       steps=5)
        split = translate.translate_with_layer_split(solver, x, y, pair,
                                                     [0, 2, 4])
    torch.cuda.synchronize()
    grid_launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end
    want = Counter({(GRID_SOURCES, *s[1:]): 6 * c
                    for s, c in SGV2_SHAPES.items()})
    check(grid_launches == {"fwd": 6 * SGV2_FWD_PER_FORWARD, "bwd": 0}
          and calls["fwd"] == want and np_finite(alpha) and np_finite(split)
          and alpha.shape == (6 * (SGV2_IMAGE + 2) + 2,
                              GRID_SOURCES * (SGV2_IMAGE + 2) + 2, 3),
          f"sgv2 grids: launches {grid_launches}, calls {dict(calls['fwd'])}, "
          f"shapes {alpha.shape} {split.shape}")
    print(f"sgv2 SEAN grids: alpha control (5 alphas) {alpha.shape}, layer "
          f"split {split.shape}, finite, launches {grid_launches} [{smi}]")
    del solver, req
    free_memory()
    return dict(video={"launches": launches, "frames": frames,
                       "transitions": transitions},
                grids={"launches": grid_launches})


def np_finite(a):
    import numpy as np
    return bool(np.isfinite(a).all())


def phase_metric_nets(nk, smi):
    """17a. InceptionV3 (2048 pool) and LPIPS drawn from a seed: the card
    against the CPU in f32 with TF32 off, relative L2 within METRIC_BAND;
    a batch-32 feature request at 299^2 (device time, peak memory); the
    host time of one 2048-wide Frechet distance (scipy's sqrtm)."""
    from de_i2i_gan_torch.metrics.evaluator import Evaluator
    from de_i2i_gan_torch.metrics.fid import ActivationStats, frechet_distance
    from de_i2i_gan_torch.metrics.inception import seeded_inception
    from de_i2i_gan_torch.metrics.lpips import seeded_lpips

    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the metric nets' runs start here
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 101)
    x = torch.rand((2, 256, 256, 3), generator=gen) * 2 - 1
    y = torch.rand((2, 256, 256, 3), generator=gen) * 2 - 1
    try:
        with torch.no_grad():
            inc = rel_l2(seeded_inception((3,), SEED, "cuda")(x.cuda())[3],
                         seeded_inception((3,), SEED, "cpu")(x)[3])
            lp = rel_l2(seeded_lpips(SEED, "cuda")(x.cuda(), y.cuda()),
                        seeded_lpips(SEED, "cpu")(x, y))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(inc <= METRIC_BAND and lp <= METRIC_BAND,
          f"metric nets card vs CPU: Inception {inc:.3e}, LPIPS {lp:.3e}")

    # a feature request with TF32 convolutions (PyTorch's default, what a
    # user's Evaluator runs), then with them off (earlier phases turn TF32
    # off and leave it so)
    ev = Evaluator(device="cuda")
    imgs = torch.rand((INCEPTION_BATCH, 299, 299, 3), device="cuda") * 2 - 1
    dev, peak_mb = {}, {}
    for label, on in (("tf32", True), ("fp32", False)):
        torch.backends.cudnn.allow_tf32 = on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dev[label] = device_ms(lambda i: ev.features(imgs), 10)
        peak_mb[label] = (torch.cuda.max_memory_allocated() - base) / 2**20
    torch.backends.cudnn.allow_tf32 = tf32[0]
    feats = [ev.features(torch.rand((64, 256, 256, 3), device="cuda") * 2 - 1
                         ).cpu().numpy() for _ in range(2)]
    stats = []
    for f in feats:
        st = ActivationStats(2048)
        st.update(f)
        stats.append(st.finalize())
    t0 = time.perf_counter()
    fid = frechet_distance(*stats[0], *stats[1])
    fid_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
    check(launches == {"fwd": 0, "bwd": 0} and math.isfinite(fid),
          f"metric nets: launches {launches}, FID {fid}")
    print(f"metric nets (weights from a seed: the numbers mean nothing): "
          f"card vs CPU relative L2 Inception {inc:.3e}, LPIPS {lp:.3e}; a "
          f"batch-{INCEPTION_BATCH} Inception feature request at 299^2 in f32 "
          f"with TF32 convolutions {dev['tf32']:.3f} ms of device time "
          f"({INCEPTION_BATCH * 1e3 / dev['tf32']:.1f} img/s), "
          f"{peak_mb['tf32']:.1f} MiB above its inputs; TF32 off "
          f"{dev['fp32']:.3f} ms, {peak_mb['fp32']:.1f} MiB; one 2048-wide Frechet "
          f"distance {fid_s:.2f} s on the host (FID {fid:.2f} between two "
          f"random batches of 64) [{smi}]")
    del ev, imgs
    free_memory()
    return dict(launches=launches, inception_err=inc, lpips_err=lp,
                request_ms=dev["tf32"], request_fp32_ms=dev["fp32"],
                peak_mb=peak_mb["tf32"], fid_host_s=fid_s)


@contextlib.contextmanager
def inception_profiled(runs):
    """Profiles the block: ``runs`` gets ``profile_split``'s numbers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    runs.append(profile_split(prof))


def profile_split(prof):
    """Kernel ms of a profiled run, of them the ones inside the
    ``evaluator.inception`` ranges (their device time, read off the ranges'
    summed events), and the norm kernels'."""
    from torch.autograd import DeviceType

    kernels = device_kernels(prof)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    # the CPU side of the range: its device time is its kernels'
    inception = sum(e.device_time_total for e in prof.key_averages()
                    if e.key == "evaluator.inception"
                    and e.device_type == DeviceType.CPU) / 1e3
    norm = sum(e.self_device_time_total for e in kernels
               if "modulated_instance_norm" in e.key) / 1e3
    return dict(kernel_ms=total, inception_ms=inception, norm_ms=norm)


def phase_metric_clis(nk, smi):
    """17b. Every metric flag through its CLI on the card, at
    ``--dims 768`` (17a times the 2048-wide FID) and small image counts:
    ``cli.test_defectgan --metrics fid is lpips --save_stats`` then
    ``--cal_mfid`` on 8a's run, ``cli.train_defectgan --val_metrics`` for
    an epoch, ``cli.test_pix2pix --metrics fid`` on 8 of 12e's pairs, ``cli.fid``
    on two of 10d's domain folders, ``cli.starganv2_main --mode eval`` on
    10d's checkpoint. Each: exact launches a G forward, finite numbers, the
    wall time, and Inception's share of the profiled kernel time."""
    # the CLIs as a user runs them: PyTorch's TF32 defaults (convolutions
    # on, matmuls off), whatever earlier phases left
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        True, False)
    try:
        return metric_clis(nk, smi)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def metric_clis(nk, smi):
    """The body of ``phase_metric_clis``."""
    from de_i2i_gan_torch.cli import fid as fid_cli
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.cli import test_defectgan, test_pix2pix, train_defectgan
    from de_i2i_gan_torch.metrics import eval_starganv2
    from de_i2i_gan_torch.models.generator import DefectGanGenerator
    from de_i2i_gan_torch.models.starganv2 import Generator

    dims = ["--dims", str(METRIC_DIMS)]
    res = CLI_DIR / "metrics"
    shutil.rmtree(res, ignore_errors=True)
    out = {}

    def run(label, fn, g_cls, per_forward, bwd=0, profile=True):
        torch.cuda.synchronize()
        prof_runs = []
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's run starts here
        t0 = time.perf_counter()
        with counted_forwards(g_cls) as g:
            if profile:
                with inception_profiled(prof_runs):
                    result = fn()
            else:
                result = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... end here
        check(launches == {"fwd": per_forward * g[0], "bwd": bwd},
              f"{label}: launches {launches}, {g[0]} G forwards of "
              f"{per_forward}, backward {bwd}")
        out[label] = dict(launches=launches, wall_s=wall_s, forwards=g[0],
                          result=result, **(prof_runs[0] if prof_runs else {}))
        return result

    # DefectGAN: the test CLI's metrics and the class statistics, then mFID
    base = cli_args("adain", "--style_norm_block_type", "adain",
                    "--results_dir", str(res), *dims, "--num_imgs",
                    str(METRIC_IMGS))
    got = run("metrics_dg", lambda: test_defectgan.main(base + [
        "--metrics", "fid", "is", "lpips", "--num_lpips_images", "2",
        "--save_stats", "--metrics_out", str(res / "metrics.json")]),
        DefectGanGenerator, FWD_PER_FORWARD)
    m = got["metrics"]
    check(set(m) == {"fid", "is", "is_std", "lpips"} and all(
        math.isfinite(v) for v in m.values()) and got["stats"],
        f"test CLI metrics {m}, stats {got['stats']}")
    got = run("metrics_mfid", lambda: test_defectgan.main(base + [
        "--cal_mfid", "--npy_path", str(res / "adain")]),
        DefectGanGenerator, FWD_PER_FORWARD)
    mfid = got["mfid"]
    check("mean" in mfid and all(math.isfinite(v) for v in mfid.values()),
          f"mFID {mfid}")

    # the in-training validation: one epoch, then the validation, profiled
    val_profiles, real_make = [], train_defectgan.make_val_fn

    def make_val_fn(*args, **kw):
        fn = real_make(*args, **kw)

        def val(steps, epoch):
            with inception_profiled(val_profiles):
                return fn(steps, epoch)
        return val

    train_defectgan.make_val_fn = make_val_fn
    try:
        trainer = run("metrics_val", lambda: train_defectgan.main(cli_args(
            "adain_val", "--style_norm_block_type", "adain", "--num_epochs",
            "1", "--save_ckpt_freq", "1", "--val_metrics", "fid", "is",
            "lpips", "--num_lpips_images", "2", "--num_imgs",
            str(METRIC_IMGS), *dims)), DefectGanGenerator, FWD_PER_FORWARD,
            bwd=FWD_PER_FORWARD * G_BACKWARDS_PER_SUPER_STEP * 12,
            profile=False)
    finally:
        train_defectgan.make_val_fn = real_make
    out["metrics_val"].update(val_profiles[0])
    val = json.loads((CLI_DIR / "ckpt" / "adain_val" / "val_metrics_1.json"
                      ).read_text())
    check(set(val) == {"fid", "is", "is_std", "lpips"} and all(
        math.isfinite(v) for v in val.values()) and trainer.iters == 12 * CRITICS,
        f"val metrics {val}")
    del trainer

    # pix2pix (SPADE: no kernel) on METRIC_P2P_PAIRS of 12e's pairs (its 48
    # batches of 1 took 55.8 s, 16 took 29.7), cli.fid (no generator)
    got = run("metrics_p2p", lambda: test_pix2pix.main(p2p_cli_args(
        "p2p", "--results_dir", str(res / "p2p"), "--metrics", "fid", *dims,
        "--max_dataset_size", str(METRIC_P2P_PAIRS))), DefectGanGenerator, 0)
    check(math.isfinite(got["fid"]), f"pix2pix FID {got}")
    tree = CLI_DIR / "sgv2" / "afhq"
    got = run("metrics_fid", lambda: fid_cli.main(
        [str(tree / "cat"), str(tree / "dog"), "--device", CARD, *dims]),
        DefectGanGenerator, 0)
    check(math.isfinite(got["fid"]), f"cli.fid {got}")

    # StarGAN v2's evaluation: every ordered domain pair
    real_ev = eval_starganv2.Evaluator
    eval_starganv2.Evaluator = lambda **kw: real_ev(dims=METRIC_DIMS, **kw)
    try:
        got = run("metrics_sgv2", lambda: sgv2_cli.main(sgv2_cli_base(
            CLI_DIR / "sgv2") + ["--mode", "eval", "--resume_iter",
                                 str(SGV2_CLI_ITERS), "--num_outs_per_domain",
                                 "2", "--eval_dir", str(res / "sgv2")]),
            Generator, SGV2_FWD_PER_FORWARD)
    finally:
        eval_starganv2.Evaluator = real_ev
    check(len(got) == 2 * 6 + 2 and all(math.isfinite(v) for v in got.values()),
          f"sgv2 eval {got}")
    for label, r in out.items():
        share = (f"Inception {r['inception_ms'] / r['kernel_ms']:.1%} of "
                 f"{r['kernel_ms']:.3f} ms of kernels, norm kernels "
                 f"{r['norm_ms']:.4f} ms" if r.get("kernel_ms") else
                 "not profiled")
        print(f"{label}: {r['wall_s']:.1f} s, {r['forwards']} G forwards, "
              f"launches {r['launches']}, {share} [{smi}]")
    print(f"metric CLIs (nets drawn from a seed: the numbers mean nothing): "
          f"test CLI {m}, mFID {mfid.get('mean'):.3f}, val {val}, pix2pix FID "
          f"{out['metrics_p2p']['result']['fid']:.3f}, cli.fid "
          f"{out['metrics_fid']['result']['fid']:.3f}, StarGAN v2 FID mean "
          f"{got['FID_latent/mean']:.3f}, LPIPS mean "
          f"{got['LPIPS_latent/mean']:.4f} [{smi}]")
    return out


# ---------------------------------------------------- 18. data parallel


def dp_sgd_config():
    """6d's SGD settings: a delta is -lr * the gradient the update applies."""
    from de_i2i_gan_torch.config import TrainConfig
    return TrainConfig(batch_size=BATCH, num_critics=CRITICS, lr=(2e-4, 1e-2),
                       optimizer="sgd")


def g_delta(steps, before, lr):
    """G's (after - before) / lr, flat, f32 on the host."""
    return torch.cat([((p.detach().float().cpu() - before[k]) / lr).reshape(-1)
                      for k, p in steps.G.named_parameters()])


def tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def collective_clock():
    """Host time inside ``torch.distributed.all_reduce`` while the block
    runs, each call timed from a synchronized device to its end on the
    device: the collectives' own time, not the wait for the kernels queued
    before them."""
    import torch.distributed as dist
    spent = {"ms": 0.0, "calls": 0}
    real = dist.all_reduce

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.synchronize()
            spent["ms"] += (time.perf_counter() - t0) * 1e3
            spent["calls"] += 1

    dist.all_reduce = timed
    try:
        yield spent
    finally:
        dist.all_reduce = real


@contextlib.contextmanager
def batch_norm_in_float64():
    """``BatchNorm`` in train mode computed in float64 (the rounding
    control of 18a): each group's ``F.batch_norm`` and its running
    statistics in float64, the output rounded to x's dtype."""
    from de_i2i_gan_torch.nn import blocks
    real = blocks.BatchNorm.forward

    def forward(self, x, bn_groups=1):
        if not self.training:
            return real(self, x, bn_groups)
        parts = []
        for part in x.double().chunk(bn_groups, dim=0):
            parts.append(F.batch_norm(part, None, None, self.weight.double(),
                                      self.bias.double(), True, 0.0, self.eps))
            with torch.no_grad():
                var, mean = torch.var_mean(part, dim=(0, 2, 3), correction=0)
                self.running_mean.lerp_(mean.float(), self.momentum)
                self.running_var.lerp_(var.float(), self.momentum)
        return torch.cat(parts, dim=0).to(x.dtype)

    blocks.BatchNorm.forward = forward
    try:
        yield
    finally:
        blocks.BatchNorm.forward = real


def range_host_ms(prof, name, runs):
    """Host ms a run inside the profiler range ``name``."""
    return sum(e.cpu_time_total for e in prof.key_averages()
               if e.key == name) / (1e3 * runs)


def timed_in_turns(runs, batch, draws, rounds):
    """Host clock of a super-step of each of ``runs`` ({label: steps}),
    ending in a synchronize, taken in turns (a, b, b, a, ...): {label: ms}."""
    times = {k: [] for k in runs}
    labels = list(runs)
    for r in range(rounds):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label].super_step(batch, draws)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.mean(v) for k, v in times.items()}


def phase_dp_nccl(nk, smi, rounds=2):
    """18a. NCCL, a group of one (the card's machine has one H100): one
    full-width f32 AdaIN super-step (SGD, TF32 off) with the group attached
    (``make_parallel_step``: the gradient all-reduce in every update, the
    BatchNorm moments all-reduced) against the same step without it:
    exactly 56/16 launches, losses within rtol 2e-4, G's and E's deltas per
    tensor within 6c's band (12c's) + F32_CONTROL_FACTOR x the distance the
    step without the group moves when only its BatchNorm is computed in
    float64 (the control: the grouped BatchNorm rounds otherwise than
    cuDNN's, and the stem's convolution, whose gradient sums a zero-mean
    dx against the images over 10^6 pixels, moves with that rounding
    alone); G's deltas as a whole within 6d's f32 band. Then what the
    reductions cost: bf16
    super-steps with and without the group in turns (host clock), one of
    each profiled (device time), the device and host time of the ranges
    ``parallel.grad_all_reduce`` and ``parallel.batch_norm``."""
    import torch.distributed as dist
    from de_i2i_gan_torch.config import TrainConfig
    from de_i2i_gan_torch.parallel.mesh import make_parallel_step

    DP_DIR.mkdir(parents=True, exist_ok=True)
    store = DP_DIR / "nccl_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        tf32_off()
        tcfg = dp_sgd_config()
        cfg = full_config(compute_dtype="float32")
        batch = make_batches(cfg, torch.Generator(device="cuda").manual_seed(SEED + 61))
        fwd, bwd = expected_launches(cfg, G_FORWARDS_PER_SUPER_STEP,
                                     G_BACKWARDS_PER_SUPER_STEP)
        runs = {}
        for label in ("alone", "group", "float64"):
            steps = training_steps(cfg, tcfg)
            before = param_snapshot(steps)
            if label == "group":
                make_parallel_step(steps, dist.group.WORLD)
            torch.cuda.synchronize()
            nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
            with (batch_norm_in_float64() if label == "float64"
                  else contextlib.nullcontext()):
                m = steps.super_step(batch, torch.Generator(device="cuda")
                                     .manual_seed(SEED + 62))
            torch.cuda.synchronize()
            launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
            check(launches == {"fwd": fwd, "bwd": bwd},
                  f"18a super-step {label} launched {launches}, expected "
                  f"{fwd}/{bwd}")
            runs[label] = dict(steps=steps, launches=launches,
                               metrics={k: v.item() for k, v in m.items()})
        on, off = runs["group"], runs["alone"]
        loss = loss_gap(on["metrics"], off["metrics"])
        lr = {"G": tcfg.lr_g, "E": tcfg.lr_g}
        gaps = delta_gaps(on["steps"], off["steps"], before, lr)
        control = delta_gaps(runs["float64"]["steps"], off["steps"], before, lr)
        over = {k: gaps[k] / (1.0 + F32_CONTROL_FACTOR * control[k])
                for k in gaps}
        worst = sorted(over, key=over.get, reverse=True)[:3]
        whole = rel_l2(g_delta(on["steps"], before["G"], tcfg.lr_g),
                       g_delta(off["steps"], before["G"], tcfg.lr_g))
        print(f"18a NCCL group of one, full-width f32 AdaIN SGD super-step "
              f"with the group vs without: launches {on['launches']}; max "
              f"loss diff {loss:.3f} x (rtol {LOSS_RTOL}); G's and E's "
              f"deltas per tensor in units of 6c's band ({GRAD_REL_L2} |ref|"
              f" + {GRAD_ATOL} sqrt(n)), against 1 + {F32_CONTROL_FACTOR} x "
              f"the float64-BatchNorm control, the closest to it: "
              + ", ".join(f"{k} {gaps[k]:.3f} (control {control[k]:.3f})"
                          for k in worst)
              + f"; G's deltas relative L2 {whole:.3e} (band "
              f"{F32_DELTA_BAND}) [{smi}]")
        check(loss <= 1.0 and max(over.values()) <= 1.0
              and whole <= F32_DELTA_BAND,
              f"18a: the grouped super-step differs: losses {loss:.3f}, "
              f"deltas {max(over.values()):.3f} of their band, G {whole:.3e}")
        launches = on["launches"]
        del runs, on, off
        free_memory()

        # the cost, at the training path's settings (bf16, Adam)
        tcfg = TrainConfig(batch_size=BATCH, num_critics=CRITICS,
                           lr=(2e-4, 1e-4))
        steps = {"alone": training_steps(full_config(), tcfg),
                 "group": training_steps(full_config(), tcfg)}
        make_parallel_step(steps["group"], dist.group.WORLD)
        batch = make_batches(full_config(), torch.Generator(device="cuda")
                             .manual_seed(SEED + 63))
        draws = torch.Generator(device="cuda").manual_seed(SEED + 64)
        timed_in_turns(steps, batch, draws, 1)  # warm-up
        ms = timed_in_turns(steps, batch, draws, rounds)
        dev = {}
        for label, st in steps.items():
            prof = profiled(lambda: st.super_step(batch, draws), 1)
            dev[label] = kernel_ms(prof, 1)
            if label == "group":
                ranges = {name: (*range_device_ms(prof, name, 1),
                                 range_host_ms(prof, name, 1))
                          for name in DP_RANGES}
                nccl_ms = sum(e.self_device_time_total for e in device_kernels(prof)
                              if "nccl" in e.key.lower()) / 1e3
        with collective_clock() as spent:
            steps["group"].super_step(batch, draws)
        print(f"18a cost of the reductions (bf16 AdaIN super-step, batch "
              f"{BATCH}, {CRITICS} critics, Adam): host clock {ms['alone']:.3f} "
              f"ms alone, {ms['group']:.3f} ms with the group of one "
              f"({ms['group'] - ms['alone']:+.3f} ms), means of {rounds} in "
              f"turns; device kernels {dev['alone']:.3f} ms vs "
              f"{dev['group']:.3f} ms ({dev['group'] - dev['alone']:+.3f} "
              f"ms), NCCL kernels {nccl_ms:.3f} ms; "
              + "; ".join(f"{name}: device {f:.3f} ms forward + {b:.3f} ms "
                          f"backward, host {h:.3f} ms"
                          for name, (f, b, h) in ranges.items())
              + f"; {spent['calls']} all-reduces a super-step, "
              f"{spent['ms']:.3f} ms of host time from a synchronized device "
              f"[{smi}]")
        result = dict(launches=launches, ms=ms, dev_ms=dev, nccl_ms=nccl_ms,
                      ranges=ranges, all_reduces=spent["calls"])
        del steps
        free_memory()
        return result
    finally:
        dist.destroy_process_group()


def dp_defectgan_rank(state_paths, batch_path, timed):
    """A rank of 18b: each dtype's state loaded, the group attached and
    rank 0's state broadcast, one SGD super-step on this rank's rows of the
    global batch: the launches, G's deltas, the state's digest, the
    metrics' means over the ranks; then in bf16 ``timed`` = (warm-up,
    timed) super-steps on the host clock and one with the collectives
    timed."""
    from de_i2i_gan_torch.ops.cuda import norm_kernels as nk
    from de_i2i_gan_torch.parallel.mesh import (
        make_parallel_step, reduce_metrics, replicate, shard_batch,
        state_digest)
    from de_i2i_gan_torch.train.checkpoint import load_train_state

    tf32_off()
    tcfg = dp_sgd_config()
    rows = shard_batch(torch.load(batch_path, weights_only=True), batch_axis=1)
    out = {}
    for dtype, path in state_paths.items():
        steps = training_steps(full_config(compute_dtype=dtype), tcfg)
        load_train_state(steps, torch.load(path, weights_only=True))
        make_parallel_step(steps)
        replicate(steps)
        before = {k: p.detach().float().cpu().clone()
                  for k, p in steps.G.named_parameters()}
        torch.cuda.synchronize()
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
        m = steps.super_step(rows)
        torch.cuda.synchronize()
        launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
        keys = list(m)
        means = reduce_metrics([[m[k] for k in keys]])[0].tolist()
        out[dtype] = dict(launches=launches, digest=state_digest(steps),
                          delta=g_delta(steps, before, tcfg.lr_g),
                          metrics=dict(zip(keys, means)))
        if dtype == "bfloat16":
            times = []
            for i in range(sum(timed)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps.super_step(rows)
                torch.cuda.synchronize()
                if i >= timed[0]:
                    times.append((time.perf_counter() - t0) * 1e3)
            with collective_clock() as spent:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps.super_step(rows)
                torch.cuda.synchronize()
                clocked = (time.perf_counter() - t0) * 1e3
            out["timing"] = dict(ms=statistics.mean(times), times=times,
                                 all_reduce_ms=spent["ms"],
                                 all_reduces=spent["calls"],
                                 clocked_ms=clocked)
        del steps
        free_memory()
    return out


def dp_gloo_rank(defectgan, trainers, cli_argvs):
    """A rank of 18b-18d (one launch: each spawn costs its ranks' start on
    the card): 18b's DefectGAN work, 18c's trainers, 18d's CLI runs."""
    return {"defectgan": dp_defectgan_rank(*defectgan),
            "trainers": dp_trainers_rank(*trainers),
            "cli": dp_cli_rank(cli_argvs)}


def phase_dp_gloo(nk, smi):
    """18b-18d. Two ranks on cuda:0 over gloo (``distributed.launch``),
    one launch for all three: 18b's DefectGAN against one process, 18c's
    other trainers, 18d's train CLI and its resume. Returns their
    results."""
    from de_i2i_gan_torch.parallel import distributed

    dg_args, dg_single = prepare_dp_defectgan()
    sg_args, sg_single = prepare_dp_trainers()
    cli_argvs = prepare_dp_cli()
    t0 = time.perf_counter()
    ranks = distributed.launch(dp_gloo_rank, DP_RANKS, dg_args, sg_args,
                               cli_argvs)
    launch_s = time.perf_counter() - t0
    return (report_dp_defectgan(smi, [r["defectgan"] for r in ranks],
                                dg_single, launch_s),
            report_dp_trainers(smi, [r["trainers"] for r in ranks], sg_single),
            report_dp_cli(smi, [r["cli"] for r in ranks]))


def prepare_dp_defectgan():
    """18b's side in this process: each dtype's state and the global batch
    written for the ranks, and one process's SGD super-step on that batch
    from that state. Returns (the ranks' arguments, one process's G deltas
    and losses by dtype)."""
    from de_i2i_gan_torch.train.checkpoint import train_state

    tf32_off()
    DP_DIR.mkdir(parents=True, exist_ok=True)
    tcfg = dp_sgd_config()
    batch = make_batches(full_config(), torch.Generator(device="cuda")
                         .manual_seed(SEED + 65))
    torch.save({k: v.cpu() for k, v in batch.items()}, DP_DIR / "batch.pt")
    single, paths = {}, {}
    for dtype in ("float32", "bfloat16"):
        steps = training_steps(full_config(compute_dtype=dtype), tcfg)
        paths[dtype] = str(DP_DIR / f"state_{dtype}.pt")
        torch.save(train_state(steps), paths[dtype])
        before = {k: p.detach().float().cpu().clone()
                  for k, p in steps.G.named_parameters()}
        m = steps.super_step(batch)
        single[dtype] = dict(delta=g_delta(steps, before, tcfg.lr_g),
                             metrics={k: v.item() for k, v in m.items()})
        del steps
        free_memory()
    return (paths, str(DP_DIR / "batch.pt"), DP_TIMED), single


def report_dp_defectgan(smi, ranks, single, launch_s):
    """18b. DefectGAN AdaIN at full width, 256^2, global batch 8 (4 a
    rank), 5 critics, one SGD super-step on two ranks against one process
    on the same global batch from the same state: the f32 control (TF32
    off) within 6d's f32 band (relative L2 of G's deltas), bf16's
    agreement printed; exactly 56/16 launches on each rank; the ranks'
    states equal bit for bit. Then the host clock of a bf16 super-step,
    gloo, two ranks on one card (no scaling figure), and the share of it
    inside the collectives (gloo stages every CUDA tensor through the
    host)."""
    fwd, bwd = expected_launches(full_config(), G_FORWARDS_PER_SUPER_STEP,
                                 G_BACKWARDS_PER_SUPER_STEP)
    for r, out in enumerate(ranks):
        for dtype in single:
            check(out[dtype]["launches"] == {"fwd": fwd, "bwd": bwd},
                  f"18b rank {r} {dtype} launched {out[dtype]['launches']}, "
                  f"expected {fwd}/{bwd} a rank")
    for dtype in single:
        differ = [k for k, v in ranks[0][dtype]["digest"].items()
                  if ranks[1][dtype]["digest"][k] != v]
        check(not differ, f"18b {dtype}: the ranks' states differ at {differ[:5]}")
    f32 = rel_l2(ranks[0]["float32"]["delta"], single["float32"]["delta"])
    b16 = rel_l2(ranks[0]["bfloat16"]["delta"], single["bfloat16"]["delta"])
    b16_f32 = rel_l2(ranks[0]["bfloat16"]["delta"], single["float32"]["delta"])
    s16_f32 = rel_l2(single["bfloat16"]["delta"], single["float32"]["delta"])
    loss = loss_gap(ranks[0]["float32"]["metrics"], single["float32"]["metrics"])
    timing = ranks[0]["timing"]
    print(f"18b two ranks on cuda:0 over gloo, DefectGAN-256 AdaIN, global "
          f"batch {BATCH} ({BATCH // 2} a rank), {CRITICS} critics, one SGD "
          f"super-step against one process on the global batch: G's deltas "
          f"relative L2 f32 (TF32 off) {f32:.3e} (band {F32_DELTA_BAND}), "
          f"bf16 {b16:.3e} (bf16 ranks vs f32 one process {b16_f32:.3e}, "
          f"bf16 vs f32 one process {s16_f32:.3e}); f32 losses max diff "
          f"{loss:.3f} x (rtol {LOSS_RTOL}); launches a rank "
          f"{ranks[0]['float32']['launches']}; the ranks' states equal bit "
          f"for bit [{smi}]")
    print(f"18b host clock of a bf16 super-step, gloo, two ranks on one card "
          f"(no scaling figure): {timing['ms']:.3f} ms (mean of "
          f"{len(timing['times'])}: {[round(t, 1) for t in timing['times']]}); "
          f"with the collectives timed from a synchronized device, "
          f"{timing['all_reduce_ms']:.3f} ms of {timing['clocked_ms']:.3f} ms "
          f"in {timing['all_reduces']} all-reduces "
          f"({timing['all_reduce_ms'] / timing['clocked_ms']:.1%}); the "
          f"launch of 18b-18d took {launch_s:.1f} s [{smi}]")
    check(f32 <= F32_DELTA_BAND and loss <= 1.0,
          f"18b: two ranks' f32 super-step differs from one process's: G "
          f"{f32:.3e}, losses {loss:.3f}")
    return dict(launches=[out["float32"]["launches"] for out in ranks],
                f32=f32, bf16=b16, timing=timing, launch_s=launch_s)


def continued_adam(steps, seed):
    """Every Adam state of ``steps`` as after many updates (count 100, the
    first moment drawn around 0, the second around 1e-2): an update is then
    lr * m / sqrt(nu), continuous in the gradient, where a fresh state with
    beta1 = 0 moves a weight by about lr * sign(g)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name in steps.STATE_OPTIMIZERS:
        tx = getattr(steps, f"tx_{name}")
        if tx is None:
            continue
        for p in tx.params:
            st = tx.opt.state[p]
            st["step"].fill_(100.0)
            st["exp_avg"].normal_(0.0, 1e-3, generator=gen)
            st["exp_avg_sq"].uniform_(0.5e-2, 2e-2, generator=gen)


def dp_trainers_rank(sgv2_state, sgv2_batch):
    """A rank of 18c: StarGAN v2 AdaIN (f32, TF32 off, the continued
    state): the per-net gradients of one latent D loss and one latent G
    loss on this rank's rows, averaged over the ranks as ``Optimizer.step``
    averages them (``distributed.all_reduce_``), then one iteration; one
    MAE super-step at batch 32, one WGAN clipping super-step at batch 128,
    one pix2pix super-step at batch 2 (bf16, each from SEED, rank 0's state
    broadcast, this rank's rows of a global batch made alike on every
    rank). Each: its launches and its state's digest."""
    from de_i2i_gan_torch.config import MAEConfig, TrainConfig
    from de_i2i_gan_torch.ops.cuda import norm_kernels as nk
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.parallel.mesh import (
        make_parallel_step, replicate, shard_batch, state_digest)
    from de_i2i_gan_torch.train.checkpoint import load_train_state
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.mae_steps import MAESteps

    tf32_off()
    out = {}

    def one_step(label, steps, run):
        make_parallel_step(steps)
        replicate(steps)
        torch.cuda.synchronize()
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the path's run starts here
        m = run(steps)
        torch.cuda.synchronize()
        launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends here
        check(all(math.isfinite(v.item()) for v in m.values()),
              f"18c {label}: non-finite loss")
        out[label] = dict(launches=launches, digest=state_digest(steps))

    solver = sgv2_trainer(sgv2_train_config("adain", compute_dtype="float32"))
    load_train_state(solver, torch.load(sgv2_state, weights_only=True))
    rows = shard_batch(torch.load(sgv2_batch, weights_only=True))
    grads = sgv2_loss_grads(solver, rows)
    distributed.all_reduce_(list(grads.values()), average=True)
    one_step("sgv2", solver, lambda s: s.train_step(rows))
    out["sgv2"]["grads"] = {k: v.cpu() for k, v in grads.items()}
    del solver, grads
    free_memory()

    # the global batches alike on every rank; each rank's own draws
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    draws = torch.Generator(device="cuda").manual_seed(
        distributed.rank_seed(SEED + 74))
    cfg = full_config()
    steps = MAESteps(cfg, MAEConfig(), mae_train_config(), device="cuda",
                     iters_per_epoch=MAE_SYNTHETIC // MAE_BATCH, num_epochs=200)
    steps.init_training()
    init_weights(steps, SEED)
    shape = (1, MAE_BATCH, cfg.image_size, cfg.image_size, 3)
    batch = {"imgs": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "labels": F.one_hot(torch.randint(0, cfg.label_nc, (1, MAE_BATCH),
                                               generator=gen, device="cuda"),
                                 cfg.label_nc).float()}
    one_step("mae", steps, lambda s: s.super_step(
        shard_batch(batch, batch_axis=1), draws))
    del steps
    free_memory()

    wcfg = wgan_config()
    steps = wgan_steps(wcfg, TrainConfig(batch_size=WGAN_BATCH, num_critics=5,
                                         lr=(5e-5,), optimizer="rmsprop",
                                         num_epochs=120))
    batch = {"imgs": torch.rand((wcfg.num_critics, WGAN_BATCH, 64, 64, 3),
                                generator=gen, device="cuda") * 2 - 1}
    one_step("wgan", steps, lambda s: s.super_step(
        shard_batch(batch, batch_axis=1), draws))
    del steps
    free_memory()

    steps = p2p_steps(p2p_config(), p2p_train_config())
    batch = p2p_batches(P2P_IMAGE, 1, gen, batch=DP_P2P_BATCH)[0]
    one_step("p2p", steps, lambda s: s.super_step(
        shard_batch(batch, batch_axis=1), draws))
    return out


def sgv2_loss_grads(solver, batch):
    """The per-net gradients, flat f32, of one latent D loss (D) and one
    latent G loss (G, M, S) of ``solver`` on ``batch``: 10c's quantities."""
    b = solver._batch(batch)
    out = {}
    loss, _ = solver.d_loss_fn(b, latent=True)
    out["D"] = torch.cat([g.float().reshape(-1) for g in torch.autograd.grad(
        loss, solver.tx_D.params)])
    loss, _ = solver.g_loss_fn(b, latent=True)
    nets = {n: list(getattr(solver, n).parameters()) for n in ("G", "M", "S")}
    flat = torch.autograd.grad(loss, [p for ps in nets.values() for p in ps],
                               allow_unused=True, materialize_grads=True)
    start = 0
    for n, ps in nets.items():
        out[n] = torch.cat([g.float().reshape(-1)
                            for g in flat[start:start + len(ps)]])
        start += len(ps)
    return out


def prepare_dp_trainers():
    """18c's side in this process: StarGAN v2's continued state and batch
    written for the ranks; at that state, one process's per-net gradients
    (``sgv2_loss_grads``) on the global batch and the mean of its
    gradients on the ranks' two halves. Returns (the ranks' arguments,
    {"global": ..., "halves": ...})."""
    from de_i2i_gan_torch.train.checkpoint import train_state

    tf32_off()
    DP_DIR.mkdir(parents=True, exist_ok=True)
    cfg = sgv2_train_config("adain", compute_dtype="float32")
    solver = sgv2_trainer(cfg)
    continued_adam(solver, SEED + 72)
    state = str(DP_DIR / "sgv2_state.pt")
    torch.save(train_state(solver), state)
    raw = sgv2_train_batches(cfg, 1, SEED + 73)[0]
    torch.save({k: v.cpu() for k, v in raw.items()}, DP_DIR / "sgv2_batch.pt")
    half = SGV2_TRAIN_BATCH // 2
    single = {"global": sgv2_loss_grads(solver, raw)}
    parts = [sgv2_loss_grads(solver, {k: v[i * half:(i + 1) * half]
                                      for k, v in raw.items()})
             for i in range(2)]
    single["halves"] = {n: (parts[0][n] + parts[1][n]) / 2 for n in parts[0]}
    single = {k: {n: g.cpu() for n, g in v.items()} for k, v in single.items()}
    del solver, parts
    free_memory()
    return (state, str(DP_DIR / "sgv2_batch.pt")), single


def report_dp_trainers(smi, ranks, single):
    """18c. The other trainers over two ranks on cuda:0 (gloo), one step
    each. StarGAN v2 AdaIN at the AFHQ flags, batch 8 (4 a rank), f32 with
    TF32 off, from a continued Adam state: the per-net gradients of one
    latent D loss and one latent G loss (10c's), reduced over the ranks,
    against one process's on the global batch within 10c's f32 band (SGV2_TRAIN_F32_BAND + F32_CONTROL_FACTOR x the control:
    how far one process's gradient moves when it is taken as the mean of
    the two halves, the split's own rounding: every convolution runs at
    batch 4, and G's L1 terms' near-ties flip with it; the distance from
    that mean is printed too); one iteration, 96/48 launches a rank. MAE
    at batch 32
    (16/8), WGAN clipping at batch 128 (0) and pix2pix at batch 2, a batch
    reduced from the CLI's default of 1, which does not split (0). Every
    trainer's ranks end with equal states."""
    f = SGV2_FWD_PER_FORWARD
    fwd, bwd = SGV2_G_PASSES["adain"]
    mae_fwd, mae_bwd = expected_launches(full_config(), *MAE_G_PASSES)
    want = {"sgv2": {"fwd": fwd * f, "bwd": bwd * f},
            "mae": {"fwd": mae_fwd, "bwd": mae_bwd},
            "wgan": {"fwd": 0, "bwd": 0}, "p2p": {"fwd": 0, "bwd": 0}}
    for label, w in want.items():
        for r, out in enumerate(ranks):
            check(out[label]["launches"] == w,
                  f"18c {label} rank {r} launched {out[label]['launches']}, "
                  f"expected {w}")
        a, b = ranks[0][label]["digest"], ranks[1][label]["digest"]
        differ = [k for k in a if a[k] != b[k]]
        check(not differ, f"18c {label}: the ranks' states differ at {differ[:5]}")
    got = ranks[0]["sgv2"]["grads"]
    worst = {}
    for net, g in got.items():
        ref, halves = single["global"][net], single["halves"][net]
        control = rel_l2(halves, ref)
        band = SGV2_TRAIN_F32_BAND + F32_CONTROL_FACTOR * control
        gap, exact = rel_l2(g, ref), rel_l2(g, halves)
        worst[net] = (gap, control, band, exact)
    print(f"18c two ranks on cuda:0 over gloo, one step each: StarGAN v2 "
          f"AdaIN (AFHQ flags, batch {SGV2_TRAIN_BATCH}, f32, TF32 off), "
          f"the latent D and G losses' gradients reduced over the ranks, "
          f"relative L2 against one process's mean of the halves / its "
          f"global batch (the control, the band): " + ", ".join(
              f"{k} {e:.3e} / {g:.3e} ({c:.3e}, {b:.3e})"
              for k, (g, c, b, e) in worst.items())
          + f"; launches a rank: " + ", ".join(
              f"{k} {ranks[0][k]['launches']}" for k in want)
          + f" (pix2pix at batch {DP_P2P_BATCH}: its default 1 does not "
          f"split); the ranks' states equal bit for bit [{smi}]")
    for net, (gap, control, band, exact) in worst.items():
        check(gap <= band, f"18c sgv2 {net}'s gradient is {gap:.3e} from one "
              f"process's on the global batch, outside {band:.3e} (from the "
              f"mean of its halves: {exact:.3e})")
    return {label: [out[label]["launches"] for out in ranks] for label in want}


def dp_cli_rank(argvs):
    """A rank of 18d: ``cli.train_defectgan.main`` for each of ``argvs``
    (the process is a rank already, so the CLI trains on it): each run's
    launches, state digest and seconds."""
    from de_i2i_gan_torch.cli.train_defectgan import main
    from de_i2i_gan_torch.ops.cuda import norm_kernels as nk
    from de_i2i_gan_torch.parallel.mesh import state_digest

    out = []
    for argv in argvs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's run starts here
        trainer = main(argv)
        torch.cuda.synchronize()
        out.append(dict(launches={"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES},
                        digest=state_digest(trainer),
                        seconds=time.perf_counter() - t0))
        del trainer
        free_memory()
    return out


def prepare_dp_cli():
    """18d's arguments: ``cli.train_defectgan --gpu_ids 0,0 --data_parallel
    on`` at 8a's flags (AdaIN) but batch DP_CLI_BATCH, for an epoch, then
    with ``--continue_training``; a fresh checkpoint directory."""
    shutil.rmtree(CLI_DIR / "ckpt" / "dp", ignore_errors=True)
    args = cli_args("dp", "--style_norm_block_type", "adain", "--gpu_ids",
                    "0,0", "--data_parallel", "on", "--batch_size",
                    str(DP_CLI_BATCH), "--num_epochs", "1")
    return [args, args + ["--continue_training"]]


def report_dp_cli(smi, ranks):
    """18d. The train CLI run by two ranks on cuda:0 (gloo; each rank calls
    the CLI's ``main``, which trains on the rank it runs in): an epoch
    (exactly 56/16 launches a super-step), rank 0 writing the checkpoint;
    then ``--continue_training`` going on from it (epoch 1 again: the JAX
    trainer's resume restarts at the recorded epoch); each run's ranks end
    with equal states."""
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint, read_iter_record

    super_steps = (512 // 2 // (DP_CLI_BATCH // 2)) // CRITICS
    fwd, bwd = expected_launches(full_config(), G_FORWARDS_PER_SUPER_STEP,
                                 G_BACKWARDS_PER_SUPER_STEP)
    want = {"fwd": super_steps * fwd, "bwd": super_steps * bwd}
    for r, runs in enumerate(ranks):
        for i, run in enumerate(runs):
            check(run["launches"] == want, f"18d rank {r} run {i} launched "
                  f"{run['launches']}, expected {want}")
    for i in range(2):
        a, b = ranks[0][i]["digest"], ranks[1][i]["digest"]
        differ = [k for k in a if a[k] != b[k]]
        check(not differ, f"18d run {i}: the ranks' states differ at {differ[:5]}")
    saved = read_checkpoint(CLI_DIR / "ckpt", "dp", "latest")
    epoch, iters = read_iter_record(CLI_DIR / "ckpt", "dp")
    step1, step2 = (ranks[0][i]["digest"]["step"] for i in range(2))
    check(saved["step"] == step2 == 2 * step1 == 2 * super_steps * CRITICS
          and (epoch, iters) == (1, 2 * super_steps * CRITICS),
          f"18d: steps {step1}, {step2}, saved {saved['step']}, iter.txt "
          f"{epoch},{iters}")
    print(f"18d cli.train_defectgan --gpu_ids 0,0 --data_parallel on "
          f"--batch_size {DP_CLI_BATCH} on two ranks: an epoch of "
          f"{super_steps} super-steps a rank in "
          f"{ranks[0][0]['seconds']:.1f} s (TensorBoard's import and the "
          f"nets' build included), the resume (epoch 1 again, as in JAX) in "
          f"{ranks[0][1]['seconds']:.1f} s; launches a rank a run "
          f"{ranks[0][0]['launches']}; checkpoint steps {step1} and {step2}; "
          f"the ranks' states equal bit for bit after each run [{smi}]")
    return dict(launches=[[run["launches"] for run in runs] for runs in ranks],
                seconds=[run["seconds"] for run in ranks[0]])


# --------------------------------------------- 19. height-sharded inference
# phase 19: cli.translate_folder --spatial 2 (parallel/spatial.py), two ranks
# on cuda:0 over gloo, one launch for the whole phase (the machine has one
# card: no scaling figure). 19a: the split kernels at the bands of 16c's
# 1024^2 forward (each norm's input halved in H), a ragged and an unaligned
# band; 19b: 16c's CLI run again on two ranks, 9 PNGs in bf16 and in an f32
# control, and SPADE at 256^2 with noise; 19c: a reference-keyed .pth pair
# imported onto the card.
SPATIAL = 2
SPATIAL_SHAPES = {(n, c, h // SPATIAL, w): k
                  for (n, c, h, w), k in FOLDER_SHAPES.items()}
SPATIAL_PER_FORWARD = sum(SPATIAL_SHAPES.values())  # 8 moments + 8 apply
SPATIAL_TIMED = 5
SPATIAL_COUNT = 1  # the f32 control: u8 levels (tests/test_translate_folder.py)
SPATIAL_BF16_FACTOR = 1.5  # bf16: mean |d| within 1.5x single bf16's
SPATIAL_SPADE_IMAGE = 256
SPATIAL_SPADE_FILES = 4
SPATIAL_NOISE_WEIGHT = 0.5
SPATIAL_DEVICES = ["--gpu_ids", "0,0"]  # DP_RANKS: two ranks on cuda:0
SPLIT_FLOPS_PER_ELEMENT = 2  # moments: add + fma; apply: fma (+ act)
# the reference defectGAN's state-dict names of the port's G and D keys
# (inverting train/torch_import.py's table), for 19c's .pth pair
REF_G_RULES = (
    (r"^stem\.conv\.", "stem.conv_block.0."),
    (r"^stem\.norm\.", "stem.conv_block.1."),
    (r"^enc_(\d+)\.conv\.", r"enc_blk.\1.conv_block.0."),
    (r"^enc_(\d+)\.norm\.", r"enc_blk.\1.conv_block.1."),
    (r"^enc_res_(\d+)\.conv_(\d+)\.conv\.",
     r"enc_res_blk.\1.res_block.\2.conv_block.0."),
    (r"^enc_res_(\d+)\.conv_(\d+)\.norm\.",
     r"enc_res_blk.\1.res_block.\2.conv_block.1."),
    (r"^dec_res_(\d+)\.norm_(\d+)\.\w+\.mlp_(shared|latent)\.",
     r"dec_res_blk.\1.norm_\2.mlp_\3.0."),
    (r"^dec_res_(\d+)\.norm_(\d+)\.\w+\.mlp_", r"dec_res_blk.\1.norm_\2.mlp_"),
    (r"^dec_res_(\d+)\.", r"dec_res_blk.\1."),
    (r"^dec_(\d+)\.norm\.\w+\.mlp_(shared|latent)\.",
     r"dec_blk.\1.norm.mlp_\2.0."),
    (r"^dec_(\d+)\.norm\.\w+\.mlp_", r"dec_blk.\1.norm.mlp_"),
    (r"^dec_(\d+)\.", r"dec_blk.\1."),
    (r"^(foreground|distribution)_head\.conv\.", r"\1_head.de_conv_block.0."),
)
REF_D_RULES = (
    (r"^stem\.conv\.", "enc_blk.0.conv_block.0."),
    (r"^enc_(\d+)\.conv\.", lambda m: f"enc_blk.{int(m[1]) + 1}.conv_block.0."),
    (r"^(cls|src)_clf\.conv\.", r"\1_clf.conv_block.0."),
)
SPECTRAL_BUFFERS = ("weight_u", "weight_v")
SEAN_STATS = ("mean", "std", "sum", "sumsq", "count")


def split_tolerance(dtype):
    return (dict(atol=F32_TOL, rtol=F32_TOL) if dtype == torch.float32
            else dict(atol=BF16_ATOL, rtol=BF16_RTOL))


def phase_split_vs_plain(nk, fused, smi):
    """19a. The moments and apply kernels against their plain versions at
    the bands' shapes, a ragged band (scalar loops) and an unaligned view
    of the first shape (scalar loops), f32 and bf16, every activation: the
    sums within SUM_BAND of the sum of their absolute terms, y within phase
    3's band on the same mean and inv. Returns the worst |d| of the moments
    (as E[x], E[x^2]) and of y."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"moments": 0.0, "apply": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        cases = [*SPATIAL_SHAPES, RAGGED, "unaligned"]
        for i, shape in enumerate(cases):
            if shape == "unaligned":
                first = next(iter(SPATIAL_SHAPES))
                x, g, b = make_norm_inputs(first, dt, SEED + 100)
                buf = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
                x = buf[1:].view(first).copy_(x)
                check(x.data_ptr() % 16 != 0, "19a: the view is aligned")
            else:
                x, g, b = make_norm_inputs(shape, dt, SEED + 100 + i)
            count = x.shape[2] * x.shape[3]
            sums = nk.modulated_instance_norm_moments(x)
            ref = fused.modulated_instance_norm_moments_ref(x)
            xf = x.float()
            terms = torch.stack([xf.abs().sum(dim=(2, 3)),
                                 xf.square().sum(dim=(2, 3))])
            torch.cuda.synchronize()
            d = (sums - ref).abs()
            check(bool((d <= SUM_BAND * terms).all()),
                  f"19a moments {tuple(x.shape)} {dt}: |d| "
                  f"{d.max().item():.3e} beyond {SUM_BAND} of the terms")
            worst["moments"] = max(worst["moments"], d.max().item() / count)
            mean, inv = fused.moments_to_stats(ref, count)
            errs = []
            for act in (None, "relu", "leaky_relu"):
                y = nk.modulated_instance_norm_apply(x, mean, inv, g, b, act)
                ry = fused.modulated_instance_norm_apply_ref(x, mean, inv, g,
                                                             b, act)
                torch.cuda.synchronize()
                check(y.dtype == dt and y.shape == x.shape, "19a apply dtype")
                torch.testing.assert_close(y.float(), ry.float(),
                                           **split_tolerance(dt))
                err = (y.float() - ry.float()).abs().max().item()
                worst["apply"] = max(worst["apply"], err)
                errs.append(f"act={act} {err:.3e}")
                del y, ry
            print(f"19a split kernels vs plain {tuple(x.shape)} "
                  f"{str(dt)[6:]}{' unaligned' if shape == 'unaligned' else ''}"
                  f": moments max|d| {d.max().item():.3e} (E[x] scale "
                  f"{d.max().item() / count:.3e}), apply max|dy| "
                  f"{', '.join(errs)} tol={split_tolerance(dt)} [{smi}]")
            del x, xf, terms, sums, ref
            free_memory()
    return worst


def phase_split_timing(nk, fused, smi):
    """19a. Each band shape in bf16, device ms: the moments kernel beside
    its plain version and ``torch.var_mean`` over (2, 3); the apply kernel
    (no activation, as the decoder's norms call it) beside its plain
    version and ``F.batch_norm`` in eval mode on (1, N*C, h, W) with
    per-(n, c) affine; each in turns (plain, kernel, library, kernel,
    plain) over rotating copies past the L2, and its bound at 3.35 TB/s:
    moments reads x once, apply reads x and writes y once. Returns each
    kernel's rows."""
    rows = {"moments": [], "apply": []}
    for shape in SPATIAL_SHAPES:
        n, c, h, w = shape
        x, g, b = make_norm_inputs(shape, torch.bfloat16, SEED + 110)
        x_bytes = x.numel() * x.element_size()
        copies = max(2, math.ceil(256e6 / (2 * x_bytes)))
        xs = [x.clone() for _ in range(copies)]
        iters = 4 * copies
        sums = fused.modulated_instance_norm_moments_ref(x)
        mean, inv = fused.moments_to_stats(sums, h * w)
        # the library calls compute the same functions: the moments, and
        # eval-mode batch norm with the row's mean and the variance whose
        # rsqrt(var + eps) is inv, f32 statistics and affine
        m_rm = mean.reshape(-1).contiguous()
        m_rv = (inv.reshape(-1).double() ** -2 - 1e-5).float()
        var_l, mean_l = torch.var_mean(x.float(), dim=(2, 3), correction=0)
        torch.testing.assert_close(mean_l, mean, atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(var_l.reshape(-1), m_rv, atol=1e-4,
                                   rtol=1e-4)
        w1, b1 = (1.0 + g).reshape(-1).contiguous(), b.reshape(-1).contiguous()
        lib = F.batch_norm(x.view(1, n * c, h, w), m_rm, m_rv, w1, b1, False,
                           0.0, 1e-5)
        torch.testing.assert_close(
            lib.view(shape).float(),
            fused.modulated_instance_norm_apply_ref(x, mean, inv, g, b).float(),
            atol=BF16_ATOL, rtol=BF16_RTOL)
        del var_l, mean_l, lib

        def pick(i):
            return xs[i % copies]

        timed = {
            "moments": (lambda i: nk.modulated_instance_norm_moments(pick(i)),
                        lambda i: fused.modulated_instance_norm_moments_ref(pick(i)),
                        lambda i: torch.var_mean(pick(i), dim=(2, 3)),
                        x_bytes + 2 * n * c * 4),
            "apply": (lambda i: nk.modulated_instance_norm_apply(
                          pick(i), mean, inv, g, b),
                      lambda i: fused.modulated_instance_norm_apply_ref(
                          pick(i), mean, inv, g, b),
                      lambda i: F.batch_norm(pick(i).view(1, n * c, h, w),
                                             m_rm, m_rv, w1, b1, False, 0.0,
                                             1e-5),
                      2 * x_bytes + 4 * n * c * 4)}
        for name, (kernel, plain, library, nbytes) in timed.items():
            p1 = device_ms(plain, iters)
            k1 = device_ms(kernel, iters)
            l1 = device_ms(library, iters)
            k2 = device_ms(kernel, iters)
            p2 = device_ms(plain, iters)
            bound_ms, bound_by = bound(nbytes,
                                       SPLIT_FLOPS_PER_ELEMENT * x.numel())
            row = dict(shape=list(shape), ms=(k1 + k2) / 2,
                       plain_ms=(p1 + p2) / 2, library_ms=l1,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows[name].append(row)
            print(f"19a {name} timing {shape} bf16: kernel {k1:.4f}/{k2:.4f} "
                  f"ms, plain {p1:.4f}/{p2:.4f} ms, "
                  f"{'torch.var_mean' if name == 'moments' else 'F.batch_norm'}"
                  f" {l1:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({nbytes / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s), roofline share {bound_ms / row['ms']:.1%}, "
                  f"{copies} rotating copies [{smi}]")
        del xs, x
        free_memory()
    return rows


def count_diff(a_dir, b_dir, names):
    """(max, mean) |d| in u8 counts between the PNGs of two folders."""
    import numpy as np
    from PIL import Image
    worst, total, n = 0, 0.0, 0
    for name in names:
        a = torch.from_numpy(np.array(Image.open(a_dir / name))).int()
        b = torch.from_numpy(np.array(Image.open(b_dir / name))).int()
        d = (a - b).abs()
        worst = max(worst, int(d.max()))
        total += float(d.float().sum())
        n += d.numel()
    return worst, total / n


def spatial_rank(runs, timed):
    """A rank of 19b: each CLI run of ``runs`` (label, argv, f32), its
    launches counted from 0 (the moments and apply kernels, the fused
    forward and backward), its G forwards and seconds; then ``timed``'s
    batch (the 16c checkpoint's G on a global batch of 4 at 1024^2, bf16):
    warm-up, SPATIAL_TIMED batches on the host clock, the peak, then the
    host ms inside the ranges ``spatial.halo`` and ``spatial.moments``."""
    import torch.distributed as dist

    from de_i2i_gan_torch.cli import translate_folder
    from de_i2i_gan_torch.models.generator import DefectGanGenerator
    from de_i2i_gan_torch.ops.cuda import norm_kernels as nk

    out = {}
    for label, argv, f32 in runs:
        torch.backends.cudnn.allow_tf32 = not f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the CLI's run starts here
        nk.SPLIT_LAUNCHES.update(moments=0, apply=0)
        with counted_forwards(DefectGanGenerator) as g:
            result, _ = run_cli(translate_folder.main, argv)
        torch.cuda.synchronize()
        out[label] = dict(
            launches={"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES,
                      **nk.SPLIT_LAUNCHES},  # ... end here
            forwards=g[0], seconds=time.perf_counter() - t0,
            written=[p.name for p in result["written"]])
        free_memory()
    torch.backends.cudnn.allow_tf32 = True
    out["timed"] = spatial_timed_batch(*timed)
    dist.barrier()
    return out


def spatial_timed_batch(argv, batch):
    """The 16c checkpoint's G (bf16, SEAN) with this rank's height shard on
    a global batch of ``batch`` at 1024^2: ms a batch (host clock from a
    barrier to the end of a synchronize), peak memory; then 2 more batches
    under the host profiler, the device synchronized before every exchange
    and reduction, so that each range's host time is its own (the
    staging, the wire, the wait for the other rank) and not the wait for
    the kernels queued before it."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from de_i2i_gan_torch.parallel import spatial

    from de_i2i_gan_torch.config import TrainConfig
    from de_i2i_gan_torch.config.options import Options, to_defectgan_config
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.parallel.spatial import (
        make_height_shard, spatial_sharded_inference)
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    opt = Options("defectgan_test").parse(argv, save=False)
    steps = DefectGanSteps(to_defectgan_config(opt), TrainConfig(),
                           device=distributed.device())
    load_checkpoint(opt.ckpt_dir, opt.name, "latest", steps, strict=False)
    infer = spatial_sharded_inference(steps.G, make_height_shard(SPATIAL))
    gen = torch.Generator(device=CARD).manual_seed(SEED + 83)
    imgs = torch.rand((batch, opt.image_size, opt.image_size, 3),
                      generator=gen, device=CARD) * 2 - 1
    labels = torch.zeros((batch, opt.label_nc), device=CARD)
    labels[:, 1] = 1.0
    noise = torch.Generator(device=CARD).manual_seed(0)

    def forward():
        infer(imgs, labels, None, noise)

    with torch.no_grad():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(SPATIAL_TIMED):
            dist.barrier()
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        real = {k: getattr(spatial.HeightShard, k)
                for k in ("exchange", "all_reduce")}

        def synced(method):
            def call(self, *args):
                torch.cuda.synchronize()
                return method(self, *args)
            return call

        for k, method in real.items():
            setattr(spatial.HeightShard, k, synced(method))
        try:
            dist.barrier()
            t = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(2):
                    forward()
                torch.cuda.synchronize()
            synced_ms = (time.perf_counter() - t) * 1e3 / 2
        finally:
            for k, method in real.items():
                setattr(spatial.HeightShard, k, method)
    return dict(ms=ms, peak_mb=peak_mb, synced_ms=synced_ms,
                halo_ms=range_host_ms(prof, "spatial.halo", 2),
                moments_ms=range_host_ms(prof, "spatial.moments", 2))


def spatial_spade_checkpoint(root):
    """19b's SPADE run at 256^2: a full-width checkpoint (spectral norm,
    noise injection, its weights moved off zero) and SPATIAL_SPADE_FILES
    PNGs; returns the CLI's flags."""
    from de_i2i_gan_torch.config.options import Options, to_defectgan_config
    from de_i2i_gan_torch.nn.blocks import NoiseInjection
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    argv = ["--name", "spade", "--ckpt_dir", str(root / "ckpt"),
            "--image_size", str(SPATIAL_SPADE_IMAGE), "--style_norm_block_type",
            "spade", "--use_spectral", "--add_noise"]
    cfg = to_defectgan_config(Options("defectgan_test").parse(argv, save=False))
    steps = DefectGanSteps(cfg, device=CARD)
    init_weights(steps, SEED + 91)
    with torch.no_grad():
        for m in steps.G.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(SPATIAL_NOISE_WEIGHT)
    save_checkpoint(root / "ckpt", "spade", "latest", steps)
    folder_images(root / "spade_in", SEED + 92, SPATIAL_SPADE_FILES,
                  SPATIAL_SPADE_IMAGE)
    return argv


def phase_spatial(nk, smi, folder):
    """19b. ``cli.translate_folder --spatial 2 --gpu_ids 0,0`` on two ranks
    (one launch): 16c's 9 PNGs at 1024^2 (full width, SEAN, batch 4) in
    bf16 and in an f32 control with TF32 off, and SPADE at 256^2 (spectral
    norm, noise; no kernel). Against one process: the f32 control and SPADE
    (f32) within 1 count of one process's PNGs, bf16's mean |d| from one
    f32 process within 1.5x one bf16 process's (16c's PNGs). Exactly 8
    moments + 8 apply launches a G forward a rank, no fused forward; the
    host clock of a batch of 4, images/s, the halo's and moments' shares,
    the peak a rank."""
    from de_i2i_gan_torch.cli import translate_folder
    from de_i2i_gan_torch.parallel import distributed

    root = CLI_DIR / "folder"
    sean = ["--name", "folder", "--ckpt_dir", str(root / "ckpt"), *FOLDER_BASE]
    spade = spatial_spade_checkpoint(root)
    f32 = ["--compute_dtype", "float32"]

    def io(src, dst):
        return ["--input_dir", str(root / src), "--output_dir", str(root / dst)]

    # one process's f32 runs, TF32 off (16c wrote the bf16 one to out/)
    tf32_off()
    for argv in (io("in", "single_f32") + sean + f32,
                 io("spade_in", "spade_single_f32") + spade + f32):
        run_cli(translate_folder.main, argv)
    torch.backends.cudnn.allow_tf32 = True
    free_memory()
    ranks_flag = ["--spatial", str(SPATIAL), *SPATIAL_DEVICES]
    runs = [("bf16", io("in", "spatial_bf16") + sean + ranks_flag, False),
            ("f32", io("in", "spatial_f32") + sean + f32 + ranks_flag, True),
            ("spade", io("spade_in", "spade_spatial_f32") + spade + f32
             + ranks_flag, True)]
    t0 = time.perf_counter()
    ranks = distributed.launch(spatial_rank, DP_RANKS, runs,
                               (sean, FOLDER_BATCH))
    launch_s = time.perf_counter() - t0

    names = [f"{i:02d}.png" for i in range(FOLDER_FILES)]
    spade_names = [f"{i:02d}.png" for i in range(SPATIAL_SPADE_FILES)]
    batches = -(-FOLDER_FILES // FOLDER_BATCH)
    for r, rank in enumerate(ranks):
        for label, _, _ in runs:
            run = rank[label]
            kernels = label != "spade"
            per = SPATIAL_PER_FORWARD if kernels else 0
            forwards = batches if kernels else -(-SPATIAL_SPADE_FILES
                                                  // FOLDER_BATCH)
            want = {"fwd": 0, "bwd": 0, "moments": per * forwards,
                    "apply": per * forwards}
            check(run["forwards"] == forwards and run["launches"] == want,
                  f"19b rank {r} {label}: {run['forwards']} G forwards, "
                  f"launches {run['launches']}, expected {want}")
            check(run["written"] == ((spade_names if label == "spade" else
                                      names) if r == 0 else []),
                  f"19b rank {r} {label} wrote {run['written']}")
    f32_diff = count_diff(root / "spatial_f32", root / "single_f32", names)
    spade_diff = count_diff(root / "spade_spatial_f32",
                            root / "spade_single_f32", spade_names)
    bf16_diff = count_diff(root / "spatial_bf16", root / "single_f32", names)
    single_bf16 = count_diff(root / "out", root / "single_f32", names)
    check(f32_diff[0] <= SPATIAL_COUNT and spade_diff[0] <= SPATIAL_COUNT,
          f"19b f32 spatial vs one process: SEAN max {f32_diff[0]}, SPADE max "
          f"{spade_diff[0]} counts (band {SPATIAL_COUNT})")
    check(bf16_diff[1] <= SPATIAL_BF16_FACTOR * single_bf16[1],
          f"19b bf16 spatial vs f32 one process mean {bf16_diff[1]:.4f} "
          f"counts beyond {SPATIAL_BF16_FACTOR} x one bf16 process's "
          f"{single_bf16[1]:.4f}")
    timed = [rank["timed"] for rank in ranks]
    ms = statistics.median(timed[0]["ms"])
    # the ranges' shares of the profiled batches (synchronized before each
    # exchange and reduction), the larger rank's
    shares = [{k: t[f"{k}_ms"] / t["synced_ms"] for k in ("halo", "moments")}
              for t in timed]
    halo = max(s["halo"] for s in shares)
    moments = max(s["moments"] for s in shares)
    print(f"19b translate_folder --spatial {SPATIAL} on two ranks sharing "
          f"cuda:0 (gloo): 9 PNGs at {FOLDER_IMAGE}^2 in bf16 "
          f"{ranks[0]['bf16']['seconds']:.1f} s, f32 "
          f"{ranks[0]['f32']['seconds']:.1f} s, SPADE {SPATIAL_SPADE_IMAGE}^2 "
          f"{ranks[0]['spade']['seconds']:.1f} s (launch of both ranks and "
          f"every run {launch_s:.1f} s); launches a rank "
          f"{ranks[0]['bf16']['launches']} over {batches} G forwards "
          f"(SPADE {ranks[0]['spade']['launches']}); against one process: "
          f"f32 max {f32_diff[0]} mean {f32_diff[1]:.4f} counts, SPADE f32 "
          f"max {spade_diff[0]} mean {spade_diff[1]:.4f}, bf16 vs f32 one "
          f"process max {bf16_diff[0]} mean {bf16_diff[1]:.4f} (one bf16 "
          f"process: max {single_bf16[0]} mean {single_bf16[1]:.4f}, band "
          f"{SPATIAL_BF16_FACTOR}x) [{smi}]")
    print(f"19b a batch of {FOLDER_BATCH} at {FOLDER_IMAGE}^2 on two ranks: "
          f"{ms:.3f} ms (rank 0 {[round(v, 3) for v in timed[0]['ms']]}), "
          f"{FOLDER_BATCH * 1e3 / ms:.2f} images/s (16c, one process: "
          f"{folder['ms']:.3f} ms); in 2 profiled batches of "
          f"{timed[0]['synced_ms']:.3f} / {timed[1]['synced_ms']:.3f} ms (the "
          f"device synchronized before each exchange and reduction), "
          f"spatial.halo {timed[0]['halo_ms']:.3f} / "
          f"{timed[1]['halo_ms']:.3f} ms, spatial.moments "
          f"{timed[0]['moments_ms']:.3f} / {timed[1]['moments_ms']:.3f} ms a "
          f"batch of host time inside the ranges: shares {halo:.1%} and "
          f"{moments:.1%} (the larger rank's); peak "
          f"{timed[0]['peak_mb']:.1f} / {timed[1]['peak_mb']:.1f} MiB a rank "
          f"(16c: {folder['peak_mb']:.1f}) [{smi}]")
    return dict(ranks=ranks, ms=ms, halo_share=halo, moments_share=moments,
                peak_mb=[t["peak_mb"] for t in timed],
                agree={"f32": f32_diff, "spade": spade_diff,
                       "bf16": bf16_diff, "single_bf16": single_bf16},
                forwards=batches)


def kept_by_import(key):
    """Whether the importer keeps the target's own tensor at ``key``:
    spectral u/v and SEAN's running statistics."""
    prefix, name = key.rsplit(".", 1)
    return name in SPECTRAL_BUFFERS or (prefix.endswith(".sean")
                                        and name in SEAN_STATS)


def reference_key(key, rules):
    """The reference's name of a port state-dict key."""
    for pattern, repl in rules:
        new, n = re.subn(pattern, repl, key)
        if n:
            return new
    raise KeyError(key)


def reference_state_dict(module, rules):
    """``module``'s parameters and BatchNorm statistics under the
    reference's names, on the CPU: ``weight_orig`` for a spectrally
    normalized conv, noise weights (1, 1, 1, 1); its spectral u/v and
    SEAN's statistics left out (the importer keeps the target's)."""
    sd = {}
    for key, value in module.state_dict().items():
        if kept_by_import(key):
            continue
        prefix, name = key.rsplit(".", 1)
        value = value.detach().cpu().clone()
        out = reference_key(key, rules)
        if ".noise" in key:
            value = value.reshape(1, 1, 1, 1)
        if name == "weight" and getattr(module.get_submodule(prefix),
                                        "use_spectral", False):
            out = out[:-len("weight")] + "weight_orig"
        sd[out] = value
    return sd


def phase_pth_import(nk, smi):
    """19c. A reference-keyed ``{epoch}_net_G.pth`` / ``_net_D.pth`` pair
    written from a seeded full-width SEAN G and D (BatchNorm statistics
    moved off their init), imported onto the card into steps drawn from
    another seed (``train/torch_import.py``): every imported tensor equals
    the source's, the kept ones (SEAN's statistics) the target's; a G
    forward of a batch of 8 at 256^2 launches the forward kernel 8 times
    and agrees with the plain path within phase 4's band."""
    from de_i2i_gan_torch.nn.blocks import BatchNorm
    from de_i2i_gan_torch.nn.normalization import SEAN
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps
    from de_i2i_gan_torch.train.torch_import import import_torch_checkpoint

    cfg = sean_config()
    src = DefectGanSteps(cfg, device=CARD)
    init_weights(src, SEED + 95)
    src.init_training()
    gen = torch.Generator().manual_seed(SEED + 95)
    with torch.no_grad():
        for m in src.G.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=gen) + 0.5)
            elif isinstance(m, SEAN):  # statistics the import must not take
                m.mean.copy_(torch.randn(m.mean.shape, generator=gen))
                m.std.copy_(torch.rand(m.std.shape, generator=gen) + 0.5)
    root = CLI_DIR / "pth"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    g_sd = reference_state_dict(src.G, REF_G_RULES)
    d_sd = reference_state_dict(src.D, REF_D_RULES)
    torch.save(g_sd, root / "1_net_G.pth")
    torch.save(d_sd, root / "1_net_D.pth")
    dst = DefectGanSteps(cfg, device=CARD)
    init_weights(dst, SEED + 96)
    kept = {("G", k): v.clone() for k, v in dst.G.state_dict().items()
            if kept_by_import(k)}
    t0 = time.perf_counter()
    import_torch_checkpoint(root / "1_net_G.pth", root / "1_net_D.pth", cfg,
                            dst)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_equal = 0
    for net in ("G", "D"):
        want, got = getattr(src, net).state_dict(), getattr(dst, net).state_dict()
        for k, v in got.items():
            ref = kept.get((net, k), want[k])
            check(v.device.type == CARD and torch.equal(v, ref),
                  f"19c {net}.{k} differs after the import")
            n_equal += 1
    gen = torch.Generator(device=CARD).manual_seed(SEED + 97)
    x = torch.rand((BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                   device=CARD) * 2 - 1
    labels = torch.eye(cfg.label_nc, device=CARD)[
        torch.randint(0, cfg.label_nc, (BATCH,), generator=gen, device=CARD)]
    feat = style_input(cfg, gen, BATCH)
    nk.LAUNCHES = nk.BWD_LAUNCHES = 0  # the imported G's forward starts here
    with torch.no_grad():
        out_k, prob = dst.G(x, labels, feat)
        torch.cuda.synchronize()
        launches = {"fwd": nk.LAUNCHES, "bwd": nk.BWD_LAUNCHES}  # ... ends
        for m in dst.G.modules():
            if hasattr(m, "use_pallas"):
                m.use_pallas = False
        out_p, _ = dst.G(x, labels, feat)
    check(launches == {"fwd": FWD_PER_FORWARD, "bwd": 0},
          f"19c: the imported G launched {launches}")
    check_images(out_k, prob, BATCH, cfg.image_size)
    d = (out_k.float() - out_p.float()).abs()
    agree = (d.max().item(), d.mean().item())
    check(agree[0] <= OUT_BAND and agree[1] <= MEAN_BAND,
          f"19c imported G: kernel vs plain max {agree[0]:.3e} mean "
          f"{agree[1]:.3e}")
    print(f"19c reference .pth import (SEAN, full width): {len(g_sd)} G and "
          f"{len(d_sd)} D entries read in {import_s:.2f} s, {n_equal} tensors "
          f"equal on {CARD} (SEAN's statistics the target's); a G forward at "
          f"batch {BATCH}: launches {launches}, kernel vs plain max "
          f"{agree[0]:.3e} mean {agree[1]:.3e} (band {OUT_BAND}, {MEAN_BAND}) "
          f"[{smi}]")
    del src, dst
    free_memory()
    return dict(launches=launches, agree=agree, tensors=n_equal)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from de_i2i_gan_torch.ops import fused
    from de_i2i_gan_torch.ops.cuda import norm_kernels as nk

    started = time.perf_counter()
    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} x{count}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"nvidia-smi: {smi}")

    # 2. build
    info = nk.build()
    print(f"build: {info.seconds:.2f} s -> {info.path.name}")
    phase_build_report(nk, info, smi)

    # 3. kernels against their plain versions
    fwd_worst = phase_fwd_vs_plain(nk, fused, smi)
    bwd_worst = phase_bwd_vs_plain(nk, fused, smi)

    # 4. serving (a small input against the CPU first)
    phase_reference(nk, smi)
    serving = phase_serving(nk, smi, full_config(), "adain")
    with tally_calls(nk) as serve_calls:
        profile_device(lambda: serving["steps"].generate(*serving["request"]),
                       2, "request", serving["ms"], smi)
    check(serve_calls["fwd"] == Counter({s: 2 * c for s, c in SLICE_SHAPES.items()})
          and not serve_calls["bwd"], f"serving calls by shape {serve_calls}")
    del serving["steps"], serving["request"]
    free_memory()

    # 5. forward kernel times
    fwd_serving_rows = phase_fwd_timing(nk, fused, SLICE_SHAPES, smi)
    fwd_train_rows = phase_fwd_timing(nk, fused, TRAIN_SHAPES, smi)

    # 6. training
    phase_train_small(nk, smi, small_config(), "adain")
    training = phase_training(nk, smi, full_config(), "adain")
    with tally_calls(nk) as train_calls:
        busy = profile_super_step(training, "adain", smi)
    check_train_calls(train_calls, "adain")
    print(f"calls by shape: serving forward {dict(serve_calls['fwd'])} over 2 "
          f"forwards; super-step forward {dict(train_calls['fwd'])}, backward "
          f"{dict(train_calls['bwd'])}")
    del training["steps"], training["batch"]
    free_memory()
    compare = phase_train_compare(smi, full_config, "adain")
    bwd_rows = phase_bwd_timing(nk, fused, smi)
    training_remat = phase_train_remat(nk, smi)

    # 7a. SEAN serving
    serving_sean = phase_serving(nk, smi, sean_config(), "sean")
    with tally_calls(nk) as sean_serve_calls:
        profile_device(lambda: serving_sean["steps"].generate(
            *serving_sean["request"]), 2, "sean request", serving_sean["ms"], smi)
    check(sean_serve_calls["fwd"] == serve_calls["fwd"]
          and not sean_serve_calls["bwd"],
          f"sean serving calls by shape {sean_serve_calls}")
    del serving_sean["steps"], serving_sean["request"]
    free_memory()

    # 7b. SEAN training
    phase_train_small(nk, smi, small_config(
        style_norm_block_type="sean", embed_nc=24, num_embeds=3,
        use_spectral=True, use_running_stats=True, style_distill=True), "sean")
    training_sean = phase_training(nk, smi, sean_config(), "sean", DIFF_AUG)
    with tally_calls(nk) as sean_train_calls:
        busy_sean = profile_super_step(training_sean, "sean", smi)
    check_train_calls(sean_train_calls, "sean")
    phase_sean_stats_request(nk, training_sean["steps"], smi)
    del training_sean["steps"], training_sean["batch"]
    free_memory()
    compare_sean = phase_train_compare(smi, sean_config, "sean", DIFF_AUG)

    # 7c. SPADE serving and training: no kernel on this path
    serving_spade = phase_serving(nk, smi, spade_config(), "spade",
                                  compare=False)
    profile_device(lambda: serving_spade["steps"].generate(
        *serving_spade["request"]), 2, "spade request", serving_spade["ms"], smi)
    del serving_spade["steps"], serving_spade["request"]
    free_memory()
    training_spade = phase_training(nk, smi, spade_config(), "spade", DIFF_AUG)
    busy_spade = profile_super_step(training_spade, "spade", smi)
    del training_spade["steps"], training_spade["batch"]
    free_memory()
    for label, run in (("serving spade", serving_spade),
                       ("training spade", training_spade)):
        check(run["launches"] == {"fwd": 0, "bwd": 0},
              f"{label} launched kernels: {run['launches']}")

    # 8. the entry points: the train CLI (8a), the test CLI on its
    # checkpoint (8d, before 8b rewrites epoch 1), the resumed run (8b), SEAN
    # with an embedding bank (8c), the feed alone (8e), the native feed (8f)
    cli_started = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    trainer_adain = phase_cli_train(nk, smi, training["ms"])
    test_cli = phase_cli_test(nk, smi)
    trainer_resume = phase_cli_resume(nk, smi, trainer_adain)
    del trainer_adain["state"]
    trainer_sean = phase_cli_sean(nk, smi)
    feed = phase_prefetch(smi, cli_loader, "synthetic loader")
    pace = ("the synthetic loader" if feed["host_ms"] >= training["ms"]
            else "the step (device and launches), not the loader")
    print(f"pace: the loader makes a super-batch in {feed['host_ms']:.1f} ms, "
          f"the preloaded super-step takes {training['ms']:.3f} ms and the "
          f"loader-fed one {trainer_adain['ms']:.3f} ms: {pace} sets it [{smi}]")
    trainer_native = phase_native_feed(nk, smi, training["ms"], trainer_adain)
    cli_s = time.perf_counter() - cli_started

    # 9. StarGAN v2 serving at 256^2: the forward kernel at its shapes (9a),
    # AdaIN (9b) and SEANv2 (9c) requests of 32
    sgv2_started = time.perf_counter()
    sgv2_worst = phase_fwd_vs_plain(nk, fused, smi, tuple(SGV2_SHAPES), (None,),
                                    boundaries=False)
    fwd_sgv2_rows = phase_fwd_timing(nk, fused, SGV2_SHAPES, smi)
    for r in fwd_sgv2_rows:
        share = r["bound_ms"] / r["ms"]
        print(f"sgv2 shape {tuple(r['shape'])}: kernel {r['ms']:.4f} ms, "
              f"{share:.1%} of its bound, {r['library_ms'] / r['ms']:.2f}x the "
              f"library call's speed: "
              f"{'below half its bound' if share < 0.5 else 'at least half its bound'}"
              f", {'behind' if r['ms'] > r['library_ms'] else 'ahead of'} the "
              f"library call [{smi}]")
    sgv2_adain = phase_sgv2_adain(nk, fused, smi)
    sgv2_sean = phase_sgv2_sean(nk, fused, smi)
    sgv2_s = time.perf_counter() - sgv2_started

    # 10. StarGAN v2 training at 256^2 (the AFHQ command): both kernels at
    # its batch-8 shapes (10a), timed train_steps of AdaIN, FusedProp and
    # SEAN (10b), a latent G loss's gradients kernel vs plain (10c), the CLI
    # (10d)
    train_started = time.perf_counter()
    t_shapes = tuple(SGV2_TRAIN_SHAPES)
    sgv2t_fwd_worst = phase_fwd_vs_plain(nk, fused, smi, t_shapes, (None,),
                                         boundaries=False)
    sgv2t_bwd_worst = phase_bwd_vs_plain(nk, fused, smi, t_shapes, (None,),
                                         boundaries=False)
    fwd_sgv2t_rows = phase_fwd_timing(nk, fused, SGV2_TRAIN_SHAPES, smi)
    bwd_sgv2t_rows = phase_bwd_timing(nk, fused, smi, SGV2_TRAIN_SHAPES,
                                      SGV2_LIBRARY_SUM_BAND)
    for kind, rows in (("fwd", fwd_sgv2t_rows), ("bwd", bwd_sgv2t_rows)):
        for r in rows:
            share = r["bound_ms"] / r["ms"]
            print(f"sgv2 train shape {tuple(r['shape'])} {kind}: kernel "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, {share:.1%} "
                  f"of it, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms: "
                  f"{'below half its bound' if share < 0.5 else 'at least half its bound'}"
                  f", {'behind' if r['ms'] > r['library_ms'] else 'ahead of'} the "
                  f"library call [{smi}]")
    floor = phase_launch_floor(nk, smi)
    split = {"10a": time.perf_counter() - train_started}
    sgv2_train = phase_sgv2_train(nk, smi, "adain")
    sgv2_fused = phase_sgv2_train(nk, smi, "fused")
    sgv2_train_sean = phase_sgv2_train(nk, smi, "sean")
    split["10b"] = time.perf_counter() - train_started - sum(split.values())
    sgv2_agree = phase_sgv2_train_agreement(nk, fused, smi)
    split["10c"] = time.perf_counter() - train_started - sum(split.values())
    sgv2_cli = phase_sgv2_cli(nk, smi, sgv2_train["ms"])
    train_s = time.perf_counter() - train_started
    split["10d"] = train_s - sum(split.values())

    # 11. MAE-GAN pretraining: both kernels timed at the batch-32 shapes (as
    # 5 and 6f), a small super-step against the CPU (11a), full-width
    # super-steps (11b), the MAE CLIs on both feeds and the test CLI (11c),
    # DefectGAN warm-started from the MAE run (11d), StarGAN v2's pretrain
    # mode and its warm start (11e)
    mae_started = time.perf_counter()
    fwd_mae_rows = phase_fwd_timing(nk, fused, MAE_SHAPES, smi)
    bwd_mae_rows = phase_bwd_timing(nk, fused, smi, MAE_SHAPES)
    for kind, rows in (("fwd", fwd_mae_rows), ("bwd", bwd_mae_rows)):
        for r in rows:
            tier = r["tier"] + (str(r["cluster"]) if r["tier"] == "C" else "")
            times = {tier: r["ms"], "S": r["streaming_ms"], **r["other_tiers_ms"]}
            print(f"MAE shape {tuple(r['shape'])} {kind}: planned tier {tier} "
                  f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of its "
                  f"bound), tier S {r['streaming_ms']:.4f} ms: the planner "
                  f"picks {'no worse than' if r['ms'] <= 1.015 * r['streaming_ms'] else 'WORSE than'}"
                  f" tier S; fastest {min(times, key=times.get)} [{smi}]")
    mae_split = {"11-timing": time.perf_counter() - mae_started}
    phase_mae_small(nk, smi)
    mae = phase_mae_train(nk, smi)
    mae_split["11ab"] = time.perf_counter() - mae_started - sum(mae_split.values())
    mae_cli = phase_mae_cli(nk, smi, mae["ms"], "mae")
    mae_native = phase_mae_cli(nk, smi, mae["ms"], "mae_native", "--native_loader")
    check(mae_cli["image_dtypes"] == {torch.float32}
          and mae_native["image_dtypes"] == {torch.uint8},
          f"MAE feeds reached the step as {mae_cli['image_dtypes']} and "
          f"{mae_native['image_dtypes']}")
    mae_test = phase_mae_test_cli(nk, smi)
    mae_split["11c"] = time.perf_counter() - mae_started - sum(mae_split.values())
    mae_warm = phase_mae_warm_start(nk, smi)
    mae_split["11d"] = time.perf_counter() - mae_started - sum(mae_split.values())
    sgv2_pre, sgv2_warm = phase_sgv2_pretrain(nk, smi, CLI_DIR / "sgv2" / "afhq")
    mae_s = time.perf_counter() - mae_started
    mae_split["11e"] = mae_s - sum(mae_split.values())

    # 12. pix2pix at its CLI's defaults, no kernel on the path: a small step
    # against the CPU (12a), full-width super-steps (12b), with remat (12c),
    # at 512^2 (12d), the train CLI on both feeds, a resume, the test CLI (12e)
    p2p_started = time.perf_counter()
    phase_p2p_small(smi)
    p2p = phase_p2p_train(nk, smi)
    p2p_split = {"12a-d": time.perf_counter() - p2p_started}
    p2p_cli = phase_p2p_cli(nk, smi, p2p["train_step"]["ms"], "p2p")
    p2p_native = phase_p2p_cli(nk, smi, p2p["train_step"]["ms"], "p2p_native",
                               "--native_loader")
    check(p2p_cli["keys"] == ["input", "target"] and p2p_native["keys"] == ["pair"],
          f"pix2pix feeds reached the step as {p2p_cli['keys']} and "
          f"{p2p_native['keys']}")
    p2p_resume = phase_p2p_resume(nk, smi, p2p_cli)
    del p2p_cli["state"], p2p_native["state"]
    p2p_test = phase_p2p_test_cli(nk, smi)
    p2p_s = time.perf_counter() - p2p_started
    p2p_split["12e"] = p2p_s - sum(p2p_split.values())

    # 13. WGAN at its CLI's defaults, no kernel on the path: small clipping
    # and GP super-steps against the CPU (13a), full-width ones (13b), the
    # train CLI on both feeds and a resume (13c)
    wgan_started = time.perf_counter()
    phase_wgan_small(smi)
    wgan = phase_wgan_train(nk, smi)
    wgan_cli = phase_wgan_cli(nk, smi)
    wgan_s = time.perf_counter() - wgan_started

    # 14. the frozen ViT: ViT-B card vs CPU and a bf16 request (14a), the
    # ViT CLIs and their bank feeding DefectGAN SEAN (14b), StarGAN v2 SEAN
    # with lambda_sty through the solver (14c) and its G gradient kernel vs
    # plain, the SEAN CLI with --vit_path and update_stats (14d)
    vit_started = time.perf_counter()
    vit = phase_vit(nk, smi)
    vit_cli, vit_bank = phase_vit_cli(nk, smi)
    sgv2_vit = phase_sgv2_sean_vit(nk, smi)
    sty_agree = phase_sgv2_train_agreement(nk, fused, smi, "sty")
    sgv2_vit_cli = phase_sgv2_sean_cli(nk, smi)
    vit_s = time.perf_counter() - vit_started

    # 15. the FAN: card vs CPU and the masks (15a), the CelebA-HQ command
    # with --wing_ckpt (15b), --mode align (15c); first both kernels at the
    # shapes of the CelebA-HQ path that 10a does not hold (w_hpf 1's 8^2
    # rows), against the plain version in every tier and timed
    fan_started = time.perf_counter()
    c_shapes = tuple(s for s in CELEBA_TRAIN_SHAPES if s not in SGV2_TRAIN_SHAPES)
    celeba_fwd_worst = phase_fwd_vs_plain(nk, fused, smi, c_shapes, (None,),
                                          boundaries=False)
    celeba_bwd_worst = phase_bwd_vs_plain(nk, fused, smi, c_shapes, (None,),
                                          boundaries=False)
    fwd_celeba_rows = phase_fwd_timing(nk, fused, c_shapes, smi)
    bwd_celeba_rows = phase_bwd_timing(nk, fused, smi, c_shapes,
                                       SGV2_LIBRARY_SUM_BAND)
    for kind, rows in (("fwd", fwd_celeba_rows), ("bwd", bwd_celeba_rows)):
        for r in rows:
            print(f"CelebA-HQ shape {tuple(r['shape'])} {kind}: tier "
                  f"{r['tier']}, kernel {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} of it, "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f}"
                  f" ms [{smi}]")
    fan = phase_fan(nk, smi)
    celeba = phase_sgv2_celeba_cli(nk, smi, fan.pop("fan"))
    align = phase_align_cli(nk, smi, celeba["wing_ckpt"])
    fan_s = time.perf_counter() - fan_started

    # 16. deployment: the custom ops (16a), serving export and its CLI
    # (16b), folder inference at 1024^2 (16c), the video and the SEAN grids
    # (16d)
    deploy_started = time.perf_counter()
    ops = phase_ops(nk, fused, smi)
    deploy_split = {"16a": time.perf_counter() - deploy_started}
    export = phase_export(nk, smi)
    deploy_split["16b"] = time.perf_counter() - deploy_started - sum(
        deploy_split.values())
    folder = phase_folder(nk, fused, smi)
    deploy_split["16c"] = time.perf_counter() - deploy_started - sum(
        deploy_split.values())
    video = phase_sgv2_video(nk, smi)
    deploy_s = time.perf_counter() - deploy_started
    deploy_split["16d"] = deploy_s - sum(deploy_split.values())

    # 17. the metrics: the nets card vs CPU and a feature request (17a),
    # every metric flag through its CLI (17b)
    metrics_started = time.perf_counter()
    metric_nets = phase_metric_nets(nk, smi)
    metric_clis = phase_metric_clis(nk, smi)
    metrics_s = time.perf_counter() - metrics_started

    # 18. data parallel: NCCL, a group of one (18a); two ranks on cuda:0
    # over gloo, DefectGAN against one process (18b), the other trainers
    # (18c), the train CLI and its resume (18d)
    dp_started = time.perf_counter()
    dp_nccl = phase_dp_nccl(nk, smi)
    dp_split = {"18a": time.perf_counter() - dp_started}
    dp_gloo, dp_trainers, dp_cli = phase_dp_gloo(nk, smi)
    dp_s = time.perf_counter() - dp_started
    dp_split["18b-d"] = dp_s - sum(dp_split.values())

    # 19. height-sharded inference: the split kernels against their plain
    # versions and timed at the bands' shapes (19a), translate_folder
    # --spatial 2 on two ranks sharing cuda:0 (19b), the reference .pth
    # import onto the card (19c)
    spatial_started = time.perf_counter()
    split_worst = phase_split_vs_plain(nk, fused, smi)
    split_rows = phase_split_timing(nk, fused, smi)
    spatial_split = {"19a": time.perf_counter() - spatial_started}
    spatial = phase_spatial(nk, smi, folder)
    spatial_split["19b"] = time.perf_counter() - spatial_started - sum(
        spatial_split.values())
    pth = phase_pth_import(nk, smi)
    spatial_s = time.perf_counter() - spatial_started
    spatial_split["19c"] = spatial_s - sum(spatial_split.values())
    spatial_paths = {f"spatial_{label}_rank{r}": rank[label]["launches"]
                     for r, rank in enumerate(spatial["ranks"])
                     for label in ("bf16", "f32", "spade")}

    per_step = training["super_steps"]
    paths = {"serving": serving, "training": training,
             "serving_sean": serving_sean, "training_sean": training_sean,
             "serving_spade": serving_spade, "training_spade": training_spade,
             "trainer_adain": trainer_adain, "test_cli": test_cli,
             "trainer_resume": trainer_resume, "trainer_sean": trainer_sean,
             "trainer_native": trainer_native, "sgv2_adain": sgv2_adain,
             "sgv2_sean": sgv2_sean, "sgv2_train": sgv2_train,
             "sgv2_train_sean": sgv2_train_sean, "sgv2_fused": sgv2_fused,
             "sgv2_cli": sgv2_cli, "mae": mae, "mae_eval": mae["eval"],
             "mae_cli": mae_cli, "mae_cli_native": mae_native,
             "mae_test_cli": mae_test, "mae_warm_start": mae_warm,
             "sgv2_pretrain": sgv2_pre, "sgv2_pretrain_warm": sgv2_warm,
             "p2p": p2p["train_step"], "p2p_fused": p2p["fused"],
             "p2p_remat": p2p["remat"], "p2p_unet": p2p["unet"],
             "p2p_512": p2p["512"], "training_remat": training_remat,
             "p2p_cli": p2p_cli, "p2p_cli_native": p2p_native,
             "p2p_resume": p2p_resume, "p2p_test_cli": p2p_test,
             "wgan": wgan["clipping"], "wgan_gp": wgan["gp"],
             "wgan_cli": wgan_cli["wgan"],
             "wgan_cli_native": wgan_cli["wgan_native"],
             "wgan_resume": wgan_cli["wgan_resume"],
             "vit_request": vit, "vit_cli": vit_cli,
             "vit_bank_sean": vit_bank, "sgv2_sean_vit": sgv2_vit,
             "sgv2_sean_vit_cli": sgv2_vit_cli, "fan": fan,
             "sgv2_celeba_cli": celeba, "align_cli": align,
             **export["paths"], "folder_1024": folder,
             "sgv2_video": video["video"], "sgv2_grids": video["grids"],
             "metric_nets": metric_nets, **metric_clis,
             "dp_nccl_group_of_one": dp_nccl,
             **{f"dp_gloo_defectgan_rank{r}": {"launches": n}
                for r, n in enumerate(dp_gloo["launches"])},
             **{f"dp_gloo_{label}_rank{r}": {"launches": n}
                for label, per_rank in dp_trainers.items()
                for r, n in enumerate(per_rank)},
             **{f"dp_cli_rank{r}_run{i}": {"launches": n}
                for r, runs in enumerate(dp_cli["launches"])
                for i, n in enumerate(runs)},
             **{k: {"launches": v} for k, v in spatial_paths.items()},
             "pth_import_sean": pth}
    unit = ("ms, plain_ms, bound_ms, library_ms: device ms summed over the "
            "kernel's calls in one training super-step, as in per_super_step; "
            "per_call rows: device ms per call and calls per super-step; "
            "per_serving_forward / per_sgv2_forward: device ms summed over one "
            "DefectGAN serving forward / one StarGAN v2 G forward at batch 32; "
            "per_sgv2_train_iteration: device ms summed over one StarGAN v2 "
            "AdaIN training iteration at batch 8; per_mae_super_step: over "
            "one DefectGAN MAE super-step at batch 32; "
            "per_sgv2_pretrain_iteration: over one StarGAN v2 AdaIN "
            "pretraining iteration at batch 8; per_sgv2_celeba_iteration: "
            "over one iteration of the CelebA-HQ command (w_hpf 1) at batch 8; "
            "per_folder_1024_forward: over one DefectGAN SEAN G forward of "
            "cli.translate_folder at 1024^2, batch 4")
    fwd_sgv2_rows = with_calls(fwd_sgv2_rows, sgv2_adain["calls"],
                               sgv2_adain["forwards"])
    sgv2t_rows = {kind: with_calls(rows, sgv2_train["calls"][kind],
                                   sgv2_train["iterations"])
                  for kind, rows in (("fwd", fwd_sgv2t_rows),
                                     ("bwd", bwd_sgv2t_rows))}

    def per_path(name, rows):
        return {name: {"calls": sum(r["calls"] for r in rows),
                       **{k: summed(rows, k) for k in SUMMED},
                       "per_call": rows}}

    def per_iteration(rows):
        return per_path("per_sgv2_train_iteration", rows)

    def mae_paths(kind, mae_rows, sgv2t):
        return {**per_path("per_mae_super_step", with_calls(
                    mae_rows, mae["calls"][kind], mae["super_steps"])),
                **per_path("per_sgv2_pretrain_iteration", with_calls(
                    sgv2t, sgv2_pre["calls"][kind], sgv2_pre["iterations"]))}

    fwd_serving_rows = with_calls(fwd_serving_rows, serve_calls["fwd"], 2)
    fwd = kernel_record(
        "modulated_instance_norm_fwd",
        "de_i2i_gan_tpu/ops/pallas/norm_kernels.py:51",
        with_calls(fwd_train_rows, train_calls["fwd"], 1),
        launches_by_path(paths, "fwd"),
        max(fwd_worst, sgv2_worst, sgv2t_fwd_worst), unit,
        {**{f"per_{path}_forward": {
            "calls": sum(r["calls"] for r in rows),
            **{k: summed(rows, k) for k in SUMMED},
            "per_call": rows}
            for path, rows in (("serving", fwd_serving_rows),
                               ("sgv2", fwd_sgv2_rows))},
         **per_iteration(sgv2t_rows["fwd"]),
         **mae_paths("fwd", fwd_mae_rows, fwd_sgv2t_rows)})
    bwd = kernel_record(
        "modulated_instance_norm_bwd",
        "de_i2i_gan_tpu/ops/pallas/norm_kernels.py:93",
        with_calls(bwd_rows, train_calls["bwd"], 1),
        launches_by_path(paths, "bwd"), max(bwd_worst, sgv2t_bwd_worst), unit,
        {**per_iteration(sgv2t_rows["bwd"]),
         **mae_paths("bwd", bwd_mae_rows, bwd_sgv2t_rows)})
    fwd["launch_floor_ms"], bwd["launch_floor_ms"] = floor["fwd_ms"], floor["bwd_ms"]
    # the CelebA-HQ command (w_hpf 1): the calls of one masked G forward, as
    # counted in 15b, and the kernels' time over one iteration's calls (15's
    # rows at its 8^2 shape, 10a's at the others)
    fwd["calls_per_sgv2_celeba_g_forward"] = celeba["per_forward"]
    for rec, kind, rows in ((fwd, "fwd", fwd_celeba_rows + fwd_sgv2t_rows),
                            (bwd, "bwd", bwd_celeba_rows + bwd_sgv2t_rows)):
        rec.update(per_path("per_sgv2_celeba_iteration", with_calls(
            [r for r in rows if tuple(r["shape"]) in CELEBA_TRAIN_SHAPES],
            celeba["calls"][kind], celeba["iterations"])))
    fwd.update(per_path("per_folder_1024_forward", folder["rows"]))
    fwd["op_host_us"] = ops
    fwd["max_abs_err"] = max(fwd["max_abs_err"], celeba_fwd_worst)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], celeba_bwd_worst)
    record = {"kernels": [fwd, bwd]}
    report_tiers(record, smi)
    split_unit = ("ms, plain_ms, bound_ms, library_ms: device ms summed over "
                  "one rank's calls in one DefectGAN SEAN G forward of "
                  "cli.translate_folder --spatial 2 at 1024^2, batch 4 (the "
                  "rank's band: every norm input halved in H); per_call rows: "
                  "device ms per call and calls a forward; library: "
                  "torch.var_mean over (2, 3) for the moments, F.batch_norm "
                  "in eval mode on (1, N*C, h, W) for apply; max_abs_err: the "
                  "moments' as E[x] and E[x^2], apply's of y")
    for kind in ("moments", "apply"):
        rows = with_calls(split_rows[kind], Counter(SPATIAL_SHAPES), 1)
        by_path = {k: v[kind] for k, v in spatial_paths.items()}
        record["kernels"].append({
            "name": f"modulated_instance_norm_{kind}", "route": "cuda",
            "source": "de_i2i_gan_torch/csrc/modulated_instance_norm.cu",
            "replaces": "de_i2i_gan_tpu/ops/pallas/norm_kernels.py:51",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": split_worst[kind], "unit": split_unit,
            **{k: summed(rows, k) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": summed(rows, "library_ms"),
            "per_spatial_forward": {"calls": sum(r["calls"] for r in rows)},
            "per_call": rows})
    print(f"per super-step ({sum(train_calls['fwd'].values())} forward, "
          f"{sum(train_calls['bwd'].values())} backward calls): forward "
          f"kernel {fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, "
          f"F.instance_norm {fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f}); "
          f"backward kernel {bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, "
          f"autograd of F.instance_norm {bwd['library_ms']:.4f}, bound "
          f"{bwd['bound_ms']:.4f}); super-step {training['ms']:.3f} ms over "
          f"{per_step} super-steps, peak {training['peak_mb']:.1f} MiB, device "
          f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}; serving "
          f"{serving['ms']:.3f} ms (plain path {serving['plain_ms']:.3f} ms), "
          f"peak {serving['peak_mb']:.1f} MiB; G-delta agreement {compare} [{smi}]")

    def busy_ms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    print(f"sean: serving {serving_sean['ms']:.3f} ms a request (plain path "
          f"{serving_sean['plain_ms']:.3f} ms), peak {serving_sean['peak_mb']:.1f} "
          f"MiB, launches {serving_sean['launches']}; training "
          f"{training_sean['ms']:.3f} ms a super-step, peak "
          f"{training_sean['peak_mb']:.1f} MiB, kernels {busy_ms(busy_sean)}, "
          f"launches {training_sean['launches']}; G-delta agreement "
          f"{compare_sean} [{smi}]")
    print(f"spade: serving {serving_spade['ms']:.3f} ms a request, peak "
          f"{serving_spade['peak_mb']:.1f} MiB; training "
          f"{training_spade['ms']:.3f} ms a super-step, peak "
          f"{training_spade['peak_mb']:.1f} MiB, kernels {busy_ms(busy_spade)}; "
          f"launches {serving_spade['launches']} and "
          f"{training_spade['launches']} [{smi}]")
    print(f"sgv2: adain {sgv2_adain['ms']['latent']:.3f} ms a latent-style "
          f"request and {sgv2_adain['ms']['reference']:.3f} ms a reference one "
          f"(batch {SGV2_BATCH}), peak {sgv2_adain['peak_mb']:.1f} MiB, kernels "
          f"{busy_ms(sgv2_adain['dev_ms'])} a request; sean "
          f"{sgv2_sean['ms']:.3f} ms a request, inference_stats "
          f"{sgv2_sean['stats_ms']:.3f} ms, peak {sgv2_sean['peak_mb']:.1f} MiB, "
          f"kernels {busy_ms(sgv2_sean['dev_ms'])}; forward kernel "
          f"{fwd['per_sgv2_forward']['ms']:.4f} ms a G forward (plain "
          f"{fwd['per_sgv2_forward']['plain_ms']:.4f}, F.instance_norm "
          f"{fwd['per_sgv2_forward']['library_ms']:.4f}, bound "
          f"{fwd['per_sgv2_forward']['bound_ms']:.4f}); agreement "
          f"{sgv2_adain['agree']} {sgv2_sean['agree']} [{smi}]")
    fi, bi = fwd["per_sgv2_train_iteration"], bwd["per_sgv2_train_iteration"]
    print(f"sgv2 training (AFHQ, batch {SGV2_TRAIN_BATCH}): AdaIN "
          f"{sgv2_train['ms']:.3f} ms an iteration (kernels "
          f"{busy_ms(sgv2_train['dev_ms'])}), peak {sgv2_train['peak_mb']:.1f} "
          f"MiB; FusedProp {sgv2_fused['ms']:.3f} ms (kernels "
          f"{busy_ms(sgv2_fused['dev_ms'])}), peak {sgv2_fused['peak_mb']:.1f} "
          f"MiB; SEAN {sgv2_train_sean['ms']:.3f} ms (kernels "
          f"{busy_ms(sgv2_train_sean['dev_ms'])}), peak "
          f"{sgv2_train_sean['peak_mb']:.1f} MiB; CLI loader-fed "
          f"{sgv2_cli['ms']:.3f} ms, busy {sgv2_cli['dev_ms'] / sgv2_cli['ms']:.1%}"
          f"; forward kernel {fi['ms']:.4f} ms an iteration ({fi['calls']} calls;"
          f" plain {fi['plain_ms']:.4f}, F.instance_norm {fi['library_ms']:.4f},"
          f" bound {fi['bound_ms']:.4f}); backward kernel {bi['ms']:.4f} ms "
          f"({bi['calls']} calls; plain {bi['plain_ms']:.4f}, autograd of "
          f"F.instance_norm {bi['library_ms']:.4f}, bound {bi['bound_ms']:.4f}); "
          f"gradient agreement {sgv2_agree} [{smi}]")
    fm, bm = fwd["per_mae_super_step"], bwd["per_mae_super_step"]
    fp, bp = fwd["per_sgv2_pretrain_iteration"], bwd["per_sgv2_pretrain_iteration"]
    print(f"MAE pretraining (DefectGAN-256 adain, batch {MAE_BATCH}): "
          f"preloaded super-step {mae['ms']:.3f} ms (kernels "
          f"{busy_ms(mae['dev_ms'])}), peak {mae['peak_mb']:.1f} MiB; CLI "
          f"loader-fed {mae_cli['ms']:.3f} ms, busy "
          f"{mae_cli['dev_ms'] / mae_cli['ms']:.1%}; native feed "
          f"{mae_native['ms']:.3f} ms, busy "
          f"{mae_native['dev_ms'] / mae_native['ms']:.1%}; forward kernel "
          f"{fm['ms']:.4f} ms a super-step ({fm['calls']} calls; plain "
          f"{fm['plain_ms']:.4f}, F.instance_norm {fm['library_ms']:.4f}, bound "
          f"{fm['bound_ms']:.4f}); backward kernel {bm['ms']:.4f} ms ({bm['calls']}"
          f" calls; plain {bm['plain_ms']:.4f}, autograd of F.instance_norm "
          f"{bm['library_ms']:.4f}, bound {bm['bound_ms']:.4f}); StarGAN v2 "
          f"pretrain loader-fed {sgv2_pre['ms']:.3f} ms an iteration, busy "
          f"{sgv2_pre['dev_ms'] / sgv2_pre['ms']:.1%}, peak "
          f"{sgv2_pre['peak_mb']:.1f} MiB, norm kernels {fp['ms']:.4f} + "
          f"{bp['ms']:.4f} ms an iteration [{smi}]")
    print(f"pix2pix (256^2, batch 1, {P2P_IPL} iterations a super-step, bf16): "
          f"train_step super-step {p2p['train_step']['ms']:.3f} ms (kernels "
          f"{busy_ms(p2p['train_step']['dev_ms'])}), peak "
          f"{p2p['train_step']['peak_mb']:.1f} MiB; FusedProp "
          f"{p2p['fused']['ms']:.3f} ms (kernels {busy_ms(p2p['fused']['dev_ms'])}), "
          f"peak {p2p['fused']['peak_mb']:.1f} MiB; remat {p2p['remat']['ms']:.3f}"
          f" ms (kernels {busy_ms(p2p['remat']['dev_ms'])}), peak "
          f"{p2p['remat']['peak_mb']:.1f} MiB; U-Net {p2p['unet']['ms']:.3f} ms "
          f"(kernels {busy_ms(p2p['unet']['dev_ms'])}), peak "
          f"{p2p['unet']['peak_mb']:.1f} MiB; 512^2 {p2p['512']['ms']:.3f} ms, "
          f"peak {p2p['512']['peak_mb']:.1f} MiB; CLI loader-fed "
          f"{p2p_cli['ms']:.3f} ms, busy {p2p_cli['dev_ms'] / p2p_cli['ms']:.1%}; "
          f"native feed {p2p_native['ms']:.3f} ms, busy "
          f"{p2p_native['dev_ms'] / p2p_native['ms']:.1%}; norm-kernel launches 0 "
          f"on every pix2pix path [{smi}]")
    print(f"DefectGAN adain remat (6g, one f32 SGD super-step): launches "
          f"{training_remat['launches']}, peak {training_remat['peak_mb']:.1f} "
          f"MiB against {training_remat['off_peak_mb']:.1f} MiB without [{smi}]")
    print(f"WGAN (64^2, batch {WGAN_BATCH}, 5 critics, bf16): clipping "
          f"super-step {wgan['clipping']['ms']:.3f} ms (kernels "
          f"{busy_ms(wgan['clipping']['dev_ms'])}), peak "
          f"{wgan['clipping']['peak_mb']:.1f} MiB; GP {wgan['gp']['ms']:.3f} ms "
          f"(kernels {busy_ms(wgan['gp']['dev_ms'])}), peak "
          f"{wgan['gp']['peak_mb']:.1f} MiB; norm-kernel launches 0 on every "
          f"WGAN path [{smi}]")
    print(f"frozen nets: ViT-B/16 card vs CPU relative L2 {vit['err']:.3e}, a "
          f"batch-{VIT_BATCH} bf16 request {vit['dev_ms']:.3f} ms on the card, "
          f"peak {vit['peak_mb']:.1f} MiB; StarGAN v2 SEAN with lambda_sty "
          f"{sgv2_vit['ms']:.3f} ms an iteration (kernels "
          f"{busy_ms(sgv2_vit['dev_ms'])}), of which the ViT "
          f"{sgv2_vit['vit_fwd_ms'] + sgv2_vit['vit_bwd_ms']:.3f} ms "
          f"(profiled), peak {sgv2_vit['peak_mb']:.1f} MiB; "
          f"G's lambda_sty gradient agreement {sty_agree}; FAN card vs CPU "
          f"{fan['err']:.3e}, masks of 8 {fan['fan_ms']:.3f} ms; CelebA-HQ "
          f"with the FAN {celeba['ms']:.3f} ms an iteration (kernels "
          f"{busy_ms(celeba['dev_ms'])}), of which the FAN "
          f"{celeba['fan_ms']:.3f} ms (profiled), {celeba['per_forward']} "
          f"forward launches a G forward, {celeba['per_iteration']} an "
          f"iteration, norm kernels "
          f"{fwd['per_sgv2_celeba_iteration']['ms']:.4f} + "
          f"{bwd['per_sgv2_celeba_iteration']['ms']:.4f} ms an iteration "
          f"(bounds {fwd['per_sgv2_celeba_iteration']['bound_ms']:.4f} + "
          f"{bwd['per_sgv2_celeba_iteration']['bound_ms']:.4f}); remat 12c "
          f"spread on vs off {p2p['remat_spread']['on_vs_off']:.3f}, off vs "
          f"off {p2p['remat_spread']['off_vs_off']:.3f}, on vs off again "
          f"{p2p['remat_spread']['on_vs_off_again']:.3f} of the band [{smi}]")
    ff = fwd["per_folder_1024_forward"]
    dg_x, sg_x = export["dg"], export["sg"]
    print(f"deployment: export DefectGAN AdaIN request {dg_x['adain']['ms']:.3f}"
          f" ms (eager {dg_x['adain']['eager_ms']:.3f}), SEAN "
          f"{dg_x['sean']['ms']:.3f} ms (eager {dg_x['sean']['eager_ms']:.3f}),"
          f" StarGAN v2 AdaIN G {sg_x['adain_generator']['ms']:.3f} ms (eager "
          f"{sg_x['adain_generator']['eager_ms']:.3f}), SEANv2 G "
          f"{sg_x['sean_generator']['ms']:.3f} ms (eager "
          f"{sg_x['sean_generator']['eager_ms']:.3f}); folder 1024^2 batch "
          f"{FOLDER_BATCH} {folder['ms']:.3f} ms, "
          f"{FOLDER_BATCH * 1e3 / folder['ms']:.2f} images/s, peak "
          f"{folder['peak_mb']:.1f} MiB, norm kernels {ff['ms']:.4f} ms a G "
          f"forward (bound {ff['bound_ms']:.4f}, F.instance_norm "
          f"{ff['library_ms']:.4f}); op host cost {ops['op_us']:.2f} us a call "
          f"(wrapper {ops['wrapper_us']:.2f}, device {ops['op_device_us']:.2f}); "
          f"metric nets card vs CPU {metric_nets['inception_err']:.3e} / "
          f"{metric_nets['lpips_err']:.3e}, Inception batch {INCEPTION_BATCH} "
          f"{metric_nets['request_ms']:.3f} ms (TF32 off "
          f"{metric_nets['request_fp32_ms']:.3f}) [{smi}]")
    for rec in record["kernels"][2:]:
        print(f"{rec['name']} a rank's G forward of --spatial {SPATIAL} at "
              f"{FOLDER_IMAGE}^2 ({rec['per_spatial_forward']['calls']} calls): "
              f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%}), plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms; "
              f"launches {rec['launches']} [{smi}]")
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s, of which phases "
          f"8a-8f {cli_s:.1f} s, 9a-9c {sgv2_s:.1f} s, 10a-10d {train_s:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in split.items())}), 11 "
          f"{mae_s:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in mae_split.items())}), "
          f"12 {p2p_s:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in p2p_split.items())}), "
          f"13 {wgan_s:.1f} s, 14 {vit_s:.1f} s, 15 {fan_s:.1f} s, 16 "
          f"{deploy_s:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in deploy_split.items())}), "
          f"17 {metrics_s:.1f} s, 18 {dp_s:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in dp_split.items())}), "
          f"19 {spatial_s:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in spatial_split.items())})")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
