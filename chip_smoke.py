#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``dinomc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its results on lines of its own; any failure raises and the
script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` from ``dinomc_tpu_torch/csrc``, timed);
2. attention K1 (forward) and K2 (backward) against their plain version
   on the card, in bf16, at the main paths' shapes (phase 4's and phase
   12's) and a few small ones;
   K2's gradients bit-identical on a repeated call; K1 and K2 timed with
   and without the host's cost, K2 also as its two launches (dQ, dK/dV)
   beside SDPA's dq and dk/dv;
3. photometric K3 against its plain version at 224 and 84 px, with rows
   that cover every branch, the flip applied and not; bit-identical on a
   repeat; timed with the flip, as the DINO step calls it, at every crop
   size of the step (224 and 184 ... 84 px), with and without the host's
   cost;
4. the real entry point, ``dinomc_tpu_torch.cli.train_dino.train_dino``,
   for 5 ViT-S/8 steps (out_dim 65536, batch 8, synthetic images, weights
   from a seed), with every kernel's launch count over that run;
5. long-sequence attention K4 (forward), K5 (dQ) and K6 (dK/dV) against
   their plain version on the card, in bf16, at the segmentation path's
   shapes (4097 tokens at 512 px, patch 8), past the TPU kernel's 5120 cap,
   and a few ragged small ones; K5's dQ and delta and K6's dK/dV
   bit-identical on a repeated call; K4 and K5 timed with and without the
   host's cost;
6. the segmentation entry point, ``dinomc_tpu_torch.cli.train_seg.train_seg``,
   twice at the published widths (ViT-S/8 UPerNet, 512 px, batch 4, 8 UAVid
   classes, synthetic data, weights from a seed): decoder-only and with the
   backbone trained, 4 steps and a validation pass each, with the kernels'
   launch counts over each run;
7. Swin window attention K7 (forward) and K8 (backward, dbias included)
   against their plain version on the card, in bf16, at the four stage
   shapes of Swin-T at 224 px (16 images), the 184 px stage-1 shape (shift +
   pad masks), the 84 px stage-4 shape (a pad-only mask), a ragged small
   one and the four stage shapes of phase 12's fine-tune (32 images); K7's output and K8's gradients bit-identical on a repeated call;
   every 224 px stage timed as kernel, plain version and
   ``F.scaled_dot_product_attention`` with the float mask bias + mask, on
   the device and, apart, with the host's launch cost in;
8. the pretraining entry point again, for 5 Swin-T steps (``--arch swin_t``,
   out_dim 65536, batch 8), with K3, K7 and K8 launched exactly as often as
   the configuration implies and no other kernel launched;
9. the fused MLP K11 against its plain version on the card, in bf16, at the
   DINO step's row counts at ViT-S, at ViT-B and ViT-Ti widths and a ragged
   small M, both GELU forms, its gradients (a plain backward) equal to the
   plain route's bit for bit; timed at every ViT-S row count beside the
   dense ``F.linear``, ``F.gelu``, ``F.linear`` chain and with the host's
   cost, and at the 224 px globals beside the plain version;
10. the head-stacked window attention K9 (forward) and K10 (backward) against
   their plain version at phase 7's shapes, K10's gradients bit-identical on
   a repeated call; each 224 px stage timed beside
   K7/K8 (phase 7's plain, SDPA and bound columns apply); then its main path,
   ``window_attention(..., variant='stacked')`` through autograd over the 12
   Swin-T blocks' shapes at 224 px (16 images), as the JAX package's callers
   reach it: by a direct call (no model names the variant);
11. the ViT-S/8 DINO step with ``mlp_impl='fused'`` (out_dim 65536, batch 8,
   weights from a seed): 5 steps of the trainer's step function with K11 on
   teacher and student, against the same 5 steps with the dense MLP from the
   same weights, images and draws; then the step under no remat and the
   ``full``, ``attn`` and ``qkv+attn+mlp`` policies, both MLP forms: step
   time, peak memory and K1/K2/K11 launches a step against what the policy
   implies;
12. classification and feature evaluation (weights from a seed, images
   made on the card): 5 ViT-S/8 fine-tune steps (``cls_train_step``, SGD,
   224 px crops of 256 px images through the EuroSAT transform, B = 32, 10
   classes), then 3 with the backbone frozen (bit-identical, no K2), then 3
   Swin-T steps (K7/K8, no K1/K2), each kernel launched exactly as the
   configuration implies, the first step of each untimed; frozen ViT-S/8
   features of 512 + 256 images at 224 px (K1 forward only), their k-NN
   (k 10, 20; bit-identical on a repeat, and the same labels as
   ``knn_predict`` on the CPU) and a 50-epoch linear probe; then the entry
   point ``dinomc_tpu_torch.cli.eurosat``: in its four modes on
   ``--data_path synthetic`` (64 px): train (2 steps), ``--evaluate_knn``,
   ``--evaluate_probe`` and ``--evaluate`` of the best checkpoint the first
   wrote; and once on an ImageFolder tree of 256 px PNGs written from a seed
   (decode, bicubic resize to 256, train crops and val centre crops at
   224 px, a val remainder batch);
13. the convnets: ``train_dino`` for 5 ResNet-50 steps and 2 WRN-50-2 steps
   with LARS and BatchNorm in the head (out_dim 65536, batch 8, the DINO
   convnet recipe's lr 0.3 and weight decay 1e-6, synthetic images, weights
   from a seed): finite losses, the student's convolutions moved, the
   teacher followed by EMA, both BatchNorm states moved
   (``num_batches_tracked`` once a crop-size bucket a step in the student,
   once a step in the teacher), K3 8 launches a step and no other kernel;
   then ``cli.eurosat --arch resnet50`` in its four modes on
   ``--data_path synthetic``, then 3 ResNet-50 ``cls_train_step``s at 224 px,
   B = 32, and 3 with the backbone frozen (its parameters bit-identical, its
   running statistics moved), launching no kernel of the table;
14. full-resolution segmentation inference and OSCD change detection: a
   3840 x 2160 frame made on the card (weights of ViT-S/8 UPerNet, 512
   channels, pool scales 1/2/3/6, 8 UAVid classes, from a seed) through
   ``eval.tiled_inference.tiled_predict`` at 224 px tiles (2 x 2 and 3 x 3,
   K1 at B = 4 and 9, phase 2 holding K1 against its plain version there)
   and 512 px tiles (2 x 2, K4 at B = 4, phase 5's first shape): K1, or K4,
   launched exactly once a ViT layer a call and no backward kernel, a finite
   canvas, each frame's CUDA-event ms and peak memory; ``evaluate_tiled``'s
   mIoU equal to the mIoU of the confusion matrix of the argmax of the same
   logits; the entry points ``cli.evaluate_stitched`` on a tree of two 3840
   x 2160 PNG pairs with ``--export_logits_dir`` (``stitch_from_files``
   rebuilds each frame's canvas bit for bit) and ``cli.predict`` with
   ``--grid 2 2`` and a ``train_seg`` checkpoint directory written in the
   phase (one 224 px step) as ``--ckpt``; then ``cli.oscd`` on change pairs
   from ``utils/synthetic.make_change_pair`` (two train cities and one val
   city of the official split, 384 px, so one step of 32 96 px tiles an
   epoch), ResNet-50 with the encoder frozen for 2 epochs (its parameters
   and running statistics bit-identical, the decoder moved, finite F1,
   panels written, the warm step's ms), a rerun that resumes from the best
   checkpoint, and 2 steps with the encoder trained (every encoder
   parameter moved by the optimizer, the running statistics moved, each
   BatchNorm's ``num_batches_tracked`` 2 a step); OSCD launches no kernel
   of the table;
15. XCiT and BigEarthNet: ``train_dino`` for 5 XCiT-S/8 steps and 2
   XCiT-M/8 steps (out_dim 65536, batch 8, the default crops, AdamW,
   synthetic images, weights from a seed): finite losses, the student moved,
   the teacher followed by EMA, K3 8 launches a step and no other kernel
   (XCiT reaches no attention kernel); one XCiT-S/8 step with remat off,
   ``full`` and ``branches`` from the same weights, images and draws (loss
   within ``LOSS_RTOL`` of ``full``'s, step ms and peak memory); 3 XCiT-S/8
   ``cls_train_step``s at 224 px, B = 32, and 3 with the backbone frozen
   (bit-identical), no kernel launched; then the entry point
   ``dinomc_tpu_torch.cli.bigearthnet`` on a BigEarthNet patch-folder tree
   written in the phase (72 patches of 120 px B02/B03/B04 PNGs and CLC
   labels; 2 train steps of 32 and a val pass of 32, 32 and 8) for
   ResNet-50, XCiT-S/8 and ViT-S/8: a micro-mAP in [0, 100], and for the
   ViT K1 12 and K2 12 a train step and K1 12 a val batch (phase 2 holds K1
   and K2 against their plain version at 226 tokens, B = 32 and 8);
16. DINO-TP, multispectral bands, packed corpora and gradient
   accumulation: K3 against its plain version at the TP shape (B = 8, 256
   px, identity normalize, the flip on half the rows; phase 3's tolerance,
   bit-identical on a repeat; timed as device time and with the host's
   cost); ``train_dino --data_mode tp`` for 5 ViT-S/8 steps (synthetic
   temporal images, out_dim 65536, B = 8: K1 60, K2 48 and K3 2 a step);
   ``cli.pack_data`` on a SeCo tree of 256 px PNGs (16 locations x 3
   timestamps) written in the phase, then 2 TP steps and 2 MC steps on the
   packed corpus (uint8 batches); 2 MC and 2 TP steps with ``--bands B4 B3
   B2`` on a tree of uint16 per-band TIFFs (8 locations x 2 timestamps; the
   band reader that ran is printed); one ``dino_train_step_accum`` at A = 2
   against one ``dino_train_step`` from the same weights and crops (bf16,
   SGD, no DropPath, clipping or weight decay; tests/test_dino_train_step.py's
   bounds, half the trained leaves' big-batch change ``ACCUM_MIN_REACH``
   times them; K1 120 and K2 96 at A = 2); one bf16 step at A = 1, 2, 4 (peak memory must fall with
   A); ``train_dino --grad_accum_steps 2`` for 2 steps each of ViT-S/8,
   ResNet-50 (LARS, BN head) and XCiT-S/8. No view of these runs goes
   through the plain photometric version.

Then one JSON line with each kernel's launches (K1's and K4's with phase
14's, K1's, K2's and K3's with phases 15 and 16's; K3's error the worse of
phases 3 and 16), error, times, bound and library time, and as the last
line ``{"ok": true, "device": {...}}``. With no CUDA device it exits with 1
and prints no result.

Every time in that line is device time: CUDA events around 10 calls
(after 2 warm-up calls) queued behind a spin kernel (``torch.cuda._sleep``)
that holds the card until the host has issued them all, so the card runs
them back to back and the host's cost of issuing them is not in it; the
script checks that the card was still spinning when the last call was
queued, and fails if it never was. A ``host_`` time is CUDA
events around 10 calls issued back to back with no spin kernel, so it also
holds the host's cost of issuing them where that exceeds the device's
(phases 2, 3, 5, 7 and 9; K1, K2, K4, K5, K6, K7, K8, K10 and K11 encode
their TMA tensor maps on the host at every call).

Each kernel's bound is the least time the card could take for the work:
the larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and its operations over the peak rate of their
type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them),
from the H100 SXM data sheet. Its library time is one PyTorch call that
computes the same function, timed here and used nowhere in the port.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Tolerances, kernel against its plain version on the same inputs:
# attention outputs are rounded to bf16 (2^-8 relative) and the kernels also
# round P to bf16 before the PV product (and dS before dQ/dK), at different
# points than the plain version does; forward |diff| <= 1e-2 absolute and
# gradients max|diff| / max|ref| <= 2e-2 leave room for that and no more.
ATTN_FWD_ATOL = 1e-2
ATTN_GRAD_RTOL = 2e-2
# photometric: f32 both sides; the slack is FMA contraction and the order of
# the mean-gray reduction, amplified by up to 1/0.225 in the normalize.
PHOTO_ATOL = 1e-4
# fused MLP, max|diff| / max|ref|: both sides accumulate in f32 and round the
# GELU'd hidden and the output to bf16 once each; a different f32 summation
# order can flip one rounding, one bf16 ulp (2^-8 = 3.9e-3 relative) of the
# output, and 1e-2 leaves room for that and no more.
MLP_RTOL = 1e-2
# The DINO loss with the fused MLP against the dense one, per step, relative:
# the two round the (M, F) hidden activation at different places (dense:
# x W1^T + b1 to bf16 before GELU; fused: after GELU), about 2^-9 relative an
# element in 12 layers; the features move by ~1e-3 relative and the loss
# (about ln 65536 = 11.1 at the start) by less. 5e-3 is about one bf16 ulp
# of the loss.
LOSS_RTOL = 5e-3

ATTN_SHAPES = [  # (what, B, N, heads, head_dim, boundary)
    ("global 224px", 16, 785, 6, 64, 0),
    ("packed 184+84 px", 8, 631, 6, 64, 530),
    ("packed 164+124 px", 8, 627, 6, 64, 401),
    ("packed 144+104 px", 8, 495, 6, 64, 325),
    ("single 84px", 8, 101, 6, 64, 0),
    ("ragged small", 2, 70, 2, 32, 33),
    ("ragged d16", 3, 50, 4, 16, 0),
    # phase 12: the fine-tune and the CLI's 224 px train batch, the feature
    # batch, the CLI's val remainder at 224 px, its 64 px synthetic batch
    ("EuroSAT fine-tune", 32, 785, 6, 64, 0),
    ("EuroSAT feature batch", 64, 785, 6, 64, 0),
    ("EuroSAT val remainder", 8, 785, 6, 64, 0),
    ("EuroSAT CLI 64 px", 32, 65, 6, 64, 0),
    # phase 14: the tiles of a 3840 x 2160 frame at 224 px, 2 x 2 and 3 x 3
    ("4K tiles 2 x 2 at 224 px", 4, 785, 6, 64, 0),
    ("4K tiles 3 x 3 at 224 px", 9, 785, 6, 64, 0),
    # phase 15: the BigEarthNet ViT-S/8 fine-tune at 120 px (15 x 15 patches),
    # its train and val batches of 32 and the val remainder of 8
    ("BigEarthNet 120 px", 32, 226, 6, 64, 0),
    ("BigEarthNet val remainder", 8, 226, 6, 64, 0),
]
TRAIN_ARGS = [
    "--arch", "vit_small", "--patch_size", "8", "--out_dim", "65536",
    "--batch_size_per_gpu", "8", "--data_path", "synthetic", "--max_steps", "5",
    "--device", "cuda", "--print_freq", "1", "--num_workers", "4",
]
LONG_SHAPES = [  # (what, B, N, heads, head_dim); the first is timed
    # the seg fine-tune's batch, and phase 14's 2 x 2 tiles at 512 px
    ("ViT-S/8 at 512 px", 4, 4097, 6, 64),
    ("ViT-S/16 at 512 px", 4, 1025, 6, 64),
    ("ViT-S/8 at 600 px", 2, 5626, 6, 64),
    ("ragged d32", 1, 1100, 2, 32),
    ("ragged d16", 1, 1030, 4, 16),
]
SEG_STEPS = 4
# the DINO step's crop sizes at B = 8: K3 is checked at the first and the
# last, timed at all
PHOTO_SIZES = (224, 184, 164, 144, 124, 104, 84)
SWIN_SHAPES = [  # (what, windows, heads, map side, shift); the first four are timed
    ("stage 1, 224 px", 1024, 3, 56, 3),
    ("stage 2, 224 px", 256, 6, 28, 3),
    ("stage 3, 224 px", 64, 12, 14, 3),
    ("stage 4, 224 px", 16, 24, 7, 0),
    ("stage 1, 184 px", 8 * 49, 3, 46, 3),
    ("stage 4, 84 px", 8, 24, 3, 0),
    ("ragged small", 8, 2, 10, 3),
    # phase 12's Swin-T fine-tune: 32 images at 224 px
    ("stage 1, 224 px, B = 32", 2048, 3, 56, 3),
    ("stage 2, 224 px, B = 32", 512, 6, 28, 3),
    ("stage 3, 224 px, B = 32", 128, 12, 14, 3),
    ("stage 4, 224 px, B = 32", 32, 24, 7, 0),
]
MLP_SHAPES = [  # (what, M, D, F); the first is timed
    ("ViT-S/8 globals, 2 x 8 at 224 px", 12560, 384, 1536),
    ("packed 184+84 px", 5048, 384, 1536),
    ("packed 164+124 px", 5016, 384, 1536),
    ("packed 144+104 px", 3960, 384, 1536),
    ("84 px alone", 808, 384, 1536),
    ("ViT-B/8 globals", 12560, 768, 3072),
    ("ragged small, ViT-Ti width", 70, 192, 768),
]
# Swin-T's 12 blocks at 224 px over 16 images: (windows, heads, map side,
# shift); the odd block of each stage is shifted (stage 4's 7 x 7 map is one
# window and never shifts)
SWIN_BLOCKS = ([(1024, 3, 56, 0), (1024, 3, 56, 3), (256, 6, 28, 0), (256, 6, 28, 3)]
               + [(64, 12, 14, 0), (64, 12, 14, 3)] * 3 + [(16, 24, 7, 0)] * 2)
REMAT_RUNS = [None, "full", "attn", "qkv+attn+mlp"]  # None: ViTConfig.remat=False
# phase 12: the EuroSAT fine-tune at 224 px (crops of 256 px images), B = 32,
# 10 classes; steps of the ViT-S/8, of its frozen backbone, of Swin-T (the
# first of each is a warm-up, not timed); the frozen-feature sets of the
# k-NN and the probe; the ImageFolder tree's images a class (train, val):
# one train batch of 32, val batches of 32 and 8
CLS_B, CLS_RAW, CLS_SIZE, CLS_CLASSES = 32, 256, 224, 10
CLS_STEPS, CLS_FROZEN_STEPS, CLS_SWIN_STEPS = 5, 3, 3
FEAT_TRAIN, FEAT_VAL, FEAT_BATCH = 512, 256, 64
TREE_TRAIN, TREE_VAL = 4, 4
CLS_CLI_ARGS = [
    "--data_path", "synthetic", "--arch", "vit_small", "--patch_size", "8", "--epochs", "1",
    "--max_steps", "2", "--device", "cuda", "--print_freq", "1",
]
CLS_TREE_ARGS = [
    "--arch", "vit_small", "--patch_size", "8", "--epochs", "1", "--device", "cuda",
    "--print_freq", "1",
]
SWIN_TRAIN_ARGS = [
    "--arch", "swin_t", "--out_dim", "65536", "--batch_size_per_gpu", "8",
    "--data_path", "synthetic", "--max_steps", "5", "--device", "cuda",
    "--print_freq", "1", "--num_workers", "4",
]
# phase 13: the DINO convnet recipe (LARS, BN in the head, base lr 0.3
# linearly scaled, weight decay 1e-6) from the first step: no warm-up, so a
# 5-step run moves LARS's trust-ratio-sized updates above f32 resolution
RESNET_TRAIN_ARGS = [
    "--arch", "resnet50", "--optimizer", "lars", "--use_bn_in_head", "true",
    "--out_dim", "65536", "--batch_size_per_gpu", "8", "--lr", "0.3",
    "--warmup_epochs", "0", "--weight_decay", "1e-6", "--weight_decay_end", "1e-6",
    "--data_path", "synthetic", "--max_steps", "5", "--device", "cuda",
    "--print_freq", "1", "--num_workers", "4",
]
WRN_STEPS = 2
RESNET_CLS_STEPS = 3
# phase 14: a 3840 x 2160 UAVid-sized frame through ViT-S/8 UPerNet (512
# channels, pool scales 1/2/3/6, 8 classes), tiled as (model size, grid):
# 224 px tiles (K1 at B = 4 and 9, 785 tokens) and 512 px tiles (K4 at B = 4,
# 4097 tokens); each path timed over TILED_REPEATS calls after a warm one
FRAME_H, FRAME_W = 2160, 3840
TILED_RUNS = [(224, (2, 2)), (224, (3, 3)), (512, (2, 2))]
TILED_REPEATS = 3
STITCHED_FRAMES = 2
# OSCD: ResNet-50, 96 px tiles, batch 32; two train cities and one val city
# of 384 x 384 change pairs (16 tiles each), so an epoch is one step of 32
OSCD_SIDE, OSCD_TILE, OSCD_B = 384, 96, 32
OSCD_ARGS = [
    "--device", "cuda", "--backbone", "resnet50", "--batch_size", str(OSCD_B), "--epochs", "2",
    "--max_steps", "2", "--print_freq", "1", "--panel_samples", "4",
]
# phase 15: XCiT DINO-MC pretraining (the ViT's crops, batch and head) and
# the BigEarthNet-19 fine-tune on a patch-folder tree of 120 px band PNGs:
# 72 patches at B = 32, so 2 train steps (the last 8 dropped) and val
# batches of 32, 32 and 8
XCIT_TRAIN_ARGS = [
    "--arch", "xcit_small_12", "--patch_size", "8", "--out_dim", "65536",
    "--batch_size_per_gpu", "8", "--data_path", "synthetic", "--max_steps", "5",
    "--device", "cuda", "--print_freq", "1", "--num_workers", "4",
]
XCIT_M_STEPS, XCIT_CLS_STEPS = 2, 3
XCIT_REMAT_RUNS = [(False, "full"), (True, "full"), (True, "branches")]  # (remat, policy)
BEN_PATCHES, BEN_SIZE, BEN_B, BEN_STEPS = 72, 120, 32, 2
BEN_ARGS = [
    "--device", "cuda", "--epochs", "1", "--max_steps", str(BEN_STEPS),
    "--batch_size_per_gpu", str(BEN_B), "--print_freq", "1",
]
BEN_ARCHS = [("resnet50", []), ("xcit_small_12", []), ("vit_small", ["--patch_size", "8"])]
# phase 16: DINO-TP (K3 on two full 256 px views a step, identity normalize),
# a packed SeCo tree of 256 px PNGs (locations x timestamps), a tree of
# uint16 per-band TIFFs, and gradient accumulation (A = 2 against the big
# batch at the JAX test's bounds: SGD, no DropPath, a scaled lr of 1e-3 from
# the first step; peak memory at each A)
TP_PHOTO_B, TP_PHOTO_S = 8, 256
TP_LOCATIONS, TP_STAMPS = 16, 3
BAND_LOCATIONS, BAND_STAMPS = 8, 2
TP_BANDS = ["B4", "B3", "B2"]
# the A = 2 against big-batch check: the update is the gradient's alone (no
# clipping, no weight decay, the last layer trained), and at least half the
# trained leaves move by ACCUM_MIN_REACH times the parameters' bound somewhere
# (lr 0.064 / 256 * 8; the bf16 difference of the two steps grows with lr)
ACCUM_SGD_ARGS = ["--optimizer", "sgd", "--drop_path_rate", "0", "--warmup_epochs", "0",
                  "--lr", "0.064", "--clip_grad", "0", "--weight_decay", "0",
                  "--weight_decay_end", "0", "--freeze_last_layer", "0"]
ACCUM_MIN_REACH = 4.0
ACCUM_RUNS = (1, 2, 4)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEG_ARGS = [
    "--device", "cuda", "--dataset", "uavid", "--data_root", "synthetic",
    "--arch", "vit_small", "--patch_size", "8", "--image_size", "512",
    "--batch_size", "4", "--max_steps", str(SEG_STEPS), "--epochs", "1",
    "--print_freq", "1",
]


_SPIN_CYCLES_PER_MS = []


def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` a millisecond, read once."""
    if not _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / a.elapsed_time(b))
    return _SPIN_CYCLES_PER_MS[0]


def _time_ms(torch, fn, iters=10, warmup=2, tries=5) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel twice as long as the host took to issue
    them, so the card runs them back to back. Valid only if the card was
    still spinning when the last call was queued; else it tries again with
    a longer spin and half the calls, and raises after ``tries``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / iters  # a call, on the host
    torch.cuda.synchronize()
    for attempt in range(tries):
        spin_ms = 2 ** (attempt + 1) * issue_ms * iters + 1.0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms(torch)))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        queued = not a.query()  # the card is still spinning: nothing ran yet
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / iters
        iters = max(1, iters // 2)
    raise AssertionError("the host never got ahead of the card: a timed call syncs with it")


def _host_ms(torch, fn, iters=10, warmup=2) -> float:
    """ms of one call of ``fn`` between CUDA events around ``iters`` calls:
    device time, or the host's cost of issuing them where that is larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _fmt(times: dict) -> str:
    """``key value`` pairs of a phase's times; a bound prints as ms (what)."""
    return "  ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v[0]:.4f} ({v[1]})"
                     for k, v in times.items())


def _bound(nbytes: float, flops: float, peak: float):
    """(least ms, what bounds it) for work that moves ``nbytes`` and does
    ``flops`` operations at the ``peak`` rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_times(torch, q, k, v, do, attn_mask=None, timer=_time_ms):
    """Forward and backward ms of ``F.scaled_dot_product_attention`` over
    (B, h, N, d) inputs: the library yardstick of an attention kernel. The
    backward's times are for all of dq, dk, dv (and the mask's gradient
    when the mask requires it), and for dq alone and dk, dv alone."""
    F = torch.nn.functional
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, attn_mask=attn_mask)
    wrt = xs + ([attn_mask] if attn_mask is not None and attn_mask.requires_grad else [])
    fixed = None if attn_mask is None else attn_mask.detach()
    return {
        "fwd": timer(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=fixed)),
        "bwd": timer(torch, lambda: torch.autograd.grad(out, wrt, do, retain_graph=True)),
        "dq": timer(torch, lambda: torch.autograd.grad(out, xs[0], do, retain_graph=True)),
        "dkv": timer(torch, lambda: torch.autograd.grad(out, xs[1:], do, retain_graph=True)),
    }


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    from dinomc_tpu_torch.ops.hopper import _build

    path, seconds = _build.build()
    _build.library()
    print(f"[build] {path.name}: nvcc {seconds:.1f} s")
    return smi


def phase_attention(torch):
    from dinomc_tpu_torch.ops.hopper.attention import (
        attention_bwd, attention_bwd_dkv, attention_bwd_dq, attention_fwd, fused_mha,
        fused_mha_reference,
    )

    worst_fwd, worst_grad, worst_grad_rel, timing = 0.0, 0.0, 0.0, None
    for i, (what, B, N, h, d, boundary) in enumerate(ATTN_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        qkv = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, N, h, d, generator=gen, device="cuda").bfloat16()
        scale = 1.0 / math.sqrt(d)

        qkv_k = qkv.clone().requires_grad_()
        out = fused_mha(*qkv_k.unbind(2), scale, boundary)
        (g_k,) = torch.autograd.grad(out, qkv_k, do)
        torch.cuda.synchronize()
        qkv_r = qkv.clone().requires_grad_()
        ref = fused_mha_reference(*qkv_r.unbind(2), scale, boundary)
        (g_r,) = torch.autograd.grad(ref, qkv_r, do, retain_graph=True)
        torch.cuda.synchronize()

        fwd_err = (out.float() - ref.float()).abs().max().item()
        grad_err = (g_k.float() - g_r.float()).abs().amax(dim=(0, 1, 3, 4))
        grad_rel = (grad_err / g_r.float().abs().amax(dim=(0, 1, 3, 4))).max().item()
        # K2 is deterministic (no atomics): a second call on the same inputs
        # gives the same bits
        q, k, v = qkv.unbind(2)
        o, lse = attention_fwd(q, k, v, scale, boundary)
        first, again = (attention_bwd(q, k, v, o, lse, do, scale, boundary) for _ in range(2))
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"[attention] {what}: B={B} N={N} h={h} d={d} boundary={boundary}  "
              f"fwd max|diff| {fwd_err:.3e}  dq/dk/dv max abs {grad_err.tolist()}  "
              f"max rel {grad_rel:.3e}  backward bit-identical on a repeat: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and grad_rel <= ATTN_GRAD_RTOL and same):
            raise AssertionError(f"attention kernel disagrees with its plain version at {what}")
        worst_fwd = max(worst_fwd, fwd_err)
        worst_grad = max(worst_grad, grad_err.max().item())
        worst_grad_rel = max(worst_grad_rel, grad_rel)

        if i < 5:  # main-path shapes: time kernel against plain
            _, delta = attention_bwd_dq(q, k, v, o, lse, do, scale, boundary)
            t = {
                "fwd_ms": _time_ms(torch, lambda: attention_fwd(q, k, v, scale, boundary)),
                "fwd_plain_ms": _time_ms(torch, lambda: fused_mha_reference(q, k, v, scale, boundary)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_fwd_ms": _host_ms(torch, lambda: attention_fwd(q, k, v, scale, boundary)),
                "bwd_ms": _time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do, scale, boundary)),
                # K2's two launches apart: dQ (and delta), then dK/dV
                "dq_ms": _time_ms(torch, lambda: attention_bwd_dq(
                    q, k, v, o, lse, do, scale, boundary)),
                "dkv_ms": _time_ms(torch, lambda: attention_bwd_dkv(
                    q, k, v, lse, delta, do, scale, boundary)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_bwd_ms": _host_ms(torch, lambda: attention_bwd(
                    q, k, v, o, lse, do, scale, boundary)),
                "bwd_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, qkv_r, do, retain_graph=True)),
            }
            if timing is None:  # the first shape: the library's time and the bound too
                lib = _sdpa_times(torch, *(x.transpose(1, 2).contiguous() for x in (q, k, v, do)))
                t.update(fwd_library_ms=lib["fwd"], bwd_library_ms=lib["bwd"],
                         dq_library_ms=lib["dq"], dkv_library_ms=lib["dkv"])
                elems, prod = B * N * h * d, B * h * N * N * d  # boundary 0: every key live
                t["fwd_bound"] = _bound(4 * elems * 2 + B * h * N * 4, 4 * prod, BF16_FLOPS)
                t["bwd_bound"] = _bound(8 * elems * 2 + B * h * N * 4, 10 * prod, BF16_FLOPS)
                timing = t
            print(f"[attention] {what} times: {_fmt(t)}")
        del qkv_r, ref, g_r
    print(f"[attention] worst: fwd max|diff| {worst_fwd:.3e} (bound {ATTN_FWD_ATOL}), grad "
          f"max|diff| {worst_grad:.3e}, max rel {worst_grad_rel:.3e} (bound {ATTN_GRAD_RTOL})")
    return worst_fwd, worst_grad, timing


def _branch_rows(torch, B, S):
    from dinomc_tpu_torch.ops.hopper import augment as ha

    gen = torch.Generator(device="cuda").manual_seed(7 + S)
    rows = ha.draw_photometric_params(gen, B, (0.8, 0.8, 0.8, 0.2), 0.5, 0.5, 0.5, 0.5, device="cuda")
    flags = torch.tensor([  # jitter, gray, blur, solarize, flip per sample
        [1, 0, 1, 0, 1], [0, 0, 1, 1, 0], [1, 1, 0, 0, 1], [0, 1, 0, 1, 0],
        [1, 0, 1, 1, 0], [0, 0, 0, 0, 1], [1, 0, 0, 0, 0], [1, 1, 1, 1, 1],
    ], dtype=torch.float32, device="cuda")[:B]
    rows[:, [ha.P_JIT, ha.P_GRAY, ha.P_BLUR, ha.P_SOL, ha.P_FLIP]] = flags
    return rows


def phase_photometric(torch):
    from dinomc_tpu_torch.ops.hopper import augment as ha

    worst, timing = 0.0, None
    for S in PHOTO_SIZES:
        B = 8
        gen = torch.Generator(device="cuda").manual_seed(S)
        imgs = torch.rand(B, 3, S, S, generator=gen, device="cuda")
        rows = _branch_rows(torch, B, S)
        if S in (PHOTO_SIZES[0], PHOTO_SIZES[-1]):
            for flip in (False, True):
                for mean, std in ((ha.IMAGENET_MEAN, ha.IMAGENET_STD), ((0.0,) * 3, (1.0,) * 3)):
                    out = ha.photometric_kernel(imgs, rows, mean, std, flip)
                    again = ha.photometric_kernel(imgs, rows, mean, std, flip)
                    torch.cuda.synchronize()
                    ref = ha.photometric_reference(imgs, rows, mean, std, flip)
                    err = (out - ref).abs().max().item()
                    same = torch.equal(out, again)
                    print(f"[photometric] S={S} B={B} flip={flip} mean={mean}: max|diff| "
                          f"{err:.3e}  bit-identical on a repeat: {same}")
                    if not (err <= PHOTO_ATOL and same):
                        raise AssertionError(f"photometric kernel disagrees with its plain "
                                             f"version at S={S} flip={flip}")
                    worst = max(worst, err)
        # as the DINO step calls it, the flip inside; ~30 f32 operations a
        # pixel, ~110 with the blur (csrc/photometric.cu)
        blurred = int(rows[:, ha.P_BLUR].sum().item())
        flops = S * S * (110 * blurred + 30 * (B - blurred))
        t = {
            "ms": _time_ms(torch, lambda: ha.photometric_kernel(imgs, rows, flip=True)),
            "plain_ms": _time_ms(torch, lambda: ha.photometric_reference(imgs, rows, flip=True)),
            # with the host's cost of issuing (two launches a call)
            "host_ms": _host_ms(torch, lambda: ha.photometric_kernel(imgs, rows, flip=True)),
            "bound": _bound(2 * imgs.numel() * 4 + rows.numel() * 4, flops, F32_FLOPS),
        }
        print(f"[photometric] S={S} B={B} flip=True times: {_fmt(t)}")
        if timing is None:  # the timed shape: the 224 px globals
            timing = t
    return worst, timing


def _train_run(torch, smi, train_args, tag, steps=5, want=None, batch_dtype=None):
    """One ``train_dino`` run of ``steps`` steps: checks the losses, that the
    student trained and the teacher followed by EMA, that no view went
    through the plain photometric version, the launches against ``want``
    and every augmentation batch's dtype against ``batch_dtype`` (each when
    given), and prints the step times. Returns (launches over the run, crop
    config, config, final state, initial state)."""
    from dinomc_tpu_torch.cli.train_dino import build_config, get_args_parser, train_dino
    from dinomc_tpu_torch.ops import augment as aug
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.ops.hopper import augment as ha
    from dinomc_tpu_torch.train.dino_trainer import init_dino_train_state

    seen, real = [], {name: getattr(aug, name) for name in ("multicrop_augment",
                                                            "multicrop_augment_tp")}

    def spy(name):
        def call(images, *args, **kwargs):
            seen.append((name, images.dtype, tuple(images.shape)))
            return real[name](images, *args, **kwargs)
        return call

    def refuse(*args, **kwargs):
        raise AssertionError("a view went through the plain photometric version on the card")

    plain = ha.photometric_reference
    with tempfile.TemporaryDirectory() as out_dir:
        args = get_args_parser().parse_args(train_args + ["--output_dir", out_dir])
        for name in real:
            setattr(aug, name, spy(name))
        ha.photometric_reference = refuse
        try:
            torch.cuda.reset_peak_memory_stats()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            summary = train_dino(args)
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
        finally:
            for name, fn in real.items():
                setattr(aug, name, fn)
            ha.photometric_reference = plain
    kinds = sorted({(name, str(dt), shape) for name, dt, shape in seen})
    print(f"[{tag}] losses {summary.losses}; batches {kinds}")
    print(f"[{tag}] launches over the run: {launches}")
    if len(summary.losses) != steps or not all(math.isfinite(x) for x in summary.losses):
        raise AssertionError(f"expected {steps} finite losses, got {summary.losses}")
    if batch_dtype is not None and any(dt != batch_dtype for _, dt, _ in seen):
        raise AssertionError(f"{tag}: batches {kinds}, expected {batch_dtype}")
    if want is not None:
        _check_launches(tag, launches, want)

    mc_cfg, cfg = build_config(args, 1)
    init = init_dino_train_state(cfg, args.seed, "cuda")
    st = summary.state
    moved = max((a - b).abs().max().item() for a, b in
                zip(st.student.parameters(), init.student.parameters()))
    ema = max((a - b).abs().max().item() for a, b in
              zip(st.teacher.parameters(), init.teacher.parameters()))
    gap = max((a - b).abs().max().item() for a, b in
              zip(st.teacher.parameters(), st.student.parameters()))
    print(f"[{tag}] student max|change| {moved:.3e}  teacher max|change| {ema:.3e}  "
          f"teacher-student max|gap| {gap:.3e}")
    if not (moved > 0 and ema > 0 and gap > 0):
        raise AssertionError("student did not train or teacher did not follow by EMA")
    warm = summary.step_ms[1:]  # the first step builds cuDNN plans and caches
    med = statistics.median(warm)
    print(f"[{tag}] step ms (CUDA events, augmentation + step): "
          f"{[round(x, 3) for x in summary.step_ms]}")
    print(f"[{tag}] median of the {len(warm)} warm steps {med:.3f} ms, "
          f"{8 / (med / 1e3):.3f} images/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"wall {wall:.1f} s  [{smi}]")
    return launches, mc_cfg, cfg, st, init


def phase_train(torch, smi):
    launches = _train_run(torch, smi, TRAIN_ARGS, "train")[0]
    for name in ("attention_fwd", "attention_bwd", "photometric"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return launches


def phase_long_attention(torch):
    from dinomc_tpu_torch.ops.hopper import attention_long as hl

    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "rel": 0.0}
    timing = None
    for i, (what, B, N, h, d) in enumerate(LONG_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        qkv = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, N, h, d, generator=gen, device="cuda").bfloat16()
        scale = 1.0 / math.sqrt(d)
        q, k, v = qkv.unbind(2)
        o, lse = hl.long_attention_fwd(q, k, v, scale)
        dq, dk, dv = hl.long_attention_bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
        ref = hl.long_mha_reference(qr, kr, vr, scale)
        g_r = torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True)
        torch.cuda.synchronize()

        fwd_err = (o.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip((dq, dk, dv), g_r)]
        rel = max(e / b.float().abs().max().item() for e, b in zip(errs, g_r))
        # K5 and K6 are deterministic (no atomics): a second call gives the
        # same bits
        dq2, delta = hl.long_attention_dq(q, k, v, o, lse, do, scale)
        _, delta2 = hl.long_attention_dq(q, k, v, o, lse, do, scale)
        same_dq = torch.equal(dq, dq2) and torch.equal(delta, delta2)
        same = same_dq and all(torch.equal(a, b) for a, b in zip(
            (dk, dv), hl.long_attention_dkv(q, k, v, lse, delta, do, scale)))
        print(f"[long attention] {what}: B={B} N={N} h={h} d={d}  fwd max|diff| "
              f"{fwd_err:.3e}  dq/dk/dv max abs {errs}  max rel {rel:.3e}  dQ and delta "
              f"bit-identical on a repeat: {same_dq}, dK/dV too: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL and same):
            raise AssertionError(f"long attention kernels disagree with their plain version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "dq": max(worst["dq"], errs[0]),
                 "dkv": max(worst["dkv"], errs[1], errs[2]), "rel": max(worst["rel"], rel)}

        if i == 0:  # the main path's shape: each kernel against its plain version
            dob = do.contiguous()
            timing = {
                "fwd_ms": _time_ms(torch, lambda: hl.long_attention_fwd(q, k, v, scale)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_fwd_ms": _host_ms(torch, lambda: hl.long_attention_fwd(q, k, v, scale)),
                "fwd_plain_ms": _time_ms(torch, lambda: hl.long_mha_reference(q, k, v, scale)),
                "dq_ms": _time_ms(torch, lambda: hl.long_attention_dq(q, k, v, o, lse, dob, scale)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_dq_ms": _host_ms(torch, lambda: hl.long_attention_dq(
                    q, k, v, o, lse, dob, scale)),
                "dq_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, qr, do, retain_graph=True)),
                "dkv_ms": _time_ms(torch, lambda: hl.long_attention_dkv(
                    q, k, v, lse, delta, dob, scale)),
                "dkv_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, (kr, vr), do, retain_graph=True)),
            }
            lib = _sdpa_times(torch, *(x.transpose(1, 2).contiguous() for x in (q, k, v, do)))
            timing.update(fwd_library_ms=lib["fwd"], dq_library_ms=lib["dq"],
                          dkv_library_ms=lib["dkv"])
            elems, prod, rows = B * N * h * d * 2, B * h * N * N * d, B * h * N * 4
            timing.update(  # K5 also reads o and writes delta; K6 reads delta
                fwd_bound=_bound(4 * elems + rows, 4 * prod, BF16_FLOPS),
                dq_bound=_bound(6 * elems + 2 * rows, 6 * prod, BF16_FLOPS),
                dkv_bound=_bound(6 * elems + 2 * rows, 8 * prod, BF16_FLOPS))
            print(f"[long attention] {what} times: {_fmt(timing)}")
        del ref, g_r, qr, kr, vr
    print(f"[long attention] worst: fwd max|diff| {worst['fwd']:.3e} (bound {ATTN_FWD_ATOL}), "
          f"grad max rel {worst['rel']:.3e} (bound {ATTN_GRAD_RTOL})")
    return worst, timing


def _seg_run(torch, train_backbone: bool, smi):
    """One ``train_seg`` run; returns (summary, launches over the run)."""
    from dinomc_tpu_torch.cli.train_seg import get_args_parser, train_seg
    from dinomc_tpu_torch.ops.hopper import _build

    flag = "true" if train_backbone else "false"
    with tempfile.TemporaryDirectory() as out_dir:
        args = get_args_parser().parse_args(
            SEG_ARGS + ["--train_backbone", flag, "--output_dir", out_dir])
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        summary = train_seg(args)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    med = sorted(summary.step_ms)[len(summary.step_ms) // 2]
    print(f"[seg train_backbone={flag}] losses {summary.losses}")
    print(f"[seg train_backbone={flag}] launches over the run: {launches}")
    print(f"[seg train_backbone={flag}] step ms (CUDA events, augmentation + step): "
          f"{[round(x, 3) for x in summary.step_ms]}")
    print(f"[seg train_backbone={flag}] median step {med:.3f} ms, {4 / (med / 1e3):.3f} "
          f"images/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"val mIoU {summary.best_miou:.4f}, wall {wall:.1f} s  [{smi}]")
    return summary, launches


def phase_seg(torch, smi):
    from dinomc_tpu_torch.cli.train_seg import get_args_parser
    from dinomc_tpu_torch.data.seg_datasets import SPECS
    from dinomc_tpu_torch.models.upernet import UPerNetConfig
    from dinomc_tpu_torch.train.seg_trainer import SegConfig, init_seg_train_state

    total = {}
    for train_backbone in (False, True):
        summary, launches = _seg_run(torch, train_backbone, smi)
        if len(summary.losses) != SEG_STEPS or not all(math.isfinite(x) for x in summary.losses):
            raise AssertionError(f"expected {SEG_STEPS} finite losses, got {summary.losses}")
        if not 0.0 <= summary.scores["miou"] <= 1.0:
            raise AssertionError(f"validation mIoU {summary.scores['miou']} outside [0, 1]")
        bwd = ("long_attention_dq", "long_attention_dkv")
        if launches.get("long_attention_fwd", 0) <= 0:
            raise AssertionError("kernel long_attention_fwd was not launched by the seg path")
        for name in bwd:
            if (launches.get(name, 0) > 0) != train_backbone:
                raise AssertionError(f"kernel {name} launched {launches.get(name, 0)} times with "
                                     f"train_backbone={train_backbone}")
        args = get_args_parser().parse_args(SEG_ARGS)
        cfg = SegConfig(model=UPerNetConfig(num_classes=SPECS[args.dataset].num_classes))
        init = dict(init_seg_train_state(cfg, args.seed, "cuda").model.named_parameters())
        final = dict(summary.state.model.named_parameters())
        bb = [n for n in final if n.startswith("backbone.")]
        dec = [n for n in final if not n.startswith("backbone.")]
        bb_moved = max((final[n] - init[n]).abs().max().item() for n in bb)
        dec_moved = max((final[n] - init[n]).abs().max().item() for n in dec)
        print(f"[seg train_backbone={train_backbone}] backbone max|change| {bb_moved:.3e}  "
              f"decoder max|change| {dec_moved:.3e}")
        if not dec_moved > 0:
            raise AssertionError("the decoder did not train")
        if train_backbone != (bb_moved > 0):
            raise AssertionError(f"backbone max|change| {bb_moved} with train_backbone={train_backbone}")
        if not train_backbone and not all(torch.equal(final[n], init[n]) for n in bb):
            raise AssertionError("the frozen backbone is not bit-identical")
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c
    return total


def phase_window_attention(torch):
    from dinomc_tpu_torch.models.swin import _attn_mask
    from dinomc_tpu_torch.ops.hopper import window_attention as wa

    worst = {"fwd": 0.0, "grad": 0.0, "rel": 0.0}
    timings = []
    for i, (what, nB, heads, side, shift) in enumerate(SWIN_SHAPES):
        C = heads * 32
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        qkv = torch.randn(nB, 49, 3 * C, generator=gen, device="cuda").bfloat16()
        bias = 0.1 * torch.randn(heads, 49, 49, generator=gen, device="cuda")
        do = torch.randn(nB, 49, C, generator=gen, device="cuda").bfloat16()
        mask = _attn_mask(side, side, 7, shift, torch.device("cuda"))
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        o = wa.window_attention_fwd(q, k, v, bias, mask, heads)
        grads = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
        torch.cuda.synchronize()
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        ref = wa.window_attention_reference(*xs, mask, heads)
        g_ref = torch.autograd.grad(ref, xs, do, retain_graph=True)
        torch.cuda.synchronize()

        fwd_err = (o.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, g_ref)]
        rel = max(e / b.float().abs().max().item() for e, b in zip(errs, g_ref))
        # K7 and K8 are deterministic (no atomics): a second call gives the
        # same bits
        same_fwd = torch.equal(o, wa.window_attention_fwd(q, k, v, bias, mask, heads))
        same = same_fwd and all(torch.equal(a, b) for a, b in zip(
            grads, wa.window_attention_bwd(q, k, v, bias, mask, do, heads)))
        print(f"[window attention] {what}: windows={nB} heads={heads} map={side} shift={shift} "
              f"mask={None if mask is None else tuple(mask.shape)}  fwd max|diff| {fwd_err:.3e}  "
              f"dq/dk/dv/dbias max abs {errs}  max rel {rel:.3e}  forward bit-identical on a "
              f"repeat: {same_fwd}, backward too: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL and same):
            raise AssertionError(f"window attention kernels disagree with their plain version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "grad": max(worst["grad"], *errs),
                 "rel": max(worst["rel"], rel)}

        if i < 4:  # the 224 px stages: kernel, plain version and library
            # the library: SDPA with the float mask bias[h] + mask[w mod nW]
            heads_first = [x.reshape(nB, 49, heads, 32).transpose(1, 2).contiguous()
                           for x in (q, k, v, do)]
            am = bias[None].expand(nB, heads, 49, 49)
            if mask is not None:
                nW = mask.shape[0]
                am = (am.reshape(nB // nW, nW, heads, 49, 49) + mask[:, None]).reshape(am.shape)
            am = am.to(torch.bfloat16).contiguous().requires_grad_()
            t = {}
            for tag, timer in (("", _time_ms), ("host_", _host_ms)):
                lib = _sdpa_times(torch, *heads_first, attn_mask=am, timer=timer)
                t.update({
                    f"{tag}fwd_ms": timer(torch, lambda: wa.window_attention_fwd(
                        q, k, v, bias, mask, heads)),
                    f"{tag}fwd_plain_ms": timer(torch, lambda: wa.window_attention_reference(
                        q, k, v, bias, mask, heads)),
                    f"{tag}fwd_library_ms": lib["fwd"],
                    f"{tag}bwd_ms": timer(torch, lambda: wa.window_attention_bwd(
                        q, k, v, bias, mask, do, heads)),
                    f"{tag}bwd_plain_ms": timer(torch, lambda: torch.autograd.grad(
                        ref, xs, do, retain_graph=True)),
                    f"{tag}bwd_library_ms": lib["bwd"],
                })
            elems, wbytes = nB * 49 * C * 2, heads * 49 * 49 * 4
            mbytes = 0 if mask is None else mask.numel() * 4
            prod = nB * heads * 49 * 49 * 32
            t["fwd_bound"] = _bound(4 * elems + wbytes + mbytes, 4 * prod, BF16_FLOPS)
            t["bwd_bound"] = _bound(7 * elems + 2 * wbytes + mbytes, 10 * prod, BF16_FLOPS)
            print(f"[window attention] {what} times: {_fmt(t)}")
            timings.append(t)
        del xs, ref, g_ref
    print(f"[window attention] worst: fwd max|diff| {worst['fwd']:.3e} (bound {ATTN_FWD_ATOL}), "
          f"grad max rel {worst['rel']:.3e} (bound {ATTN_GRAD_RTOL})")
    return worst, timings


def phase_swin_train(torch, smi):
    """Swin-T pretraining: K3, K7 and K8 launched exactly as the
    configuration implies (one backbone call per crop size, teacher over the
    globals, student over every crop; Swin does not pack crops), and no
    attention kernel of the ViT."""
    launches, mc_cfg, cfg, _, _ = _train_run(torch, smi, SWIN_TRAIN_ARGS, "swin train")
    steps = 5
    blocks = cfg.encoder(True).swin_config().num_blocks
    buckets = len(set(mc_cfg.local_sizes))
    want = {
        "photometric": steps * (2 + len(mc_cfg.local_sizes)),
        "window_attention_fwd": steps * blocks * (2 + buckets),
        "window_attention_bwd": steps * blocks * (1 + buckets),
    }
    print(f"[swin train] launches implied by the configuration: {want}")
    if launches != want:
        raise AssertionError(f"Swin kernel launches {launches}, the configuration implies {want}")
    return launches


def _mlp_inputs(torch, M, D, Fd, seed):
    """x (M, D), W1 (F, D), b1, W2 (D, F), b2 and dO in bf16 on the card;
    weights scaled by 1/sqrt(fan-in) so activations stay O(1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    w1 = (torch.randn(Fd, D, generator=gen, device="cuda") / math.sqrt(D)).bfloat16()
    w2 = (torch.randn(D, Fd, generator=gen, device="cuda") / math.sqrt(Fd)).bfloat16()
    b1, b2 = ((0.1 * torch.randn(n, generator=gen, device="cuda")).bfloat16() for n in (Fd, D))
    do = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    return (x, w1, b1, w2, b2), do


def phase_fused_mlp(torch):
    from dinomc_tpu_torch.ops.hopper import fused_mlp as fm

    F = torch.nn.functional
    worst_abs, worst_rel, timing = 0.0, 0.0, None
    for i, (what, M, D, Fd) in enumerate(MLP_SHAPES):
        args, do = _mlp_inputs(torch, M, D, Fd, 400 + i)
        for approx in (True, False):
            outs, grads = [], []
            for forward in (fm.fused_mlp_fwd, fm.fused_mlp_reference):
                xs = [a.clone().requires_grad_() for a in args]
                out = fm.FusedMLP.apply(*xs, approx, forward)
                outs.append(out.float())
                grads.append(torch.autograd.grad(out, xs, do))
            torch.cuda.synchronize()
            err = (outs[0] - outs[1]).abs().max().item()
            rel = err / outs[1].abs().max().item()
            same = all(torch.equal(a, b) for a, b in zip(*grads))
            print(f"[fused mlp] {what}: M={M} D={D} F={Fd} gelu={'tanh' if approx else 'erf'}  "
                  f"fwd max|diff| {err:.3e}  rel {rel:.3e}  gradients equal to the plain "
                  f"route's: {same}")
            if not (rel <= MLP_RTOL and same):
                raise AssertionError(f"fused MLP kernel disagrees with its plain version at {what}")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if D == 384:  # the ViT-S rows: kernel beside the dense chain, the bound
            x, w1, b1, w2, b2 = args
            t = {
                "ms": _time_ms(torch, lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2, True)),
                # three PyTorch calls (cuBLAS, an elementwise GELU, cuBLAS): no one
                # PyTorch call computes this function
                "library_ms": _time_ms(torch, lambda: F.linear(
                    F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_ms": _host_ms(torch, lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2, True)),
                "bound": _bound(2 * (2 * M * D + 2 * D * Fd + Fd + D), 4 * M * D * Fd, BF16_FLOPS),
            }
            if i == 0:  # the 224 px globals: the plain version too
                t["plain_ms"] = _time_ms(torch, lambda: fm.fused_mlp_reference(
                    x, w1, b1, w2, b2, True))
                timing = t
            print(f"[fused mlp] {what} times: {_fmt(t)}")
    print(f"[fused mlp] worst: fwd max|diff| {worst_abs:.3e}, rel {worst_rel:.3e} (bound {MLP_RTOL})")
    return worst_abs, timing


def _window_inputs(torch, nB, heads, side, shift, seed):
    from dinomc_tpu_torch.models.swin import _attn_mask

    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(nB, 49, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, 49, 49, generator=gen, device="cuda")
    do = torch.randn(nB, 49, C, generator=gen, device="cuda").bfloat16()
    mask = _attn_mask(side, side, 7, shift, torch.device("cuda"))
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], bias, mask, do


def phase_window_attention_stacked(torch, win_t):
    """K9/K10 against the plain version at phase 7's shapes (the same
    inputs), both bit-identical on a repeat and K9 also between qkv column
    slices and tensors of their own; each 224 px stage timed beside K7/K8
    (device time, and K9/K7 with the host's cost); then the main path."""
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.ops.hopper import window_attention as wa

    worst = {"fwd": 0.0, "grad": 0.0, "rel": 0.0}
    timings = []
    for i, (what, nB, heads, side, shift) in enumerate(SWIN_SHAPES):
        q, k, v, bias, mask, do = _window_inputs(torch, nB, heads, side, shift, 300 + i)
        o = wa.window_attention_stacked_fwd(q, k, v, bias, mask, heads)
        grads = wa.window_attention_stacked_bwd(q, k, v, bias, mask, do, heads)
        torch.cuda.synchronize()
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        ref = wa.window_attention_reference(*xs, mask, heads)
        g_ref = torch.autograd.grad(ref, xs, do)
        torch.cuda.synchronize()
        fwd_err = (o.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, g_ref)]
        rel = max(e / b.float().abs().max().item() for e, b in zip(errs, g_ref))
        # K9 and K10 are deterministic (no atomics): a second call gives the
        # same bits, and so do q, k, v as tensors of their own (a map each)
        same_fwd = torch.equal(o, wa.window_attention_stacked_fwd(q, k, v, bias, mask, heads))
        apart_fwd = torch.equal(o, wa.window_attention_stacked_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), bias, mask, heads))
        same = all(torch.equal(a, b) for a, b in zip(
            grads, wa.window_attention_stacked_bwd(q, k, v, bias, mask, do, heads)))
        print(f"[stacked window attention] {what}: windows={nB} heads={heads} "
              f"(a block: {wa.head_chunk(heads, wa.STACKED_HEADS['fwd'])} / "
              f"{wa.head_chunk(heads, wa.STACKED_HEADS['bwd'])} heads)  fwd max|diff| "
              f"{fwd_err:.3e}  dq/dk/dv/dbias max abs {errs}  max rel {rel:.3e}  "
              f"forward bit-identical on a repeat: {same_fwd}, q/k/v apart: {apart_fwd}; "
              f"backward on a repeat: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL
                and same_fwd and apart_fwd and same):
            raise AssertionError(f"stacked window attention kernels disagree with their plain "
                                 f"version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "grad": max(worst["grad"], *errs),
                 "rel": max(worst["rel"], rel)}
        if i < 4:  # the 224 px stages: K9/K10 beside K7/K8 in this call
            t = {
                "fwd_ms": _time_ms(torch, lambda: wa.window_attention_stacked_fwd(
                    q, k, v, bias, mask, heads)),
                "perhead_fwd_ms": _time_ms(torch, lambda: wa.window_attention_fwd(
                    q, k, v, bias, mask, heads)),
                "host_fwd_ms": _host_ms(torch, lambda: wa.window_attention_stacked_fwd(
                    q, k, v, bias, mask, heads)),
                "perhead_host_fwd_ms": _host_ms(torch, lambda: wa.window_attention_fwd(
                    q, k, v, bias, mask, heads)),
                "bwd_ms": _time_ms(torch, lambda: wa.window_attention_stacked_bwd(
                    q, k, v, bias, mask, do, heads)),
                "perhead_bwd_ms": _time_ms(torch, lambda: wa.window_attention_bwd(
                    q, k, v, bias, mask, do, heads)),
            }
            t.update({key: win_t[i][key] for key in (
                "fwd_plain_ms", "fwd_library_ms", "fwd_bound",
                "bwd_plain_ms", "bwd_library_ms", "bwd_bound")})
            print(f"[stacked window attention] {what} times: {_fmt(t)}")
            timings.append(t)
        del xs, ref, g_ref
    print(f"[stacked window attention] worst: fwd max|diff| {worst['fwd']:.3e} (bound "
          f"{ATTN_FWD_ATOL}), grad max rel {worst['rel']:.3e} (bound {ATTN_GRAD_RTOL})")

    # The main path: the public entry over Swin-T's 12 block shapes, forward
    # and backward through autograd.
    inputs = [_window_inputs(torch, *blk, 500 + j) for j, blk in enumerate(SWIN_BLOCKS)]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    for (q, k, v, bias, mask, do), (_, heads, _, _) in zip(inputs, SWIN_BLOCKS):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        out = wa.window_attention(*xs, mask, heads, variant="stacked")
        torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {"window_attention_stacked_fwd": len(SWIN_BLOCKS),
            "window_attention_stacked_bwd": len(SWIN_BLOCKS)}
    print(f"[stacked window attention] main path, window_attention(variant='stacked') over "
          f"Swin-T's {len(SWIN_BLOCKS)} blocks at 224 px: launches {launches}")
    if launches != want:
        raise AssertionError(f"stacked window attention launches {launches}, want {want}")
    return worst, timings, launches


def _dino_setup(torch):
    """The ViT-S/8 DINO configuration of phase 4 (out_dim 65536, B = 8) and 5
    steps of its inputs: images and multi-crop draws made on the card from a
    seed, augmented once and shared by every run below."""
    from dinomc_tpu_torch.cli.train_dino import build_config, build_schedules, get_args_parser
    from dinomc_tpu_torch.ops.augment import draw_multicrop, multicrop_augment

    args = get_args_parser().parse_args(TRAIN_ARGS)
    mc_cfg, cfg = build_config(args, 1)
    sch = build_schedules(args, args.batch_size_per_gpu, 1)
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, S = args.batch_size_per_gpu, args.image_size
    batches = []
    for _ in range(5):
        images = torch.rand(B, S, S, 3, generator=gen, device="cuda")
        batches.append(multicrop_augment(images, draw_multicrop(gen, B, S, S, mc_cfg, device="cuda"),
                                         mc_cfg))
    return cfg, sch, batches


def _set_backbones(torch, state, **fields):
    import dataclasses

    for model in (state.student, state.teacher):
        model["backbone"].cfg = dataclasses.replace(model["backbone"].cfg, **fields)


def _step(torch, state, batch, sch, cfg):
    """One ``dino_train_step``; returns (loss, ms between CUDA events around
    it, launches, peak memory GiB)."""
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.dino_trainer import dino_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    metrics = dino_train_step(state, *batch, sch, cfg)
    b.record()
    b.synchronize()
    return (metrics["loss"].item(), a.elapsed_time(b), dict(_build.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2**30)


def phase_fused_mlp_train(torch, smi):
    """5 DINO steps with the fused MLP against 5 with the dense one, from the
    same weights and inputs; then the step under the remat policies. Returns
    the fused run's launches (the main path of K11)."""
    from dinomc_tpu_torch.train.dino_trainer import init_dino_train_state

    cfg, sch, batches = _dino_setup(torch)
    depth = cfg.encoder(True).vit_config().depth
    # one teacher call (the globals), four student calls (the globals and the
    # three packed local pairs 184+84, 164+124, 144+104); the default 'attn'
    # remat keeps K1's output, and torch's recompute replays K11
    teacher_calls, student_calls = 1, 4
    want = {"attention_fwd": depth * (teacher_calls + student_calls),
            "attention_bwd": depth * student_calls,
            "fused_mlp": depth * (teacher_calls + 2 * student_calls)}
    losses, launches = {}, {}
    for impl in ("fused", "dense"):
        state = init_dino_train_state(cfg, 0, "cuda")
        _set_backbones(torch, state, mlp_impl=impl)
        losses[impl], total = [], {}
        for i, batch in enumerate(batches):
            loss, ms, got, peak = _step(torch, state, batch, sch, cfg)
            losses[impl].append(loss)
            for name, c in got.items():
                total[name] = total.get(name, 0) + c
            if impl == "fused" and {n: got.get(n, 0) for n in want} != want:
                raise AssertionError(f"fused-MLP step {i}: launches {got}, the policy implies {want}")
        launches[impl] = total
        print(f"[fused mlp train] mlp_impl={impl}: losses {losses[impl]}  launches over 5 steps "
              f"{total}")
        del state
    print(f"[fused mlp train] launches a step implied by remat_policy='attn': {want}")
    if launches["dense"].get("fused_mlp", 0):
        raise AssertionError("the dense MLP launched K11")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["fused"], losses["dense"])]
    print(f"[fused mlp train] loss |fused - dense| / |dense| per step {[f'{r:.3e}' for r in rel]} "
          f"(bound {LOSS_RTOL})")
    if not (all(math.isfinite(x) for x in losses["fused"]) and max(rel) <= LOSS_RTOL):
        raise AssertionError("the fused-MLP DINO steps disagree with the dense ones")

    # Remat on the card: one state; a warm-up step for each configuration,
    # then 3 rounds that take 2 steps of each in turn, so a drift of the
    # host's speed falls on every configuration alike. Step ms: CUDA events
    # around the step, the host's issuing in it where the card waits on it
    # (the step syncs the host; device busy time is profile_torch_step.py's).
    state = init_dino_train_state(cfg, 0, "cuda")
    runs = [(impl, policy) for impl in ("dense", "fused") for policy in REMAT_RUNS]
    seen = {run: [] for run in runs}
    for r in range(4):
        for impl, policy in runs:
            _set_backbones(torch, state, mlp_impl=impl, remat=policy is not None,
                           remat_policy=policy or "attn")
            for j in range(1 if r == 0 else 2):
                result = _step(torch, state, batches[(r + j) % 5], sch, cfg)
                if r:
                    seen[(impl, policy)].append(result)
    for impl, policy in runs:
        results = seen[(impl, policy)]
        ms = sorted(x[1] for x in results)
        got = results[-1][2]
        reruns_attn = policy == "full"
        expect = {"attention_fwd": depth * (teacher_calls + student_calls * (1 + reruns_attn)),
                  "attention_bwd": depth * student_calls,
                  "fused_mlp": 0 if impl == "dense" else
                  depth * (teacher_calls + student_calls * (1 + (policy is not None)))}
        counts = {n: got.get(n, 0) for n in expect}
        print(f"[remat] mlp_impl={impl} remat={policy or 'off'}: step ms median "
              f"{(ms[2] + ms[3]) / 2:.3f} (of {[round(x, 3) for x in ms]})  peak "
              f"{max(x[3] for x in results):.3f} GiB  launches a step {counts} "
              f"(implied {expect})  [{smi}]")
        if any({n: x[2].get(n, 0) for n in expect} != expect for x in results):
            raise AssertionError(f"remat {policy}: launches {counts}, the policy implies {expect}")
    return launches["fused"]


def _cls_steps(torch, state, cfg, steps, gen, tag, smi):
    """``steps`` fine-tune steps on fresh 256 px images made on the card,
    through the CLI's EuroSAT train transform (crop boxes and flips drawn
    first); prints the losses and the step times, the median over every
    step but the first (a warm-up). Returns the launches over the steps.
    A step's time is CUDA events around transform + step, the host's
    issuing in it (the loss is read each step)."""
    from dinomc_tpu_torch.ops import augment as aug
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.cls_trainer import cls_train_step

    losses, times = [], []
    _build.LAUNCHES.clear()
    for _ in range(steps):
        images = torch.rand(CLS_B, CLS_RAW, CLS_RAW, 3, generator=gen, device="cuda")
        labels = torch.randint(0, CLS_CLASSES, (CLS_B,), generator=gen, device="cuda")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        draws = aug.draw_eurosat_view(gen, CLS_B, CLS_RAW, CLS_RAW, device="cuda")
        m = cls_train_step(state, aug.eurosat_train_view(images, draws, CLS_SIZE), labels,
                           0.01, 0.0, cfg)
        b.record()
        losses.append(float(m["loss"]))
        times.append(a.elapsed_time(b))
    launches = dict(_build.LAUNCHES)
    print(f"[{tag}] losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite fine-tune loss: {losses}")
    med = statistics.median(times[1:])
    print(f"[{tag}] step ms (CUDA events, transform + step; the first a warm-up): "
          f"{[round(x, 3) for x in times]}")
    print(f"[{tag}] median of the {steps - 1} warm steps {med:.3f} ms, "
          f"{CLS_B / (med / 1e3):.3f} images/s, B = {CLS_B} at {CLS_SIZE} px  [{smi}]")
    return launches


def _check_launches(tag, launches, want):
    print(f"[{tag}] launches {launches}, implied by the configuration {want}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, the configuration implies {want}")


def phase_cls(torch, smi):
    """Classification fine-tune and frozen-feature evaluation. Returns the
    launches of the phase's main paths, summed by kernel."""
    import dataclasses

    import numpy as np

    from dinomc_tpu_torch.cli import eurosat
    from dinomc_tpu_torch.eval.knn import extract_features, knn_accuracy, knn_predict
    from dinomc_tpu_torch.eval.linear_probe import train_linear_probe
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.cls_trainer import ClsConfig, init_cls_train_state

    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg = ClsConfig(arch="vit_small", patch_size=8, num_classes=CLS_CLASSES)
    depth = cfg.encoder().vit_config().depth
    state = init_cls_train_state(cfg, seed=0, device="cuda")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    launches = _cls_steps(torch, state, cfg, CLS_STEPS, gen, "cls vit_small/8", smi)
    # remat 'attn' keeps K1's output: one K1 and one K2 a block a step
    _check_launches("cls vit_small/8", launches,
                    {"attention_fwd": CLS_STEPS * depth, "attention_bwd": CLS_STEPS * depth})
    add(launches)
    now = state.model.state_dict()
    moved = {part: max((now[k] - init[k]).abs().max().item() for k in now if k.startswith(part))
             for part in ("backbone.", "fc.")}
    print(f"[cls vit_small/8] max|change| {moved}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"the fine-tune did not move backbone and classifier: {moved}")

    frozen_cfg = dataclasses.replace(cfg, freeze_backbone=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    launches = _cls_steps(torch, state, frozen_cfg, CLS_FROZEN_STEPS, gen,
                          "cls vit_small/8 frozen", smi)
    _check_launches("cls vit_small/8 frozen", launches,
                    {"attention_fwd": CLS_FROZEN_STEPS * depth})
    add(launches)
    now = state.model.state_dict()
    if not all(torch.equal(now[k], v) for k, v in before.items() if k.startswith("backbone.")):
        raise AssertionError("the frozen backbone is not bit-identical")
    if torch.equal(now["fc.kernel"], before["fc.kernel"]):
        raise AssertionError("the classifier did not move with the backbone frozen")
    print("[cls vit_small/8 frozen] backbone bit-identical")

    swin_cfg = ClsConfig(arch="swin_t", num_classes=CLS_CLASSES)
    blocks = swin_cfg.encoder().swin_config().num_blocks
    swin = init_cls_train_state(swin_cfg, seed=0, device="cuda")
    launches = _cls_steps(torch, swin, swin_cfg, CLS_SWIN_STEPS, gen, "cls swin_t", smi)
    _check_launches("cls swin_t", launches, {"window_attention_fwd": CLS_SWIN_STEPS * blocks,
                                             "window_attention_bwd": CLS_SWIN_STEPS * blocks})
    add(launches)
    del swin

    # frozen features: a class-coloured image set made on the card, so the
    # k-NN and the probe have something to find
    enc, backbone = cfg.encoder(), state.model["backbone"]
    colors = torch.rand(CLS_CLASSES, 3, generator=gen, device="cuda")

    def feature_set(count):
        labels = torch.arange(count, device="cuda") % CLS_CLASSES
        noise = torch.rand(count, CLS_SIZE, CLS_SIZE, 3, generator=gen, device="cuda")
        return 0.5 * noise + 0.5 * colors[labels][:, None, None, :], labels

    def batches(images, labels):
        for s in range(0, len(images), FEAT_BATCH):
            yield images[s:s + FEAT_BATCH], labels[s:s + FEAT_BATCH]

    from dinomc_tpu_torch.ops.augment import normalize

    (tri, trl), (tei, tel) = feature_set(FEAT_TRAIN), feature_set(FEAT_VAL)
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trf, trl = extract_features(lambda x: enc.apply(backbone, normalize(x)), batches(tri, trl))
    tef, tel = extract_features(lambda x: enc.apply(backbone, normalize(x)), batches(tei, tel))
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    calls = -(-FEAT_TRAIN // FEAT_BATCH) - (-FEAT_VAL // FEAT_BATCH)
    _check_launches("features", launches, {"attention_fwd": calls * depth})
    add(launches)
    print(f"[features] {FEAT_TRAIN + FEAT_VAL} images at {CLS_SIZE} px in {feat_s:.3f} s, "
          f"{(FEAT_TRAIN + FEAT_VAL) / feat_s:.3f} images/s (host clock, synced)  [{smi}]")

    t0 = time.perf_counter()
    accs = knn_accuracy(trf, trl, tef, tel, ks=(10, 20), num_classes=CLS_CLASSES)
    knn_s = time.perf_counter() - t0
    again = knn_accuracy(trf, trl, tef, tel, ks=(10, 20), num_classes=CLS_CLASSES)
    on_card = knn_predict(trf, trl, tef, k=20, num_classes=CLS_CLASSES).cpu()
    repeat = knn_predict(trf, trl, tef, k=20, num_classes=CLS_CLASSES).cpu()
    on_cpu = knn_predict(trf.cpu(), trl.cpu(), tef.cpu(), k=20, num_classes=CLS_CLASSES)
    print(f"[knn] top-1 {accs} (repeat {again}); labels equal to the CPU's: "
          f"{torch.equal(on_card, on_cpu)}; {knn_s:.4f} s  [{smi}]")
    if not all(0.0 <= a <= 100.0 for a in accs.values()) or accs != again:
        raise AssertionError(f"k-NN {accs}, repeat {again}")
    if not torch.equal(on_card, repeat):
        raise AssertionError("k-NN labels differ on a repeat")
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("k-NN labels on the card differ from the CPU's")
    t0 = time.perf_counter()
    probe = train_linear_probe(trf, trl, tef, tel, num_classes=CLS_CLASSES, epochs=50)
    probe_s = time.perf_counter() - t0
    print(f"[probe] top-1 {probe['top1']:.2f}, loss {probe['loss']:.4f}; {probe_s:.4f} s  [{smi}]")
    if not 0.0 <= probe["top1"] <= 100.0:
        raise AssertionError(f"probe top-1 {probe['top1']}")
    del state, trf, tef

    with tempfile.TemporaryDirectory() as out_dir:
        results = {}
        for mode in ("train", "evaluate_knn", "evaluate_probe", "evaluate"):
            extra = [] if mode == "train" else [f"--{mode}", "true"]
            args = eurosat.get_args_parser().parse_args(
                CLS_CLI_ARGS + ["--output_dir", out_dir] + extra)
            results[mode] = eurosat.run(args)
    print(f"[eurosat cli] {results}")
    if not all(0.0 <= v <= 100.0 for v in results.values()):
        raise AssertionError(f"eurosat CLI results outside [0, 100]: {results}")
    if results["evaluate"] != results["train"]:
        raise AssertionError("--evaluate of the best checkpoint disagrees with the run that wrote it")

    # the CLI's real-data path at 224 px: an ImageFolder tree (train/, val/,
    # a directory a class) of 256 px PNGs written from a seed
    from PIL import Image

    with tempfile.TemporaryDirectory() as root:
        rng = np.random.RandomState(12)
        for split, count in (("train", TREE_TRAIN), ("val", TREE_VAL)):
            for c in range(CLS_CLASSES):
                os.makedirs(f"{root}/{split}/class{c}")
                for i in range(count):
                    pixels = rng.randint(0, 256, (CLS_RAW, CLS_RAW, 3), dtype=np.uint8)
                    Image.fromarray(pixels).save(f"{root}/{split}/class{c}/{i}.png")
        args = eurosat.get_args_parser().parse_args(
            CLS_TREE_ARGS + ["--data_path", root, "--output_dir", f"{root}/out"])
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        top1 = eurosat.run(args)
        tree_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    # one train step (40 images, batches of 32, the last dropped), then the
    # val pass over 40 images in batches of 32 and 8
    _check_launches("eurosat cli imagefolder", launches,
                    {"attention_fwd": 3 * depth, "attention_bwd": depth})
    add(launches)
    print(f"[eurosat cli imagefolder] {CLS_CLASSES * TREE_TRAIN} train and "
          f"{CLS_CLASSES * TREE_VAL} val PNGs of {CLS_RAW} px at {CLS_SIZE} px: top-1 {top1:.2f}; "
          f"{tree_s:.3f} s  [{smi}]")
    if not 0.0 <= top1 <= 100.0:
        raise AssertionError(f"eurosat CLI top-1 on the ImageFolder tree: {top1}")
    return total


def _convnet_train(torch, smi, arch, steps):
    """``steps`` DINO steps of ``arch`` through ``train_dino`` with LARS and
    BN in the head; checks K3's launches, the convolutions, and both
    BatchNorm states. Returns the launches over the run."""
    args = RESNET_TRAIN_ARGS + ["--arch", arch, "--max_steps", str(steps)]
    launches, mc_cfg, cfg, st, init = _train_run(torch, smi, args, f"{arch} train", steps)
    _check_launches(f"{arch} train", launches, {"photometric": steps * (2 + len(mc_cfg.local_sizes))})
    convs = max((st.student.state_dict()[k] - v).abs().max().item()
                for k, v in init.student.state_dict().items() if ".conv" in k)
    print(f"[{arch} train] student convolutions max|change| {convs:.3e}")
    if not convs > 0:
        raise AssertionError("the student's convolutions did not move")
    buckets = 1 + len(set(mc_cfg.local_sizes))
    for which, calls in (("student", steps * buckets), ("teacher", steps)):
        now, before = getattr(st, which).state_dict(), getattr(init, which).state_dict()
        moved = min(max((now[k] - before[k]).abs().max().item() for k in now if k.endswith(s))
                    for s in ("running_mean", "running_var"))
        tracked = {int(v) for k, v in now.items() if k.endswith("num_batches_tracked")}
        print(f"[{arch} train] {which} running statistics max|change| {moved:.3e}, "
              f"num_batches_tracked {sorted(tracked)} (implied {calls})")
        if not moved > 0 or tracked != {calls}:
            raise AssertionError(f"{which} BatchNorm state: moved {moved}, tracked {tracked}, "
                                 f"the configuration implies {calls}")
    return launches


def phase_convnets(torch, smi):
    """The ResNets: DINO-MC pretraining, the EuroSAT CLI and fine-tune steps.
    Returns the launches of the phase's main paths, summed by kernel."""
    import dataclasses

    from dinomc_tpu_torch.cli import eurosat
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.cls_trainer import ClsConfig, init_cls_train_state

    total = dict(_convnet_train(torch, smi, "resnet50", 5))
    for name, c in _convnet_train(torch, smi, "wide_resnet50_2", WRN_STEPS).items():
        total[name] = total.get(name, 0) + c
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out_dir:
        results = {}
        _build.LAUNCHES.clear()
        for mode in ("train", "evaluate_knn", "evaluate_probe", "evaluate"):
            extra = [] if mode == "train" else [f"--{mode}", "true"]
            args = eurosat.get_args_parser().parse_args(
                CLS_CLI_ARGS + ["--arch", "resnet50", "--output_dir", out_dir] + extra)
            results[mode] = eurosat.run(args)
        launches = dict(_build.LAUNCHES)
    print(f"[eurosat cli resnet50] {results}")
    _check_launches("eurosat cli resnet50", launches, {})
    if not all(0.0 <= v <= 100.0 for v in results.values()):
        raise AssertionError(f"eurosat CLI results outside [0, 100]: {results}")
    if results["evaluate"] != results["train"]:
        raise AssertionError("--evaluate of the best checkpoint disagrees with the run that wrote it")

    gen = torch.Generator(device="cuda").manual_seed(13)
    cfg = ClsConfig(arch="resnet50", num_classes=CLS_CLASSES)
    state = init_cls_train_state(cfg, seed=0, device="cuda")
    for frozen in (False, True):
        step_cfg = dataclasses.replace(cfg, freeze_backbone=frozen)
        tag = "cls resnet50" + (" frozen" if frozen else "")
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        _check_launches(tag, _cls_steps(torch, state, step_cfg, RESNET_CLS_STEPS, gen, tag, smi),
                        {})
        now = state.model.state_dict()
        params = [k for k, _ in state.model.named_parameters() if k.startswith("backbone.")]
        same = all(torch.equal(now[k], before[k]) for k in params)
        stats = statistics.median(
            (now[k] - before[k]).abs().max().item() for k in now if k.endswith("running_var"))
        print(f"[{tag}] backbone parameters bit-identical: {same}; running variances "
              f"median max|change| {stats:.3e}")
        if same != frozen or not stats > 0:
            raise AssertionError(f"{tag}: parameters bit-identical {same}, running stats {stats}")
    return total


def _seg_frame(torch, seed):
    """A normalized 3840 x 2160 frame and its class mask, made on the card."""
    from dinomc_tpu_torch.data.seg_datasets import UAVID
    from dinomc_tpu_torch.ops.augment import normalize

    gen = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.rand(FRAME_H, FRAME_W, 3, generator=gen, device="cuda")
    mask = torch.randint(0, UAVID.num_classes, (FRAME_H, FRAME_W), generator=gen, device="cuda")
    return normalize(image, UAVID.mean, UAVID.std), mask


def _write_frames(root, n, seed):
    """``n`` 3840 x 2160 RGB PNGs and palette masks under root/{images,masks}."""
    import numpy as np
    from PIL import Image

    from dinomc_tpu_torch.data.seg_datasets import UAVID

    rng = np.random.RandomState(seed)
    palette = np.asarray(UAVID.palette, np.uint8)
    for sub in ("images", "masks"):
        os.makedirs(f"{root}/{sub}")
    for i in range(n):
        pixels = rng.randint(0, 256, (FRAME_H, FRAME_W, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(f"{root}/images/frame_{i}.png", compress_level=1)
        mask = palette[rng.randint(0, UAVID.num_classes, (FRAME_H, FRAME_W))]
        Image.fromarray(mask).save(f"{root}/masks/frame_{i}.png", compress_level=1)


def phase_full_res(torch, smi):
    """Phase 14, part one: tiled full-resolution segmentation inference.
    Returns the launches of its main paths, summed by kernel."""
    import numpy as np

    from dinomc_tpu_torch.cli import evaluate_stitched, predict
    from dinomc_tpu_torch.cli.train_seg import get_args_parser as seg_parser, train_seg
    from dinomc_tpu_torch.data.seg_datasets import UAVID
    from dinomc_tpu_torch.eval.metrics import confusion_matrix
    from dinomc_tpu_torch.eval.tiled_inference import (
        evaluate_tiled, stitch_from_files, tiled_predict,
    )
    from dinomc_tpu_torch.models.upernet import UPerNetConfig
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.seg_trainer import SegConfig, init_seg_train_state, seg_predict

    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    C = UAVID.num_classes
    model = init_seg_train_state(SegConfig(model=UPerNetConfig(num_classes=C)), 0, "cuda").model
    depth = len(model.backbone.vit.blocks)
    x, mask = _seg_frame(torch, 14)

    def predict_fn(batch):
        return seg_predict(model, batch)

    for size, grid in TILED_RUNS:
        tag = f"tiled {size} px {grid[0]} x {grid[1]}"
        _build.LAUNCHES.clear()
        canvas = tiled_predict(predict_fn, x, grid, size)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        kernel = "attention_fwd" if size == 224 else "long_attention_fwd"
        _check_launches(tag, launches, {kernel: depth})
        add(launches)
        if canvas.shape != (FRAME_H, FRAME_W, C) or not bool(canvas.isfinite().all()):
            raise AssertionError(f"{tag}: canvas {tuple(canvas.shape)}, finite "
                                 f"{bool(canvas.isfinite().all())}")
        del canvas
        ms = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TILED_REPEATS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            tiled_predict(predict_fn, x, grid, size)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        print(f"[{tag}] a 3840 x 2160 frame: ms (CUDA events, host-issued) "
              f"{[round(v, 3) for v in ms]}, median {statistics.median(ms):.3f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{smi}]")

    # evaluate_tiled's mIoU against the mIoU of the confusion matrix of the
    # argmax, on the same logits: the model's output is recorded, and the
    # canvas rebuilt from it by the same resize and stitch
    outputs = []

    def recording_fn(batch):
        outputs.append(predict_fn(batch))
        return outputs[-1]

    scores = evaluate_tiled(recording_fn, [(x, mask)], C, (2, 2), 224)
    canvas = tiled_predict(lambda batch: outputs[0], x, (2, 2), 224)
    cm = confusion_matrix(canvas.argmax(-1), mask, C).float()
    tp = cm.diagonal()
    inter, union = tp.cpu().numpy(), (cm.sum(1) + cm.sum(0) - tp).cpu().numpy()
    miou = float((inter / np.maximum(union, 1e-10))[union > 0].mean())
    print(f"[evaluate_tiled] mIoU {scores['miou']:.6f}, from the confusion matrix {miou:.6f}")
    if scores["miou"] != miou or scores["n_images"] != 1:
        raise AssertionError(f"evaluate_tiled's mIoU {scores['miou']} is not the confusion "
                             f"matrix's {miou}")
    del canvas, outputs, x, mask

    with tempfile.TemporaryDirectory() as root:
        _write_frames(root, STITCHED_FRAMES, 14)
        # a train_seg checkpoint directory: one 224 px step from seed 0
        seg_out = f"{root}/seg"
        seg_args = seg_parser().parse_args(SEG_ARGS + [
            "--image_size", "224", "--max_steps", "1", "--output_dir", seg_out])
        trained = train_seg(seg_args).state.model.state_dict()

        args = evaluate_stitched.get_args_parser().parse_args([
            "--device", "cuda", "--data_root", root, "--grid", "2", "2",
            "--export_logits_dir", f"{root}/logits"])
        canvases = {}
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        cli_scores = evaluate_stitched.run(
            args, on_frame=lambda stem, logits: canvases.update({stem: logits}))
        cli_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        _check_launches("evaluate_stitched cli", launches,
                        {"attention_fwd": STITCHED_FRAMES * depth})
        add(launches)
        print(f"[evaluate_stitched cli] {STITCHED_FRAMES} PNG frames of 3840 x 2160: mIoU "
              f"{cli_scores['miou']:.4f}, {cli_s:.3f} s with decoding and export, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{smi}]")
        for stem, logits in canvases.items():
            rebuilt = stitch_from_files(f"{root}/logits", f"{root}/logits/patches_metadata.json",
                                        (FRAME_H, FRAME_W), basename=stem, device="cuda")
            if not torch.equal(rebuilt, logits):
                raise AssertionError(f"the exported patches of {stem} do not rebuild its canvas")
        print(f"[evaluate_stitched cli] the exported patches rebuild all {len(canvases)} "
              "canvases bit for bit")

        args = predict.get_args_parser().parse_args([
            "--device", "cuda", "--image", f"{root}/images/frame_0.png", "--grid", "2", "2",
            "--ckpt", f"{seg_out}/checkpoints", "--out", f"{root}/pred.png",
            "--figure", f"{root}/figure.png"])
        loaded = predict.load_seg_model(args, UAVID, torch.device("cuda")).state_dict()
        if not all(torch.equal(loaded[k], trained[k]) for k in trained):
            raise AssertionError("--ckpt did not restore the train_seg checkpoint")
        del loaded
        _build.LAUNCHES.clear()
        pred = predict.run(args)
        launches = dict(_build.LAUNCHES)
        _check_launches("predict cli", launches, {"attention_fwd": depth})
        add(launches)
        if pred.shape != (FRAME_H, FRAME_W) or not os.path.getsize(f"{root}/pred.png"):
            raise AssertionError(f"predict CLI: mask {pred.shape}")
        print(f"[predict cli] --grid 2 2 with a train_seg checkpoint: mask {pred.shape}, classes "
              f"{np.bincount(pred.ravel(), minlength=C).tolist()}")
    return total


def _oscd_tree(root):
    """Three cities of change pairs from ``make_change_pair``: two train
    cities and one val city of the official split, 384 px each."""
    import numpy as np
    from PIL import Image

    from dinomc_tpu_torch.utils.synthetic import make_change_pair

    for i, city in enumerate(("beirut", "paris", "brasilia")):
        os.makedirs(f"{root}/{city}")
        img1, img2, change = make_change_pair(OSCD_SIDE, np.random.RandomState(14 + i))
        for name, arr in (("t1", img1), ("t2", img2), ("cm", change)):
            Image.fromarray((arr * 255 + 0.5).astype(np.uint8)).save(f"{root}/{city}/{name}.png")


def phase_oscd(torch, smi):
    """Phase 14, part two: OSCD change detection through ``cli.oscd``."""
    from dinomc_tpu_torch.cli import oscd
    from dinomc_tpu_torch.models.siamese import SiameseConfig
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.oscd_trainer import OSCDConfig, init_oscd_train_state

    with tempfile.TemporaryDirectory() as root:
        _oscd_tree(root)
        frozen = oscd.get_args_parser().parse_args(
            OSCD_ARGS + ["--data_path", root, "--output_dir", f"{root}/frozen"])
        _build.LAUNCHES.clear()
        first = oscd.run(frozen)
        _check_launches("oscd cli frozen", dict(_build.LAUNCHES), {})
        init = init_oscd_train_state(OSCDConfig(model=SiameseConfig()), frozen.seed,
                                     "cuda").model.state_dict()
        now = first.state.model.state_dict()
        enc = [k for k in now if k.startswith("encoder.")]
        params = [k for k, _ in first.state.model.named_parameters()]
        dec = [k for k in params if not k.startswith("encoder.")]
        same = all(torch.equal(now[k], init[k]) for k in enc)
        moved = max((now[k] - init[k]).abs().max().item() for k in dec)
        panels = sorted(os.listdir(f"{root}/frozen/panels/epoch_000"))
        warm = first.step_ms[1:]
        print(f"[oscd cli frozen] losses {first.losses}, epochs {first.epochs}; encoder "
              f"parameters and running statistics bit-identical: {same}; decoder max|change| "
              f"{moved:.3e}; panels {panels}")
        print(f"[oscd cli frozen] step ms (CUDA events, upload + step) "
              f"{[round(v, 3) for v in first.step_ms]}, warm {statistics.median(warm):.3f} ms "
              f"at B = {OSCD_B}, {OSCD_TILE} px  [{smi}]")
        if not (same and moved > 0 and len(first.losses) == 2 and len(panels) == 4
                and all(math.isfinite(r["f1"]) for r in first.epochs)):
            raise AssertionError("OSCD frozen-encoder run: see the lines above")

        # a rerun resumes from the one checkpoint kept, the best epoch's (the
        # later of equal F1s), and trains on from there up to --max_steps
        again = oscd.run(frozen)
        best = max(first.epochs, key=lambda r: (r["f1"], r["epoch"]))
        print(f"[oscd cli resume] start epoch {again.start_epoch}, step {again.state.step} after "
              f"{len(again.losses)} more, best F1 {again.best_f1:.4f} (the first run's best: "
              f"epoch {best['epoch']}, step {best['step']}, F1 {first.best_f1:.4f})")
        if (again.start_epoch != best["epoch"] + 1 or again.best_f1 < first.best_f1
                or again.state.step != best["step"] + len(again.losses)):
            raise AssertionError("the resumed run did not start from the best checkpoint")

        trained = oscd.get_args_parser().parse_args(
            OSCD_ARGS + ["--data_path", root, "--output_dir", f"{root}/trained",
                         "--freeze_encoder", "false"])
        _build.LAUNCHES.clear()
        out = oscd.run(trained)
        _check_launches("oscd cli trained", dict(_build.LAUNCHES), {})
        now = out.state.model.state_dict()
        # the optimizer's move (parameters) apart from the forward's
        # (running statistics, which train mode moves whatever the optimizer does)
        enc_params = [k for k in params if k.startswith("encoder.")]
        still = [k for k in enc_params if torch.equal(now[k], init[k])]
        moved = max((now[k] - init[k]).abs().max().item() for k in enc_params)
        stats = [k for k in enc if "running_" in k]
        stats_moved = max((now[k] - init[k]).abs().max().item() for k in stats)
        tracked = {int(now[k]) for k in enc if k.endswith("num_batches_tracked")}
        print(f"[oscd cli trained] losses {out.losses}; encoder parameters max|change| "
              f"{moved:.3e}, {len(enc_params) - len(still)} of {len(enc_params)} moved; "
              f"running statistics max|change| {stats_moved:.3e}; num_batches_tracked "
              f"{sorted(tracked)} (implied {2 * len(out.losses)}); step ms "
              f"{[round(v, 3) for v in out.step_ms]}  [{smi}]")
        if not (not still and stats_moved > 0 and tracked == {2 * len(out.losses)}
                and len(out.losses) == 2):
            raise AssertionError("OSCD trained-encoder run: see the line above")


def _ben_tree(root):
    """BEN_PATCHES BigEarthNet patch folders of BEN_SIZE px band PNGs
    (``<patch>_B02.png``, ``_B03``, ``_B04``) and their
    ``<patch>_labels_metadata.json`` of 1-4 CLC-43 names, from a seed."""
    import numpy as np
    from PIL import Image

    from dinomc_tpu_torch.data.classification import BEN19_GROUPS

    clc = [name for group in BEN19_GROUPS.values() for name in group]
    rng = np.random.default_rng(15)
    for i in range(BEN_PATCHES):
        name = f"S2B_MSIL2A_{i:05d}"
        os.makedirs(f"{root}/{name}")
        for band in ("B02", "B03", "B04"):
            img = rng.integers(0, 256, (BEN_SIZE, BEN_SIZE, 3), dtype=np.uint8)
            Image.fromarray(img).save(f"{root}/{name}/{name}_{band}.png")
        labels = [str(x) for x in rng.choice(clc, int(rng.integers(1, 5)), replace=False)]
        with open(f"{root}/{name}/{name}_labels_metadata.json", "w") as f:
            json.dump({"labels": labels}, f)


def phase_xcit(torch, smi):
    """XCiT pretraining and fine-tune steps, then the BigEarthNet CLI.
    Returns the launches of the phase's main paths, summed by kernel."""
    import dataclasses

    from dinomc_tpu_torch.cli import bigearthnet
    from dinomc_tpu_torch.cli.train_dino import build_config, build_schedules, get_args_parser
    from dinomc_tpu_torch.ops.augment import draw_multicrop, multicrop_augment
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.cls_trainer import ClsConfig, init_cls_train_state
    from dinomc_tpu_torch.train.dino_trainer import init_dino_train_state

    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    crops = 2 + len(build_config(get_args_parser().parse_args(XCIT_TRAIN_ARGS), 1)[0].local_sizes)
    for arch, steps in (("xcit_small_12", 5), ("xcit_medium_24", XCIT_M_STEPS)):
        tag = f"{arch}/8 train"
        launches = _train_run(torch, smi, XCIT_TRAIN_ARGS + [
            "--arch", arch, "--max_steps", str(steps)], tag, steps)[0]
        _check_launches(tag, launches, {"photometric": steps * crops})
        add(launches)
        torch.cuda.empty_cache()

    # remat off / full / branches: the same weights, images and DropPath draws
    args = get_args_parser().parse_args(XCIT_TRAIN_ARGS)
    mc_cfg, cfg = build_config(args, 1)
    sch = build_schedules(args, args.batch_size_per_gpu, 1)
    gen = torch.Generator(device="cuda").manual_seed(16)
    B, S = args.batch_size_per_gpu, args.image_size
    batches = [multicrop_augment(torch.rand(B, S, S, 3, generator=gen, device="cuda"),
                                 draw_multicrop(gen, B, S, S, mc_cfg, device="cuda"), mc_cfg)
               for _ in range(2)]
    losses = {}
    for remat, policy in XCIT_REMAT_RUNS:
        state = init_dino_train_state(cfg, args.seed, "cuda")
        _set_backbones(torch, state, remat=remat, remat_policy=policy)
        runs = [_step(torch, state, batch, sch, cfg) for batch in batches]
        name = policy if remat else "off"
        losses[name] = [r[0] for r in runs]
        loss, ms, launches, peak = runs[-1]  # the second step: cuDNN's plans are built
        print(f"[xcit remat {name}] losses {losses[name]}, second step {ms:.3f} ms, "
              f"peak memory {peak:.3f} GiB, launches {launches}  [{smi}]")
        if launches:
            raise AssertionError(f"XCiT step launched {launches}")
        del state
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for name in ("off", "branches")
              for a, b in zip(losses[name], losses["full"]))
    print(f"[xcit remat] loss |policy - full| / |full| max {rel:.3e} (bound {LOSS_RTOL})")
    if not rel <= LOSS_RTOL:
        raise AssertionError("XCiT's remat policies disagree with full")

    cls_gen = torch.Generator(device="cuda").manual_seed(17)
    ccfg = ClsConfig(arch="xcit_small_12", num_classes=CLS_CLASSES)
    state = init_cls_train_state(ccfg, seed=0, device="cuda")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    _check_launches("cls xcit_small_12/8", _cls_steps(
        torch, state, ccfg, XCIT_CLS_STEPS, cls_gen, "cls xcit_small_12/8", smi), {})
    now = state.model.state_dict()
    moved = min(max((now[k] - init[k]).abs().max().item() for k in now if k.startswith(part))
                for part in ("backbone.", "fc."))
    before = {k: v.clone() for k, v in now.items()}
    frozen = dataclasses.replace(ccfg, freeze_backbone=True)
    _check_launches("cls xcit_small_12/8 frozen", _cls_steps(
        torch, state, frozen, XCIT_CLS_STEPS, cls_gen, "cls xcit_small_12/8 frozen", smi), {})
    now = state.model.state_dict()
    same = all(torch.equal(now[k], v) for k, v in before.items() if k.startswith("backbone."))
    print(f"[cls xcit_small_12/8] backbone and classifier moved (min of max|change| "
          f"{moved:.3e}); frozen: backbone bit-identical {same}, classifier moved "
          f"{not torch.equal(now['fc.kernel'], before['fc.kernel'])}")
    if not (moved > 0 and same and not torch.equal(now["fc.kernel"], before["fc.kernel"])):
        raise AssertionError("the XCiT fine-tune: see the line above")
    del state
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        _ben_tree(f"{root}/ben")
        for arch, extra in BEN_ARCHS:
            args = bigearthnet.get_args_parser().parse_args(
                BEN_ARGS + ["--arch", arch, "--data_path", f"{root}/ben",
                            "--output_dir", f"{root}/{arch}"] + extra)
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            best = bigearthnet.run(args)
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            tag = f"bigearthnet cli {arch}"
            print(f"[{tag}] micro mAP {best:.4f}, {wall:.1f} s for {BEN_STEPS} steps of "
                  f"{BEN_B} and a val pass of {BEN_PATCHES} at {BEN_SIZE} px  [{smi}]")
            if not (math.isfinite(best) and 0.0 <= best <= 100.0):
                raise AssertionError(f"{tag}: micro mAP {best}")
            want = {}
            if arch.startswith("vit_"):  # remat 'attn': one K1 and one K2 a block a step
                depth = ClsConfig(arch=arch).encoder().vit_config().depth
                val_batches = -(-BEN_PATCHES // BEN_B)
                want = {"attention_fwd": depth * (BEN_STEPS + val_batches),
                        "attention_bwd": depth * BEN_STEPS}
            _check_launches(tag, launches, want)
            add(launches)
    return total


def _tp_photometric(torch):
    """K3 at DINO-TP's shape: the pre-crop augment of two full 256 px views,
    normalize set to identity, the flip inside. Returns (max|diff|, times)."""
    from dinomc_tpu_torch.ops.hopper import augment as ha

    B, S = TP_PHOTO_B, TP_PHOTO_S
    gen = torch.Generator(device="cuda").manual_seed(S)
    imgs = torch.rand(B, 3, S, S, generator=gen, device="cuda")
    rows = _branch_rows(torch, B, S)  # every stage on and off; the flip on rows 0, 2, 5, 7
    ident = ((0.0,) * 3, (1.0,) * 3)
    out = ha.photometric_kernel(imgs, rows, *ident, True)
    again = ha.photometric_kernel(imgs, rows, *ident, True)
    torch.cuda.synchronize()
    ref = ha.photometric_reference(imgs, rows, *ident, True)
    err = (out - ref).abs().max().item()
    same = torch.equal(out, again)
    flips = int(rows[:, ha.P_FLIP].sum().item())
    print(f"[tp photometric] S={S} B={B} flip=True (on {flips} of {B} rows) identity normalize: "
          f"max|diff| {err:.3e} (bound {PHOTO_ATOL})  bit-identical on a repeat: {same}")
    if not (err <= PHOTO_ATOL and same and 0 < flips < B):
        raise AssertionError("photometric kernel disagrees with its plain version at the TP shape")
    blurred = int(rows[:, ha.P_BLUR].sum().item())
    flops = S * S * (110 * blurred + 30 * (B - blurred))
    t = {
        "ms": _time_ms(torch, lambda: ha.photometric_kernel(imgs, rows, *ident, True)),
        "plain_ms": _time_ms(torch, lambda: ha.photometric_reference(imgs, rows, *ident, True)),
        # with the host's cost of issuing (two launches a call)
        "host_ms": _host_ms(torch, lambda: ha.photometric_kernel(imgs, rows, *ident, True)),
        "bound": _bound(2 * imgs.numel() * 4 + rows.numel() * 4, flops, F32_FLOPS),
    }
    print(f"[tp photometric] S={S} B={B} times: {_fmt(t)}")
    return err, t


def _seco_png_tree(root):
    """TP_LOCATIONS SeCo locations of TP_STAMPS 256 px PNG timestamps each,
    from a seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(18)
    for loc in range(TP_LOCATIONS):
        os.makedirs(f"{root}/{loc:04d}")
        for s in range(TP_STAMPS):
            img = rng.integers(0, 256, (TP_PHOTO_S, TP_PHOTO_S, 3), dtype=np.uint8)
            Image.fromarray(img).save(f"{root}/{loc:04d}/t{s}.png")


def _band_tif_tree(root):
    """BAND_LOCATIONS locations of BAND_STAMPS timestamp directories, each
    one uint16 TIFF a band (PIL ``I;16``), Sentinel-2 digital numbers
    around the B2/B3/B4 quantiles, from a seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(19)
    for loc in range(BAND_LOCATIONS):
        for s in range(BAND_STAMPS):
            d = f"{root}/{loc:04d}/t{s}"
            os.makedirs(d)
            for band in TP_BANDS:
                img = Image.fromarray(
                    rng.integers(0, 160, (TP_PHOTO_S, TP_PHOTO_S)).astype(np.uint16))
                if img.mode != "I;16":
                    raise AssertionError(f"PIL wrote a uint16 band as {img.mode}")
                img.save(f"{d}/{band}.tif")


def _accum_compare(torch, smi):
    """One ``dino_train_step_accum`` at A = 2 against one ``dino_train_step``
    from the same weights and crops (ViT-S/8, B = 8, SGD with no clipping
    or weight decay, no DropPath): tests/test_dino_train_step.py::
    test_grad_accum_matches_big_batch's bounds, with at least half the
    trained leaves' big-batch change ``ACCUM_MIN_REACH`` times the
    parameters' bound, so that a wrong scale of the gradients shows.
    Returns the two steps' launches."""
    from dinomc_tpu_torch.cli.train_dino import build_config, build_schedules, get_args_parser
    from dinomc_tpu_torch.ops.augment import draw_multicrop, multicrop_augment
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.dino_trainer import (
        dino_train_step, dino_train_step_accum, init_dino_train_state,
    )

    args = get_args_parser().parse_args(TRAIN_ARGS + ACCUM_SGD_ARGS)
    mc_cfg, cfg = build_config(args, 1)
    sch = build_schedules(args, args.batch_size_per_gpu, 1)
    gen = torch.Generator(device="cuda").manual_seed(20)
    B, S = args.batch_size_per_gpu, args.image_size
    images = torch.rand(B, S, S, 3, generator=gen, device="cuda")
    g, locals_ = multicrop_augment(images, draw_multicrop(gen, B, S, S, mc_cfg, device="cuda"), mc_cfg)
    runs = {}
    for name, step in (("big batch", lambda st: dino_train_step(st, g, locals_, sch, cfg)),
                       ("A = 2", lambda st: dino_train_step_accum(st, g, locals_, sch, cfg, 2))):
        state = init_dino_train_state(cfg, args.seed, "cuda")
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        loss = step(state)["loss"].item()
        runs[name] = (state, loss, dict(_build.LAUNCHES))
    (big, l_big, n_big), (acc, l_acc, n_acc) = runs["big batch"], runs["A = 2"]
    init = init_dino_train_state(cfg, args.seed, "cuda")
    worst, reach, still = 0.0, {}, []
    for (k, a), b, p0 in zip(acc.student.named_parameters(), big.student.parameters(),
                             init.student.parameters()):
        bound = 2e-6 + 2e-4 * b.abs()
        worst = max(worst, ((a - b).abs() / bound).max().item())
        r = ((b - p0).abs() / bound).max().item()  # the big step's change over the bound
        if r > 0:
            reach[k] = r
        else:
            still.append(k)
    least, most = min(reach, key=reach.get), max(reach, key=reach.get)
    reached = sum(r >= ACCUM_MIN_REACH for r in reach.values())
    center = ((acc.center - big.center).abs() / (1e-6 + 1e-5 * big.center.abs())).max().item()
    loss_ratio = abs(l_acc - l_big) / (1e-5 + 1e-5 * abs(l_big))
    print(f"[accum A=2 vs big batch] {cfg.compute_dtype}, SGD, no DropPath, clipping or weight "
          f"decay, lr {float(sch.lr[0]):.3e}: loss {l_acc:.7f} / {l_big:.7f}; |diff| / bound: "
          f"loss {loss_ratio:.3f}, centre {center:.3f}, parameters {worst:.3f} (bounds loss and "
          f"centre rtol 1e-5, parameters rtol 2e-4 atol 2e-6)")
    print(f"[accum A=2 vs big batch] the big step's largest change over the parameters' bound, "
          f"leaf by leaf: {reached} of {len(reach)} trained leaves at >= {ACCUM_MIN_REACH} "
          f"(need half); least {reach[least]:.3f} ({least}), median "
          f"{statistics.median(reach.values()):.3f}, most {reach[most]:.3f} ({most}); "
          f"unmoved {still}")
    if still != ["head.last_layer.weight_g"] or 2 * reached < len(reach):
        raise AssertionError("the big-batch step is too small to show a wrong accumulation")
    if not (loss_ratio <= 1 and center <= 1 and worst <= 1):
        raise AssertionError("the accumulated step disagrees with the big-batch step")
    depth = cfg.encoder(True).vit_config().depth
    _check_launches("accum big batch step", n_big, {"attention_fwd": 5 * depth,
                                                    "attention_bwd": 4 * depth})
    _check_launches("accum A=2 step", n_acc, {"attention_fwd": 2 * 5 * depth,
                                              "attention_bwd": 2 * 4 * depth})
    return n_big, n_acc


def _accum_memory(torch, smi):
    """One bf16 ViT-S/8 step at A = 1, 2 and 4 (B = 8, AdamW, DropPath
    0.1), each from a fresh state: ms and peak memory, which must fall with
    A. Returns the launches, summed."""
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.dino_trainer import dino_train_step_accum, init_dino_train_state

    cfg, sch, batches = _dino_setup(torch)
    total, peaks = {}, {}
    for A in ACCUM_RUNS:
        state = init_dino_train_state(cfg, 0, "cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = dino_train_step_accum(state, *batches[0], sch, cfg, accum=A)["loss"]
        b.record()
        b.synchronize()
        peaks[A] = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(_build.LAUNCHES)
        print(f"[accum A={A}] loss {loss.item():.6f}, step {a.elapsed_time(b):.3f} ms (the first "
              f"of its state), peak memory {peaks[A]:.3f} GiB, launches {launches}  [{smi}]")
        _check_launches(f"accum A={A}", launches, {"attention_fwd": A * 60, "attention_bwd": A * 48})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del state
    if not all(peaks[x] > peaks[y] for x, y in zip(ACCUM_RUNS, ACCUM_RUNS[1:])):
        raise AssertionError(f"peak memory does not fall with A: {peaks}")
    return total


def phase_tp(torch, smi):
    """DINO-TP, multispectral bands, packed corpora and gradient
    accumulation. Returns (K3's max|diff| and times at the TP shape, the
    launches of the phase's main paths summed by kernel)."""
    from dinomc_tpu_torch.cli import pack_data
    from dinomc_tpu_torch.data import native_loader

    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    tp_err, tp_t = _tp_photometric(torch)
    per_step = {"attention_fwd": 60, "attention_bwd": 48}

    def want(steps, photometric):
        return {**{k: v * steps for k, v in per_step.items()}, "photometric": photometric * steps}

    add(_train_run(torch, smi, TRAIN_ARGS + ["--data_mode", "tp"], "tp train", 5,
                   want(5, 2))[0])
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        _seco_png_tree(f"{root}/seco")
        line = pack_data.main(["--src", f"{root}/seco", "--out", f"{root}/packed",
                               "--size", str(TP_PHOTO_S)])
        if line["packed"] != TP_LOCATIONS * TP_STAMPS or line["groups"] != TP_LOCATIONS:
            raise AssertionError(f"pack_data: {line}")
        short = ["--max_steps", "2", "--data_path", f"{root}/packed"]
        add(_train_run(torch, smi, TRAIN_ARGS + short + ["--data_mode", "tp"], "tp packed", 2,
                       want(2, 2), torch.uint8)[0])
        add(_train_run(torch, smi, TRAIN_ARGS + short, "mc packed", 2, want(2, 8),
                       torch.uint8)[0])

        _band_tif_tree(f"{root}/bands")
        probe = f"{root}/bands/0000/t0/{TP_BANDS[0]}.tif"
        try:
            import rasterio  # noqa: F401
            reader = "rasterio"
        except ImportError:
            reader = "native" if native_loader.read_band(probe) is not None else "PIL"
        print(f"[bands] band reader: {reader} (native loader available: "
              f"{native_loader.available()})")
        short = ["--max_steps", "2", "--data_path", f"{root}/bands", "--bands", *TP_BANDS]
        add(_train_run(torch, smi, TRAIN_ARGS + short, "bands mc", 2, want(2, 8),
                       torch.float32)[0])
        add(_train_run(torch, smi, TRAIN_ARGS + short + ["--data_mode", "tp"], "bands tp", 2,
                       want(2, 2), torch.float32)[0])

    for n in _accum_compare(torch, smi):
        add(n)
    add(_accum_memory(torch, smi))
    torch.cuda.empty_cache()
    short = ["--max_steps", "2", "--grad_accum_steps", "2"]
    vit_accum = {k: 2 * v for k, v in want(2, 4).items()}  # K1/K2 twice a step, K3 8 a step
    for tag, base, kernels in (("vit_small/8", TRAIN_ARGS, vit_accum),
                               ("resnet50", RESNET_TRAIN_ARGS, {"photometric": 16}),
                               ("xcit_small_12/8", XCIT_TRAIN_ARGS, {"photometric": 16})):
        tag = f"{tag} accum 2 train"
        add(_train_run(torch, smi, base + short, tag, 2, kernels)[0])
        torch.cuda.empty_cache()
    return tp_err, tp_t, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = phase_card(torch)
    fwd_err, grad_err, attn_t = phase_attention(torch)
    photo_err, photo_t = phase_photometric(torch)
    launches = phase_train(torch, smi)
    long_err, long_t = phase_long_attention(torch)
    seg_launches = phase_seg(torch, smi)
    win_err, win_t = phase_window_attention(torch)
    swin_launches = phase_swin_train(torch, smi)
    mlp_err, mlp_t = phase_fused_mlp(torch)
    wins_err, wins_t, wins_launches = phase_window_attention_stacked(torch, win_t)
    mlp_launches = phase_fused_mlp_train(torch, smi)
    cls_launches = phase_cls(torch, smi)
    convnet_launches = phase_convnets(torch, smi)
    full_res_launches = phase_full_res(torch, smi)
    phase_oscd(torch, smi)
    xcit_launches = phase_xcit(torch, smi)
    tp_err, tp_photo_t, tp_launches = phase_tp(torch, smi)

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dinomc_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")
    src = "dinomc_tpu_torch/csrc/"

    def entry(name, source, replaces, n, err, ms, plain_ms, bound, library_ms):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}

    def with_cls(counts, name):  # a main path's launches, phases 12, 14-16's counted in
        return (counts.get(name, 0) + cls_launches.get(name, 0) + full_res_launches.get(name, 0)
                + xcit_launches.get(name, 0) + tp_launches.get(name, 0))

    kernels = [
        entry("attention_fwd", "attention.cu", "dinomc_tpu/ops/pallas/attention.py:162",
              with_cls(launches, "attention_fwd"), fwd_err, attn_t["fwd_ms"],
              attn_t["fwd_plain_ms"], attn_t["fwd_bound"], attn_t["fwd_library_ms"]),
        entry("attention_bwd", "attention.cu", "dinomc_tpu/ops/pallas/attention.py:188",
              with_cls(launches, "attention_bwd"), grad_err, attn_t["bwd_ms"],
              attn_t["bwd_plain_ms"], attn_t["bwd_bound"], attn_t["bwd_library_ms"]),
        entry("photometric", "photometric.cu", "dinomc_tpu/ops/pallas/augment.py:194",
              launches.get("photometric", 0) + convnet_launches.get("photometric", 0)
              + xcit_launches.get("photometric", 0) + tp_launches.get("photometric", 0),
              max(photo_err, tp_err), photo_t["ms"], photo_t["plain_ms"], photo_t["bound"], None),
    ]
    for name, line, key in (("long_attention_fwd", 150, "fwd"), ("long_attention_dq", 174, "dq"),
                            ("long_attention_dkv", 187, "dkv")):
        kernels.append(entry(
            name, "attention_long.cu", f"dinomc_tpu/ops/pallas/attention_long.py:{line}",
            seg_launches.get(name, 0) + full_res_launches.get(name, 0), long_err[key],
            long_t[f"{key}_ms"], long_t[f"{key}_plain_ms"], long_t[f"{key}_bound"],
            long_t[f"{key}_library_ms"]))
    stage1 = win_t[0]  # the timed shape: stage 1 of the 224 px globals
    for name, line, key, err in (("window_attention_fwd", 281, "fwd", win_err["fwd"]),
                                 ("window_attention_bwd", 319, "bwd", win_err["grad"])):
        kernels.append(entry(
            name, "window_attention.cu", f"dinomc_tpu/ops/pallas/window_attention.py:{line}",
            with_cls(swin_launches, name), err, stage1[f"{key}_ms"], stage1[f"{key}_plain_ms"],
            stage1[f"{key}_bound"], stage1[f"{key}_library_ms"]))
    stacked1 = wins_t[0]
    for name, line, key, err in (("window_attention_stacked_fwd", 558, "fwd", wins_err["fwd"]),
                                 ("window_attention_stacked_bwd", 591, "bwd", wins_err["grad"])):
        kernels.append(entry(
            name, "window_attention_stacked.cu",
            f"dinomc_tpu/ops/pallas/window_attention.py:{line}", wins_launches.get(name, 0), err,
            stacked1[f"{key}_ms"], stacked1[f"{key}_plain_ms"], stacked1[f"{key}_bound"],
            stacked1[f"{key}_library_ms"]))
    kernels.append(entry(
        "fused_mlp", "fused_mlp.cu", "dinomc_tpu/ops/pallas/fused_mlp.py:64",
        mlp_launches.get("fused_mlp", 0), mlp_err, mlp_t["ms"], mlp_t["plain_ms"], mlp_t["bound"],
        mlp_t["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
