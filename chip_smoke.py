#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``retinanet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card of capability 9.0 (H100); exits non-zero without one.
Phases, one line each (any failure raises and the exit code is non-zero):

1. device: torch version, ``nvidia-smi`` name and power limit, capability;
2. build: the seven hand-written kernel sources with ``nvcc``, started
   together; ptxas register/smem/spill lines;
3. B1 check: fused bottleneck kernel vs its plain version at the four
   stage shapes of the 640-px flagship (batch 2 and 8, randomized GN
   γ/β), bitwise repeatability, and its kernels per call (4, and no
   other kernel with the weight layouts made beforehand);
4. B2 check: NMS keep-mask kernel vs the plain greedy mask on clustered,
   class-offset boxes with parked invalids (``B2_CASES``: the b8 and b128
   serving shapes, N = 2048, 4125 (the reference decode path at 640 px),
   5000, 8192 and 16384, 63-65 and 1 boxes, exact IoU ties): exactly
   equal and repeatable;
5. B3 check: fused bottleneck backward kernel vs its plain version at the
   four stage shapes (batch 2 and 8, randomized γ/β, random bf16 dout):
   for dx and each parameter gradient, max |Δ|/max|ref| and correlation
   against the plain version run on the kernel's own recomputed forward
   (the same relu masks), ‖Δ‖₂/‖ref‖₂ and correlation against the plain
   version's own recompute, the share of relu decisions the two
   recomputes flip, accuracy against the float64 gradient, bitwise
   repeatability, and its recomputed forward (y1..y3, GN statistics)
   bitwise B1's (``return_forward=True`` on both);
6. serving path: resnet_50_dense RetinaNet at 640 px, 80 classes, bf16,
   seeded random weights, through ``Detector`` at batch 8, at the default
   NMSConfig and at score_threshold 0.005; launch counts, head outputs vs
   the unfused plain path, B2 on the model's own candidates; then the
   decode phase: the reference path (``decode_levels`` + ``nms_padded``)
   on the serving model's own heads at batch 8 against
   ``fused_decode_nms`` at the default NMSConfig and at score_threshold
   0.005, and with every candidate (``pre_nms_top_k=None``, [8,4125,4])
   through one counted B2 launch whose mask equals the plain mask; both
   paths timed at batch 8 and 128;
7. training path: the same flagship with ``fused_train`` through
   ``make_train_step`` at batch 8 on a fixed batch; launch counts per
   step (12 B1 + 12 B3), one step vs the plain path from the same
   parameters (losses, grad_norm, and every parameter's gradient leaf by
   leaf), the same for the step with B4 in the model and for planted B3
   faults, each of which must be rejected, and the loss over 10 steps;
8. B4/B5/B7 checks: fused GroupNorm+activation vs its plain version, on
   each of its paths (split; cluster where the image fits), at every
   GroupNorm shape the model gives at or above the 2^18 gate (forward
   hooks on the kernel, int8 and training paths) and at ``B4_EXTRA``,
   bf16 and fp32, with its kernels per call (2 split, 1 cluster), and its
   backward vs autograd of the plain forward; the projection block at
   res2 b0 (batch 2 and 8) to B1's bound; the stem epilogue bitwise at
   ``B7_CASES`` (batch 2, 8 and 128 at the stem's shape, odd sides whose
   last 4-row band is 1, 2 or 3 rows, C = 256 and 2048); each bitwise
   repeatable;
9. int8 serving: the flagship with ``quantize="int8"`` (and the fused
   flags, which the int8 gate ignores) through ``Detector`` at batch 8:
   59 B6 launches and no B1/B5; every weight scale s_w the correctly
   rounded quotient amax / 127; a second forward profiled: three B6
   kernels per conv and no weight quantized again; heads vs the int8
   plain path; then B6 at every distinct int8 conv shape that run gave,
   bitwise, with weights quantized in the call and prepared; at odd
   sides (stride 2 padding both sides) and fp32 in and out;
10. ``fused_proj`` serving: 12 B1 + 1 B5 launches per forward, heads vs
   the unfused plain path;
11. B4 in the model (``gn``): every GroupNorm of the serving model set
   to ``use_kernel`` (no config field, no default changed), counted (B4
   launches equal the gated GroupNorm calls), heads vs the plain path,
   the kernels next to each B4 launch (no copy or transpose), then in
   turns with and without B4: b128 images/s on the kernel and int8
   paths, b8 latency, the b32 ``fused_train`` step;
   entry points: ``GroupNorm(use_kernel=True)`` at ``ENTRY_GN`` (P5
   under the gate takes ``group_norm``) and ``fused_stem`` on a 640-px
   batch (B7: no model config reaches it, as in the JAX package);
   ``fused_stem`` equals the model's stem layers bitwise;
12. timing: serving images/s and p50 at batch 8 and 128 (bf16 kernel,
   int8 and plain paths; ``fused_proj`` against the same config without
   it at 128); training step ms, images/s and peak memory of both paths
   at batch 8 and 32; each kernel vs its plain version (and a PyTorch
   call computing the same function, where one exists) at the paths'
   shapes (CUDA events after warmup), with its bound at the card's
   published peaks.  B1 by launch group (``B1_GROUPS``: the three GEMMs,
   the residual pass, host copies) per stage; B3 by launch group
   (``B3_GROUPS``) and kernel from a profile, at batch 8 and at batch 32
   on res2; B6 per conv shape
   three ways (the whole conv with prepared weights; its launches, and
   its GEMM alone, queued behind a sleep kernel so that only device time
   counts, beside ``torch._int_mm`` on the same quantized operands); B2
   at batch 8 and 128 by kernel, with the floor of its dependency chain;
   B4 on each path at ``B4_SWEEP`` (the measurements behind its path
   rule) and at ``B4_TIMED``, with and without the activation, beside
   ``F.group_norm``; B7 at batch 8 and 128 per call and in device time,
   beside ``F.max_pool2d`` alone on the same y as a yardstick, and ``fused_stem`` by part (conv,
   statistics, B7) beside the model's stem layers, eager and with B4;
   then ``[mfu]`` lines: images/s × ``forward_gflops_per_image`` over the
   bf16 peak for each batch-128 serving path timed;
13. breakdown: ``torch.profiler`` device time by kernel group, idle share
   and kernels per call: serving at batch 8 and 128 (kernel, int8 and
   plain paths; at 128 with B4 in the model too) and training at batch 8
   and 32 (at 32 with B4 too) (``utils/profiling.py``);
14. eval (run after the decode phase): the evaluation path as a user calls
   it, ``retinanet_tpu_torch.evaluate.main`` in-process with
   ``--from-export`` (an export of seeded ``init_params`` weights,
   resnet_50_dense, 3 shapes classes) on a 640-px shapes set of 64 images
   at batch 8 and decode threshold 0.005, on the kernel path
   (``--fused-blocks --fused-res2``: 12 B1 + 1 B2 launches per batch), the
   plain path (1 B2) and ``--quantize int8`` (59 B6 + 1 B2), every other
   kernel 0; one batch through the rectangular bucket 640×448 on the
   kernel path; the kernel path's heads within HEAD_RTOL/HEAD_ATOL of the
   plain path's on each batch it served, the bucket's included; its COCO
   metrics within EVAL_METRIC_BOUND of the plain path's; each path's metrics, images/s over the loop and ms
   per batch in host preparation (``select_canvas`` + ``process_sample``),
   the ``Detector`` call and the evaluator; ``retinanet_tpu_torch.detect``
   on three PNG files (1 B2 launch per batch, detections and annotated
   images); the kernel path's loop over 16 images under
   ``torch.profiler`` (device busy, idle share);
15. backbones: ResNeXt-50 (the default ``resnet_50``), MobileNetV2 and
   DenseNet-121/169 through ``Detector`` at 640 px, 80 classes, bf16, b8,
   on seeded weights (BACKBONES): on the plain path (1 B2 launch a
   batch), with every GroupNorm on B4 (its launches equal the gated
   GroupNorm calls, each call within B4_REL of its plain version, the
   heads at least as close to the float32 model as the eager
   GroupNorm's) and int8 (BACKBONE_B6 B6 + 1 B2 launches, the heads
   within HEAD_RTOL/HEAD_ATOL of the same model on B6's plain version,
   their distance to the float32 model logged); B6 bitwise its plain
   version at every distinct int8 conv (grouped ones as block-diagonal
   dense, C and F padded to 64), each timed beside its bound; images/s
   and p50 at b8 and b128 on the three paths, MFU of the useful work
   (and as run), the training step at b8 at dropout 0.2 and 0; one
   training step with dropout 0.2 with and without remat from one seed
   (REMAT_*), and the host time of a forward's dropout generators;
   ResNeXt-50's grouped 3×3 as it runs
   against ``F.conv2d(groups=32)``; and ResNeXt-50 through the training
   CLI at its default ``--backbone`` (BACKBONE_FIT_*: a resume, finite
   losses, a falling data loss), ``evaluate --experiment`` and ``detect
   --experiment``;
16. distributed: the port's data-parallel runs as ``torchrun`` starts
   them, two ranks spawned on the one card over gloo (DIST_*): the
   flagship at 640 px, full width and depth, global batch 4, two fp32
   steps of the plain path (TF32 off, weight decay on) against one
   process on the same global batches (total_loss and grad_norm relative,
   every parameter absolute, at the JAX shard_map test's bounds widened to
   about twice the one-process fp32 steps' recorded distance to float64,
   fixed; that distance itself held to them as a witness), every
   rank's parameters bitwise rank 0's; a bf16 ``fused_train`` step (12 B1
   + 12 B3 on each rank) whose every gradient leaf is held to the float32
   one-process step as ``check_training`` holds the kernel path's, and a
   planted fault (the loss's global sums left local) that must fail it;
   ``train.main`` on each rank, 4 steps at 320 px with a resume (one
   metrics writer, whole checkpoints, the restore logged on each rank);
   ``evaluate --from-export`` on the eval phase's set (12 B1 + 1 B2 a
   batch on each rank's shard), the same metrics on both ranks and
   within EVAL_METRIC_BOUND of one process; ``Detector(devices=)`` with
   two replicas on the card, bitwise one device on each half of a host
   batch; a one-rank NCCL group through the fp32 step; per-rank step ms
   and peak memory (two ranks share one card: no scaling is measured);
17. fit (last): the training loop as a user drives it
   (``train.parse_args`` and ``Trainer.fit``, what ``train.main`` does,
   with a checkpoint every 100 steps) on the JAX package's shapes-200
   convergence setup at 320 px (FIT_*): the kernel path
   (``--fused-train``) and the plain path, each in a spawned process of
   its own, 1000 steps in two invocations with a resume between; gates:
   12 B1 + 12 B3 launches a step on the kernel path and none on the
   plain, the logged restore, the checkpoints kept, finite losses, the
   data loss below half of step 1's, the profile trace; then each path's
   last checkpoint through ``evaluate.load_detector`` on 64 held-out
   shapes images on its own serving path: AP50 ≥ 0.5 each, the mAPs
   within 0.05, the kernel path's model with every GroupNorm on B4
   within 0.02, int8's mAP logged; ``evaluate --experiment`` equal to
   ``export --experiment`` + ``evaluate --from-export``, ``detect
   --experiment --step`` on two PNG files (1 B2 launch), and
   ``Trainer.write_image_summaries`` (24 PNGs).

``--phases`` runs a comma-separated subset (``build,checks,int8,proj,gn,
entry,serving,decode,eval,training,timing,breakdown,backbones,distributed,
fit``) and
prints no result lines: for a first call after a kernel change.  ``--phases parent`` (not
in the default run) compares kernels with a parent commit's, each whose
module is in ``parent_kernels/`` (git-ignored): B1 and B5
(``bottleneck.py``, within B1's bound, timed in turns, B1 by launch
group), B2 (``nms.py``, equal masks, in turns per call and in device
time), B4 (``groupnorm.py``, both within B4's bound, in turns), B6
(``int8_conv.py``, bitwise given the same s_x and weights), B7
(``stem.py``, both bitwise the plain version, in turns per call and in
device time, batch 8 and 128).
Put there that commit's ``ops/<module>.py`` and the ``ops/csrc`` sources
and headers they build.

Then a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name/power
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import logging
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from retinanet_tpu_torch import detect, evaluate, native, train
from retinanet_tpu_torch.config import Config
from retinanet_tpu_torch.data import pipeline
from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.eval_coco import COCOEvaluator, evaluate_model
from retinanet_tpu_torch.export import (export_model, init_params,
                                        load_exported_detector)
from retinanet_tpu_torch.infer import (Detector, benchmark,
                                       forward_gflops_per_image)
from retinanet_tpu_torch.models.layers import (GN_KERNEL_MIN_ELEMENTS, Conv,
                                               ConvGN, Dropout, DropoutKeys,
                                               GroupNorm, get_activation,
                                               group_norm, max_pool_same,
                                               resolve_groups,
                                               use_group_norm_kernel)
from retinanet_tpu_torch.models import layers, resnet
from retinanet_tpu_torch.models.resnet import ResNetBottleneck
from retinanet_tpu_torch.models.retinanet import RetinaNet
from retinanet_tpu_torch.ops import bottleneck as b1
from retinanet_tpu_torch.ops import losses
from retinanet_tpu_torch.ops import bottleneck_bwd as b3
from retinanet_tpu_torch.ops import groupnorm as b4
from retinanet_tpu_torch.ops import int8_conv as b6
from retinanet_tpu_torch.ops import nms as b2
from retinanet_tpu_torch.ops import stem as b7
from retinanet_tpu_torch.ops.anchors import build_levels
from retinanet_tpu_torch.ops.grouped import block_diagonal
from retinanet_tpu_torch.parallel import distributed
from retinanet_tpu_torch.train import (benchmark_train,
                                       benchmark_train_pipeline,
                                       create_train_state, make_train_step,
                                       synthetic_batch)
from retinanet_tpu_torch.utils import profiling
from retinanet_tpu_torch.utils.profiling import (device_breakdown, group_of,
                                                 kernel_launches,
                                                 kernel_sequence)

SIZE = 640  # the canvas side of every phase
# (H, W, C, F) of the 12 identity blocks at 640 px, with their counts.
STAGES = (("res2", 160, 160, 256, 64, 2), ("res3", 80, 80, 512, 128, 3),
          ("res4", 40, 40, 1024, 256, 5), ("res5", 20, 20, 2048, 512, 2))
# The eval phase's rectangular bucket, H × W = 640 × 448, and the shapes
# of its identity blocks (res2 160 × 112 … res5 20 × 14).
BUCKET = (SIZE, SIZE * 7 // 10)
BUCKET_STAGES = tuple((name, h, w * 7 // 10, c, f, count)
                      for name, h, w, c, f, count in STAGES)
# B1 bound: |Δ| ≤ 2⁻⁵·max(1, |ref|, |n3|) per element, n3 the plain
# version's GN3 output there, and mean |Δ| ≤ 1e-3.  Both versions round
# every conv to bf16 but sum it in another fp32 order, so a conv output
# may sit one bf16 step apart and GN3 carries the step to n3; the residual
# add keeps it whole where x cancels n3, so the step is n3's (at
# [16,40,40,512] an element with n3 ≈ 1.9 and x ≈ −0.86 read 0.035 at
# |ref| ≈ 1).  Against the float64 version of the block, B1's max error at
# most B1_TRUTH_FACTOR × the plain version's + B1_TRUTH_SLACK; and B1's
# output bitwise the plain epilogue (GN3 affine, residual add, relu) of
# its own forward.
B1_REL = 2.0 ** -5
B1_MEAN = 1e-3
B1_TRUTH_FACTOR, B1_TRUTH_SLACK = 1.2, 5e-3
# Head outputs of the kernel path vs the unfused plain path: the JAX
# package's own fused-vs-unfused backbone bound (test_pallas_bottleneck).
HEAD_RTOL, HEAD_ATOL = 5e-2, 1e-1
# B3 bound, for dx and each parameter gradient, with the numbers of the JAX
# package's kernel-vs-autodiff test (test_pallas_bottleneck_bwd.py:65-71):
# max|Δ| ≤ 0.03·max|ref| and correlation ≥ 0.999 against the plain version
# run on the kernel's own recomputed forward (bf16 y1..y3 and fp32 GN
# statistics), so that both take the same relu decisions and part only in
# the order of their fp32 sums.  Against the plain version's own recompute,
# whose conv sums run in another order, a conv output one bf16 step apart
# flips a relu whose input is within a step of 0: at most B3_FLIPS of the
# three masks' decisions may differ, and since one flipped output relu
# moves an element of dx by |dout|, that comparison is held to
# ‖Δ‖₂ ≤ 0.03·‖ref‖₂ and correlation ≥ 0.999.  Against the float64
# gradient (the plain version rounding nowhere) a max error, relative to
# max|truth|, at most 1.2× the plain version's + 5e-3 (the JAX package's
# "at least as accurate" test, :158-227).
B3_REL, B3_CORR, B3_FLIPS = 0.03, 0.999, 1e-3
B3_TRUTH_FACTOR, B3_TRUTH_SLACK = 1.2, 5e-3
B3_OUTPUTS = ("dx", "dk1", "dg1", "db1", "dk2", "dg2", "db2", "dk3", "dg3",
              "db3")
# Training step, kernel path vs plain path from the same parameters: each
# loss within 1% and grad_norm within 0.1% relative.  Gradients are held
# leaf by leaf to the float32 plain path's (the truth, as float64 is for
# B3 alone): a leaf's error ‖g − t‖₂/‖t‖₂ on the kernel path at most
# TRAIN_TRUTH_FACTOR × the bf16 plain path's + TRAIN_TRUTH_SLACK, leaves
# with max|t| < 1e-6 skipped (the JAX package's "at least as accurate"
# criterion, test_pallas_bottleneck_bwd.py:158-227, and its per-leaf
# whole-backbone test, :230-259).  Two bf16 paths part by more than
# either's distance to the truth at 640 px, because GN backwards cancel
# heavily and bf16 cotangents carry the rounding through 16 blocks; so
# the kernel path is held to the truth, not to the plain path.  Each
# planted B3 fault (TRAIN_FAULTS) must fail this comparison.
TRAIN_LOSS_REL, TRAIN_NORM_REL = 1e-2, 1e-3
TRAIN_TRUTH_FACTOR, TRAIN_TRUTH_SLACK, TRAIN_LEAF_MIN = 1.2, 5e-3, 1e-6
TRAIN_STEPS = 10  # the loss must fall over this many steps on one batch


def _zero_dk(g):
    dx, dk1, dg1, db1, dk2, dg2, db2, dk3, dg3, db3 = g
    z = torch.zeros_like
    return dx, z(dk1), dg1, db1, z(dk2), dg2, db2, z(dk3), dg3, db3


def _swap_gn(g):
    dx, dk1, dg1, db1, dk2, dg2, db2, dk3, dg3, db3 = g
    return dx, dk1, db1, dg1, dk2, db2, dg2, dk3, db3, dg3


# Faults planted in B3's output, each a wiring mistake the check must see:
# weight gradients lost, GN γ/β gradients swapped, half of dx lost, and dx
# handed to the wrong images.
TRAIN_FAULTS = {
    "zero_dk": _zero_dk,
    "swap_dgamma_dbeta": _swap_gn,
    "half_dx": lambda g: (g[0] * 0.5, *g[1:]),
    "dx_images_rolled": lambda g: (g[0].roll(1, 0), *g[1:]),
}
# Published peaks of one H100 SXM (dense bf16 and int8 tensor cores, fp32
# outside them, HBM), against which each kernel's bound is stated.
PEAK_BF16, PEAK_INT8, PEAK_FP32, PEAK_BYTES = 989e12, 1979e12, 67e12, 3.35e12
# B4 kernel vs its plain version: both apply an fp32 affine from fp32
# statistics summed in another order, so outputs may sit one bf16 step
# apart: |Δ| ≤ B4_REL·max(1, |ref|) per element (2⁻⁷ in bf16, 1e-4 in
# fp32).  Its backward (the plain fp32 formula of the TPU op's _bwd)
# against autograd of the plain forward: max|Δ| ≤ 1e-3·max|ref| for dx,
# dγ and dβ (sums of 10⁵-10⁶ fp32 terms in another order).
B4_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}
B4_GRAD_REL = 1e-3
# Head activations GN+ELU normalizes, and the stem's GN+relu input, at
# 640 px: (name, H, W, C, activation).
B4_SHAPES = (("P3", 80, 80, 256, "elu"), ("P4", 40, 40, 256, "elu"),
             ("stem", 320, 320, 64, "relu"))
# B4 beyond the model's GroupNorm shapes (checked in bf16 and fp32 with
# them): an odd-sided plane (a 600-px input's res3, 75x57: no row block or
# cluster slice ends on a whole image) and the narrowest and widest channel
# counts of the model's GroupNorms.  (H, W, C, activation).
B4_EXTRA = ((75, 57, 256, "elu"), (75, 57, 64, "relu"), (40, 40, 64, None),
            (20, 20, 2048, None))
# Kernels per call of each B4 path: the split path's statistics and apply
# launches, the cluster path's one.
B4_PATH_KERNELS = {"split": 2, "cluster": 1}
# GroupNorm modules driven as B4's entry point at batch 8: the P3 and P4
# head activations, the stem's, res5's widest (name, H, W, C, activation),
# and P5's, which falls under the 2^18 gate and must take group_norm.
ENTRY_GN = B4_SHAPES + (("res5", 20, 20, 2048, None),
                        ("P5", 20, 20, 256, "elu"))
# res2 b0, the stride-1 projection block at 640 px: H, W, Cin, C, F.
RES2_B0 = (160, 160, 64, 256, 64)
# The stem conv's output at 640 px: H, W, C.
STEM = (320, 320, 64)
# Clock cycles of the sleep kernel ahead of a queued timing (~5 ms), more
# than the host takes to enqueue the timed calls.
QUEUE_CYCLES = 10_000_000
PHASES = ("build", "checks", "int8", "proj", "gn", "entry", "serving",
          "decode", "eval", "training", "timing", "breakdown", "backbones",
          "distributed", "fit")
# The eval phase: ``evaluate.main`` on a 640-px shapes set of EVAL_IMAGES
# images at batch EVAL_BATCH, from an export of seeded ``init_params``
# weights (resnet_50_dense, the three shapes classes), on each path: its
# flags and the launches per batch it must give (every other kernel 0).
EVAL_IMAGES, EVAL_BATCH = 64, 8
EVAL_PATHS = {
    "kernels": (("--fused-blocks", "--fused-res2"), {"b1": 12, "b2": 1}),
    "plain": ((), {"b2": 1}),
    "int8": (("--quantize", "int8"), {"b6": 59, "b2": 1}),
}
# The kernel path's metrics (mAP, AP50, AP75, the area mAPs and AR@k) are
# each held to the plain path's within EVAL_METRIC_BOUND, absolute.  On
# seeded init_params weights every score sits near the π prior (0.01), so
# bf16 rounding re-ranks near-tied detections; on the CPU, the plain path
# in bf16 against float32 (24 shapes images at 256 px) differed by at most
# 0.0044 (AR@100).  The metrics themselves sit below the bound (mAP ~1e-4,
# AR@100 ~0.006), so it tests the mechanism only; the kernel path's heads,
# held to the plain path's on every batch it served, test the agreement.
EVAL_METRIC_BOUND = 0.02
EVAL_BREAKDOWN_IMAGES = 16  # the kernel path's loop under torch.profiler
# Faults planted in B1's output on the eval path, each of which the eval
# heads check must see: the output handed to the wrong images, shifted by
# one row, and scaled by 1.1.
EVAL_FAULTS = {
    "images_rolled": lambda y: y.roll(1, 0),
    "rows_shifted": lambda y: y.roll(1, 2),  # NCHW, channels_last
    "scaled": lambda y: y * 1.1,
}
# The fit phase: the port's training loop (``train.Trainer.fit``) and the
# CLIs that read its checkpoints, on the JAX package's shapes-200
# convergence setup (NOTES.md, "Flagship convergence @640": resnet_50_dense,
# b16, momentum SGD at lr 1e-2, dropout 0, bce+dice) at half its canvas:
# FIT_IMAGES shapes images at FIT_SIZE px, seed FIT_SEED.  Each path trains
# FIT_STEPS steps, in a process of its own (``train_fit_paths``), in two
# invocations of half as many (epochs of
# FIT_EPOCH_STEPS of the 12 batches an epoch holds; the second resumes
# from the first's last checkpoint and restarts at epoch 0, as JAX's
# does), logging every FIT_LOG_EVERY steps, a checkpoint every
# FIT_CHECKPOINT_EVERY of which FIT_KEEP stay; the kernel path's first
# invocation traces FIT_PROFILE steps.  Gates: the mean data loss
# (class_loss + regr_loss: total_loss holds an L2 term of ~2.7 that 400
# steps of weight decay hardly move) of the last 5 logged steps below
# FIT_LOSS_FALL × step 1's; every logged loss finite; on FIT_EVAL_IMAGES
# held-out images (seed FIT_EVAL_SEED) each path's last checkpoint, served
# on its own path (FIT_SERVE), reaches AP50 ≥ FIT_AP50_FLOOR, the two
# mAPs lie within FIT_MAP_GAP, and the kernel path's model with every
# GroupNorm on B4 within FIT_B4_GAP of it.  At 400 steps the held-out mAP
# still climbs fast and two seeds of the plain path end 0.11 apart; from
# ~500 steps on it holds at 0.45-0.53 (PERF.md §6), hence FIT_STEPS.  The
# two paths from one seed part by up to 0.06 mAP (seeds 42-44, the
# ``spread`` phase), on 64 held-out images as on 512 or 1024, and served
# from the last checkpoint as from the mean of the last 3: the noise lies
# in the trained models, not in the images, and the one-seed gate fails
# without a fault for about one seed in three (PERF.md §7).  Each run also
# logs both paths' mAP on FIT_WIDE_EVAL_IMAGES held-out images, ungated.
FIT_IMAGES, FIT_SIZE, FIT_BATCH, FIT_SEED = 200, 320, 16, 42
FIT_STEPS, FIT_EPOCH_STEPS, FIT_LOG_EVERY = 1000, 10, 10
FIT_PROCESS_TIMEOUT = 900  # seconds for both of a path's invocations
FIT_CHECKPOINT_EVERY, FIT_KEEP, FIT_PROFILE = 100, 3, 3
FIT_PATHS = {"kernels": ("--fused-train",), "plain": ()}
FIT_SERVE = {"kernels": ("--fused-blocks", "--fused-res2"), "plain": ()}
FIT_CLASSES = 3  # the shapes set's square, triangle and circle
FIT_LOSS_FALL = 0.5
FIT_EVAL_IMAGES, FIT_WIDE_EVAL_IMAGES, FIT_EVAL_SEED = 64, 512, 7
FIT_SURFACE_IMAGES = 64  # the training images evaluate/detect/export read
FIT_AVERAGE = FIT_KEEP  # checkpoints the spread phase also serves averaged
FIT_AP50_FLOOR, FIT_MAP_GAP, FIT_B4_GAP = 0.5, 0.05, 0.02
# (H, W, C, F) of the 12 identity blocks at FIT_SIZE px, with their counts:
# the fit phase trains and serves them at FIT_BATCH.
FIT_STAGES = tuple((name, h * FIT_SIZE // SIZE, w * FIT_SIZE // SIZE, c, f,
                    count) for name, h, w, c, f, count in STAGES)
# The distributed phase (``check_distributed``): DIST_WORLD ranks, each a
# spawned process on the one card over gloo (NCCL puts no two ranks on one
# device), on slices of a global batch of DIST_BATCH: DIST_STEPS fp32
# steps against one process, one counted bf16 step then DIST_TIMED_STEPS
# timed, ``train.main`` for DIST_FIT_STEPS steps at DIST_FIT_SIZE px on
# DIST_FIT_IMAGES images.  DIST_*_RTOL/ATOL are the JAX shard_map test's
# bounds (tests/test_parallel.py: total_loss and grad_norm relative,
# parameters absolute).  At 640 px a rank's batch of 2 runs other cuDNN
# fp32 algorithms than one process's 4, so the fp32 two-rank gap to one
# process is held to DIST_FP32_BOUNDS: those bounds widened to about twice
# what one fp32 process stood from the same steps in float64 on the H100
# (3.1e-7 / 3.46e-4 / 1.49e-5; PERF.md's distributed findings).  The
# float64 steps run on as a witness held to the same bounds, so a drift of
# fp32 or of the float64 reference fails instead of widening the gate.  A
# rank that fails, or no answer from every rank within DIST_TIMEOUT,
# fails the phase.
DIST_WORLD, DIST_BATCH, DIST_STEPS, DIST_TIMED_STEPS = 2, 4, 2, 3
DIST_LOSS_RTOL, DIST_NORM_RTOL, DIST_PARAM_ATOL = 1e-5, 1e-4, 2e-5
DIST_FP32_BOUNDS = {"total_loss": 1e-5, "grad_norm": 7e-4,
                    "param_max_abs": 3e-5}
DIST_FIT_IMAGES, DIST_FIT_SIZE, DIST_FIT_STEPS = 16, 320, 4
DIST_TIMEOUT = 420  # seconds for every rank's figures
# Run only when asked for (``--phases build,spread``): both fit paths
# trained from each of SPREAD_SEEDS as the fit phase trains them, and each
# model's held-out mAP, served from its last checkpoint and as the mean of
# its newest FIT_AVERAGE, on the first n held-out images for each n of
# SPREAD_EVAL_IMAGES, with every pairwise gap: the noise the FIT_MAP_GAP
# bound must sit above.
SPREAD_SEEDS, SPREAD_EVAL_IMAGES = (42, 43, 44), (64, 512)
# Run only when asked for (``--phases parent``): the parent commit's B1, B5
# and B6 sources, placed in PARENT_DIR, against this tree's on the card.
PARENT_DIR = Path(__file__).resolve().parent / "parent_kernels"
# B3's launches by group, first match wins (kernel names in the profile).
B3_GROUPS = (("recompute", ("::fwd_gemm<",)),
             ("dgrad", ("dgrad_gemm",)), ("wgrad", ("wgrad_gemm",)),
             ("slice sums", ("reduce_slices", "reduce_images")),
             ("output mask + GN", ("out_mask_bwd", "gn_bwd_", "relu_planes")))
# B1's and B5's launches by group (``block_group``), and their kernels per
# call: three GEMMs (B5's first is conv1 and the projection in one) whose
# last CTA per image finalizes the GN, and the residual pass.
B1_GROUPS = ("conv1 GEMM", "conv2 GEMM", "conv3 GEMM", "GN finalize",
             "residual", "host copies")
BLOCK_KERNELS = 4


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2,
                 queued: bool = False) -> float:
    """ms per call of ``fn`` between CUDA events after ``warmup`` calls.
    ``queued`` first occupies the card with a sleep kernel, so that all
    ``iters`` calls are enqueued before the start event runs: the device
    time of the calls, without the host's launch cost between them."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def he_kernel(shape, gen):
    """He-normal OIHW kernel."""
    fan_in = shape[1] * shape[2] * shape[3]
    return torch.randn(*shape, generator=gen) * math.sqrt(2.0 / fan_in)


def gn_affine(n, gen):
    """Randomized GN γ ≈ 1 ± 0.3 and β ≈ ±0.3."""
    return (1.0 + 0.3 * torch.randn(n, generator=gen),
            0.3 * torch.randn(n, generator=gen))


def block_inputs(batch, h, w, c, f, gen, device):
    """Random bf16 block input and He-normal kernels, randomized GN γ/β."""
    x = torch.randn(batch, h, w, c, generator=gen).to(torch.bfloat16)
    params = []
    for shape in ((f, c, 1, 1), (f, f, 3, 3), (c, f, 1, 1)):
        params += [he_kernel(shape, gen), *gn_affine(shape[0], gen)]
    return x.to(device), [p.to(device) for p in params]


def block_group(name: str, namespace: str) -> str:
    """The ``B1_GROUPS`` group of a kernel launched by a B1 or B5 call
    whose kernels live in ``namespace`` (this tree's or a parent's); the
    others are the wrapper's host copies (weight layouts)."""
    if namespace not in name:
        return "host copies"
    if "gemm<" in name:  # fwd_gemm<TAPS, PRO, BN> (a parent: conv_gemm)
        args = [a.strip().split(")")[-1] for a in
                name.split("gemm<", 1)[1].split(">", 1)[0].split(",")]
        if args[0] == "9":
            return "conv2 GEMM"
        return "conv3 GEMM" if args[1] in ("true", "1") else "conv1 GEMM"
    if "gn_finalize" in name:
        return "GN finalize"
    return "residual" if "residual" in name else "other"


def block_split(call, namespace="b1_fused_bottleneck"):
    """{group: [launches, device ms]} per call of a B1/B5 ``call``."""
    split = {}
    for name, (n, ms) in kernel_launches(call).items():
        total = split.setdefault(block_group(name, namespace), [0.0, 0.0])
        total[0] += n
        total[1] += ms
    return split


def check_block_launches(label, split, namespace, **fields):
    """A B1/B5 call with its weights laid out beforehand launches
    BLOCK_KERNELS kernels of its own and nothing else (``split``:
    ``block_split`` of the call)."""
    own = sum(n for g, (n, _) in split.items() if g != "host copies")
    copies = split.get("host copies", [0, 0])[0]
    log(label, **fields, kernels=own, host_copies=copies,
        launches_and_ms=split)
    if own != BLOCK_KERNELS or copies:
        raise AssertionError(f"{label} launched {own} kernels of "
                             f"{namespace} and {copies} others per call, "
                             f"expected {BLOCK_KERNELS} and 0")


def forward_diff(a, b):
    """Which parts of two ``Forward``s (y1, y2, y3, GN statistics) are
    bitwise equal."""
    stats = all(torch.equal(s, t) for pa, pb in zip(a[3], b[3])
                for s, t in zip(pa, pb))
    return [bool(torch.equal(s, t)) for s, t in zip(a[:3], b[:3])] + [stats]


def check_b1(device) -> float:
    """B1 vs plain at every stage shape, at batch 2 and at the flagship
    run's batch 8, at batch 8 at the eval phase's bucket shapes, and at
    the fit phase's stage shapes and batch; 4 kernels per call at res2,
    batch 8."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for batch, stages in ((2, STAGES), (8, STAGES + BUCKET_STAGES),
                          (FIT_BATCH, FIT_STAGES)):
        for name, h, w, c, f, _ in stages:
            x, params = block_inputs(batch, h, w, c, f, gen, device)
            if (name, batch, w) == ("res2", 8, h):
                wts = b1.prepare_weights(*params[::3])
                check_block_launches("b1-launches-per-call", block_split(
                    lambda: b1.fused_bottleneck(x, *params, weights=wts)),
                    "b1_fused_bottleneck")
            ref = b1.fused_bottleneck_plain(x, *params).float()
            n3 = b1._residual_branch(x.permute(0, 3, 1, 2), *params, 1e-5)
            n3 = n3.permute(0, 2, 3, 1).float()
            out = b1.fused_bottleneck(x, *params)
            again, fwd = b1.fused_bottleneck(x, *params, return_forward=True)
            gb = params[1:3] + params[4:6] + params[7:9]
            epilogue = torch.relu(b3.relu_inputs(x, fwd, *gb)[2])
            truth = torch.relu(b3.relu_inputs(x, b3.recompute_forward(
                x, *params, dtype=torch.float64), *gb)[2]).view(out.shape)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            bound = B1_REL * torch.maximum(ref.abs(), n3.abs()).clamp(min=1.0)
            truth_err = [(t.double() - truth).abs().max().item()
                         for t in (out, ref)]
            checks = dict(
                within_bound=not (err > bound).any().item(),
                mean=err.mean().item() <= B1_MEAN,
                as_accurate=truth_err[0] <= B1_TRUTH_FACTOR * truth_err[1]
                + B1_TRUTH_SLACK,
                own_epilogue=bool(torch.equal(out, epilogue.view(
                    out.shape))),
                bitwise_repeat=bool(torch.equal(out, again)))
            log("b1-check", stage=name, shape=[batch, h, w, c], F=f,
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                over_bound=int((err > bound).sum().item()),
                over_output_step=int((err > B1_REL * ref.abs().clamp(
                    min=1.0)).sum().item()),
                f64_max_err_kernel_plain=truth_err, **checks)
            if not all(checks.values()):
                raise AssertionError(f"B1 disagrees with its plain version "
                                     f"at {name} {h}x{w}, batch {batch}: "
                                     f"{checks}")
            worst = max(worst, err.max().item())
            del x, params, ref, n3, out, again, fwd, epilogue, truth, err
            del bound
    torch.cuda.empty_cache()
    return worst


def block_bound(batch, h, w, c, f, passes):
    """(ms, bound_by) of ``passes`` block GEMM sets (1 forward, 3 for the
    backward's recompute, dgrad and wgrad) at the published peaks: FLOP =
    passes·2·B·H·W·(2CF + 9F²); bytes = each bf16 image tensor (x, out for
    the forward; x, dout, dx for the backward) once, the fp32 parameters
    once, and for the backward their fp32 gradients once."""
    hw = batch * h * w
    flop = passes * 2 * hw * (2 * c * f + 9 * f * f)
    params = (2 * c * f + 9 * f * f + 4 * f + 2 * c) * 4
    images = (2 if passes == 1 else 3) * hw * c * 2
    nbytes = images + params * (1 if passes == 1 else 2)
    t_op, t_by = flop / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_op, t_by) * 1e3, "operations" if t_op >= t_by else "bytes"


def pearson(a, b) -> float:
    return torch.corrcoef(torch.stack([a.ravel(), b.ravel()]))[0, 1].item()


def check_b3(device) -> float:
    """B3 vs its plain version on the kernel's forward, on its own
    recompute and in float64 at every stage shape, at batch 2 and 8, and
    at the fit phase's stage shapes and batch; returns the worst max |Δ|
    of dx against the plain version on the kernel's forward."""
    gen = torch.Generator().manual_seed(5)
    worst = 0.0
    for batch, stages in ((2, STAGES), (8, STAGES),
                          (FIT_BATCH, FIT_STAGES)):
        for name, h, w, c, f, _ in stages:
            x, params = block_inputs(batch, h, w, c, f, gen, device)
            dout = torch.randn(batch, h, w, c, generator=gen).to(
                torch.bfloat16).to(device)
            out, fwd = b3.fused_bottleneck_bwd(x, dout, *params,
                                               return_forward=True)
            b1_fwd = b1.fused_bottleneck(x, *params, return_forward=True)[1]
            again = b3.fused_bottleneck_bwd(x, dout, *params)
            same = b3.fused_bottleneck_bwd_plain(x, dout, *params,
                                                 forward=fwd)
            own_fwd = b3.recompute_forward(x, *params)
            ref = b3.fused_bottleneck_bwd_plain(x, dout, *params,
                                                forward=own_fwd)
            truth = b3.fused_bottleneck_bwd_plain(x, dout, *params,
                                                  dtype=torch.float64)
            gb = params[1:3] + params[4:6] + params[7:9]
            flips = [((a > 0) != (b > 0)).float().mean().item() for a, b in
                     zip(b3.relu_inputs(x, fwd, *gb),
                         b3.relu_inputs(x, own_fwd, *gb))]
            torch.cuda.synchronize()
            stats = {k: {} for k in ("max_rel", "corr", "l2_rel_own",
                                     "corr_own", "f64_err_kernel",
                                     "f64_err_plain")}
            for key, o, s, r, t in zip(B3_OUTPUTS, out, same, ref, truth):
                o, s, r = o.float(), s.float(), r.float()
                stats["max_rel"][key] = ((o - s).abs().max()
                                         / s.abs().max()).item()
                stats["corr"][key] = pearson(o, s)
                stats["l2_rel_own"][key] = ((o - r).norm()
                                            / r.norm()).item()
                stats["corr_own"][key] = pearson(o, r)
                scale = t.abs().max()
                stats["f64_err_kernel"][key] = (
                    (o - t).abs().max() / scale).item()
                stats["f64_err_plain"][key] = (
                    (r - t).abs().max() / scale).item()
            repeat = all(torch.equal(a, b) for a, b in zip(out, again))
            as_b1 = forward_diff(fwd, b1_fwd)
            dx_err = (out[0].float() - same[0].float()).abs().max().item()
            log("b3-check", stage=name, shape=[batch, h, w, c], F=f,
                dx_max_abs_err=dx_err, relu_flips=flips, **stats,
                bitwise_repeat=repeat,
                forward_bitwise_b1_y1_y2_y3_stats=as_b1)
            if not all(as_b1):
                raise AssertionError(f"B3's recomputed forward is not B1's "
                                     f"at {name}, batch {batch}: {as_b1}")
            bad = [k for k in B3_OUTPUTS
                   if not (stats["max_rel"][k] <= B3_REL
                           and stats["corr"][k] >= B3_CORR
                           and stats["l2_rel_own"][k] <= B3_REL
                           and stats["corr_own"][k] >= B3_CORR
                           and stats["f64_err_kernel"][k]
                           <= B3_TRUTH_FACTOR * stats["f64_err_plain"][k]
                           + B3_TRUTH_SLACK)]
            if bad or max(flips) > B3_FLIPS:
                raise AssertionError(f"B3 disagrees with its plain version "
                                     f"at {name}, batch {batch}: {bad}, "
                                     f"relu flips {flips}")
            if not repeat:
                raise AssertionError(f"B3 is not bitwise repeatable at "
                                     f"{name}, batch {batch}")
            worst = max(worst, dx_err)
            del x, params, dout, fwd, b1_fwd, own_fwd, same, ref, truth, out
            del again
    torch.cuda.empty_cache()
    return worst


def record_gn_shapes(device):
    """The GroupNorm inputs of one forward of each path a B4 A/B runs
    (forward hooks): at batch 8, bf16 serving on the kernel path and on
    the int8 path (every block eager), and the kernel path's training
    forward; the fit phase's served kernel-path model at its size and
    batch.  Logs each distinct (B, H, W, C, activation, dtype) with its
    calls per forward and whether it passes the 2^18 gate; returns
    {path: {shape: calls per forward}}."""
    found = {}
    for path, config, training, classes in (
            ("kernels", flagship_config(), False, 80),
            ("int8", int8_config(), False, 80),
            ("train", train_config(), True, 80),
            ("fit", fit_serving_config("kernels"), False, FIT_CLASSES)):
        size, batch = config.data.image_size, config.data.batch_size
        images = torch.randn(batch, size, size, 3,
                             generator=torch.Generator().manual_seed(3)
                             ).to(device)
        model = RetinaNet.from_config(config.model, 9, classes)
        model.load_state_dict(init_params(
            config, torch.Generator().manual_seed(0), classes))
        model.to(device).eval()
        shapes = found[path] = {}

        def record(module, inputs, _shapes=shapes):
            n, c, h, w = inputs[0].shape
            key = (n, h, w, c, module.activation, inputs[0].dtype)
            _shapes[key] = _shapes.get(key, 0) + 1

        hooks = [m.register_forward_pre_hook(record)
                 for m in model.modules() if isinstance(m, GroupNorm)]
        with torch.no_grad():
            model(images, training=training)
        for hook in hooks:
            hook.remove()
        for (b, h, w, c, act, dtype), n in sorted(
                shapes.items(), key=lambda kv: str(kv[0])):
            log("gn-shapes", path=path, shape=[b, h, w, c], activation=act,
                dtype=str(dtype), calls_per_forward=n,
                takes_b4=h * w * c >= GN_KERNEL_MIN_ELEMENTS)
        del model, images
    torch.cuda.empty_cache()
    return found


def b4_paths(h, w, c, dtype):
    """The B4 paths an h x w x c image of ``dtype`` can take: the cluster
    path where the image fits a cluster's shared memory."""
    size = torch.tensor([], dtype=dtype).element_size()
    fits = b4.cluster_smem(h * w, c, resolve_groups(c), size)
    return list(b4.PATHS) if fits <= b4.CLUSTER_SMEM else ["split"]


def check_b4(device, gn_shapes) -> float:
    """B4 vs its plain version, each path the shape allows, at every
    GroupNorm shape of ``gn_shapes`` (``record_gn_shapes``) that passes the
    gate, at its batch, and at B4_EXTRA, batch 8, in bf16 and fp32: within
    B4_REL and bitwise repeatable; B4_PATH_KERNELS kernels per call on
    each path; its backward vs autograd of the plain forward at P3 in
    fp32.  Returns the worst max |Δ| of the forward."""
    gen = torch.Generator().manual_seed(6)
    shapes = {(b, h, w, c, act) for found in gn_shapes.values()
              for b, h, w, c, act, _ in found
              if h * w * c >= GN_KERNEL_MIN_ELEMENTS}
    shapes = sorted(shapes | {(8, *extra) for extra in B4_EXTRA}, key=str)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for n, h, w, c, act in shapes:
            x = (2 * torch.randn(n, h, w, c, generator=gen) + 0.5).to(dtype)
            gamma, beta = gn_affine(c, gen)
            x, gamma, beta = x.to(device), gamma.to(device), beta.to(device)
            groups = resolve_groups(c)
            with torch.no_grad():
                ref = b4.fused_group_norm_act_plain(x, gamma, beta, groups,
                                                    1e-5, act).float()
                for path in b4_paths(h, w, c, dtype):
                    out = b4.forward_cuda(x, gamma, beta, groups, 1e-5, act,
                                          path)
                    again = b4.forward_cuda(x, gamma, beta, groups, 1e-5,
                                            act, path)
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs()
                    over = int((err > B4_REL[dtype] * ref.abs().clamp(
                        min=1.0)).sum().item())
                    repeat = bool(torch.equal(out, again))
                    log("b4-check", shape=[n, h, w, c], activation=act,
                        dtype=str(dtype), path=path,
                        default_path=b4.kernel_path(n, h * w, c, groups,
                                                    dtype),
                        max_abs_err=err.max().item(),
                        mean_abs_err=err.mean().item(),
                        bitwise_equal_share=(err == 0).float().mean().item(),
                        over_bound=over, bitwise_repeat=repeat)
                    if over or not repeat:
                        raise AssertionError(
                            f"B4 ({path}) disagrees with its plain version "
                            f"or is not repeatable at {[h, w, c]}, {dtype}")
                    worst = max(worst, err.max().item())
                    del out, again
            del x, ref
    # Kernels per call, each path and dtype, over every shape at batch 2.
    planes = sorted({shape[1:] for shape in shapes}, key=str)
    for dtype in (torch.bfloat16, torch.float32):
        for path in b4.PATHS:
            cases = []
            for h, w, c, act in planes:
                if path not in b4_paths(h, w, c, dtype):
                    continue
                x = torch.randn(2, h, w, c, generator=gen).to(dtype)
                cases.append((x.to(device), *(t.to(device) for t in
                                              gn_affine(c, gen)),
                              resolve_groups(c), act))

            def call(_cases=cases, _path=path):
                with torch.no_grad():
                    for x, gamma, beta, groups, act in _cases:
                        b4.forward_cuda(x, gamma, beta, groups, 1e-5, act,
                                        _path)

            kernels = kernel_launches(call, calls=1)
            per_call = sum(n for n, _ in kernels.values()) / len(cases)
            log("b4-kernels-per-call", path=path, dtype=str(dtype),
                calls=len(cases), kernels_per_call=per_call,
                kernels=sorted(k.split("(")[0][-60:] for k in kernels))
            if per_call != B4_PATH_KERNELS[path]:
                raise AssertionError(f"B4's {path} path launched {per_call} "
                                     f"kernels per call in {dtype}, "
                                     f"expected {B4_PATH_KERNELS[path]}")
            del cases
    h, w, c = 80, 80, 256
    x = torch.randn(8, h, w, c, generator=gen).to(device)
    gamma, beta = (t.to(device) for t in gn_affine(c, gen))
    cot = torch.randn(8, h, w, c, generator=gen).to(device)
    grads = []
    for forward in (b4.fused_group_norm_act, b4.fused_group_norm_act_plain):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, gamma, beta)]
        out = forward(*leaves, 32, 1e-5, "elu")
        grads.append(torch.autograd.grad((out * cot).sum(), leaves))
    rel = {k: ((g - r).abs().max() / r.abs().max()).item()
           for k, g, r in zip(("dx", "dgamma", "dbeta"), *grads)}
    log("b4-grad-check", shape=[8, h, w, c], activation="elu",
        max_rel=rel, bound=B4_GRAD_REL)
    if max(rel.values()) > B4_GRAD_REL:
        raise AssertionError(f"B4's backward disagrees with autograd: {rel}")
    torch.cuda.empty_cache()
    return worst


def proj_inputs(batch, gen, device):
    """Random bf16 res2-b0 input, He kernels k1, k2, k3, kp (OIHW) and
    randomized GN γ/β, in ``fused_bottleneck_proj``'s argument order."""
    h, w, cin, c, f = RES2_B0
    x = torch.randn(batch, h, w, cin, generator=gen).to(torch.bfloat16)
    params = []
    for shape in ((f, cin, 1, 1), (f, f, 3, 3), (c, f, 1, 1),
                  (c, cin, 1, 1)):
        params += [he_kernel(shape, gen), *gn_affine(shape[0], gen)]
    return x.to(device), [p.to(device) for p in params]


def check_b5(device) -> float:
    """B5 vs its plain version at res2 b0, batch 2 and 8, to B1's bound;
    bitwise repeatable; 4 kernels per call at batch 8."""
    gen = torch.Generator().manual_seed(7)
    worst = 0.0
    for batch in (2, 8):
        x, params = proj_inputs(batch, gen, device)
        if batch == 8:
            wts = b1.prepare_proj_weights(*params[::3])
            check_block_launches("b5-launches-per-call", block_split(
                lambda: b1.fused_bottleneck_proj(x, *params, weights=wts),
                "b5_fused_bottleneck_proj"), "b5_fused_bottleneck_proj")
        ref = b1.fused_bottleneck_proj_plain(x, *params).float()
        out = b1.fused_bottleneck_proj(x, *params)
        again = b1.fused_bottleneck_proj(x, *params)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs()
        bound = B1_REL * ref.abs().clamp(min=1.0)
        log("b5-check", shape=list(x.shape), C=RES2_B0[3], F=RES2_B0[4],
            max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
            over_bound=int((err > bound).sum().item()),
            bitwise_repeat=bool(torch.equal(out, again)))
        if (err > bound).any() or err.mean().item() > B1_MEAN:
            raise AssertionError(f"B5 disagrees with its plain version at "
                                 f"batch {batch}")
        if not torch.equal(out, again):
            raise AssertionError(f"B5 is not bitwise repeatable at batch "
                                 f"{batch}")
        worst = max(worst, err.max().item())
    return worst


# B7's checks, (B, H, W, C): the stem's shape at batch 2, 8 and 128; odd
# sides (TF-SAME pads top and left by one) with 38, 37 and 35 output rows,
# so that the last of the kernel's 4-row bands holds 2, 1 and 3 rows, and
# 3 output rows, one short band; C = 256 (8 columns a CTA) and C = 2048
# (one column a CTA, every window's third column loaded by its own
# thread).
B7_CASES = ((2, *STEM), (8, *STEM), (128, *STEM), (2, 75, 57, 64),
            (2, 73, 57, 64), (2, 69, 55, 64), (1, 5, 7, 64),
            (2, 75, 57, 256), (2, 20, 21, 2048))


def stem_case(shape, gen, device):
    """A bf16 stem activation y and per-image scale in [0.5, 1.5), shift
    ±0.3 (fp32; the wrapper rounds them to bf16)."""
    batch, _, _, c = shape
    y = torch.randn(*shape, generator=gen).to(torch.bfloat16).to(device)
    scale = (torch.rand(batch, c, generator=gen) + 0.5).to(device)
    shift = (0.3 * torch.randn(batch, c, generator=gen)).to(device)
    return y, scale, shift


def check_b7(device) -> float:
    """B7 vs its plain version at B7_CASES: bitwise equal and
    repeatable."""
    gen = torch.Generator().manual_seed(8)
    for shape in B7_CASES:
        y, scale, shift = stem_case(shape, gen, device)
        ref = b7.gn_relu_maxpool_plain(y, scale, shift)
        out = b7.gn_relu_maxpool(y, scale, shift)
        again = b7.gn_relu_maxpool(y, scale, shift)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        log("b7-check", shape=list(shape), out=list(out.shape),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            bitwise_equal=equal, bitwise_repeat=bool(torch.equal(out, again)))
        if not equal or not torch.equal(out, again):
            raise AssertionError(f"B7 differs from its plain version at "
                                 f"{list(shape)}")
        del y, ref, out, again
    torch.cuda.empty_cache()
    return 0.0


def compare_heads(label, got, want, check=True, log_levels=True):
    """Log (``log_levels``) and (``check``) check each head level of
    ``got`` against ``want`` within HEAD_RTOL/HEAD_ATOL; returns the share
    of bitwise-equal elements and the elements outside the bound."""
    equal = total = outside = 0
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            g, w = got[head][pn].float(), want[head][pn].float()
            err = (g - w).abs()
            corr = torch.corrcoef(torch.stack([g.ravel(), w.ravel()]))[0, 1]
            over = int((err > HEAD_ATOL + HEAD_RTOL * w.abs()).sum().item())
            equal += int((err == 0).sum().item())
            total += err.numel()
            outside += over
            if log_levels:
                log(f"{label}-heads", head=head, level=pn,
                    max_abs_err=err.max().item(),
                    mean_abs_err=err.mean().item(), ref_std=w.std().item(),
                    corr=corr.item(),
                    bitwise_equal_share=(err == 0).float().mean().item(),
                    within_bound=not over, outside_bound=over)
            if over and check:
                raise AssertionError(f"{label}: heads disagree at "
                                     f"{head}/{pn}")
    return equal / total, outside


def int8_config(batch: int = 8) -> Config:
    """The bench serving config with ``quantize="int8"`` (``evaluate
    --quantize int8``), ``fused_proj`` on as well: the int8 gate must keep
    every block off B1 and B5."""
    config = flagship_config(batch)
    return config.replace(model=dataclasses.replace(
        config.model, quantize="int8", fused_proj=True))


def int8_shape_hooks(model, shapes):
    """Forward hooks on every quantized conv of ``model`` that count its
    (B, H, W, C, F, k, stride) in ``shapes``; returns the hooks."""
    def record(module, inputs, output):
        b, c, h, w = inputs[0].shape
        key = (b, h, w, c, module.kernel.shape[0], module.kernel_size,
               module.strides)
        shapes[key] = shapes.get(key, 0) + 1

    return [m.register_forward_hook(record) for m in model.modules()
            if isinstance(m, Conv) and m.quantize]


def fit_int8_shapes(device):
    """The distinct int8 conv shapes, with their counts, of one forward
    of the fit phase's int8 serving model (FIT_SIZE px, FIT_BATCH) on
    seeded weights."""
    config = fit_serving_config("kernels", quantize=True)
    detector = Detector(config, init_params(
        config, torch.Generator().manual_seed(0), FIT_CLASSES),
        [str(i) for i in range(FIT_CLASSES)], device)
    shapes = {}
    hooks = int8_shape_hooks(detector.model, shapes)
    detector(torch.randn(FIT_BATCH, FIT_SIZE, FIT_SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device))
    for hook in hooks:
        hook.remove()
    del detector
    torch.cuda.empty_cache()
    return shapes


def check_int8_serving(device):
    """int8 serving through ``Detector`` at batch 8, counted: one B6 launch
    per quantized conv (the 52 block convs of the backbone, the stem
    excepted, and the FPN's 7), no B1 or B5; heads vs the same model on
    the plain int8 convolution.  Returns the launches and the distinct
    int8 conv shapes of the run with their counts."""
    config = int8_config()
    names = [str(i) for i in range(80)]
    state = init_params(config, torch.Generator().manual_seed(0), 80)
    detector = Detector(config, state, names, device)
    images = torch.randn(8, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)
    convs = {name: m for name, m in detector.model.named_modules()
             if isinstance(m, Conv) and m.quantize}
    shapes = {}
    hooks = int8_shape_hooks(detector.model, shapes)
    # The main path, counted: one int8 serving batch.
    b1.fused_bottleneck.launches = 0
    b1.fused_bottleneck_proj.launches = 0
    b6.int8_conv.launches = 0
    out = detector(images)
    torch.cuda.synchronize()
    launches = {"b6": b6.int8_conv.launches,
                "b1": b1.fused_bottleneck.launches,
                "b5": b1.fused_bottleneck_proj.launches}
    for hook in hooks:
        hook.remove()
    # s_w, as B6 read it, against the correctly rounded quotient (float64
    # division of two fp32 values, rounded once to fp32), and how often
    # PyTorch's division by the Python scalar 127.0 misses it.
    channels = wrong = scalar_off = 0
    with torch.no_grad():
        for m in convs.values():
            s_w = m._int8_weights(m.kernel).s_w
            amax = torch.clamp(m.kernel.float().abs().amax(dim=(1, 2, 3)),
                               min=1e-12)
            exact = (amax.double() / 127.0).float()
            channels += exact.numel()
            wrong += int((s_w != exact).sum().item())
            scalar_off += int((amax / 127.0 != exact).sum().item())
    log("int8-weight-scales", convs=len(convs), channels=channels,
        not_the_quotient=wrong, scalar_division_off=scalar_off)
    if wrong:
        raise AssertionError(f"{wrong} of {channels} weight scales are not "
                             f"the correctly rounded quotient")
    backbone = sum(n.startswith("backbone_net.") for n in convs)
    log("int8-launches", **launches, quantized_convs=len(convs),
        backbone_convs=backbone, fpn_convs=len(convs) - backbone,
        stem_quantized=detector.model.backbone_net.ConvGN_0.Conv_0.quantize,
        distinct_shapes=len(shapes))
    if launches != {"b6": 59, "b1": 0, "b5": 0} or len(convs) != 59:
        raise AssertionError(f"expected 59 B6 launches (52 backbone + 7 FPN "
                             f"convs) and no B1/B5 per int8 forward, got "
                             f"{launches} over {len(convs)} quantized convs")
    finite = all(bool(torch.isfinite(t.float()).all()) for t in
                 (out.boxes, out.scores))
    log("int8-output", boxes=list(out.boxes.shape),
        valid=int(out.valid.sum().item()), finite=finite)
    if not finite or tuple(out.boxes.shape) != (8, 1000, 4):
        raise AssertionError("bad int8 detections")

    # Serving again: the weights stay quantized (no prepare_weights build),
    # and each conv launches B6's three kernels and nothing else of B6.
    builds = b6.prepare_weights.builds
    by_name = kernel_launches(lambda: detector(images), calls=1)
    b6_kernels = {}
    for name, (n, ms) in by_name.items():
        if "b6_int8_conv" in name:
            short = name.split("b6_int8_conv::", 1)[1].split("<")[0]
            total = b6_kernels.get(short, (0.0, 0.0))
            b6_kernels[short] = (total[0] + n, total[1] + ms)
    per_b6 = sum(n for n, _ in b6_kernels.values())
    log("int8-kernels",
        kernels_per_forward=sum(n for n, _ in by_name.values()),
        b6_launches_and_device_ms=b6_kernels,
        b6_kernels_per_conv=per_b6 / 59,
        weight_builds_while_serving=b6.prepare_weights.builds - builds)
    if b6.prepare_weights.builds != builds or per_b6 > 3 * 59:
        raise AssertionError(f"int8 serving quantized weights "
                             f"({b6.prepare_weights.builds - builds} builds) "
                             f"or launched {per_b6} B6 kernels for 59 convs")

    real = b6.int8_conv
    with torch.inference_mode():
        got = detector.model(images)
        b6.int8_conv = (lambda x, kernel, strides=1, out_dtype=None,
                        weights=None, groups=1: b6.int8_conv_plain(
                            x, kernel, strides, out_dtype or x.dtype,
                            groups=groups))
        try:
            want = detector.model(images)
        finally:
            b6.int8_conv = real
    share = compare_heads("int8", got, want)[0]
    log("int8-vs-plain", bitwise_equal_share=share)
    del detector, got, want
    torch.cuda.empty_cache()
    return launches, shapes


def int8_case(key, gen, device):
    b, h, w, c, f, k, s = key
    x = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
    return x.to(device), he_kernel((f, c, k, k), gen).to(device)


def check_b6(device, shapes) -> float:
    """B6 vs its plain version at every distinct int8 conv shape of
    ``shapes`` (the 640-px flagship at batch 8, the fit phase's model;
    bitwise equal and repeatable), at odd sides, fp32 in and out, and
    through ``int8_conv3x3``."""
    gen = torch.Generator().manual_seed(9)
    for key, count in sorted(shapes.items()):
        x, kernel = int8_case(key, gen, device)
        s = key[-1]
        ref = b6.int8_conv_plain(x, kernel, s, torch.bfloat16)
        out = b6.int8_conv(x, kernel, s)
        again = b6.int8_conv(x, kernel, s,
                             weights=b6.prepare_weights(kernel))
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        log("b6-check", shape=list(key[:4]), F=key[4], k=key[5], stride=s,
            convs_per_forward=count, out=list(out.shape),
            tile_n=b6.tile_n(key[4], out.shape[0] * out.shape[1]
                             * out.shape[2], key[5] ** 2 * key[3]),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            bitwise_equal=equal,
            bitwise_repeat_prepared=bool(torch.equal(out, again)))
        if not equal or not torch.equal(out, again):
            raise AssertionError(f"B6 differs from its plain version at "
                                 f"{key}")
        del x, kernel, ref, out, again
    # Odd sides (a 600-px input's 75x57 res3 plane): stride 2 pads one row
    # and column on each side; and fp32 in and out.
    for key, dtype in (((2, 75, 57, 64, 64, 3, 2), torch.bfloat16),
                       ((2, 75, 57, 64, 64, 3, 1), torch.bfloat16),
                       ((2, 75, 57, 64, 64, 1, 2), torch.bfloat16),
                       ((2, 75, 57, 64, 128, 3, 2), torch.float32),
                       ((2, 75, 57, 24, 40, 3, 2), torch.float32)):
        x, kernel = int8_case(key, gen, device)
        x = x.to(dtype)
        s = key[-1]
        ref = b6.int8_conv_plain(x, kernel, s, dtype)
        out = b6.int8_conv(x, kernel, s)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        log("b6-check", shape=list(key[:4]), F=key[4], k=key[5], stride=s,
            dtype=str(dtype), out=list(out.shape),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            bitwise_equal=equal)
        if not equal or out.dtype != dtype:
            raise AssertionError(f"B6 differs from its plain version at "
                                 f"{key}, {dtype}")
        del x, kernel, ref, out
    # The widened geometry (B6_WIDENED): C and F padded, grouped kernels.
    b6_new_shapes(device, dict.fromkeys(B6_WIDENED, 0), {})
    # The JAX entry point, with bias and relu, at a head conv's shape.
    x, kernel = int8_case((8, 80, 80, 256, 256, 3, 1), gen, device)
    w = kernel.permute(2, 3, 1, 0)
    bias = torch.randn(256, generator=gen).to(device)
    out = b6.int8_conv3x3(x, w, bias, relu=True)
    ref = b6.int8_conv_plain(x, kernel, 1, torch.bfloat16, bias, True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, ref))
    log("b6-check", entry="int8_conv3x3", shape=list(x.shape), F=256,
        bias=True, relu=True, bitwise_equal=equal)
    if not equal:
        raise AssertionError("int8_conv3x3 differs from its plain version")
    torch.cuda.empty_cache()
    return 0.0


def check_fused_proj(device):
    """``fused_proj`` serving through ``Detector`` at batch 8, counted:
    12 B1 + 1 B5 per forward; heads vs the unfused plain path."""
    config = flagship_config()
    config = config.replace(model=dataclasses.replace(config.model,
                                                      fused_proj=True))
    state = init_params(config, torch.Generator().manual_seed(0), 80)
    detector = Detector(config, state, [str(i) for i in range(80)], device)
    images = torch.randn(8, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)
    # The main path, counted: one fused_proj serving batch.
    b1.fused_bottleneck.launches = 0
    b1.fused_bottleneck_proj.launches = 0
    out = detector(images)
    torch.cuda.synchronize()
    launches = {"b1": b1.fused_bottleneck.launches,
                "b5": b1.fused_bottleneck_proj.launches}
    log("proj-launches", **launches)
    if launches != {"b1": 12, "b5": 1}:
        raise AssertionError(f"expected 12 B1 + 1 B5 launches per "
                             f"fused_proj forward, got {launches}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in
               (out.boxes, out.scores)):
        raise AssertionError("non-finite fused_proj detections")
    plain = RetinaNet.from_config(flagship_config(fused=False).model, 9, 80)
    plain.load_state_dict(state)
    plain.to(device).eval()
    with torch.inference_mode():
        share = compare_heads("proj", detector.model(images),
                              plain(images))[0]
    log("proj-vs-plain", bitwise_equal_share=share)
    del detector, plain
    torch.cuda.empty_cache()
    return launches


def stem_inputs(gen, device, batch=8):
    """A 640-px batch and He 7×7 stem weights (HWIO), GN γ/β."""
    x = torch.randn(batch, SIZE, SIZE, 3, generator=gen)
    w = he_kernel((64, 3, 7, 7), gen).permute(2, 3, 1, 0).contiguous()
    return [t.to(device) for t in (x, w, *gn_affine(64, gen))]


def drive_entry_points(device):
    """B4's and B7's entry points outside any config (as in the JAX
    package), counted: ``GroupNorm(use_kernel=True)`` at ENTRY_GN's shapes
    (bf16, batch 8), of which the four at or above the 2^18 gate launch B4
    and P5 takes ``group_norm``, and ``fused_stem`` on a 640-px batch of 8.
    The B4 modules' outputs are held to B4's bound against the plain
    version, P5's must equal ``group_norm``, and ``fused_stem`` must equal
    the model's stem layers bitwise."""
    gen = torch.Generator().manual_seed(10)
    mods, xs = [], []
    for _, h, w, c, act in ENTRY_GN:
        mod = GroupNorm(c, activation=act, use_kernel=True)
        with torch.no_grad():
            mod.gamma.copy_(gn_affine(c, gen)[0])
            mod.beta.copy_(gn_affine(c, gen)[1])
        mods.append(mod.to(device))
        xs.append(torch.randn(8, c, h, w, generator=gen).to(
            torch.bfloat16).to(device).contiguous(
            memory_format=torch.channels_last))
    x, w, gamma, beta = stem_inputs(gen, device)
    # The main path, counted: the GroupNorms and one stem.
    b4.fused_group_norm_act.launches = 0
    b7.gn_relu_maxpool.launches = 0
    with torch.no_grad():
        outs = [m(t) for m, t in zip(mods, xs)]
        pooled = b7.fused_stem(x, w, gamma, beta)
    torch.cuda.synchronize()
    launches = {"b4": b4.fused_group_norm_act.launches,
                "b7": b7.gn_relu_maxpool.launches}
    gated = sum(h * wd * c >= GN_KERNEL_MIN_ELEMENTS
                for _, h, wd, c, _ in ENTRY_GN)
    log("entry-launches", **launches, gn_modules=len(mods),
        gn_at_or_above_gate=gated)
    if launches != {"b4": gated, "b7": 1}:
        raise AssertionError(f"expected {gated} B4 and 1 B7 launches, got "
                             f"{launches}")
    for (name, h, wd, c, act), mod, t, out in zip(ENTRY_GN, mods, xs, outs):
        if h * wd * c < GN_KERNEL_MIN_ELEMENTS:
            equal = bool(torch.equal(out, group_norm(
                t, mod.gamma, mod.beta, mod.groups, mod.eps, act)))
            log("entry-b4", at=name, below_gate=True,
                bitwise_group_norm=equal)
            if not equal:
                raise AssertionError(f"GroupNorm below the gate is not "
                                     f"group_norm at {name}")
            continue
        ref = b4.fused_group_norm_act_plain(
            t.permute(0, 2, 3, 1), mod.gamma, mod.beta, resolve_groups(c),
            1e-5, act).permute(0, 3, 1, 2).float()
        err = (out.float() - ref).abs()
        over = int((err > B4_REL[torch.bfloat16] * ref.abs().clamp(min=1.0)
                    ).sum().item())
        log("entry-b4", at=name, path=b4.kernel_path(8, h * wd, c,
                                                     resolve_groups(c),
                                                     torch.bfloat16),
            max_abs_err=err.max().item(), over_bound=over)
        if over:
            raise AssertionError(f"GroupNorm(use_kernel=True) disagrees at "
                                 f"{name}")
    stem = ConvGN(3, 64, kernel_size=7, strides=2, activation="relu")
    with torch.no_grad():
        stem.Conv_0.kernel.copy_(w.permute(3, 2, 0, 1))
        stem.GroupNorm_0.gamma.copy_(gamma)
        stem.GroupNorm_0.beta.copy_(beta)
        stem.to(device)
        ref = max_pool_same(stem(x.to(torch.bfloat16).permute(0, 3, 1, 2)),
                            3, 2).permute(0, 2, 3, 1)
    equal = bool(torch.equal(pooled, ref))
    log("entry-b7", shape=list(pooled.shape), bitwise_equal_model_stem=equal)
    if not equal:
        raise AssertionError("fused_stem differs from the model's stem")
    del mods, xs, outs, x, pooled, ref, stem
    torch.cuda.empty_cache()
    return launches


def clustered_boxes(batch, n, gen, quantized=False):
    """Score-sorted candidates as the serving path builds them: clustered
    corner boxes, class offsets ``ids·4``, 20% invalid parked −1e4."""
    centers = torch.rand(batch, n, 2, generator=gen) * 0.8 + 0.1
    sizes = torch.rand(batch, n, 2, generator=gen) * 0.25 + 0.05
    if quantized:  # a coarse grid gives exact IoU ties, at 0.5 too
        centers = (centers * 32).round() / 32
        sizes = (sizes * 16).round().clamp(min=1) / 16
    boxes = torch.cat([centers - sizes / 2, centers + sizes / 2], -1)
    ids = torch.randint(0, 4, (batch, n), generator=gen)
    boxes = boxes + (ids[..., None] * 4.0)
    valid = torch.rand(batch, n, generator=gen) > 0.2
    return torch.where(valid[..., None], boxes, boxes - 1e4).float()


# B2's checks, (batch, N) and whether the boxes sit on a coarse grid: the
# b8 and b128 serving shapes, N = 2048, the reference decode path's N at
# 640 px (4125: a ring of five 65-word row blocks), 5000, 8192 (three
# 128-word slots), 16384 (two 192-word slots, the rest of each row block
# read from device memory), blocks that end before, at and one box into a
# 64-box word, and exact IoU ties.
B2_CASES = (((8, 1000), False), ((128, 1000), False), ((3, 200), False),
            ((1, 2048), False), ((8, 4125), False), ((1, 5000), False),
            ((2, 8192), False), ((1, 16384), False), ((2, 63), False),
            ((2, 64), False), ((2, 65), False), ((1, 1), False),
            ((8, 1000), True))


def check_b2(device) -> tuple[int, int]:
    """B2's keep mask vs the plain greedy mask at B2_CASES: exactly equal
    and repeatable.  Returns (mismatches, the largest N compared)."""
    gen = torch.Generator().manual_seed(2)
    mismatches, largest = 0, 0
    for shape, quantized in B2_CASES:
        boxes = clustered_boxes(*shape, gen, quantized).to(device)
        want = b2._greedy_keep_mask(boxes, 0.5)
        got = b2.nms_keep_mask_batch(boxes, 0.5)
        again = b2.nms_keep_mask_batch(boxes, 0.5)
        diff = int((got != want).sum().item())
        log("b2-check", shape=[*shape, 4], quantized=quantized,
            kept=int(want.sum().item()), mismatches=diff,
            bitwise_repeat=bool(torch.equal(got, again)))
        if diff or not torch.equal(got, again):
            raise AssertionError(f"B2 keep mask differs at {shape}")
        mismatches += diff
        largest = max(largest, got.shape[1])
    return mismatches, largest


def flagship_config(batch: int = 8, fused: bool = True) -> Config:
    """The JAX bench's serving config (bench.py:94-119) at 80 classes; the
    unfused blocks on the plain path."""
    config = Config()
    return config.replace(
        model=dataclasses.replace(
            config.model, backbone="resnet_50_dense", fused_blocks=fused,
            fused_res2=fused, fused_res3_strips=10, fused_res4_strips=10),
        data=dataclasses.replace(config.data, image_size=SIZE,
                                 batch_size=batch),
        nms=dataclasses.replace(config.nms, use_approx_top_k=True))


def check_flagship(device):
    config = flagship_config()
    low = config.replace(nms=dataclasses.replace(config.nms,
                                                 score_threshold=0.005))
    names = [str(i) for i in range(80)]
    state = init_params(config, torch.Generator().manual_seed(0), 80)
    detectors = [Detector(c, state, names, device) for c in (config, low)]
    images = torch.randn(8, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)

    # The main path, counted: both NMS configs, one batch each.
    b1.fused_bottleneck.launches = 0
    b2.nms_keep_mask_batch.launches = 0
    outs = [det(images) for det in detectors]
    torch.cuda.synchronize()
    launches = {"b1": b1.fused_bottleneck.launches,
                "b2": b2.nms_keep_mask_batch.launches}
    log("flagship-launches", **launches, batches=2)
    if launches["b1"] != 24 or launches["b2"] < 2:
        raise AssertionError(f"expected 12 B1 launches per forward and a B2 "
                             f"launch per batch, got {launches}")

    for label, out in zip(("default", "score_threshold=0.005"), outs):
        finite = all(bool(torch.isfinite(t.float()).all()) for t in
                     (out.boxes, out.scores))
        log("flagship-output", nms=label, boxes=list(out.boxes.shape),
            valid=int(out.valid.sum().item()), finite=finite)
        if not finite or tuple(out.boxes.shape) != (8, 1000, 4):
            raise AssertionError(f"bad detections at {label}")
    if int(outs[1].valid.sum().item()) == 0:
        raise AssertionError("no detections at score_threshold 0.005")

    # Kernel path vs the unfused plain path on the same weights and images.
    fused = detectors[0].model
    plain = RetinaNet.from_config(flagship_config(fused=False).model, 9, 80)
    plain.load_state_dict(state)
    plain.to(device).eval()
    with torch.inference_mode():
        got, want = fused(images), plain(images)
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            g, w = got[head][pn].float(), want[head][pn].float()
            err = (g - w).abs()
            corr = torch.corrcoef(torch.stack([g.ravel(), w.ravel()]))[0, 1]
            ok = bool((err <= HEAD_ATOL + HEAD_RTOL * w.abs()).all())
            log("flagship-heads", head=head, level=pn,
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                ref_std=w.std().item(), corr=corr.item(), within_bound=ok)
            if not ok:
                raise AssertionError(f"kernel path disagrees at {head}/{pn}")

    # B2 on the model's own candidates equals the plain mask.
    levels = build_levels(config.anchors)
    for c in (config.nms, low.nms):
        with torch.inference_mode():
            cand, shifted = b2.nms_candidates(
                got["classifications"], got["regressions"], levels,
                (SIZE, SIZE), c)
            diff = int((b2.nms_keep_mask_batch(shifted, c.iou_threshold)
                        != b2._greedy_keep_mask(shifted, c.iou_threshold)
                        ).sum().item())
        log("flagship-b2", score_threshold=c.score_threshold,
            valid_candidates=int(cand.valid.sum().item()), mismatches=diff)
        if diff:
            raise AssertionError("B2 differs on the model's candidates")
    del detectors, plain, fused
    torch.cuda.empty_cache()
    return launches


def check_decode(device):
    """The reference decode path on the serving model's own heads (the
    bench config at 640 px, batch 8, seeded weights and images), at the
    default NMSConfig and at score_threshold 0.005:
    ``nms_padded(decode_levels(...))`` at the shared pre-NMS cap against
    ``fused_decode_nms`` (valid and class ids exact, scores to 1e-6 and
    valid boxes to 1e-5: ``tests/test_nms.py``'s bounds for JAX's pair),
    then with ``pre_nms_top_k=None``, counted: every candidate, [8,4125,4]
    at 640 px, through one B2 launch, whose mask must equal the plain mask.
    Both paths timed at batch 8 and 128 (the heads repeated)."""
    config = flagship_config()
    levels = build_levels(config.anchors)
    model = RetinaNet.from_config(config.model, levels.num_anchors, 80)
    model.load_state_dict(init_params(config,
                                      torch.Generator().manual_seed(0), 80))
    model.to(device).eval()
    images = torch.randn(8, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)
    with torch.inference_mode():
        heads = model(images)
    cls, reg = heads["classifications"], heads["regressions"]
    del model, images, heads
    configs = (config.nms, dataclasses.replace(config.nms,
                                               score_threshold=0.005))
    every_n = sum(min(config.nms.top_k_per_level,
                      math.prod(levels.grid_hw(pn, SIZE)) * levels.num_anchors)
                  for pn in levels)  # 4125 at 640 px
    launches = {}
    for cfg in configs:
        with torch.inference_mode():
            decoded = b2.decode_levels(cls, reg, levels, SIZE, cfg)
            ref = b2.nms_padded(decoded, cfg.iou_threshold,
                                cfg.max_output_size,
                                pre_nms_top_k=cfg.pre_nms_top_k)
            got = b2.fused_decode_nms(cls, reg, levels, (SIZE, SIZE), cfg)
            valid = ref.valid
            same = {
                "valid": bool(torch.equal(got.valid, valid)),
                "class_ids": bool(torch.equal(got.class_ids, ref.class_ids)),
                "scores": (got.scores - ref.scores).abs().max().item(),
                "boxes": ((got.boxes - ref.boxes)[valid].abs().max().item()
                          if valid.any() else 0.0)}
            # The main path of this phase, counted: every candidate.
            b2.nms_keep_mask_batch.launches = 0
            every = b2.nms_padded(decoded, cfg.iou_threshold,
                                  cfg.max_output_size, pre_nms_top_k=None)
            torch.cuda.synchronize()
            launches[cfg.score_threshold] = b2.nms_keep_mask_batch.launches
            _, shifted = b2.padded_candidates(decoded, None)
            mismatches = int((b2.nms_keep_mask_batch(shifted,
                                                     cfg.iou_threshold)
                              != b2._greedy_keep_mask(shifted,
                                                      cfg.iou_threshold)
                              ).sum().item())
        log("decode-check", score_threshold=cfg.score_threshold,
            pre_nms_top_k=cfg.pre_nms_top_k,
            valid_candidates=int(decoded.valid.sum().item()),
            detections=int(valid.sum().item()), equal_fused=same,
            every_candidate_boxes=list(shifted.shape),
            b2_launches=launches[cfg.score_threshold],
            detections_every_candidate=int(every.valid.sum().item()),
            b2_mismatches=mismatches)
        if (not same["valid"] or not same["class_ids"] or same["scores"] > 1e-6
                or same["boxes"] > 1e-5):
            raise AssertionError(f"the reference decode path differs from "
                                 f"fused_decode_nms at {cfg}")
        if (launches[cfg.score_threshold] != 1 or mismatches
                or tuple(shifted.shape) != (8, every_n, 4)):
            raise AssertionError("every candidate did not go through B2, "
                                 "or its mask differs from the plain mask")
    cfg = configs[1]
    for batch in (8, 128):
        cls_b = {k: v.repeat(batch // 8, 1, 1, 1, 1) for k, v in cls.items()}
        reg_b = {k: v.repeat(batch // 8, 1, 1, 1, 1) for k, v in reg.items()}
        calls = {
            "fused_decode_nms": lambda: b2.fused_decode_nms(
                cls_b, reg_b, levels, (SIZE, SIZE), cfg),
            "reference": lambda: b2.nms_padded(
                b2.decode_levels(cls_b, reg_b, levels, SIZE, cfg),
                cfg.iou_threshold, cfg.max_output_size,
                pre_nms_top_k=cfg.pre_nms_top_k),
            "reference_every_candidate": lambda: b2.nms_padded(
                b2.decode_levels(cls_b, reg_b, levels, SIZE, cfg),
                cfg.iou_threshold, cfg.max_output_size, pre_nms_top_k=None)}
        with torch.inference_mode():
            ms = {k: cuda_time_ms(f, 10 if batch == 8 else 3)
                  for k, f in calls.items()}
        log("decode-time", batch=batch, score_threshold=cfg.score_threshold,
            ms=ms)
        del cls_b, reg_b
    torch.cuda.empty_cache()
    return launches


def is_layout_copy(name: str) -> bool:
    """A kernel that copies or transposes a tensor within its dtype (a
    cast, such as a conv kernel's fp32 to bf16, is not one)."""
    low = name.lower()
    return "direct_copy" in low or "transpose" in low


def is_cast(name: str) -> bool:
    return "copy_kernel" in name.lower() and not is_layout_copy(name)


def b4_neighbours(names):
    """The kernels just before and just after each run of B4 kernels."""
    around = []
    for i, name in enumerate(names):
        if "b4_group_norm" not in name:
            continue
        for j in (i - 1, i + 1):
            if 0 <= j < len(names) and "b4_group_norm" not in names[j]:
                around.append(names[j])
    return around


@contextlib.contextmanager
def b4_plain():
    """B4's plain version in place of its kernel on the card (the
    wrapper's ``forward_cuda``; its autograd backward is unchanged), as the
    int8 check patches B6's."""
    real = b4.forward_cuda
    b4.forward_cuda = (
        lambda x, gamma, beta, groups, eps, activation, path=None:
        b4.fused_group_norm_act_plain(x, gamma, beta, groups, eps,
                                      activation))
    try:
        yield
    finally:
        b4.forward_cuda = real


def gn_as_kernel_path(model):
    """``use_kernel`` on the GroupNorms of an unfused ``model`` that take
    B4 on the kernel path: every one but those inside the identity blocks,
    which B1 (and B3) run with the model's bf16 affine."""
    use_group_norm_kernel(model)
    for block in model.modules():
        if isinstance(block, ResNetBottleneck) and not block.project:
            use_group_norm_kernel(block, False)


def check_gn_model(device, gn_shapes):
    """The in-model B4 A/B: every GroupNorm of ``Detector.model`` on B4
    (``use_group_norm_kernel``: the JAX module's ``use_pallas`` set for the
    whole model; no config or default changes), the bench serving config
    at batch 8, counted: B4 launches per forward equal the recorded
    GroupNorm calls at or above the gate (``record_gn_shapes``); each B4
    call within B4_REL of its plain version on the model's activations;
    the heads at least as close to the float32 model as the plain path's
    with the model's own GroupNorm, and logged against the same path with
    B4's plain version and the unfused plain path with it; the kernels of
    a forward
    with and without B4, and the kernels next to each B4 launch (a copy or
    transpose there would be a layout change around B4, what sank the JAX
    package's in-model GroupNorm).  Returns the launches."""
    config = flagship_config()
    state = init_params(config, torch.Generator().manual_seed(0), 80)
    detector = Detector(config, state, [str(i) for i in range(80)], device)
    switched = use_group_norm_kernel(detector.model)
    images = torch.randn(8, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)
    gated = sum(n for (_, h, w, c, _, _), n in gn_shapes["kernels"].items()
                if h * w * c >= GN_KERNEL_MIN_ELEMENTS)
    # The main path, counted: one serving batch with B4 in the model.
    b1.fused_bottleneck.launches = 0
    b2.nms_keep_mask_batch.launches = 0
    b4.fused_group_norm_act.launches = 0
    out = detector(images)
    torch.cuda.synchronize()
    launches = {"b4": b4.fused_group_norm_act.launches,
                "b1": b1.fused_bottleneck.launches,
                "b2": b2.nms_keep_mask_batch.launches}
    log("gn-launches", gn_modules=switched,
        gn_calls_at_or_above_gate=gated, **launches)
    if launches != {"b4": gated, "b1": 12, "b2": 1}:
        raise AssertionError(f"expected {gated} B4, 12 B1 and 1 B2 launches "
                             f"per forward with B4 in the model, got "
                             f"{launches}")
    if (not all(bool(torch.isfinite(t.float()).all())
                for t in (out.boxes, out.scores))
            or tuple(out.boxes.shape) != (8, 1000, 4)):
        raise AssertionError("bad detections with B4 in the model")
    # Each B4 call of the forward against B4's plain version on the same
    # model activations (forward hooks): within B4_REL.
    calls = []

    def against_plain(module, inputs, output):
        x = inputs[0]
        n, c, h, w = x.shape
        if h * w * c < GN_KERNEL_MIN_ELEMENTS:
            return
        ref = b4.fused_group_norm_act_plain(
            x.permute(0, 2, 3, 1), module.gamma, module.beta,
            resolve_groups(c, module.groups), module.eps,
            module.activation).permute(0, 3, 1, 2).float()
        err = (output.float() - ref).abs()
        calls.append((int((err > B4_REL[x.dtype] * ref.abs().clamp(min=1.0))
                          .sum().item()), err.max().item(),
                      (err == 0).float().mean().item(),
                      x.permute(0, 2, 3, 1).is_contiguous()))

    hooks = [m.register_forward_hook(against_plain)
             for m in detector.model.modules() if isinstance(m, GroupNorm)]
    with torch.inference_mode():
        got = detector.model(images)
    for hook in hooks:
        hook.remove()
    log("gn-calls-vs-plain", calls=len(calls),
        over_bound=sum(c[0] for c in calls),
        max_abs_err=max(c[1] for c in calls),
        min_bitwise_equal_share=min(c[2] for c in calls),
        inputs_not_channels_last=sum(not c[3] for c in calls))
    if len(calls) != gated or any(c[0] for c in calls):
        raise AssertionError("a B4 call in the model disagrees with its "
                             "plain version")
    if not all(c[3] for c in calls):
        raise AssertionError("a GroupNorm input in the model is not "
                             "channels_last: B4's NHWC view would copy it")
    # The heads, logged with their elements outside the JAX bound: against
    # the same path with B4's plain version (``b4_plain``), and against the
    # unfused plain path with B4's plain version where the kernel path has
    # B4 (``gn_as_kernel_path``).  Both share the kernel path's rounding
    # points and part from it in summation orders, which 36 more GroupNorms
    # carry through the network.
    plain = RetinaNet.from_config(flagship_config(fused=False).model, 9, 80)
    plain.load_state_dict(state)
    plain.to(device).eval()
    with torch.inference_mode():
        gn_as_kernel_path(plain)
        with b4_plain():
            want = detector.model(images)
            want_plain = plain(images)
        use_group_norm_kernel(plain, False)
        share, outside = compare_heads("gn", got, want, check=False)
        share_plain, outside_plain = compare_heads(
            "gn-plain-path", got, want_plain, check=False)
        eager = plain(images)
    log("gn-vs-plain", bitwise_equal_share=share, outside_bound=outside,
        plain_path_bitwise_equal_share=share_plain,
        plain_path_outside_bound=outside_plain)
    # Against the model's own GroupNorm (bf16 scale, shift and affine), B4
    # (fp32 affine) differs in where bf16 rounds (ROADMAP C.6): both held
    # to the float32 model, B4 at least as close as the eager path
    # (TRAIN_TRUTH_FACTOR/SLACK, the repo's "at least as accurate" bound).
    f32 = flagship_config(fused=False)
    f32 = RetinaNet.from_config(dataclasses.replace(
        f32.model, compute_dtype="float32"), 9, 80)
    f32.load_state_dict(state)
    f32.to(device).eval()
    with torch.inference_mode():
        truth = f32(images)
    worse = []
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            t = truth[head][pn].float()
            err = {k: ((v[head][pn].float() - t).norm() / t.norm()).item()
                   for k, v in (("b4", got), ("eager_gn", eager))}
            diff = (got[head][pn].float() - eager[head][pn].float()).abs()
            log("gn-vs-float32", head=head, level=pn, rel_l2_err=err,
                max_abs_diff_b4_vs_eager_gn=diff.max().item(),
                mean_abs_diff_b4_vs_eager_gn=diff.mean().item())
            if err["b4"] > (TRAIN_TRUTH_FACTOR * err["eager_gn"]
                            + TRAIN_TRUTH_SLACK):
                worse.append(f"{head}/{pn}")
    if worse:
        raise AssertionError(f"B4 in the model is less accurate than the "
                             f"model's GroupNorm at {worse}")
    del plain, f32, got, want, want_plain, eager, truth
    order = {}
    for on in (False, True):
        use_group_norm_kernel(detector.model, on)
        with torch.inference_mode():
            order[on] = [name for name, _ in kernel_sequence(
                lambda: detector.model(images))]
    around = b4_neighbours(order[True])
    groups = {}
    for name in around:
        groups[group_of(name)] = groups.get(group_of(name), 0) + 1
    log("gn-layout", kernels_per_forward=[len(order[False]),
                                          len(order[True])],
        b4_kernels=sum("b4_group_norm" in n for n in order[True]),
        layout_copies=[sum(map(is_layout_copy, order[False])),
                       sum(map(is_layout_copy, order[True]))],
        casts=[sum(map(is_cast, order[False])),
               sum(map(is_cast, order[True]))],
        kernels_next_to_b4=len(around),
        layout_copies_next_to_b4=sum(map(is_layout_copy, around)),
        casts_next_to_b4=sum(map(is_cast, around)),
        groups_next_to_b4=groups)
    if sum(map(is_layout_copy, around)):
        raise AssertionError("a copy or transpose kernel runs next to B4 in "
                             "the model")
    del detector, out
    torch.cuda.empty_cache()
    return launches


def time_gn_model(device):
    """The in-model B4 A/B timed in turns (without B4, with, with,
    without): serving images/s and latency at batch 128 on the kernel and
    int8 paths and at batch 8 on the kernel path, and the batch-32
    ``fused_train`` step (B4 forward, its plain backward)."""
    for path, batch in (("kernels", 128), ("int8", 128), ("kernels", 8)):
        for on in (False, True, True, False):
            r = benchmark(serving_config(path, batch), batch_size=batch,
                          steps=10 if batch == 8 else 5, warmup=2,
                          num_classes=80, device=device,
                          group_norm_kernel=on)
            log("gn-e2e-time", path=path, batch=batch, b4=on,
                images_per_sec=r["images_per_sec"],
                p50_ms=r["p50_latency_ms"], p99_ms=r["p99_latency_ms"])
            if batch == 128:
                B128_RATES.setdefault(path + "+b4" * on, []).append(
                    r["images_per_sec"])
            torch.cuda.empty_cache()
    for on in (False, True, True, False):
        r = benchmark_train(train_config(32), batch_size=32, steps=5,
                            warmup=2, num_classes=80, device=device,
                            group_norm_kernel=on)
        log("gn-train-time", path="kernels", batch=32, b4=on,
            step_ms=r["step_ms"], images_per_sec=r["images_per_sec"],
            peak_memory_gib=r["peak_memory_bytes"] / 2 ** 30,
            final_loss=r["final_loss"])
        if not r["finite"]:
            raise AssertionError("non-finite loss timing the step with B4")
        torch.cuda.empty_cache()


def train_config(batch: int = 8, fused: bool = True) -> Config:
    """The flagship's training config: resnet_50_dense at 640 px, bf16,
    the Config's default momentum SGD; ``fused_train`` on the kernel path."""
    config = Config()
    return config.replace(
        model=dataclasses.replace(config.model, backbone="resnet_50_dense",
                                  fused_train=fused),
        data=dataclasses.replace(config.data, image_size=SIZE,
                                 batch_size=batch))


TRAIN_KEYS = ("total_loss", "class_loss", "regr_loss", "regularization_loss",
              "grad_norm")


def compare_steps(label, got, plain, truth, identity,
                  grad_norm=True) -> bool:
    """Whether a training step ``got`` agrees with the bf16 plain path's
    ``plain`` and is as close to the float32 path's ``truth`` (each a pair
    of scalars and {parameter: gradient}): its losses, every gradient leaf
    and (``grad_norm``) its gradient norm; logs the losses' and
    grad_norm's relative errors against ``plain`` and, for the identity
    blocks (``identity``, the 108 parameters B3 differentiates) and the
    other leaves, the worst leaf and quantiles of the ratio of ``got``'s
    error to the plain path's."""
    (g_scalars, g_grads), (p_scalars, p_grads) = got, plain
    rel = {k: abs(g_scalars[k] - p_scalars[k]) / abs(p_scalars[k])
           for k in TRAIN_KEYS}
    errs, skipped = {}, 0
    for name, t in truth[1].items():
        if t.abs().max().item() < TRAIN_LEAF_MIN:
            skipped += 1
            continue
        errs[name] = tuple(((g[name] - t).norm() / t.norm()).item()
                           for g in (g_grads, p_grads))
    margin = {n: e - TRAIN_TRUTH_FACTOR * p - TRAIN_TRUTH_SLACK
              for n, (e, p) in errs.items()}
    bad = [n for n, m in margin.items() if not m <= 0]

    def summary(names):
        names = [n for n in names if n in errs]
        worst = max(names, key=lambda n: margin[n])
        ratio = torch.tensor([errs[n][0] / errs[n][1] for n in names])
        q = torch.quantile(ratio, torch.tensor([0.5, 0.9, 1.0]))
        return {"worst": [worst, *errs[worst]],
                "err_ratio_p50_p90_max": q.tolist(),
                "plain_err_p50": float(torch.tensor(
                    [errs[n][1] for n in names]).median())}

    leaves_and_losses = (not bad and max(rel[k] for k in TRAIN_KEYS[:4])
                         <= TRAIN_LOSS_REL)
    norm_ok = rel["grad_norm"] <= TRAIN_NORM_REL
    agrees = leaves_and_losses and (norm_ok or not grad_norm)
    log("train-vs-plain", run=label, rel=rel, leaves=len(errs),
        skipped=skipped, identity_blocks=summary(identity),
        other_leaves=summary(set(errs) - set(identity)),
        leaves_out_of_bound=len(bad), first_out_of_bound=bad[:3],
        grad_norm_within=norm_ok, grad_norm_held=grad_norm, agrees=agrees)
    return agrees


def check_training(device):
    """One step of each path from the same seeded parameters on the fixed
    batch: launch counts of the kernel path's step, its losses and every
    gradient against the plain path's, the kernel path's loss over
    ``TRAIN_STEPS`` steps, and each planted B3 fault rejected."""
    levels = build_levels()
    state_dict = init_params(train_config(), torch.Generator().manual_seed(0),
                             80)
    batch = synthetic_batch(8, SIZE, 100, device)

    def first_step(model, config, with_metrics=False):
        state = create_train_state(model, config, state_dict)
        step = make_train_step(model, levels, config, with_metrics)
        state, metrics = step(state, *batch,
                              torch.Generator(device).manual_seed(1))
        scalars = {k: float(metrics[k]) for k in TRAIN_KEYS}
        finite = all(map(math.isfinite, scalars.values()))
        # From a zero momentum trace, the trace after one step is the
        # step's gradient.
        grads = {n: t.clone() for n, t in
                 zip(state.params, state.opt_state["trace"])}
        return state, metrics, (scalars, grads), finite

    config = train_config(8, fused=False)
    f32 = config.replace(model=dataclasses.replace(
        config.model, compute_dtype="float32"))
    refs = {}
    for path, cfg in (("plain", config), ("float32", f32),
                      ("plain+b4", config)):
        model = RetinaNet.from_config(cfg.model, 9, 80).to(device)
        with contextlib.ExitStack() as stack:
            if path == "plain+b4":  # B4's plain version where kernels have B4
                gn_as_kernel_path(model)
                stack.enter_context(b4_plain())
            _, metrics, refs[path], finite = first_step(model, cfg, True)
        log("train-step", path=path, batch=8, **refs[path][0],
            num_fg=int(metrics["num_fg"]), finite=finite)
        if not finite:
            raise AssertionError(f"non-finite training step on the {path} "
                                 "path")
        del model, metrics
        torch.cuda.empty_cache()

    config = train_config(8)
    model = RetinaNet.from_config(config.model, 9, 80).to(device)
    identity = [f"{m}.{p}" for m, mod in model.named_modules()
                if isinstance(mod, ResNetBottleneck) and not mod.project
                for p, _ in mod.named_parameters()]
    # The main path, counted: one training step.
    b1.fused_bottleneck.launches = 0
    b3.fused_bottleneck_bwd.launches = 0
    state, metrics, got, finite = first_step(model, config, True)
    torch.cuda.synchronize()
    launches = {"b1": b1.fused_bottleneck.launches,
                "b3": b3.fused_bottleneck_bwd.launches}
    log("train-step", path="kernels", batch=8, **got[0],
        num_fg=int(metrics["num_fg"]), finite=finite)
    log("train-launches", **launches, steps=1)
    if not finite:
        raise AssertionError("non-finite training step on the kernel path")
    if launches != {"b1": 12, "b3": 12}:
        raise AssertionError(f"expected 12 B1 and 12 B3 launches per "
                             f"training step, got {launches}")
    losses = [got[0]["total_loss"]]
    light = make_train_step(model, levels, config, with_metrics=False)
    for _ in range(TRAIN_STEPS - 1):
        state, metrics = light(state, *batch)
        losses.append(float(metrics["total_loss"]))
    log("train-loss", path="kernels", steps=TRAIN_STEPS, total_loss=losses)
    del state, metrics

    sound = compare_steps("kernels", got, refs["plain"], refs["float32"],
                          identity)
    # The same step with every GroupNorm's forward on B4 (its backward the
    # plain fp32 gradient): its losses and every gradient leaf held as the
    # kernel path's are, against the plain path with B4's plain version in
    # the same GroupNorms (the same rounding points); its gradient norm,
    # which 36 more summation orders move by more than the kernel path's
    # 0.1%, logged.  Against the plain path with the model's own GroupNorm
    # (bf16 affine, ROADMAP C.6), logged.
    use_group_norm_kernel(model)
    b4.fused_group_norm_act.launches = 0
    with_b4 = first_step(model, config)[2]
    torch.cuda.synchronize()
    b4_launches = b4.fused_group_norm_act.launches
    use_group_norm_kernel(model, False)
    log("train-launches", path="kernels+b4", b4=b4_launches, steps=1)
    b4_sound = compare_steps("kernels+b4", with_b4, refs["plain+b4"],
                             refs["float32"], identity, grad_norm=False)
    compare_steps("kernels+b4 vs plain with the model's GroupNorm", with_b4,
                  refs["plain"], refs["float32"], identity)
    del with_b4
    real = b3.fused_bottleneck_bwd
    missed = []
    for fault, plant in TRAIN_FAULTS.items():
        def faulty(*args, _plant=plant, **kwargs):
            return _plant(real(*args, **kwargs))
        faulty.launches = 0
        b3.fused_bottleneck_bwd = faulty
        try:
            bad = first_step(model, config)[2]
        finally:
            b3.fused_bottleneck_bwd = real
        if compare_steps(fault, bad, refs["plain"], refs["float32"],
                         identity):
            missed.append(fault)
        del bad
    del model, got, refs
    torch.cuda.empty_cache()
    if not sound:
        raise AssertionError("the kernel path's training step disagrees "
                             "with the plain path")
    if not b4_sound or not b4_launches:
        raise AssertionError(f"the training step with B4 in the model "
                             f"({b4_launches} launches) disagrees with the "
                             f"plain path")
    if missed:
        raise AssertionError(f"planted B3 faults passed the check: {missed}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    return launches


# B2's serial chain per box: a bit test and an OR, each an integer
# instruction whose result the next one waits for (~4 cycles each).
B2_CHAIN_OPS, INT_OP_CYCLES = 2, 4


def b2_chain_floor_ms(n):
    """The least time of B2's dependency chain over ``n`` boxes at the
    card's maximum SM clock: images run in parallel, one warp each."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return n * B2_CHAIN_OPS * INT_OP_CYCLES / (mhz * 1e6) * 1e3


def nms_bound(batch, n):
    """(ms, bound_by) of the keep mask: ~17 fp32 operations per box pair
    (the IoU and its test) outside the tensor cores; bytes: the boxes in,
    the mask out."""
    t_op = batch * n * (n - 1) / 2 * 17 / PEAK_FP32
    t_by = (batch * n * 16 + batch * n) / PEAK_BYTES
    return max(t_op, t_by) * 1e3, "operations" if t_op >= t_by else "bytes"


def b3_groups(call):
    """B3's launches and device ms per call by launch group (B3_GROUPS),
    and by kernel (name without its namespace and arguments)."""
    split, kernels = {}, {}
    for name, (n, ms) in kernel_launches(call).items():
        if "b3_fused_bottleneck_bwd" not in name:
            continue
        group = next((g for g, keys in B3_GROUPS
                      if any(k in name for k in keys)), "other")
        short = name.split("b3_fused_bottleneck_bwd::", 1)[1].split("(")[0]
        for table, key in ((split, group), (kernels, short)):
            total = table.get(key, (0.0, 0.0))
            table[key] = (total[0] + n, total[1] + ms)
    return split, kernels


def add_split(total, split, count):
    """Adds ``count`` times a per-call {group: [launches, ms]} to
    ``total``."""
    for g, (n, ms) in split.items():
        t = total.setdefault(g, [0.0, 0.0])
        t[0] += count * n
        t[1] += count * ms


def time_kernels(device):
    """Each kernel vs its plain version at the slices' shapes (batch 8),
    with its bound; B1 and B3 summed over the 12 identity blocks.  B1 as
    the serving path calls it, with its weight layouts made beforehand
    (``kernel_ms``), and laying them out in the call
    (``kernel_ms_layouts_in_call``, the scope of the parent's wrapper)."""
    gen = torch.Generator().manual_seed(4)
    timing = {"b1": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_op=0.0,
                         ms_layouts_in_call=0.0),
              "b3": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_op=0.0)}
    groups, b1_groups = {}, {}
    for name, h, w, c, f, count in STAGES:
        x, params = block_inputs(8, h, w, c, f, gen, device)
        dout = torch.randn(8, h, w, c, generator=gen).to(
            torch.bfloat16).to(device)
        wts = b1.prepare_weights(*params[::3])
        in_call = cuda_time_ms(lambda: b1.fused_bottleneck(x, *params), 10)
        timing["b1"]["ms_layouts_in_call"] += count * in_call
        for key, passes, kernel, plain in (
                ("b1", 1, lambda: b1.fused_bottleneck(x, *params,
                                                      weights=wts),
                 lambda: b1.fused_bottleneck_plain(x, *params)),
                ("b3", 3, lambda: b3.fused_bottleneck_bwd(x, dout, *params),
                 lambda: b3.fused_bottleneck_bwd_plain(x, dout, *params))):
            k_ms = cuda_time_ms(kernel, 10)
            p_ms = cuda_time_ms(plain, 5)
            bound, by = block_bound(8, h, w, c, f, passes)
            log(f"{key}-time", stage=name, batch=8, kernel_ms=k_ms,
                plain_ms=p_ms, bound_ms=bound, bound_by=by,
                blocks_per_step=count,
                **({"kernel_ms_layouts_in_call": in_call} if key == "b1"
                   else {}))
            t = timing[key]
            t["ms"] += count * k_ms
            t["plain_ms"] += count * p_ms
            t["bound_ms"] += count * bound
            t["t_op"] += count * (bound if by == "operations" else 0.0)
        split = block_split(lambda: b1.fused_bottleneck(x, *params,
                                                        weights=wts))
        check_block_launches("b1-split", split, "b1_fused_bottleneck",
                             stage=name, batch=8)
        add_split(b1_groups, split, count)
        split, kernels = b3_groups(lambda: b3.fused_bottleneck_bwd(
            x, dout, *params))
        log("b3-split", stage=name, batch=8, launches_and_ms=split,
            by_kernel=kernels)
        add_split(groups, split, count)
        del x, params, dout, wts
    log("b1-split-total", batch=8, blocks=12, launches_and_ms=b1_groups)
    log("b3-split-total", batch=8, blocks=12, launches_and_ms=groups)
    for t in timing.values():
        t["bound_by"] = ("operations" if t.pop("t_op") >= t["bound_ms"] / 2
                         else "bytes")
    # B3 at the training bench's batch 32, res2's shape (two blocks a step).
    name, h, w, c, f, count = STAGES[0]
    x, params = block_inputs(32, h, w, c, f, gen, device)
    dout = torch.randn(32, h, w, c, generator=gen).to(torch.bfloat16).to(
        device)

    def call():
        b3.fused_bottleneck_bwd(x, dout, *params)

    k_ms = cuda_time_ms(call, 5)
    bound, by = block_bound(32, h, w, c, f, 3)
    log("b3-time", stage=name, batch=32, kernel_ms=k_ms, bound_ms=bound,
        bound_by=by, blocks_per_step=count,
        launches_and_ms=b3_groups(call)[0])
    del x, params, dout
    timing["b2"] = time_b2(device, gen)
    torch.cuda.empty_cache()
    return timing


def time_b2(device, gen):
    """B2 at the serving shapes (batch 8 and 128, and the single-image
    entry) and at the reference decode path's [8,4125,4] against its plain
    version, with its device time per kernel, its operations bound and the
    floor of its dependency chain; returns the batch-8 serving figures for
    the kernel line, with N = 4125's."""
    for shape in ((8, 1000), (128, 1000), (1, 1000), (8, 4125)):
        boxes = clustered_boxes(*shape, gen).to(device)
        single = shape[0] == 1
        kernel = ((lambda: b2.nms_keep_mask(boxes[0], 0.5)) if single else
                  (lambda: b2.nms_keep_mask_batch(boxes, 0.5)))
        k_ms = cuda_time_ms(kernel, 20)
        p_ms = cuda_time_ms(lambda: b2._greedy_keep_mask(boxes, 0.5), 3,
                            warmup=1)
        bound, by = nms_bound(*shape)
        kernels = {name.split("b2_nms::", 1)[-1].split("(")[0]: v
                   for name, v in kernel_launches(kernel).items()}
        log("b2-time", shape=[*shape, 4], kernel_ms=k_ms, plain_ms=p_ms,
            bound_ms=bound, bound_by=by,
            chain_floor_ms=b2_chain_floor_ms(shape[1]),
            launches_and_device_ms=kernels,
            entry="nms_keep_mask" if single else "nms_keep_mask_batch")
        if shape == (8, 1000):
            timing = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                          bound_by=by)
        elif shape == (8, 4125):
            timing.update(ms_n4125=k_ms, plain_ms_n4125=p_ms,
                          bound_ms_n4125=bound)
    return timing


def bound(flop, nbytes, peak):
    """(ms, bound_by): the larger of ``flop`` at ``peak`` and ``nbytes`` at
    the card's memory rate."""
    t_op, t_by = flop / peak, nbytes / PEAK_BYTES
    return max(t_op, t_by) * 1e3, "operations" if t_op >= t_by else "bytes"


def int_mm_ms(x_q, weights):
    """``torch._int_mm`` on a 1×1 stride-1 conv's quantized operands, the
    ones B6's GEMM reads (the integer-GEMM yardstick of B6), or None where
    this PyTorch build refuses the shapes."""
    f, c = weights.shape[:2]
    a = x_q.reshape(-1, c)
    w_q = weights.w_q.view(f, c)
    try:
        return cuda_time_ms(lambda: torch._int_mm(a, w_q.t()), 10,
                            queued=True)
    except RuntimeError as err:
        log("b6-library", error=str(err).splitlines()[0])
        return None


def time_b6(device, int8_shapes, gen):
    """B6 at every int8 conv shape of the flagship at batch 8, three ways:
    the whole conv through the wrapper with prepared weights, host work
    included (``ms``), and, queued behind a sleep kernel so that only the
    device's time counts, its three launches alone on preallocated
    buffers (``launches_ms``) and the GEMM launch alone (``gemm_ms``),
    with ``torch._int_mm`` beside the GEMM on the same quantized operands
    for the 1×1 stride-1 convs (queued too); the plain version.  Summed over the 59 convs (``check_int8_serving``
    counts the kernels per conv)."""
    t = dict(ms=0.0, launches_ms=0.0, gemm_ms=0.0, plain_ms=0.0,
             bound_ms=0.0, t_op=0.0)
    lib = dict(library_ms=0.0, gemm_ms_library_scope=0.0, library_convs=0)
    for key, count in sorted(int8_shapes.items()):
        b, h, w, c, f, k, s = key
        x, kernel = int8_case(key, gen, device)
        wts = b6.prepare_weights(kernel)
        ho, wo = -(-h // s), -(-w // s)
        x_q = torch.empty(b6.xq_bytes(x.shape), dtype=torch.int8,
                          device=device)
        out = torch.empty(b, ho, wo, f, dtype=torch.bfloat16, device=device)
        work = b6.scratch(device)[0]

        def run(which=b6.AMAX | b6.QUANTIZE | b6.GEMM):
            return lambda: b6.launch(x, x_q, work, wts, out, s, which=which)

        k_ms = cuda_time_ms(lambda: b6.int8_conv(x, kernel, s, weights=wts),
                            10)
        # leaves x_q and s_x for the GEMM alone
        l_ms = cuda_time_ms(run(), 10, queued=True)
        g_ms = cuda_time_ms(run(b6.GEMM), 10, queued=True)
        p_ms = cuda_time_ms(lambda: b6.int8_conv_plain(
            x, kernel, s, torch.bfloat16), 2, warmup=1)
        # x and y bf16, the prepared weights int8 w_q and fp32 s_w
        ms, by = bound(2 * b * ho * wo * k * k * c * f,
                       (b * h * w * c + b * ho * wo * f) * 2
                       + k * k * c * f + 4 * f, PEAK_INT8)
        i_ms = int_mm_ms(x_q, wts) if (k, s) == (1, 1) else None
        log("b6-time", shape=[b, h, w, c], F=f, k=k, stride=s,
            tile_n=b6.tile_n(f, b * ho * wo, k * k * c),
            convs_per_forward=count, conv_ms=k_ms, launches_ms=l_ms,
            gemm_ms=g_ms, int_mm_ms=i_ms,
            plain_ms=p_ms, bound_ms=ms, bound_by=by)
        for name, v in (("ms", k_ms), ("launches_ms", l_ms),
                        ("gemm_ms", g_ms), ("plain_ms", p_ms),
                        ("bound_ms", ms)):
            t[name] += count * v
        t["t_op"] += count * (ms if by == "operations" else 0.0)
        if i_ms is not None:
            lib["library_ms"] += count * i_ms
            lib["gemm_ms_library_scope"] += count * g_ms
            lib["library_convs"] += count
        del x, kernel, wts, x_q, out
    t["bound_by"] = ("operations" if t.pop("t_op") >= t["bound_ms"] / 2
                     else "bytes")
    if not lib["library_convs"]:
        lib["library_ms"] = None
    log("b6-time-total", **t, **lib)
    return dict(t, **lib)


# B4 timed at the P3 and P4 head activations at batch 8 (the sums go into
# the kernel line) and at P3 at the serving bench's batch 128, and at the
# stem's (name, batch, H, W, C, activation).
B4_TIMED = (("P3", 8, 80, 80, 256, "elu"), ("P4", 8, 40, 40, 256, "elu"),
            ("P3", 128, 80, 80, 256, "elu"), ("stem", 8, 320, 320, 64,
                                              "relu"))


# Image shapes (H, W, C) of the model's gated GroupNorms that the cluster
# path can hold, from 0.8 to 3.3 MB in bf16: B4's paths timed at batch 8
# and 128 to set the wrapper's rule (``groupnorm.kernel_path``).
B4_SWEEP = ((40, 40, 256), (20, 20, 2048), (40, 40, 512), (80, 80, 128),
            (40, 40, 1024), (80, 80, 256), (160, 160, 64))


def sweep_b4_paths(device, gen):
    """Each B4 path (the cluster path also with 8 CTAs per image) at
    B4_SWEEP, bf16, no activation, batch 8 and 128."""
    for h, w, c in B4_SWEEP:
        groups = resolve_groups(c)
        gamma, beta = (p.to(device) for p in gn_affine(c, gen))
        for batch in (8, 128):
            x = torch.randn(batch, h, w, c, generator=gen).to(
                torch.bfloat16).to(device)
            ms = {}
            for label, path, size in (("split", "split", 16),
                                      ("cluster16", "cluster", 16),
                                      ("cluster8", "cluster", 8)):
                saved, b4.CLUSTER_SIZE = b4.CLUSTER_SIZE, size
                try:
                    if (path == "split" or b4.cluster_smem(
                            h * w, c, groups, 2) <= b4.CLUSTER_SMEM):
                        with torch.no_grad():
                            ms[label] = cuda_time_ms(
                                lambda: b4.forward_cuda(x, gamma, beta,
                                                        groups, 1e-5, None,
                                                        path),
                                20 if batch == 8 else 5)
                finally:
                    b4.CLUSTER_SIZE = saved
            log("b4-paths", shape=[batch, h, w, c],
                image_bytes=h * w * c * 2,
                cluster_smem_per_cta=b4.cluster_smem(h * w, c, groups, 2),
                rule=b4.kernel_path(batch, h * w, c, groups,
                                    torch.bfloat16),
                ms=ms)
            del x


def time_b4(device, gen):
    """B4 at B4_TIMED in bf16 on each path its shape allows, with the
    activation and without it, against its plain version, ``F.group_norm``
    (the one PyTorch call for the same function: no activation) and, for
    reference, ``F.elu(F.group_norm(...))``.  The kernel line takes the sum
    over the batch-8 P3 and P4 calls, without the activation."""
    t = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    gn = torch.nn.functional.group_norm
    for name, batch, h, w, c, act in B4_TIMED:
        x = torch.randn(batch, h, w, c, generator=gen).to(
            torch.bfloat16).to(device)
        gamma, beta = (p.to(device) for p in gn_affine(c, gen))
        groups = resolve_groups(c)
        xc = x.permute(0, 3, 1, 2)
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        iters = 20 if batch == 8 else 5
        paths = {}
        with torch.no_grad():
            for path in b4_paths(h, w, c, x.dtype):
                for a in (None, act):
                    paths[f"{path}/{a}"] = cuda_time_ms(
                        lambda: b4.forward_cuda(x, gamma, beta, groups, 1e-5,
                                                a, path), iters)
            k_ms = cuda_time_ms(lambda: b4.fused_group_norm_act(
                x, gamma, beta, groups, 1e-5, None), iters)
            k_act = cuda_time_ms(lambda: b4.fused_group_norm_act(
                x, gamma, beta, groups, 1e-5, act), iters)
            p_ms = cuda_time_ms(lambda: b4.fused_group_norm_act_plain(
                x, gamma, beta, groups, 1e-5, None), iters // 2)
            l_ms = cuda_time_ms(lambda: gn(xc, groups, g16, b16, 1e-5),
                                iters)
            l_act = cuda_time_ms(lambda: torch.nn.functional.elu(
                gn(xc, groups, g16, b16, 1e-5)), iters)
        with torch.no_grad():
            kernels = {
                path: {k.split("b4_group_norm::", 1)[-1].split("<")[0]: v
                       for k, v in kernel_launches(
                           lambda: b4.forward_cuda(x, gamma, beta, groups,
                                                   1e-5, None, path)).items()}
                for path in b4_paths(h, w, c, x.dtype)}
        ms, by = bound(0, 2 * x.numel() * 2 + 2 * c * 4, PEAK_FP32)
        log("b4-time", at=name, shape=[batch, h, w, c], activation=act,
            path=b4.kernel_path(batch, h * w, c, groups, x.dtype),
            launches_and_device_ms_by_path=kernels,
            kernel_ms=k_ms, kernel_ms_with_activation=k_act,
            ms_by_path_and_activation=paths, plain_ms=p_ms,
            library_ms=l_ms, library_ms_group_norm_then_elu=l_act,
            bound_ms=ms, bound_by=by)
        if batch == 8 and name in ("P3", "P4"):
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("library_ms", l_ms), ("bound_ms", ms)):
                t[key] += v
        del x, xc
    torch.cuda.empty_cache()
    return dict(t, bound_by="bytes")


def time_new_kernels(device, int8_shapes):
    """B4-B7 vs their plain versions (and a PyTorch call computing the same
    function, where one exists) at their main paths' shapes, batch 8:
    B4 at the P3/P4 head activations (``time_b4``), B5 at res2 b0, B6
    summed over the 59 convs of an int8 forward (``time_b6``), B7 at the
    stem's output."""
    gen = torch.Generator().manual_seed(11)
    sweep_b4_paths(device, gen)
    timing = {"b4": time_b4(device, gen)}
    x, params = proj_inputs(8, gen, device)
    h, w, cin, c, f = RES2_B0
    wts = b1.prepare_proj_weights(*params[::3])
    k_ms = cuda_time_ms(lambda: b1.fused_bottleneck_proj(x, *params,
                                                         weights=wts), 10)
    in_call = cuda_time_ms(lambda: b1.fused_bottleneck_proj(x, *params), 10)
    p_ms = cuda_time_ms(lambda: b1.fused_bottleneck_proj_plain(x, *params), 5)
    weights = cin * f + 9 * f * f + f * c + cin * c
    ms, by = bound(2 * 8 * h * w * weights,
                   8 * h * w * (cin + c) * 2 + (weights + 4 * f + 4 * c) * 4,
                   PEAK_BF16)
    log("b5-time", shape=[8, h, w, cin], C=c, F=f, kernel_ms=k_ms,
        kernel_ms_layouts_in_call=in_call, plain_ms=p_ms, bound_ms=ms,
        bound_by=by,
        launches_and_ms=block_split(
            lambda: b1.fused_bottleneck_proj(x, *params, weights=wts),
            "b5_fused_bottleneck_proj"))
    timing["b5"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=ms, bound_by=by,
                        library_ms=None, ms_layouts_in_call=in_call)
    del x, params, wts

    timing["b6"] = time_b6(device, int8_shapes, gen)
    timing["b7"] = time_b7(device, gen)
    torch.cuda.empty_cache()
    return timing


def b7_bound(shape):
    """(ms, bound_by) of B7 on y [B,H,W,C] bf16 with fp32 scale and shift
    [B,C]: y read once, the pooled output written once; ~3 operations per
    element of y (multiply, add, max), far under the fp32 peak."""
    batch, h, w, c = shape
    out = batch * -(-h // 2) * -(-w // 2) * c
    return bound(3 * batch * h * w * c,
                 batch * h * w * c * 2 + out * 2 + 2 * batch * c * 4,
                 PEAK_FP32)


def time_b7(device, gen):
    """B7 at the stem's shape, batch 8 and 128: ms per call between CUDA
    events (the host's launch in it) and device ms (queued), its plain
    version, its bytes bound and, as a yardstick
    (not the same function), ``F.max_pool2d`` alone on the same
    channels_last y, which moves the same bytes.  Then ``fused_stem`` split
    into conv, statistics and B7, beside the model's stem layers
    (``ConvGN_0`` + ``max_pool_same``) eager and with B4, at batch 8 and
    128.  Returns the batch-8 figures for the kernel line, with b128's."""
    timing = {}
    for batch in (8, 128):
        shape = (batch, *STEM)
        y, scale, shift = stem_case(shape, gen, device)
        iters = 20 if batch == 8 else 5

        def call():
            b7.gn_relu_maxpool(y, scale, shift)

        k_ms = cuda_time_ms(call, iters)
        dev_ms = cuda_time_ms(call, iters, queued=True)
        p_ms = cuda_time_ms(lambda: b7.gn_relu_maxpool_plain(y, scale, shift),
                            10 if batch == 8 else 3, warmup=1)
        yc = y.permute(0, 3, 1, 2)
        pool_ms = cuda_time_ms(lambda: F.max_pool2d(yc, 3, 2, padding=1),
                               iters, queued=True)
        ms, by = b7_bound(shape)
        log("b7-time", shape=list(shape), kernel_ms=k_ms,
            device_ms=dev_ms, share_of_bound=ms / dev_ms,
            plain_ms=p_ms, bound_ms=ms,
            bound_by=by, yardstick_max_pool2d_device_ms=pool_ms,
            launches_and_device_ms=kernel_launches(call))
        if batch == 8:
            timing = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                          bound_ms=ms, bound_by=by, library_ms=None)
        else:
            timing.update(ms_b128=k_ms, device_ms_b128=dev_ms,
                          bound_ms_b128=ms)
        del y, scale, shift, yc
        torch.cuda.empty_cache()
        time_stem(device, gen, batch)
    return timing


def time_stem(device, gen, batch):
    """``fused_stem`` at a 640-px batch, whole and by part (``stem_conv``,
    ``stem_statistics``, B7 with its NHWC view), against the model's stem
    layers on the same weights, eager (``group_norm``) and with B4."""
    x, w, gamma, beta = stem_inputs(gen, device, batch)
    iters = 10 if batch == 8 else 3
    y = b7.stem_conv(x, w)
    scale, shift = b7.stem_statistics(y, gamma, beta)
    parts = {
        "conv": lambda: b7.stem_conv(x, w),
        "statistics": lambda: b7.stem_statistics(y, gamma, beta),
        "b7": lambda: b7.gn_relu_maxpool(y.permute(0, 2, 3, 1).contiguous(),
                                         scale, shift),
        "whole": lambda: b7.fused_stem(x, w, gamma, beta)}
    stem = ConvGN(3, 64, kernel_size=7, strides=2, activation="relu")
    with torch.no_grad():
        stem.Conv_0.kernel.copy_(w.permute(3, 2, 0, 1))
        stem.GroupNorm_0.gamma.copy_(gamma)
        stem.GroupNorm_0.beta.copy_(beta)
    stem.to(device)
    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)

    def layers():
        return max_pool_same(stem(xc), 3, 2)

    with torch.no_grad():
        ms = {k: cuda_time_ms(f, iters) for k, f in parts.items()}
        model_ms = {}
        for on in (False, True):
            stem.GroupNorm_0.use_kernel = on
            model_ms["b4" if on else "eager"] = cuda_time_ms(layers, iters)
    log("stem-time", batch=batch, fused_stem_ms_by_part=ms,
        model_stem_layers_ms=model_ms)
    del x, y, xc, stem
    torch.cuda.empty_cache()


def serving_config(path: str, batch: int) -> Config:
    """The serving configs timed: the bench config on its kernels, with
    ``fused_proj`` too, with int8 convs, and unfused on the plain path."""
    if path == "int8":
        return int8_config(batch)
    config = flagship_config(batch, fused=path != "plain")
    return config.replace(model=dataclasses.replace(
        config.model, fused_proj=path == "fused_proj"))


# images/s of each batch-128 serving run, by path ("+b4": every GroupNorm
# on B4), for the MFU lines.
B128_RATES = {}


def log_mfu():
    """Model FLOP utilization of each batch-128 serving path timed:
    images/s × ``forward_gflops_per_image`` over the H100's dense bf16 peak
    (989 TFLOP/s; int8 paths are held to the same peak)."""
    gflops = forward_gflops_per_image(flagship_config(128))
    log("mfu-flops", gflops_per_image=gflops, image_size=SIZE,
        peak_tflops=PEAK_BF16 / 1e12)
    for path, rates in B128_RATES.items():
        ips = sum(rates) / len(rates)
        log("mfu", path=path, batch=128, images_per_sec=ips,
            tflops=ips * gflops / 1e3, mfu=ips * gflops * 1e9 / PEAK_BF16,
            images_per_sec_runs=rates)


def time_end_to_end(device):
    """Serving images/s and latency at batch 8 and 128; at 128 the
    ``fused_proj`` A/B runs in turns (kernels, fused_proj, fused_proj,
    kernels)."""
    runs = [(8, p) for p in ("kernels", "int8", "plain")]
    runs += [(128, p) for p in ("kernels", "fused_proj", "int8", "plain",
                                "fused_proj", "kernels")]
    for batch, path in runs:
        r = benchmark(serving_config(path, batch), batch_size=batch,
                      steps=10 if batch == 8 else 5, warmup=2,
                      num_classes=80, device=device)
        log("e2e-time", path=path, batch=batch,
            images_per_sec=r["images_per_sec"],
            p50_ms=r["p50_latency_ms"], p99_ms=r["p99_latency_ms"])
        if batch == 128:
            B128_RATES.setdefault(path, []).append(r["images_per_sec"])
        torch.cuda.empty_cache()


def time_training(device):
    """Training step ms, images/s and peak memory of both paths at the
    Config's batch 8 and at bench.py's training batch 32."""
    for batch in (8, 32):
        for path in ("kernels", "plain"):
            config = train_config(batch, fused=path == "kernels")
            try:
                r = benchmark_train(config, batch_size=batch, steps=5,
                                    warmup=2, num_classes=80, device=device)
            except torch.cuda.OutOfMemoryError as err:
                log("train-time", path=path, batch=batch, fits=False,
                    error=str(err).splitlines()[0])
                torch.cuda.empty_cache()
                continue
            log("train-time", path=path, batch=batch, fits=True,
                step_ms=r["step_ms"], images_per_sec=r["images_per_sec"],
                peak_memory_gib=r["peak_memory_bytes"] / 2 ** 30,
                final_loss=r["final_loss"])
            if not r["finite"]:
                raise AssertionError(f"non-finite loss timing the {path} "
                                     f"path at batch {batch}")
            torch.cuda.empty_cache()


def time_train_pipeline(device):
    """The kernel path's training step at the fit phase's size and batch,
    fed by the live host pipeline (``benchmark_train_pipeline``: shapes
    images drawn, augmented and padded on host threads, uint8 batches
    copied on a side stream one step ahead) and, for the host's share, by
    one batch kept on the card (``benchmark_train``)."""
    config = train_config(FIT_BATCH)
    config = config.replace(data=dataclasses.replace(
        config.data, image_size=FIT_SIZE))
    for feed, bench in (("pipeline", benchmark_train_pipeline),
                        ("device batch", benchmark_train),
                        ("pipeline", benchmark_train_pipeline)):
        r = bench(config, batch_size=FIT_BATCH, steps=20, warmup=3,
                  num_classes=FIT_CLASSES, device=device)
        log("train-pipeline-time", feed=feed, batch=FIT_BATCH,
            image_size=FIT_SIZE, step_ms=r["step_ms"],
            images_per_sec=r["images_per_sec"])
        torch.cuda.empty_cache()


def breakdown(device):
    """Device time by kernel group, idle share and kernels per call:
    serving through ``Detector`` at batch 8 and 128 (kernel, int8 and
    plain paths; at 128 the kernel and int8 paths with B4 in the model
    too), training through ``make_train_step`` (no metrics) at batch 8 and
    32 (kernel and plain paths; at 32 the kernel path with B4 too)."""
    levels = build_levels()
    runs = [(8, p) for p in ("kernels", "int8", "plain")]
    runs += [(128, p) for p in ("kernels", "kernels+b4", "int8", "int8+b4",
                                "plain")]
    for batch, path in runs:
        config = serving_config(path.split("+")[0], batch)
        detector = Detector(config, init_params(
            config, torch.Generator().manual_seed(0), 80),
            [str(i) for i in range(80)], device)
        use_group_norm_kernel(detector.model, path.endswith("+b4"))
        images = torch.randn(batch, SIZE, SIZE, 3,
                             generator=torch.Generator().manual_seed(3)
                             ).to(device)
        log("breakdown", slice="serving", path=path, batch=batch,
            **device_breakdown(lambda: detector(images)))
        del detector, images
        torch.cuda.empty_cache()
    for batch, path in ((8, "kernels"), (8, "plain"), (32, "kernels"),
                        (32, "kernels+b4"), (32, "plain")):
        config = train_config(batch, fused=path != "plain")
        model = RetinaNet.from_config(config.model, 9, 80).to(device)
        use_group_norm_kernel(model, path.endswith("+b4"))
        box = [create_train_state(model, config, init_params(
            config, torch.Generator().manual_seed(0), 80))]
        step = make_train_step(model, levels, config, with_metrics=False)
        data = synthetic_batch(batch, SIZE, config.assign.max_boxes,
                               device)

        def call():
            box[0] = step(box[0], *data)[0]

        log("breakdown", slice="training", path=path, batch=batch,
            **device_breakdown(call))
        del model, box, step, data
        torch.cuda.empty_cache()


def parent_module(name: str):
    """The parent commit's ``ops/<name>.py`` from PARENT_DIR, its kernel
    libraries pointed at the parent's sources there (which include the
    parent's headers beside them)."""
    spec = importlib.util.spec_from_file_location(f"parent_{name}",
                                                  PARENT_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for lib in (getattr(module, k) for k in ("LIB", "PROJ_LIB")
                if hasattr(module, k)):
        lib.source = PARENT_DIR / lib.source.name
    return module


def within_b1_bound(label, out, ref, **fields) -> None:
    """Logs how far ``out`` is from ``ref`` and raises unless it is
    within B1's bound."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    over = int((err > B1_REL * ref.abs().clamp(min=1.0)).sum().item())
    log(label, **fields, max_abs_err=err.max().item(),
        mean_abs_err=err.mean().item(),
        bitwise_equal_share=(err == 0).float().mean().item(),
        over_bound=over)
    if over or err.mean().item() > B1_MEAN:
        raise AssertionError(f"{label}: outside B1's bound at {fields}")


def parent_b1_b5(device, gen):
    """B1 at the four stage shapes and B5 at res2 b0, batch 8, against the
    parent's: within B1's bound of the parent's output (GEMMs that sum in
    another order), timed in turns (parent, this tree, this tree, parent;
    each wrapper as serving calls it), B1 by launch group."""
    old1 = parent_module("bottleneck")
    turns = {"parent": 0.0, "this": 0.0}
    for name, h, w, c, f, count in STAGES:
        x, params = block_inputs(8, h, w, c, f, gen, device)
        wts = b1.prepare_weights(*params[::3])
        new = b1.fused_bottleneck(x, *params, weights=wts)
        old = old1.fused_bottleneck(x, *params)
        torch.cuda.synchronize()
        within_b1_bound("parent-b1", new, old, stage=name, batch=8)
        calls = {"parent": lambda: old1.fused_bottleneck(x, *params),
                 "this": lambda: b1.fused_bottleneck(x, *params,
                                                     weights=wts)}
        ms = in_turns(calls, 10)
        for who, v in ms.items():
            turns[who] += count * sum(v) / len(v)
        log("parent-b1-time", stage=name, batch=8, blocks=count,
            ms_in_turns=ms)
        log("parent-b1-split", stage=name, batch=8,
            launches_and_ms=block_split(calls["parent"]))
        del x, params, wts, new, old
    log("parent-b1-time-total", batch=8, blocks=12, parent_ms=turns["parent"],
        this_ms=turns["this"])
    x, params = proj_inputs(8, gen, device)
    wts = b1.prepare_proj_weights(*params[::3])
    calls = {"parent": lambda: old1.fused_bottleneck_proj(x, *params),
             "this": lambda: b1.fused_bottleneck_proj(x, *params,
                                                      weights=wts)}
    new, old = calls["this"](), calls["parent"]()
    torch.cuda.synchronize()
    within_b1_bound("parent-b5", new, old, shape=list(x.shape))
    ms = in_turns(calls, 10)
    log("parent-b5-time", batch=8, ms_in_turns=ms,
        parent_split=block_split(calls["parent"],
                                 "b5_fused_bottleneck_proj"))
    del x, params, wts, new, old


def parent_b6(device, gen, int8_shapes):
    """B6 at every int8 conv shape against the parent's: end to end, and
    bitwise with the parent's kernels given this tree's s_x and prepared
    weights; each conv with prepared weights timed in turns (device ms,
    queued), summed over the forward's convs.  Also logs whether
    PyTorch's CUDA division by a Python scalar equals the true quotient
    (how an earlier tree divided s_x and s_w)."""
    old6 = parent_module("int8_conv")
    t = torch.rand(1 << 20, generator=gen).to(device) * 100
    log("parent-scalar-division",
        differs_share=(t / 127.0 != t / torch.full_like(t, 127.0))
        .float().mean().item())
    ends, turns = 0, {"parent": [0.0, 0.0], "this": [0.0, 0.0]}
    for key in sorted(int8_shapes):
        x, kernel = int8_case(key, gen, device)
        s = key[-1]
        wts = b6.prepare_weights(kernel)
        ms = in_turns({"parent": lambda: old6.int8_conv(x, kernel, s,
                                                        weights=wts),
                       "this": lambda: b6.int8_conv(x, kernel, s,
                                                    weights=wts)},
                      10, queued=True)
        for who, (a, b) in ms.items():
            turns[who][0] += int8_shapes[key] * a
            turns[who][1] += int8_shapes[key] * b
        new = b6.int8_conv(x, kernel, s, weights=wts)
        old = old6.int8_conv(x, kernel, s)
        s_new = b6.quantize_activations(x)
        s_old = old6.quantize_activations(x)
        real = old6.quantize_activations
        old6.quantize_activations = lambda _: s_new
        try:
            same_inputs = old6.int8_conv(x, kernel, s, weights=wts)
        finally:
            old6.quantize_activations = real
        torch.cuda.synchronize()
        end = bool(torch.equal(new, old))
        ends += end
        log("parent-b6", shape=list(key[:4]), F=key[4], k=key[5], stride=s,
            bitwise_end_to_end=end,
            s_x_equal=bool(torch.equal(s_new, s_old)),
            s_w_equal=bool(torch.equal(wts.s_w,
                                       old6.quantize_weights(kernel)[1])),
            bitwise_given_s_x_and_weights=bool(torch.equal(new,
                                                           same_inputs)))
        if not torch.equal(new, same_inputs):
            raise AssertionError(f"B6 differs from the parent's kernels at "
                                 f"{key}")
        del x, kernel, wts, new, old, same_inputs
    log("parent-b6-total", shapes=len(int8_shapes), bitwise_end_to_end=ends,
        device_ms_per_forward_in_turns=turns)


def in_turns(calls, iters, queued=False):
    """ms per call of each of ``calls`` {"parent": fn, "this": fn}, timed
    parent, this, this, parent (``queued``: device ms, see
    ``cuda_time_ms``)."""
    ms = {}
    for who in ("parent", "this", "this", "parent"):
        ms.setdefault(who, []).append(cuda_time_ms(calls[who], iters,
                                                   queued=queued))
    return ms


def parent_b4(device, gen):
    """B4 at B4_TIMED (bf16, with and without the activation) against the
    parent's: both within B4_REL of the plain version, timed in turns."""
    old4 = parent_module("groupnorm")
    for name, batch, h, w, c, act in B4_TIMED:
        x = torch.randn(batch, h, w, c, generator=gen).to(
            torch.bfloat16).to(device)
        gamma, beta = (p.to(device) for p in gn_affine(c, gen))
        groups = resolve_groups(c)
        for a in (None, act):
            with torch.no_grad():
                calls = {"parent": lambda: old4.fused_group_norm_act(
                             x, gamma, beta, groups, 1e-5, a),
                         "this": lambda: b4.fused_group_norm_act(
                             x, gamma, beta, groups, 1e-5, a)}
                ref = b4.fused_group_norm_act_plain(x, gamma, beta, groups,
                                                    1e-5, a).float()
                errs = {who: (f().float() - ref).abs() for who, f in
                        calls.items()}
                bound = B4_REL[torch.bfloat16] * ref.abs().clamp(min=1.0)
                over = {who: int((e > bound).sum().item())
                        for who, e in errs.items()}
                ms = in_turns(calls, 20 if batch == 8 else 5)
            log("parent-b4", at=name, shape=[batch, h, w, c], activation=a,
                path=b4.kernel_path(batch, h * w, c, groups, x.dtype),
                max_abs_err={k: e.max().item() for k, e in errs.items()},
                over_bound=over, ms_in_turns=ms)
            if any(over.values()):
                raise AssertionError(f"B4 or the parent's is outside B4's "
                                     f"bound at {name}, batch {batch}")
            del errs, ref
        del x
    torch.cuda.empty_cache()


def parent_b2(device, gen):
    """B2 at the serving shapes against the parent's: equal keep masks,
    timed in turns, per call and in device time."""
    old2 = parent_module("nms")
    for shape in ((8, 1000), (128, 1000)):
        boxes = clustered_boxes(*shape, gen).to(device)
        calls = {"parent": lambda: old2.nms_keep_mask_batch(boxes, 0.5),
                 "this": lambda: b2.nms_keep_mask_batch(boxes, 0.5)}
        equal = bool(torch.equal(calls["parent"](), calls["this"]()))
        log("parent-b2", shape=[*shape, 4], equal=equal,
            ms_in_turns=in_turns(calls, 20),
            device_ms_in_turns=in_turns(calls, 20, queued=True),
            launches_and_device_ms={who: kernel_launches(f)
                                    for who, f in calls.items()})
        if not equal:
            raise AssertionError(f"B2 differs from the parent's at {shape}")


def parent_b7(device, gen):
    """B7 at the stem's shape, batch 8 and 128, against the parent's:
    both bitwise equal to the plain version, timed in turns, per call and
    in device time."""
    old7 = parent_module("stem")
    for batch in (8, 128):
        y, scale, shift = stem_case((batch, *STEM), gen, device)
        calls = {"parent": lambda: old7.gn_relu_maxpool(y, scale, shift),
                 "this": lambda: b7.gn_relu_maxpool(y, scale, shift)}
        ref = b7.gn_relu_maxpool_plain(y, scale, shift)
        equal = {who: bool(torch.equal(f(), ref)) for who, f in calls.items()}
        del ref
        iters = 20 if batch == 8 else 5
        log("parent-b7", shape=[batch, *STEM], bitwise_plain=equal,
            ms_in_turns=in_turns(calls, iters),
            device_ms_in_turns=in_turns(calls, iters, queued=True))
        if not all(equal.values()):
            raise AssertionError(f"B7 or the parent's differs from the plain "
                                 f"version at batch {batch}")
        del y, scale, shift
        torch.cuda.empty_cache()


# The parent comparisons, each run when its module is in PARENT_DIR.
PARENT_CHECKS = {"bottleneck": parent_b1_b5, "groupnorm": parent_b4,
                 "nms": parent_b2, "stem": parent_b7}


def check_parent(device, int8_shapes):
    """This tree's kernels against the parent commit's, built from the
    sources in PARENT_DIR: B1 and B5 (``bottleneck.py``), B2 (``nms.py``),
    B4 (``groupnorm.py``), B6 (``int8_conv.py``) and B7 (``stem.py``),
    each where its module is there."""
    gen = torch.Generator().manual_seed(12)
    ran = []
    for name, check in PARENT_CHECKS.items():
        if (PARENT_DIR / f"{name}.py").exists():
            check(device, gen)
            ran.append(name)
    if (PARENT_DIR / "int8_conv.py").exists():
        parent_b6(device, gen, int8_shapes)
        ran.append("int8_conv")
    if not ran:
        raise AssertionError(f"no parent module in {PARENT_DIR}")
    log("parent", compared=ran)


def eval_counters():
    """Each kernel's wrapper, whose ``launches`` it counts, by key."""
    return {"b1": b1.fused_bottleneck, "b2": b2.nms_keep_mask_batch,
            "b3": b3.fused_bottleneck_bwd, "b4": b4.fused_group_norm_act,
            "b5": b1.fused_bottleneck_proj, "b6": b6.int8_conv,
            "b7": b7.gn_relu_maxpool}


@contextlib.contextmanager
def eval_timers():
    """Host seconds per call, patched in around one ``evaluate.main``:
    ``prepare`` (``select_canvas`` and ``process_sample``, which
    ``evaluate_model`` looks up at each call), ``detect`` (``Detector.detect``:
    the copy to the card, forward, decode, NMS and the copy back, which
    waits for the card), ``evaluator`` (``COCOEvaluator.add``) and ``loop``
    (``evaluate_model``); ``shapes`` and ``images`` the batches given to
    ``detect`` and ``detect_end`` the host clock as each call returned."""
    spent = {"prepare": [], "detect": [], "evaluator": [], "loop": [],
             "shapes": [], "images": [], "detect_end": []}
    saved = (pipeline.select_canvas, pipeline.process_sample,
             Detector.detect, COCOEvaluator.add, evaluate.evaluate_model)

    def timed(fn, key):
        def call(*args, **kw):
            if key == "detect":
                spent["shapes"].append(tuple(args[1].shape))
                spent["images"].append(args[1])
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                end = time.perf_counter()
                spent[key].append(end - t)
                if key == "detect":
                    spent["detect_end"].append(end)
        return call

    pipeline.select_canvas = timed(saved[0], "prepare")
    pipeline.process_sample = timed(saved[1], "prepare")
    Detector.detect = timed(saved[2], "detect")
    COCOEvaluator.add = timed(saved[3], "evaluator")
    evaluate.evaluate_model = timed(saved[4], "loop")
    try:
        yield spent
    finally:
        (pipeline.select_canvas, pipeline.process_sample, Detector.detect,
         COCOEvaluator.add, evaluate.evaluate_model) = saved


def run_eval(label, argv, expected, batches):
    """``evaluate.main(argv)`` in-process with every launch count set to 0
    just before and read just after; each kernel must have launched
    ``expected`` times per batch (absent: 0).  Logs the printed metrics,
    images/s over the loop and its split per batch: host preparation,
    the ``Detector`` call, the evaluator, and the rest (the loader's
    samples, stacking)."""
    counters = eval_counters()
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    with eval_timers() as spent, contextlib.redirect_stdout(out):
        metrics = evaluate.main(list(argv))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    printed = out.getvalue().strip().splitlines()
    if len(printed) != 1 or \
            json.loads(printed[0]) != evaluate.strict_json(metrics):
        raise AssertionError(f"{label}: evaluate printed {printed}, not one "
                             f"strict-JSON line of its metrics")
    per_batch = {k: n / batches for k, n in launches.items()}
    images = sum(shape[0] for shape in spent["shapes"])
    loop, detect = sum(spent["loop"]), spent["detect"]
    prepare, evaluator = sum(spent["prepare"]), sum(spent["evaluator"])
    steady = sorted(detect[1:]) or detect
    # Between the first and the last Detector call's return, the loop did
    # every later batch once: its preparation, its Detector call and the
    # evaluator on the batch before (the first batch carries the warm-up).
    ends = spent["detect_end"]
    log("eval", path=label, metrics=json.loads(printed[0]),
        launches_per_batch=per_batch, batches=len(detect),
        batch_shapes=sorted(set(spent["shapes"])),
        images_per_sec=images / loop, loop_s=loop,
        images_per_sec_after_first_batch=(
            (images - spent["shapes"][0][0]) / (ends[-1] - ends[0])
            if len(ends) > 1 else None),
        prepare_ms_per_batch=prepare / len(detect) * 1e3,
        detect_ms_per_batch=sum(detect) / len(detect) * 1e3,
        detect_ms_first=detect[0] * 1e3,
        detect_ms_steady_median=steady[len(steady) // 2] * 1e3,
        evaluator_ms_per_batch=evaluator / len(detect) * 1e3,
        other_ms_per_batch=(loop - prepare - sum(detect) - evaluator)
        / len(detect) * 1e3)
    want = {k: expected.get(k, 0) for k in counters}
    if len(detect) != batches or per_batch != want:
        raise AssertionError(f"{label}: expected {want} launches per batch "
                             f"over {batches} batches, got {launches} over "
                             f"{len(detect)}")
    if not metrics["AR@100"] > 0:
        raise AssertionError(f"{label}: no detection matched a shape: "
                             f"{metrics}")
    return metrics, per_batch, spent


def check_detect(device, artifact, root):
    """``retinanet_tpu_torch.detect.main`` on three shapes images written
    as PNG files (two 640×640, one 800×600 that the pipeline shrinks) at
    batch 2 with score threshold 0.005: 1 B2 launch per batch and no other
    kernel, detections for each image in the JSON dump, one annotated PNG
    per image.  Reading and writing the files takes cv2 or PIL, which the
    card's machine has."""
    from retinanet_tpu_torch.data.loaders.shapes import Shapes

    paths = []
    for i, (size, seed) in enumerate((((SIZE, SIZE), 1), ((SIZE, SIZE), 2),
                                      ((800, 600), 3))):
        image = next(iter(Shapes(None, 1, size, seed=seed)))["image"]
        paths.append(str(root / f"detect{i}.png"))
        if pipeline.cv2 is not None:
            pipeline.cv2.imwrite(paths[-1], image[..., ::-1])
        else:
            pipeline.Image.fromarray(image).save(paths[-1])
    counters = eval_counters()
    for fn in counters.values():
        fn.launches = 0
    dump, out = str(root / "detect.json"), root / "detect_out"
    # detect logs every detection; the dump holds them.
    quiet = logging.getLogger(detect.__name__)
    level = quiet.level
    quiet.setLevel(logging.WARNING)
    try:
        records = detect.main([*paths, "--from-export", artifact, "--device",
                               str(device), "--batch-size", "2",
                               "--score-threshold", "0.005", "--dump-json",
                               dump, "--out", str(out)])
    finally:
        quiet.setLevel(level)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    per_image = [sum(r["image"] == p for r in records) for p in paths]
    with open(dump) as f:
        dumped = json.load(f)
    written = sorted(q.name for q in out.glob("detect*.det.png"))
    log("eval-detect", images=len(paths), batches=2, launches=launches,
        detections_per_image=per_image, annotated=written)
    if launches != {k: 2 if k == "b2" else 0 for k in counters}:
        raise AssertionError(f"detect: expected 1 B2 launch per batch and "
                             f"no other kernel, got {launches}")
    if dumped != records or min(per_image) == 0 or len(written) != 3 or \
            not all(math.isfinite(v) for r in records for v in r["box_tlbr"]):
        raise AssertionError(f"detect: {per_image} detections per image, "
                             f"{written} written")


def check_eval(device):
    """The evaluation path (``python -m retinanet_tpu_torch.evaluate
    --from-export``) on the card: each of EVAL_PATHS over the whole set,
    one batch through the rectangular bucket 640×448 on the kernel path,
    the kernel path's metrics held to the plain path's, and the kernel
    path's loop under ``torch.profiler`` (device busy and idle share)."""
    root = Path(__file__).resolve().parent / "build" / "eval_smoke"
    root.mkdir(parents=True, exist_ok=True)
    config = Config()
    config = config.replace(model=dataclasses.replace(
        config.model, backbone="resnet_50_dense", num_classes=3))
    names = ["square", "triangle", "circle"]
    artifact = str(root / "model.npz")
    export_model(init_params(config, torch.Generator().manual_seed(0), 3),
                 names, "resnet_50_dense", SIZE, artifact)
    dataset = ["shapes", str(root / "shapes"), str(EVAL_IMAGES), str(SIZE)]
    base = ("--dataset", *dataset, "--from-export", artifact,
            "--batch-size", str(EVAL_BATCH), "--decode-threshold", "0.005",
            "--device", str(device))
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    metrics, launches = {}, {}
    for path, (flags, expected) in EVAL_PATHS.items():
        metrics[path], launches[path], spent = run_eval(
            path, base + flags, expected, batches)
        if path == "kernels":
            served = spent["images"]
        torch.cuda.empty_cache()
    flags, expected = EVAL_PATHS["kernels"]
    _, _, spent = run_eval(
        f"kernels, bucket {BUCKET[0]}x{BUCKET[1]}",
        base + flags + ("--buckets", f"{BUCKET[0]}x{BUCKET[1]}",
                        "--max-images", str(EVAL_BATCH)), expected, 1)
    if spent["shapes"] != [(EVAL_BATCH, *BUCKET, 3)]:
        raise AssertionError(f"bucket batch shapes {spent['shapes']}")

    # The kernel path's heads on every batch it served, the bucket's
    # included, against the float32 plain path's: no farther than the bf16
    # plain path's (TRAIN_TRUTH_FACTOR/SLACK, the repo's "at least as
    # accurate" bound), at every level.  At these weights the metrics
    # cannot tell a wrong kernel from a right one, the heads can.  Elements
    # outside the JAX fused-vs-unfused bound against the bf16 plain path
    # are logged beside.
    def serving_config(extra):
        return evaluate.build_config(
            evaluate.build_parser().parse_args(list(base + extra)))

    serving = serving_config(flags)
    detector = load_exported_detector(artifact, serving, device)
    plain_config = serving_config(())
    plain = load_exported_detector(artifact, plain_config, device)
    f32 = load_exported_detector(artifact, plain_config.replace(
        model=dataclasses.replace(plain_config.model,
                                  compute_dtype="float32")), device)

    def less_accurate(got, want, truth):
        """Each head level's rel. L2 distance to ``truth`` of ``got`` and
        ``want``, and the levels where ``got`` is the farther."""
        levels, worse = {}, []
        for head in ("classifications", "regressions"):
            for pn in ("P3", "P4", "P5", "P6", "P7"):
                t = truth[head][pn].float()
                err = [((v[head][pn].float() - t).norm() / t.norm()).item()
                       for v in (got, want)]
                levels[f"{head[0]}{pn}"] = err
                if err[0] > TRAIN_TRUTH_FACTOR * err[1] + TRAIN_TRUTH_SLACK:
                    worse.append(f"{head}/{pn}")
        return levels, worse

    worse = []
    with torch.inference_mode():
        for i, images in enumerate(served + spent["images"]):
            x = torch.as_tensor(images).to(device)
            got, want, truth = (d.model(x) for d in (detector, plain, f32))
            share, outside = compare_heads(f"eval-batch-{i}", got, want,
                                           check=False, log_levels=False)
            levels, farther = less_accurate(got, want, truth)
            worse += [f"batch {i} {level}" for level in farther]
            log("eval-heads", batch=i, shape=list(x.shape),
                rel_l2_to_float32_kernels_plain=levels,
                vs_plain_bitwise_equal_share=share,
                vs_plain_outside_jax_bound=outside)
        # The same check on the first batch with each EVAL_FAULTS planted.
        x = torch.as_tensor(served[0]).to(device)
        want, truth = plain.model(x), f32.model(x)
        real, missed = resnet.fused_bottleneck, []
        for fault, plant in EVAL_FAULTS.items():
            def faulty(*args, _plant=plant, **kwargs):
                return _plant(real(*args, **kwargs))
            resnet.fused_bottleneck = faulty
            try:
                got = detector.model(x)
            finally:
                resnet.fused_bottleneck = real
            farther = less_accurate(got, want, truth)[1]
            log("eval-heads-fault", fault=fault, levels_farther=farther)
            if not farther:
                missed.append(fault)
    if worse:
        raise AssertionError(f"the eval kernel path's heads are less "
                             f"accurate than the plain path's at {worse}")
    if missed:
        raise AssertionError(f"the eval heads check missed the planted "
                             f"B1 faults {missed}")
    del plain, f32, served, got, want, truth

    for path in ("kernels", "int8"):
        gaps = {k: abs(v - metrics["plain"][k])
                for k, v in metrics[path].items()
                if isinstance(v, float) and not math.isnan(v)}
        within = max(gaps.values()) <= EVAL_METRIC_BOUND
        log("eval-vs-plain", path=path, gaps=gaps, largest=max(gaps.values()),
            bound=EVAL_METRIC_BOUND if path == "kernels" else None,
            within=within if path == "kernels" else None)
        if path == "kernels" and not within:
            raise AssertionError(f"kernel path metrics {metrics[path]} "
                                 f"differ from the plain path's "
                                 f"{metrics['plain']} by more than "
                                 f"{EVAL_METRIC_BOUND}")

    check_detect(device, artifact, root)

    loader = Inferred("shapes", [str(root / "shapes"),
                                 str(EVAL_BREAKDOWN_IMAGES), str(SIZE)],
                      include_crowds=True)
    log("eval-breakdown", path="kernels", images=EVAL_BREAKDOWN_IMAGES,
        batch=EVAL_BATCH, **device_breakdown(
            lambda: evaluate_model(detector, loader, serving)))
    del detector
    torch.cuda.empty_cache()
    return launches


def fit_argv(path, root, device, seed=FIT_SEED, profile=0):
    """The training CLI's flags of one invocation of a fit path: the
    setup of the FIT_* constants, FIT_STEPS // 2 steps."""
    return ["--dataset", "shapes", str(root / "shapes"), str(FIT_IMAGES),
            str(FIT_SIZE), "--experiment", str(root / f"{path}_seed{seed}"),
            "--backbone", "resnet_50_dense", "--scale", str(FIT_SIZE),
            "--batch-size", str(FIT_BATCH), "--optimizer", "momentum",
            "--learning-rate", "1e-2", "--dropout", "0", "--class-loss",
            "bce", "dice", "--seed", str(seed), "--log-every",
            str(FIT_LOG_EVERY), "--epochs",
            str(FIT_STEPS // 2 // FIT_EPOCH_STEPS), "--steps-per-epoch",
            str(FIT_EPOCH_STEPS), "--device", str(device),
            *FIT_PATHS[path], *(("--profile", str(profile)) if profile
                                else ())]


class LogCapture(logging.Handler):
    """The messages of one logger at INFO, while in a ``with`` block."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.logger, self.messages = logging.getLogger(name), []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def run_fit(argv):
    """What ``train.main(argv)`` does (``parse_args``, then
    ``Trainer(config, device).fit()``), with FIT_CHECKPOINT_EVERY and
    FIT_KEEP, for which the CLI has no flag (nor has the JAX package's).
    Every launch count is set to 0 just before and read just after: the
    Trainer's construction and ``fit``, which runs the training steps and
    writes checkpoints, metrics and the profile, and nothing else."""
    config, device = train.parse_args(argv)
    config = config.replace(train=dataclasses.replace(
        config.train, checkpoint_every=FIT_CHECKPOINT_EVERY,
        keep_checkpoints=FIT_KEEP))
    counters = eval_counters()
    for fn in counters.values():
        fn.launches = 0
    t = time.monotonic()
    with LogCapture(train.__name__) as messages:
        state = train.Trainer(config, device=device).fit()
    torch.cuda.synchronize()
    return (state, {k: fn.launches for k, fn in counters.items()},
            messages, time.monotonic() - t)


def fit_path_runs(path, root, device, seed, queue):
    """A spawned process's work: both invocations of one fit path in a
    fresh experiment, FIT_STEPS // 2 steps from seeded weights, then as
    many again resuming from the first's last checkpoint (``run_fit``).
    Puts (path, seed, [(step, launches, log messages, seconds)], None) in
    ``queue``, or (path, seed, None, the traceback)."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(root / f"{path}_seed{seed}", ignore_errors=True)
        runs = []
        for profile in (FIT_PROFILE if path == "kernels" else 0, 0):
            state, launches, messages, seconds = run_fit(
                fit_argv(path, root, device, seed, profile))
            runs.append((int(state.step), launches, messages, seconds))
            del state
            torch.cuda.empty_cache()
    except BaseException:
        import traceback
        queue.put((path, seed, None, traceback.format_exc()))
        raise
    queue.put((path, seed, runs, None))


def train_fit_paths(root, device,
                    jobs=tuple((path, FIT_SEED) for path in FIT_PATHS)):
    """The fit paths of ``jobs`` ((path, seed) pairs) at once, each in a
    spawned process of its own: a step keeps the card busy a fraction of
    its time (the host launches ~8000 kernels), so two or three processes
    on one card take little longer than one.  Each process sets and reads
    its own launch counts.  Returns each job's failed gates and logged
    values (``fit_gates``)."""
    import multiprocessing
    import queue as queues

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=fit_path_runs,
                         args=(path, root, str(device), seed, results))
             for path, seed in jobs]
    for proc in procs:
        proc.start()
    runs, errors = {}, {}
    try:
        for _ in procs:
            path, seed, got, error = results.get(
                timeout=FIT_PROCESS_TIMEOUT)
            if error is not None:
                errors[path, seed] = error
            runs[path, seed] = got
    except queues.Empty:
        errors["timeout"] = f"no result within {FIT_PROCESS_TIMEOUT} s"
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    if errors:
        raise AssertionError(f"fit processes failed: {errors}")
    return {job: fit_gates(*job, root, runs[job]) for job in jobs}


def fit_gates(path, seed, root, runs):
    """The gates of one fit path's runs: the step counts, the restore, the
    checkpoints kept, the launches, finite losses, the data loss's fall
    to below FIT_LOSS_FALL of step 1's and the total loss's fall, the
    profile trace.  Returns the failed gates (empty when all held)
    and the logged values."""
    experiment = root / f"{path}_seed{seed}"
    half = FIT_STEPS // 2
    with open(experiment / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    kept = train.CheckpointStore(str(experiment)).checkpoint_steps()
    traces = sorted(p.name for p in (experiment / "profile").glob("*.json"))
    # The data loss: total_loss less the L2 term (~2.7 at these weights,
    # which the weight decay hardly moves in these steps).
    losses = {r["step"]: r["class_loss"] + r["regr_loss"] for r in records}
    last = [losses[r["step"]] for r in records[-5:]]
    rates = {r["step"]: r["images_per_sec"] for r in records}
    steady = sorted(v for s, v in rates.items()
                    if s not in (1, half + FIT_LOG_EVERY))
    launches = [{k: n for k, n in run[1].items() if n} for run in runs]
    fields = dict(
        path=path, seed=seed, steps=[run[0] for run in runs],
        seconds=[run[3] for run in runs],
        ms_per_step=[run[3] / half * 1e3 for run in runs],
        launches=launches, checkpoints_kept=kept, profile_traces=traces,
        restored=[m for m in runs[1][2] if m.startswith("restored")],
        total_loss_step_1=records[0]["total_loss"],
        total_loss_last_5_mean=sum(r["total_loss"] for r in records[-5:]) / 5,
        data_loss_step_1=losses.get(1),
        data_loss_last_5_mean=sum(last) / len(last),
        logged_steps=len(records),
        images_per_sec_median=steady[len(steady) // 2],
        images_per_sec=rates)
    log("fit", **fields)
    failed = []
    if fields["steps"] != [half, FIT_STEPS]:
        failed.append(f"steps {fields['steps']}")
    if fields["restored"] != [f"restored checkpoint from step {half}"]:
        failed.append(f"restore log {fields['restored']}")
    if len(kept) > FIT_KEEP or kept[-1:] != [FIT_STEPS]:
        failed.append(f"checkpoints kept {kept}")
    per_run = {"b1": 12 * half, "b3": 12 * half} if path == "kernels" \
        else {}
    if launches != [per_run, per_run]:
        failed.append(f"launches {launches}, expected {per_run} a run")
    if not all(math.isfinite(r[k]) for r in records
               for k in TRAIN_KEYS):
        failed.append("a non-finite logged loss")
    if not fields["data_loss_last_5_mean"] < FIT_LOSS_FALL * losses[1]:
        failed.append(f"data loss {losses[1]} → "
                      f"{fields['data_loss_last_5_mean']}")
    if not fields["total_loss_last_5_mean"] < fields["total_loss_step_1"]:
        failed.append(f"total loss {fields['total_loss_step_1']} → "
                      f"{fields['total_loss_last_5_mean']}")
    if path == "kernels" and len(traces) != 1:
        failed.append(f"profile traces {traces}")
    return failed, fields


def fit_serving_config(path, quantize=False, *flags):
    """The ``evaluate`` CLI's config serving a fit path's model (its
    FIT_SERVE flags), with ``flags`` added."""
    argv = ["--dataset", "shapes", "unused", str(FIT_EVAL_IMAGES),
            str(FIT_SIZE), "--backbone", "resnet_50_dense", "--scale",
            str(FIT_SIZE), "--batch-size", str(FIT_BATCH), *FIT_SERVE[path],
            *(("--quantize", "int8") if quantize else ()), *flags]
    return evaluate.build_config(evaluate.build_parser().parse_args(argv))


def fit_serving(path, experiment, device, quantize=False, average=1):
    """``evaluate.load_detector`` on the mean of the newest ``average``
    checkpoints (1: the FIT_STEPS checkpoint), with the serving flags of
    the path that trained it, and its config."""
    flags = (("--average-checkpoints", str(average)) if average > 1
             else ("--step", str(FIT_STEPS)))
    config = fit_serving_config(path, quantize, "--experiment",
                                str(experiment), *flags)
    step = None if average > 1 else FIT_STEPS
    return evaluate.load_detector(config, fit_eval_loader(), step,
                                  average_last=average, device=device), config


def fit_eval_loader(images=FIT_EVAL_IMAGES):
    from retinanet_tpu_torch.data.loaders.shapes import Shapes
    return Shapes(None, images, (FIT_SIZE, FIT_SIZE), seed=FIT_EVAL_SEED)


def fit_map(label, detector, config, images=FIT_EVAL_IMAGES):
    """``evaluate_model`` on the first ``images`` held-out images,
    counted: the metrics and the launches per batch."""
    counters = eval_counters()
    for fn in counters.values():
        fn.launches = 0
    t = time.monotonic()
    metrics = evaluate_model(detector, fit_eval_loader(images), config)
    torch.cuda.synchronize()
    batches = -(-images // FIT_BATCH)
    per_batch = {k: fn.launches / batches for k, fn in counters.items()
                 if fn.launches}
    log("fit-map", path=label, images=images,
        metrics=evaluate.strict_json(metrics),
        launches_per_batch=per_batch, seconds=time.monotonic() - t)
    return metrics, per_batch


def fit_maps(root, device, seed=FIT_SEED, paths=tuple(FIT_PATHS)):
    """Each path's FIT_STEPS checkpoint on the held-out set, served on its
    own path, and on FIT_WIDE_EVAL_IMAGES held-out images (keyed
    "<path>@wide"); for the kernel path also with every GroupNorm on B4
    and with int8 convs."""
    maps = {}
    for path in paths:
        experiment = root / f"{path}_seed{seed}"
        detector, config = fit_serving(path, experiment, device)
        maps[path] = fit_map(path, detector, config)
        maps[f"{path}@wide"] = fit_map(f"{path}@wide", detector, config,
                                       FIT_WIDE_EVAL_IMAGES)
        if path == "kernels":
            use_group_norm_kernel(detector.model, True)
            maps["kernels+b4"] = fit_map("kernels+b4", detector, config)
            del detector
            detector, config = fit_serving(path, experiment, device,
                                           quantize=True)
            maps["int8"] = fit_map("int8", detector, config)
        del detector
        torch.cuda.empty_cache()
    return maps


def fit_surfaces(root, device):
    """The serving surfaces on the kernel path's trained experiment:
    ``evaluate --experiment`` over the first 64 training images,
    ``export --experiment`` then ``evaluate --from-export`` on the file
    (the same metrics), ``detect --experiment --step`` on two PNG files (1
    B2 launch a batch), and ``write_image_summaries`` at the last step."""
    from retinanet_tpu_torch import export
    from retinanet_tpu_torch.data.loaders.shapes import Shapes

    experiment = str(root / f"kernels_seed{FIT_SEED}")
    dataset = ["shapes", str(root / "shapes"), str(FIT_SURFACE_IMAGES),
               str(FIT_SIZE)]
    serving = ("--backbone", "resnet_50_dense", "--scale", str(FIT_SIZE))
    base = ("--dataset", *dataset, "--batch-size", str(FIT_BATCH),
            "--device", str(device), *FIT_SERVE["kernels"])
    batches = FIT_SURFACE_IMAGES // FIT_BATCH
    expected = EVAL_PATHS["kernels"][1]
    from_experiment, _, _ = run_eval(
        "fit-experiment", base + ("--experiment", experiment) + serving,
        expected, batches)
    artifact = str(root / "kernels.npz")
    export.main(["--experiment", experiment, *serving, "--dataset",
                 *dataset, "--out", artifact, "--device", str(device)])
    from_export, _, _ = run_eval(
        "fit-export", base + ("--from-export", artifact), expected, batches)
    equal = (evaluate.strict_json(from_export)
             == evaluate.strict_json(from_experiment))  # nan as None
    log("fit-export", equal=equal)
    if not equal:
        raise AssertionError(f"--from-export {from_export} differs from "
                             f"--experiment {from_experiment}")

    paths = []
    for seed in (1, 2):
        image = next(iter(Shapes(None, 1, (FIT_SIZE, FIT_SIZE),
                                 seed=seed)))["image"]
        paths.append(str(root / f"detect{seed}.png"))
        pipeline.cv2.imwrite(paths[-1], image[..., ::-1])
    counters = eval_counters()
    for fn in counters.values():
        fn.launches = 0
    quiet = logging.getLogger(detect.__name__)  # the records hold them
    level = quiet.level
    quiet.setLevel(logging.WARNING)
    try:
        records = detect.main([*paths, "--experiment", experiment,
                               "--step", str(FIT_STEPS), *serving,
                               "--dataset", *dataset, "--batch-size", "2",
                               "--score-threshold", "0.05", "--device",
                               str(device)])
    finally:
        quiet.setLevel(level)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    per_image = [sum(r["image"] == p for r in records) for p in paths]
    log("fit-detect", launches=launches, detections_per_image=per_image,
        classes=sorted({r["class"] for r in records}))
    if launches != {"b2": 1} or min(per_image) == 0:
        raise AssertionError(f"detect --experiment: {launches} launches, "
                             f"{per_image} detections per image")

    config, _ = train.parse_args(fit_argv("kernels", root, device))
    trainer = train.Trainer(config, device=device)
    state = trainer.restore_checkpoint(create_train_state(
        trainer.model, config, trainer.model.state_dict()))
    with contextlib.closing(trainer.pipeline.prefetched(0)) as stream:
        batch = next(stream)
    trainer.write_image_summaries(state, batch)
    out = Path(experiment) / "summaries" / f"step_{state.step}"
    want = {f"{i}_{kind}.png" for i in (0, 1) for kind in ("true", "pred")}
    want |= {f"{i}_classmap_{pn}_{kind}.png" for i in (0, 1)
             for pn in ("P3", "P4", "P5", "P6", "P7")
             for kind in ("true", "pred")}
    written = {p.name for p in out.glob("*.png")}
    log("fit-summaries", step=state.step, written=len(written),
        missing=sorted(want - written))
    if state.step != FIT_STEPS or written != want:
        raise AssertionError(f"image summaries at step {state.step}: "
                             f"missing {sorted(want - written)}")


def free_port() -> int:
    """A TCP port on the loopback that no one holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_batches(device):
    """DIST_STEPS global batches of DIST_BATCH images at SIZE px from a
    seeded generator: normal images, three boxes of random classes each
    (sides 0.35-0.7 of the canvas), 100 box slots."""
    gen = torch.Generator().manual_seed(11)
    batches = []
    for _ in range(DIST_STEPS):
        b = DIST_BATCH
        images = torch.randn(b, SIZE, SIZE, 3, generator=gen)
        corner = torch.rand(b, 3, 2, generator=gen) * 0.3
        boxes = torch.zeros(b, 100, 4)
        boxes[:, :3] = torch.cat(
            [corner, corner + 0.35 + torch.rand(b, 3, 2, generator=gen)
             * 0.35], -1)
        ids = torch.zeros(b, 100, dtype=torch.int32)
        ids[:, :3] = torch.randint(0, 80, (b, 3), generator=gen,
                                   dtype=torch.int32)
        mask = torch.zeros(b, 100, dtype=torch.bool)
        mask[:, :3] = True
        batches.append(tuple(t.to(device)
                             for t in (images, boxes, ids, mask)))
    return batches


def group_norm_float64(x, gamma, beta, groups, eps=1e-5, activation=None):
    """``layers.group_norm`` with its statistics and affine in float64
    (the model's own takes fp32 statistics whatever the input dtype)."""
    n, c, h, w = x.shape
    xg = x.double().reshape(n, resolve_groups(c, groups), -1)
    mean = xg.mean(-1, keepdim=True)
    var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).view(n, c, h, w)
    y = y * gamma.double()[:, None, None] + beta.double()[:, None, None]
    return y if activation is None else get_activation(activation)(y)


@contextlib.contextmanager
def float64_model():
    """Every GroupNorm of a model built inside in float64."""
    real = layers.group_norm
    layers.group_norm = group_norm_float64
    try:
        yield
    finally:
        layers.group_norm = real


def dist_steps(config, batches, device, group):
    """``make_train_step(group=)`` of ``config`` from the seeded weights of
    ``check_training`` over ``batches``, each cut to this rank's slice
    when ``group`` is given.  Returns the parameters as one flat tensor,
    each step's TRAIN_KEYS scalars and ms (host clock between
    synchronisations), and the first step's gradient by parameter (from a
    zero momentum trace, the trace after one step)."""
    model = RetinaNet.from_config(config.model, 9, 80).to(device)
    if config.model.compute_dtype == "float64":
        model.double()
    state = create_train_state(model, config, init_params(
        config, torch.Generator().manual_seed(0), 80))
    step = make_train_step(model, build_levels(), config, with_metrics=False,
                           group=group)
    gen = torch.Generator().manual_seed(1)
    scalars, ms, first = [], [], None
    for batch in batches:
        if group is not None:
            start, size = distributed.process_batch_slice(batch[0].shape[0])
            batch = tuple(t[start:start + size] for t in batch)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        state, metrics = step(state, *batch, gen)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
        scalars.append({k: float(metrics[k]) for k in TRAIN_KEYS})
        if first is None:
            first = {n: t.clone() for n, t in
                     zip(state.params, state.opt_state["trace"])}
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in state.params.values()])
    return flat, scalars, ms, first


def bucket_ms(numel, device, group, reps=3):
    """ms of one all-reduce of a ``numel`` fp32 bucket on ``device`` over
    ``group`` (host clock between synchronisations), the best of
    ``reps``."""
    bucket = torch.ones(numel, device=device)
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        torch.distributed.all_reduce(bucket, group=group)
        torch.cuda.synchronize(device)
        best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def same_as_rank_0(flat, group) -> bool:
    """Whether this rank's ``flat`` equals rank 0's, bit for bit."""
    lead = flat.clone()
    torch.distributed.broadcast(lead, src=0, group=group)
    return torch.equal(lead, flat)


def step_gaps(got, want):
    """Largest relative gaps of total_loss and grad_norm over the steps."""
    return {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want))
            for k in ("total_loss", "grad_norm")}


def dist_eval_argv(root, artifact, device):
    dataset = ["shapes", str(root / "shapes"), str(EVAL_IMAGES), str(SIZE)]
    return ("--dataset", *dataset, "--from-export", artifact,
            "--batch-size", str(EVAL_BATCH), "--decode-threshold", "0.005",
            "--device", str(device), *EVAL_PATHS["kernels"][0])


def dist_fit_argv(root, device):
    """The training CLI at DIST_FIT_SIZE px on DIST_FIT_IMAGES shapes
    images, the kernel path, half of DIST_FIT_STEPS an invocation."""
    return ["--dataset", "shapes", str(root / "fit_shapes"),
            str(DIST_FIT_IMAGES), str(DIST_FIT_SIZE), "--experiment",
            str(root / "fit"), "--backbone", "resnet_50_dense", "--scale",
            str(DIST_FIT_SIZE), "--batch-size", str(DIST_BATCH), "--epochs",
            "1", "--steps-per-epoch", str(DIST_FIT_STEPS // 2),
            "--log-every", "1", "--dropout", "0", "--device", str(device),
            "--fused-train"]


def data_parallel_serving(device, artifact):
    """``Detector(devices=[device, device])`` from the export on a host
    batch of EVAL_BATCH images, each half copied from pinned host memory
    straight to its replica, against one device's detector on each half
    (the same shapes, so the same algorithms): whether every output is
    bitwise equal and in batch order, and the ms of each (host clock
    between synchronisations, the best of 3)."""
    one = Detector.from_export(artifact, device=device)
    two = Detector.from_export(artifact, device=device,
                               devices=[device, device])
    images = torch.randn(EVAL_BATCH, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(12))
    half = EVAL_BATCH // 2

    def timed(fn):
        best, out = math.inf, None
        for _ in range(3):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(device)
            best = min(best, (time.perf_counter() - t) * 1e3)
        return out, best

    got, two_ms = timed(lambda: two(images))
    want, one_ms = timed(lambda: [one(images[:half]), one(images[half:])])
    equal = all(torch.equal(g, torch.cat([w[i] for w in want]))
                for i, g in enumerate(got))
    return {"bitwise": equal, "two_replicas_ms": two_ms,
            "one_device_two_halves_ms": one_ms}


def distributed_rank(rank, device, ports, root, artifact, results):
    """One rank of the distributed phase, in a spawned process, joined as
    ``torchrun`` joins a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    the address in the environment) on the one card: every rank is given
    ``cuda:0``, so by ``backend_for`` they share it over gloo whatever the
    host's card count.  Puts (rank, its
    figures, None) in ``results``, or (rank, None, the traceback)."""
    import traceback

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.update(
            RANK=str(rank), WORLD_SIZE=str(DIST_WORLD), LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE=str(DIST_WORLD), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(ports[0]))
        root, device = Path(root), torch.device(device)
        with LogCapture(distributed.__name__) as joined:
            backend = distributed.initialize(device)
        group = distributed.group()
        out = {"backend": backend, "joined": joined}
        batches = dist_batches(device)

        # The plain path in fp32 against one process on the global batches.
        f32 = train_config(DIST_BATCH, fused=False)
        f32 = f32.replace(model=dataclasses.replace(
            f32.model, compute_dtype="float32"))
        flat, out["fp32_steps"], out["fp32_ms"], _ = dist_steps(
            f32, batches, device, group)
        out["fp32_same_as_rank_0"] = same_as_rank_0(flat, group)
        out["bucket_ms"] = bucket_ms(flat.numel(), device, group)

        # The kernel path in bf16: one counted step, then timed ones.
        config = train_config(DIST_BATCH)
        counters = eval_counters()
        for fn in counters.values():
            fn.launches = 0
        _, k_steps, out["kernel_ms"], got = dist_steps(
            config, [batches[i % DIST_STEPS]
                     for i in range(1 + DIST_TIMED_STEPS)], device, group)
        torch.cuda.synchronize()
        out["kernel_launches"] = {k: fn.launches for k, fn in
                                  counters.items()}
        out["kernel_steps"] = 1 + DIST_TIMED_STEPS
        # The planted fault, on every rank: the seam returns the local sum.
        real = losses.global_sum
        losses.global_sum = lambda x, group=None: x
        try:
            fault = dist_steps(config, batches[:1], device, group)
        finally:
            losses.global_sum = real
        fault = (fault[1][0], fault[3])
        got = (k_steps[0], got)

        if rank == 0:  # one process on the global batches, and the verdicts
            one_flat, one_steps, out["one_process_fp32_ms"], truth = \
                dist_steps(f32, batches, device, None)
            out["fp32_gaps"] = step_gaps(out["fp32_steps"], one_steps)
            out["fp32_param_max_abs"] = float((flat - one_flat).abs().max())
            # How far fp32 itself stands from the step in float64.
            with float64_model():
                f64_flat, f64_steps, _, _ = dist_steps(
                    f32.replace(model=dataclasses.replace(
                        f32.model, compute_dtype="float64")),
                    batches, device, None)
            out["fp32_vs_float64"] = {
                **step_gaps(one_steps, f64_steps),
                "param_max_abs": float((one_flat - f64_flat).abs().max())}
            del f64_flat
            _, plain_steps, _, plain = dist_steps(
                train_config(DIST_BATCH, fused=False), batches[:1], device,
                None)
            with torch.device("meta"):
                meta = RetinaNet.from_config(config.model, 9, 80)
            identity = [f"{m}.{p}" for m, mod in meta.named_modules()
                        if isinstance(mod, ResNetBottleneck)
                        and not mod.project
                        for p, _ in mod.named_parameters()]
            out["kernels_agree"] = compare_steps(
                f"distributed kernels, rank 0 of {DIST_WORLD}", got,
                (plain_steps[0], plain), (one_steps[0], truth), identity)
            out["fault_agrees"] = compare_steps(
                "distributed fault: local sums", fault,
                (plain_steps[0], plain), (one_steps[0], truth), identity)
            del truth, plain
        del got, fault, flat
        torch.cuda.empty_cache()
        distributed.barrier()

        # Trainer.fit as train.main runs it, then a resume.
        fits = []
        for _ in range(2):
            for fn in counters.values():
                fn.launches = 0
            t = time.monotonic()
            with LogCapture(train.__name__) as messages:
                state = train.main(dist_fit_argv(root, device))
            torch.cuda.synchronize()
            fits.append({"step": int(state.step),
                         "seconds": time.monotonic() - t,
                         "launches": {k: fn.launches
                                      for k, fn in counters.items()},
                         "restored": [m for m in messages
                                      if m.startswith("restored")]})
            del state
        out["fit"] = fits
        exp = root / "fit"
        out["fit_records"] = [json.loads(line)["step"] for line in
                              (exp / "metrics.jsonl").read_text().splitlines()]
        store = train.CheckpointStore(str(exp))
        out["fit_checkpoints"] = {
            step: sorted(os.listdir(exp / "checkpoints" / f"step_{step}"))
            for step in store.checkpoint_steps()}
        out["fit_tmp"] = [n for n in os.listdir(exp / "checkpoints")
                          if "tmp" in n]
        torch.cuda.empty_cache()

        # evaluate --from-export: this rank's shard, the whole set's metrics.
        metrics, per_batch, _ = run_eval(
            f"distributed kernels, rank {rank} of {DIST_WORLD}",
            dist_eval_argv(root, artifact, device),
            EVAL_PATHS["kernels"][1], EVAL_IMAGES // EVAL_BATCH // DIST_WORLD)
        out["eval"] = evaluate.strict_json(metrics)
        out["eval_launches_per_batch"] = per_batch
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        distributed.barrier()
        torch.distributed.destroy_process_group()

        if rank == 0:  # a one-rank NCCL group through the same step
            backend, reason = distributed.backend_for(device, 1)
            torch.distributed.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{ports[1]}",
                world_size=1, rank=0)
            try:
                nccl_flat, nccl_steps, _, _ = dist_steps(
                    f32, batches, device, torch.distributed.group.WORLD)
            finally:
                torch.distributed.destroy_process_group()
            out["nccl"] = {
                "backend": backend, "reason": reason,
                "gaps": step_gaps(nccl_steps, one_steps),
                "param_max_abs": float((nccl_flat - one_flat).abs().max()),
                "bitwise": torch.equal(nccl_flat, one_flat)}
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    results.put((rank, out, None))


def check_distributed(device):
    """The distributed phase (DIST_* constants): DIST_WORLD ranks, each a
    spawned process on the one card over gloo, as ``torchrun`` would start
    them on a host whose ranks share a card; gates every rank's figures
    and, in this process, data-parallel serving (``data_parallel_serving``).
    Returns the kernels' launches on each rank: B1 and B3 a training step,
    B2 (and B1) an evaluation batch."""
    import multiprocessing
    import queue as queues

    t0 = time.monotonic()
    root = Path(__file__).resolve().parent / "build" / "dist_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = Config()
    config = config.replace(model=dataclasses.replace(
        config.model, backbone="resnet_50_dense", num_classes=3))
    artifact = str(root / "model.npz")
    export_model(init_params(config, torch.Generator().manual_seed(0), 3),
                 ["square", "triangle", "circle"], "resnet_50_dense", SIZE,
                 artifact)
    one_process = evaluate.strict_json(run_eval(
        "distributed reference, one process",
        dist_eval_argv(root, artifact, device), EVAL_PATHS["kernels"][1],
        EVAL_IMAGES // EVAL_BATCH)[0])
    serving = data_parallel_serving(device, artifact)
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    ports = [free_port(), free_port()]
    procs = [ctx.Process(target=distributed_rank,
                         args=(rank, str(device), ports, str(root), artifact,
                               results))
             for rank in range(DIST_WORLD)]
    for proc in procs:
        proc.start()
    ranks, errors = {}, {}
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        while len(ranks) + len(errors) < DIST_WORLD:
            rank, got, error = results.get(
                timeout=max(1.0, deadline - time.monotonic()))
            if error is not None:
                errors[rank] = error
                break  # the other ranks may wait on it in a collective
            ranks[rank] = got
    except queues.Empty:
        errors["timeout"] = (f"ranks {sorted(set(range(DIST_WORLD)) - set(ranks))} "
                             f"gave no result within {DIST_TIMEOUT} s")
    finally:
        for proc in procs:
            proc.join(timeout=30 if not errors else 1)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    if errors:
        raise AssertionError(f"distributed ranks failed: {errors}")
    seconds = time.monotonic() - t0

    lead = ranks[0]
    steps = lead["kernel_steps"]
    per_rank = {rank: {
        "backend": r["backend"], "fp32_step_ms": r["fp32_ms"],
        "kernel_step_ms": r["kernel_ms"],
        "kernel_launches_per_step": {k: n / steps for k, n in
                                     r["kernel_launches"].items() if n},
        "fit_launches_per_step": [
            {k: n / (DIST_FIT_STEPS // 2) for k, n in f["launches"].items()
             if n} for f in r["fit"]],
        "fit_seconds": [f["seconds"] for f in r["fit"]],
        "gradient_bucket_all_reduce_ms": r["bucket_ms"],
        "eval_launches_per_batch": r["eval_launches_per_batch"],
        "peak_gib": r["peak_gib"]} for rank, r in ranks.items()}
    failed = []
    if any(r["backend"] != "gloo" for r in ranks.values()):
        failed.append("backend")
    # Two fp32 runs, each as far from float64 as the witness, may stand
    # twice that far apart: DIST_FP32_BOUNDS, fixed from its readings.
    f64, bounds = lead["fp32_vs_float64"], DIST_FP32_BOUNDS
    gaps = {**lead["fp32_gaps"], "param_max_abs": lead["fp32_param_max_abs"]}
    if not all(gaps[k] <= bound for k, bound in bounds.items()):
        failed.append("fp32 vs one process")
    if not all(f64[k] <= bound for k, bound in bounds.items()):
        failed.append("one fp32 process vs float64")
    if not all(r["fp32_same_as_rank_0"] for r in ranks.values()) or \
            any(r["fp32_steps"] != lead["fp32_steps"]
                for r in ranks.values()):
        failed.append("fp32 ranks not bitwise equal")
    want = {"b1": 12.0, "b3": 12.0}
    if any(p["kernel_launches_per_step"] != want
           or any(f != want for f in p["fit_launches_per_step"])
           for p in per_rank.values()):
        failed.append("B1/B3 launches a step")
    if not lead["kernels_agree"]:
        failed.append("kernel path vs float32")
    if lead["fault_agrees"]:
        failed.append("planted fault passed")
    for rank, r in ranks.items():
        if [f["step"] for f in r["fit"]] != [DIST_FIT_STEPS // 2,
                                              DIST_FIT_STEPS] \
                or r["fit"][0]["restored"] \
                or r["fit"][1]["restored"] != [
                    f"restored checkpoint from step {DIST_FIT_STEPS // 2}"]:
            failed.append(f"fit steps or restore on rank {rank}")
    complete = sorted(["opt_state.pt", "params.pt"])
    if lead["fit_records"] != list(range(1, DIST_FIT_STEPS + 1)) or \
            lead["fit_checkpoints"] != {DIST_FIT_STEPS // 2: complete,
                                        DIST_FIT_STEPS: complete} \
            or lead["fit_tmp"]:
        failed.append("fit writes")
    eval_gaps = {k: abs(v - one_process[k]) for k, v in lead["eval"].items()
                 if isinstance(v, float) and one_process[k] is not None}
    if any(r["eval"] != lead["eval"] for r in ranks.values()):
        failed.append("eval metrics differ between ranks")
    if max(eval_gaps.values()) > EVAL_METRIC_BOUND:
        failed.append("eval vs one process")
    if not serving["bitwise"]:
        failed.append("data-parallel Detector vs one device")
    nccl = lead["nccl"]
    if nccl["backend"] != "nccl" or \
            nccl["gaps"]["total_loss"] > DIST_LOSS_RTOL or \
            nccl["gaps"]["grad_norm"] > DIST_NORM_RTOL or \
            not nccl["param_max_abs"] <= DIST_PARAM_ATOL:
        failed.append("one-rank NCCL group")
    log("distributed", world=DIST_WORLD, global_batch=DIST_BATCH,
        steps=DIST_STEPS, joined=lead["joined"], per_rank=per_rank,
        one_process_fp32_step_ms=lead["one_process_fp32_ms"],
        fp32_gaps=lead["fp32_gaps"],
        fp32_param_max_abs=lead["fp32_param_max_abs"],
        one_process_fp32_vs_float64=f64, fp32_bounds=bounds,
        jax_bounds={"total_loss_rtol": DIST_LOSS_RTOL,
                    "grad_norm_rtol": DIST_NORM_RTOL,
                    "param_atol": DIST_PARAM_ATOL},
        eval_metric_bound=EVAL_METRIC_BOUND,
        kernels_agree=lead["kernels_agree"],
        fault_agrees=lead["fault_agrees"],
        fit=[{"steps": [f["step"] for f in r["fit"]],
              "restored": [f["restored"] for f in r["fit"]]}
             for r in ranks.values()],
        fit_records=lead["fit_records"],
        fit_checkpoints=lead["fit_checkpoints"],
        eval_metrics=lead["eval"], eval_one_process=one_process,
        eval_gaps=eval_gaps, data_parallel_detector=serving, nccl=nccl,
        seconds=seconds,
        nvidia_smi=nvidia_smi(),
        note=f"{DIST_WORLD} ranks share one card: no scaling is measured",
        failed=failed)
    if failed:
        raise AssertionError(f"distributed phase failed: {failed}")
    return {"b1": per_rank[0]["kernel_launches_per_step"]["b1"],
            "b3": per_rank[0]["kernel_launches_per_step"]["b3"],
            "b2": lead["eval_launches_per_batch"]["b2"],
            "b1_eval": lead["eval_launches_per_batch"]["b1"]}


def check_fit(device):
    """The fit phase (FIT_* constants): both paths trained and gated, the
    mAP gate, B4 and int8 on the trained kernel-path model, and the
    serving surfaces on its checkpoints.  Returns the kernel path's
    training launches per kernel."""
    root = Path(__file__).resolve().parent / "build" / "fit_smoke"
    root.mkdir(parents=True, exist_ok=True)
    gates = train_fit_paths(root, device)
    failed = {path: f for (path, _), (f, _) in gates.items()}
    fits = {path: fields for (path, _), (_, fields) in gates.items()}
    if any(failed.values()):
        raise AssertionError(f"fit gates failed: {failed}")
    maps = fit_maps(root, device)
    m = {path: metrics for path, (metrics, _) in maps.items()}
    gaps = {"kernels_vs_plain": abs(m["kernels"]["mAP"] - m["plain"]["mAP"]),
            "b4_vs_kernels": abs(m["kernels+b4"]["mAP"]
                                 - m["kernels"]["mAP"]),
            "int8_vs_kernels": m["int8"]["mAP"] - m["kernels"]["mAP"],
            "kernels_vs_plain_wide_ungated": abs(
                m["kernels@wide"]["mAP"] - m["plain@wide"]["mAP"])}
    gated = {"ap50": {p: m[p]["AP50"] >= FIT_AP50_FLOOR
                      for p in FIT_PATHS},
             "kernels_vs_plain": gaps["kernels_vs_plain"] <= FIT_MAP_GAP,
             "b4_vs_kernels": gaps["b4_vs_kernels"] <= FIT_B4_GAP}
    launches = {p: per_batch for p, (_, per_batch) in maps.items()}
    log("fit-gate", mAP={p: v["mAP"] for p, v in m.items()},
        AP50={p: v["AP50"] for p, v in m.items()}, gaps=gaps,
        ap50_floor=FIT_AP50_FLOOR, map_gap_bound=FIT_MAP_GAP,
        b4_gap_bound=FIT_B4_GAP, held=gated)
    serve = {"kernels": {"b1": 12, "b2": 1}, "plain": {"b2": 1},
             "int8": {"b6": 59, "b2": 1}}
    serve.update({f"{p}@wide": serve[p] for p in FIT_PATHS})
    wrong = {p: launches[p] for p, want in serve.items()
             if launches[p] != want}
    if not launches["kernels+b4"].get("b4") or \
            launches["kernels+b4"].get("b1") != 12:
        wrong["kernels+b4"] = launches["kernels+b4"]
    if wrong:
        raise AssertionError(f"fit mAP runs launched {wrong}")
    if not (all(gated["ap50"].values()) and gated["kernels_vs_plain"]
            and gated["b4_vs_kernels"]):
        raise AssertionError(f"mAP gate failed: {gated}")
    fit_surfaces(root, device)
    return {k: sum(run.get(k, 0) for run in fits["kernels"]["launches"])
            for k in eval_counters()}


def fit_spread(device):
    """The ``spread`` phase: both fit paths trained from each of
    SPREAD_SEEDS (``train_fit_paths``, three at once, gated as in the fit
    phase), each model's held-out mAP from its last checkpoint and from
    the mean of its newest FIT_AVERAGE on the first n images for each n
    of SPREAD_EVAL_IMAGES, and the gaps between every two models: same
    seed across paths, same path across seeds, and across both."""
    root = Path(__file__).resolve().parent / "build" / "fit_smoke"
    root.mkdir(parents=True, exist_ok=True)
    maps = {}
    models = [(path, seed) for seed in SPREAD_SEEDS for path in FIT_PATHS]
    for jobs in (models[:len(models) // 2], models[len(models) // 2:]):
        failed = {job: f for job, (f, _) in
                  train_fit_paths(root, device, jobs).items() if f}
        if failed:
            raise AssertionError(f"fit gates failed: {failed}")
        for path, seed in jobs:
            experiment = root / f"{path}_seed{seed}"
            for average in (1, FIT_AVERAGE):
                detector, config = fit_serving(path, experiment, device,
                                               average=average)
                for n in SPREAD_EVAL_IMAGES:
                    maps[average, n, path, seed] = fit_map(
                        f"{path}{seed}/{average}", detector, config,
                        n)[0]["mAP"]
                del detector
            shutil.rmtree(experiment / "checkpoints")
            torch.cuda.empty_cache()
    for average in (1, FIT_AVERAGE):
        for n in SPREAD_EVAL_IMAGES:
            m = {job: maps[(average, n) + job] for job in models}
            gaps = {"same_seed": [], "same_path": [], "across": []}
            for i, (pa, sa) in enumerate(models):
                for pb, sb in models[i + 1:]:
                    kind = ("same_seed" if sa == sb else
                            "same_path" if pa == pb else "across")
                    gaps[kind].append(abs(m[pa, sa] - m[pb, sb]))
            log("fit-spread", checkpoints_averaged=average, eval_images=n,
                map_gap_bound=FIT_MAP_GAP,
                mAP={f"{p}{s}": v for (p, s), v in m.items()},
                max_gap={k: max(v) for k, v in gaps.items()},
                mean_gap={k: sum(v) / len(v) for k, v in gaps.items()},
                gaps=gaps)


# The backbones phase: the four backbones beside the dense flagship
# (``resnet_50``, ResNeXt-50 32×4d, the default; ``mobilenet_v2``;
# ``densenet_121``/``densenet_169``) served through ``Detector`` at 640 px,
# 80 classes, bf16, on seeded ``init_params`` weights, on the plain path,
# with every GroupNorm on B4, and with int8 convs (B6): launches per batch
# gated (BACKBONE_B6 B6 and 1 B2 per int8 forward, 1 B2 per batch
# otherwise), each B4 call of the model within B4_REL of its plain version,
# the heads with B4 at least as close to the float32 model as the eager
# GroupNorm's (TRAIN_TRUTH_FACTOR/SLACK), the int8 heads within
# HEAD_RTOL/HEAD_ATOL of the same model on B6's plain version, and B6
# bitwise its plain version at every distinct int8 conv of each backbone.
BACKBONES = ("resnet_50", "mobilenet_v2", "densenet_121", "densenet_169")
BACKBONE_B6 = {"resnet_50": 59, "mobilenet_v2": 41, "densenet_121": 126,
               "densenet_169": 174}
# B6 beyond the 640-px models' shapes, (B, H, W, C, F, k, stride, groups):
# C and F below 64 and not multiples of it (x_q and w_q zero-padded, the
# store predicated), on odd sides at stride 1 and 2, and cardinality-32
# grouped convs (run as their block-diagonal dense form) at ResNeXt-50's
# widest and at stride 2; and more than 65535 row tiles of 128 output pixels
# (MobileNetV2's first expand conv at batch 128 has 102400).
B6_WIDENED = ((2, 75, 57, 24, 16, 1, 1, 1), (2, 75, 57, 16, 96, 3, 2, 1),
              (2, 75, 57, 40, 136, 1, 1, 1), (2, 75, 57, 136, 40, 3, 1, 1),
              (2, 20, 20, 1024, 1024, 3, 1, 32),
              (2, 75, 57, 256, 256, 3, 2, 32),
              (90, 320, 320, 8, 16, 1, 1, 1))
# One training step at batch 8 (dropout 0.2) with and without remat, from
# one seed: each parameter's update (−lr·gradient at step 1) within
# REMAT_REL of the other's (‖Δ‖₂/‖ref‖₂, leaves with max|ref| ≥
# TRAIN_LEAF_MIN): the recomputation repeats the forward, dropout masks
# included, and cuDNN's weight gradients may sum in another order; and a
# step from another dropout seed must part by more than REMAT_SEED_FACTOR ×
# that, so the masks do matter.
REMAT_REL, REMAT_SEED_FACTOR = 1e-2, 10.0
# ResNeXt-50's training loop: BACKBONE_FIT_STEPS steps at FIT_SIZE px, batch
# FIT_BATCH, on BACKBONE_FIT_IMAGES shapes images (epochs of all of them),
# in two invocations of half as many (the second resumes), then
# ``evaluate --experiment`` and ``detect --experiment`` on its checkpoint.
BACKBONE_FIT_STEPS, BACKBONE_FIT_IMAGES = 30, 80
# The grouped 3×3 of ResNeXt-50's four stages at batch 8 (H, W, width): as
# the block-diagonal dense conv it runs as, against F.conv2d(groups=32).
GROUPED_3X3 = ((160, 160, 128), (80, 80, 256), (40, 40, 512),
               (20, 20, 1024))


def backbone_config(backbone, batch=8, quantize="none", **model):
    config = Config()
    return config.replace(
        model=dataclasses.replace(config.model, backbone=backbone,
                                  quantize=quantize, **model),
        data=dataclasses.replace(config.data, image_size=SIZE,
                                 batch_size=batch),
        nms=dataclasses.replace(config.nms, use_approx_top_k=True))


def counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after (synchronised): (its result, {kernel: launches})."""
    counters = eval_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items() if c.launches}


def check_detections(label, out, batch=8):
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out.boxes, out.scores))
    if not finite or tuple(out.boxes.shape) != (batch, 1000, 4):
        raise AssertionError(f"{label}: bad detections")


def b4_calls_vs_plain(model, images):
    """One forward of ``model`` (every GroupNorm on B4) with each B4 call
    held to its plain version on the model's activations (forward hooks):
    {(C, groups): [calls, worst max |Δ|]}; raises past B4_REL."""
    found, over = {}, []

    def hook(module, inputs, output):
        x = inputs[0]
        n, c, h, w = x.shape
        if h * w * c < GN_KERNEL_MIN_ELEMENTS:
            return
        groups = resolve_groups(c, module.groups)
        ref = b4.fused_group_norm_act_plain(
            x.permute(0, 2, 3, 1), module.gamma, module.beta, groups,
            module.eps, module.activation).permute(0, 3, 1, 2).float()
        err = (output.float() - ref).abs()
        if bool((err > B4_REL[x.dtype] * ref.abs().clamp(min=1.0)).any()):
            over.append((h, w, c, groups))
        entry = found.setdefault((c, groups), [0, 0.0])
        entry[0] += 1
        entry[1] = max(entry[1], err.max().item())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm)]
    with torch.inference_mode():
        model(images)
    for h in hooks:
        h.remove()
    if over:
        raise AssertionError(f"B4 disagrees with its plain version at "
                             f"{over}")
    return found


def int8_conv_shapes(model, images):
    """{(B, H, W, C, F, k, stride, groups): convs per forward} of one
    forward's int8 convs (forward pre-hooks)."""
    shapes = {}

    def record(module, inputs):
        b, c, h, w = inputs[0].shape
        key = (b, h, w, c, module.kernel.shape[0], module.kernel_size,
               module.strides, module.feature_group_count)
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, Conv) and m.quantize]
    with torch.inference_mode():
        model(images)
    for h in hooks:
        h.remove()
    return shapes


def b6_new_shapes(device, shapes, timed):
    """B6 bitwise its plain version (with ``groups``) at each shape of
    ``shapes`` not yet in ``timed``, in one call with weights quantized in
    the call and in one with them prepared; each timed with prepared
    weights (the whole conv and, queued, its GEMM alone) beside its bound
    at the int8 peak.  Adds {shape: fields} to ``timed``."""
    gen = torch.Generator().manual_seed(9)
    for key in sorted(set(shapes) - set(timed)):
        b, h, w, c, f, k, s, g = key
        x = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
        kernel = he_kernel((f, c // g, k, k), gen)
        x, kernel = x.to(device), kernel.to(device)
        wts = b6.prepare_weights(kernel, g)
        ref = b6.int8_conv_plain(x, kernel, s, torch.bfloat16, groups=g)
        out = b6.int8_conv(x, kernel, s, groups=g)
        again = b6.int8_conv(x, kernel, s, weights=wts, groups=g)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref)) and bool(torch.equal(again, ref))
        ho, wo = out.shape[1:3]
        x_q = torch.empty(b6.xq_bytes(x.shape), dtype=torch.int8,
                          device=device)
        y = torch.empty_like(out)
        work = b6.scratch(device)[0]
        conv_ms = cuda_time_ms(lambda: b6.int8_conv(x, kernel, s,
                                                    weights=wts, groups=g), 5)
        b6.launch(x, x_q, work, wts, y, s)  # leaves x_q and s_x
        gemm_ms = cuda_time_ms(lambda: b6.launch(x, x_q, work, wts, y, s,
                                                 which=b6.GEMM), 5,
                               queued=True)
        ms, by = bound(2 * b * ho * wo * k * k * (c // g) * f,
                       (b * h * w * c + b * ho * wo * f) * 2
                       + k * k * (c // g) * f + 4 * f, PEAK_INT8)
        timed[key] = dict(
            convs_per_forward=shapes[key], conv_ms=conv_ms, gemm_ms=gemm_ms,
            bound_ms=ms, bound_by=by, bitwise_equal=equal,
            padded_c=b6.padded(c), padded_f=b6.padded(f),
            tile_n=b6.tile_n(b6.padded(f), b * ho * wo,
                             k * k * b6.padded(c)))
        log("b6-backbone", shape=[b, h, w, c], F=f, k=k, stride=s, groups=g,
            **timed[key])
        if not equal:
            raise AssertionError(f"B6 differs from its plain version at "
                                 f"{key}")
        del x, kernel, wts, ref, out, again, x_q, y
    torch.cuda.empty_cache()


def serve_backbone(device, backbone, b6_timed):
    """The serving checks of one backbone at batch 8 (see BACKBONES);
    returns {path: launches per batch}.  Adds its int8 convs' shapes to
    ``b6_timed`` (``b6_new_shapes``)."""
    names = [str(i) for i in range(80)]
    config = backbone_config(backbone)
    state = init_params(config, torch.Generator().manual_seed(0), 80)
    images = torch.randn(8, SIZE, SIZE, 3,
                         generator=torch.Generator().manual_seed(3)
                         ).to(device)
    launches = {}
    detector = Detector(config, state, names, device)
    out, launches["plain"] = counted(lambda: detector(images))
    check_detections(backbone, out)
    with torch.inference_mode():
        eager = detector.model(images)
    gated = use_group_norm_kernel(detector.model)
    out, launches["b4"] = counted(lambda: detector(images))
    check_detections(f"{backbone}+b4", out)
    groups = b4_calls_vs_plain(detector.model, images)
    with torch.inference_mode():
        got = detector.model(images)
    f32 = RetinaNet.from_config(dataclasses.replace(
        config.model, compute_dtype="float32"), 9, 80)
    f32.load_state_dict(state)
    f32.to(device).eval()
    with torch.inference_mode():
        truth = f32(images)
    del f32
    worse, errs = [], {}
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            t = truth[head][pn].float()
            err = {k: ((v[head][pn].float() - t).norm() / t.norm()).item()
                   for k, v in (("b4", got), ("eager_gn", eager))}
            errs[f"{head[:5]}/{pn}"] = err
            if err["b4"] > (TRAIN_TRUTH_FACTOR * err["eager_gn"]
                            + TRAIN_TRUTH_SLACK):
                worse.append(f"{head}/{pn}")
    log("backbone-b4", backbone=backbone, gn_modules=gated,
        launches=launches["b4"],
        groups={f"C{c}/g{g}": v for (c, g), v in sorted(groups.items())},
        rel_l2_vs_float32=errs)
    if worse:
        raise AssertionError(f"{backbone}: B4 in the model is less accurate "
                             f"than its GroupNorm at {worse}")
    del detector, got, eager

    q = Detector(backbone_config(backbone, quantize="int8"), state, names,
                 device)
    out, launches["int8"] = counted(lambda: q(images))
    check_detections(f"{backbone} int8", out)
    shapes = int8_conv_shapes(q.model, images)
    with torch.inference_mode():
        got = q.model(images)
        real = b6.int8_conv
        b6.int8_conv = (lambda x, kernel, strides=1, out_dtype=None,
                        weights=None, groups=1: b6.int8_conv_plain(
                            x, kernel, strides, out_dtype or x.dtype,
                            groups=groups))
        try:
            want = q.model(images)
        finally:
            b6.int8_conv = real
    share = compare_heads(f"{backbone}-int8", got, want, log_levels=False)[0]
    int8_vs_f32, outside = {}, 0
    for head in ("classifications", "regressions"):
        for pn in ("P3", "P4", "P5", "P6", "P7"):
            t = truth[head][pn].float()
            g = got[head][pn].float()
            int8_vs_f32[f"{head[:5]}/{pn}"] = ((g - t).norm()
                                               / t.norm()).item()
            outside += int(((g - t).abs() > HEAD_ATOL + HEAD_RTOL * t.abs())
                           .sum().item())
    log("backbone-int8", backbone=backbone, launches=launches["int8"],
        distinct_shapes=len(shapes), b6_vs_plain_bitwise_share=share,
        rel_l2_vs_float32=int8_vs_f32,
        elements_outside_head_bound_vs_float32=outside)
    del q, got, want, truth
    torch.cuda.empty_cache()
    b6_new_shapes(device, shapes, b6_timed)
    log("b6-backbone-forward", backbone=backbone,
        convs=sum(shapes.values()),
        **{k: sum(n * b6_timed[key][k] for key, n in shapes.items())
           for k in ("conv_ms", "gemm_ms", "bound_ms")})
    b4_calls = sum(calls for calls, _ in groups.values())
    want = {"plain": {"b2": 1}, "b4": {"b2": 1, "b4": b4_calls},
            "int8": {"b6": BACKBONE_B6[backbone], "b2": 1}}
    log("backbone-launches", backbone=backbone, per_batch=launches,
        expected=want)
    if launches != want:
        raise AssertionError(f"{backbone}: launches {launches}, expected "
                             f"{want}")
    return launches


def grouped_conv_times(device):
    """Device ms of ResNeXt-50's grouped 3×3 at batch 8 as it runs (the
    block-diagonal dense conv, ``grouped_as_dense`` up to width 512) and
    as ``F.conv2d(groups=32)``, bf16 channels_last, recorded only."""
    gen = torch.Generator().manual_seed(4)
    for h, w, width in GROUPED_3X3:
        x = torch.randn(8, width, h, w, generator=gen).to(
            device, torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
        k = he_kernel((width, width // 32, 3, 3), gen).to(device)
        dense = block_diagonal(k, 32).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        grouped = k.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        ms = {"dense_ms": cuda_time_ms(
            lambda: F.conv2d(x, dense, padding=1), 10, queued=True),
            "grouped_ms": cuda_time_ms(
            lambda: F.conv2d(x, grouped, padding=1, groups=32), 10,
            queued=True)}
        log("grouped-3x3-time", shape=[8, h, w, width], groups=32,
            runs_as="dense" if width <= 512 else "grouped", **ms)
        del x, k, dense, grouped


def remat_step(device, backbone):
    """One ``make_train_step`` at batch 8, dropout 0.2, with and without
    remat from dropout seed 1, and without from seed 2: each parameter's
    update held as REMAT_REL/REMAT_SEED_FACTOR say."""
    batch = synthetic_batch(8, SIZE, Config().assign.max_boxes, device)
    state0 = init_params(backbone_config(backbone),
                         torch.Generator().manual_seed(0), 80)
    updates = {}
    for label, remat, seed in (("no_remat", False, 1), ("remat", True, 1),
                               ("other_seed", False, 2)):
        config = backbone_config(backbone, remat=remat)
        model = RetinaNet.from_config(config.model, 9, 80).to(device)
        sites = [m.site for m in model.modules() if isinstance(m, Dropout)]
        state = create_train_state(model, config, state0)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        step = make_train_step(model, build_levels(config.anchors), config,
                               with_metrics=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        state, metrics = step(state, *batch,
                              torch.Generator().manual_seed(seed))
        loss = metrics["total_loss"].item()
        ms = (time.perf_counter() - t) * 1e3
        updates[label] = {k: (state.params[k].detach() - before[k]).float()
                          for k in before}
        log("backbone-step", backbone=backbone, run=label, total_loss=loss,
            first_step_ms=ms,
            peak_gb=torch.cuda.max_memory_allocated(device) / 2 ** 30)
        if not math.isfinite(loss):
            raise AssertionError(f"{backbone}: {label} loss {loss}")
        del model, state, before
        torch.cuda.empty_cache()
    ref = updates["no_remat"]

    def worst(other):
        return max(((other[k] - r).norm() / r.norm()).item()
                   for k, r in ref.items()
                   if r.abs().max().item() >= TRAIN_LEAF_MIN)

    remat_rel, seed_rel = worst(updates["remat"]), worst(updates["other_seed"])
    log("backbone-remat", backbone=backbone, worst_leaf_rel_remat=remat_rel,
        worst_leaf_rel_other_seed=seed_rel, bound=REMAT_REL,
        seed_factor=REMAT_SEED_FACTOR)
    if remat_rel > REMAT_REL or seed_rel < REMAT_SEED_FACTOR * remat_rel:
        raise AssertionError(f"{backbone}: remat update {remat_rel}, other "
                             f"seed {seed_rel}")
    dropout_host_cost(device, backbone, sites)


def dropout_host_cost(device, backbone, sites, reps=20):
    """Host ms that one training forward spends making its dropout
    generators on the card, one per site (median of ``reps``): the model's
    way (``DropoutKeys.generator``, one generator re-seeded per site) and,
    for comparison, a new ``torch.Generator`` per site."""

    def reuse():
        keys = DropoutKeys(1)
        for site in sites:
            keys.generator(site, device)

    def fresh():
        for site in sites:
            torch.Generator(device).manual_seed(site)

    ms = {}
    for label, fn in (("reuse_ms", reuse), ("fresh_ms", fresh)):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        ms[label] = statistics.median(times)
    log("backbone-dropout-host", backbone=backbone, sites=len(sites), **ms)


def time_backbone(device, backbone):
    """images/s and p50 at batch 8 and 128 on the plain, +B4 and int8
    paths (``infer.benchmark``), MFU from the model's useful work
    (``forward_gflops_per_image(algorithmic=True)``: ResNeXt-50's grouped
    3×3 without the zeros of its block-diagonal form; ``mfu_as_run``
    counts them), and the training step at batch 8 (``benchmark_train``)."""
    gflops = forward_gflops_per_image(backbone_config(backbone))
    useful = forward_gflops_per_image(backbone_config(backbone),
                                      algorithmic=True)
    for batch in (8, 128):
        for path in ("plain", "b4", "int8"):
            config = backbone_config(
                backbone, batch, "int8" if path == "int8" else "none")
            steps = 5 if batch == 8 else 3
            r, launches = counted(lambda: benchmark(
                config, batch_size=batch, steps=steps, warmup=1,
                num_classes=80, device=device,
                group_norm_kernel=path == "b4"))
            calls = 1 + steps + min(steps, 10)  # warm-up, timed, latency
            per_call = {k: n / calls for k, n in launches.items()}
            log("backbone-time", backbone=backbone, path=path, batch=batch,
                images_per_sec=r["images_per_sec"],
                p50_ms=r["p50_latency_ms"],
                mfu=r["images_per_sec"] * useful * 1e9 / PEAK_BF16,
                mfu_as_run=r["images_per_sec"] * gflops * 1e9 / PEAK_BF16,
                launches_per_batch=per_call)
            want = {"b2": 1, **({"b6": BACKBONE_B6[backbone]}
                                if path == "int8" else {})}
            if {k: v for k, v in per_call.items() if k != "b4"} != want \
                    or ("b4" in per_call) != (path == "b4"):
                raise AssertionError(f"{backbone} {path} at b{batch}: "
                                     f"{per_call} launches per batch")
            torch.cuda.empty_cache()
    # Dropout 0 beside the default 0.2, where the model has dropout sites.
    for rate in (0.2,) if backbone == "resnet_50" else (0.2, 0.0):
        t = benchmark_train(backbone_config(backbone, dropout_rate=rate),
                            batch_size=8, steps=3, warmup=1, num_classes=80,
                            device=device)
        log("backbone-train-time", backbone=backbone, batch=8, dropout=rate,
            step_ms=t["step_ms"], images_per_sec=t["images_per_sec"],
            peak_gb=t["peak_memory_bytes"] / 2 ** 30,
            gflops_per_image=gflops, useful_gflops_per_image=useful)
        torch.cuda.empty_cache()


def backbone_fit(device):
    """ResNeXt-50, the default backbone, through the training CLI as
    ``run_fit`` drives it (no ``--backbone`` flag): BACKBONE_FIT_STEPS at
    FIT_SIZE px, batch FIT_BATCH, in two invocations (the second logs the
    restore and resumes), finite losses, the data loss of the last logged
    step below step 1's; then ``evaluate --experiment`` (1 B2 a batch,
    finite metrics) and ``detect --experiment`` (1 B2)."""
    root = Path(__file__).resolve().parent / "build" / "backbones_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    dataset = ["shapes", str(root / "shapes"), str(BACKBONE_FIT_IMAGES),
               str(FIT_SIZE)]
    experiment = str(root / "resnet_50")
    half = BACKBONE_FIT_STEPS // 2
    per_epoch = BACKBONE_FIT_IMAGES // FIT_BATCH
    argv = ["--dataset", *dataset, "--experiment", experiment, "--scale",
            str(FIT_SIZE), "--batch-size", str(FIT_BATCH), "--dropout", "0",
            "--log-every", "5", "--epochs", str(half // per_epoch),
            "--steps-per-epoch", str(per_epoch), "--device", str(device)]
    runs = []
    for _ in range(2):
        state, launches, messages, seconds = run_fit(argv)
        runs.append((int(state.step), seconds, messages))
        del state
        torch.cuda.empty_cache()
    with open(Path(experiment) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    data = [(r["step"], r["class_loss"] + r["regr_loss"]) for r in records
            if "class_loss" in r]
    restored = any("restored checkpoint" in m for m in runs[1][2])
    step_ms = [r["images_per_sec"] for r in records if r["step"] > 1]
    log("backbone-fit", backbone="resnet_50", steps=[r[0] for r in runs],
        seconds=[r[1] for r in runs], restored=restored, data_loss=data,
        step_ms=[FIT_BATCH / v * 1e3 for v in step_ms])
    finite = all(math.isfinite(r["total_loss"]) for r in records
                 if "total_loss" in r)
    if ([r[0] for r in runs] != [half, 2 * half] or not restored
            or not finite or not data[-1][1] < data[0][1]):
        raise AssertionError(f"resnet_50 fit: steps {[r[0] for r in runs]}, "
                             f"restored {restored}, data loss {data}")
    base = ["--dataset", *dataset, "--experiment", experiment, "--scale",
            str(FIT_SIZE), "--batch-size", str(FIT_BATCH),
            "--score-threshold", "0.005", "--device", str(device)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics, eval_launches = counted(lambda: evaluate.main(base))
    batches = BACKBONE_FIT_IMAGES // FIT_BATCH
    finite = all(v is None or math.isfinite(v) for v in
                 evaluate.strict_json(metrics).values()
                 if not isinstance(v, (list, dict)))
    log("backbone-evaluate", backbone="resnet_50",
        metrics=evaluate.strict_json(metrics), launches=eval_launches,
        batches=batches)
    if eval_launches != {"b2": batches} or not finite:
        raise AssertionError(f"evaluate --experiment: {eval_launches} "
                             f"launches over {batches} batches")
    from retinanet_tpu_torch.data.loaders.shapes import Shapes
    image = next(iter(Shapes(None, 1, (FIT_SIZE, FIT_SIZE), seed=1)))["image"]
    path = str(root / "detect.png")
    pipeline.cv2.imwrite(path, image[..., ::-1])
    records, det_launches = counted(lambda: detect.main(
        [path, "--experiment", experiment, "--scale", str(FIT_SIZE),
         "--dataset", *dataset, "--score-threshold", "0.0", "--device",
         str(device)]))
    log("backbone-detect", backbone="resnet_50", launches=det_launches,
        detections=len(records))
    if det_launches != {"b2": 1} or not records:
        raise AssertionError(f"detect --experiment: {det_launches} launches,"
                             f" {len(records)} detections")
    return data


def check_backbones(device):
    """The backbones phase (BACKBONES).  Returns {backbone: {path:
    launches per batch}} and the B6 shapes timed."""
    launches, b6_timed = {}, {}
    for backbone in BACKBONES:
        t = time.monotonic()
        launches[backbone] = serve_backbone(device, backbone, b6_timed)
        if backbone != "resnet_50":
            remat_step(device, backbone)
        time_backbone(device, backbone)
        log("backbone-done", backbone=backbone,
            seconds=time.monotonic() - t)
    grouped_conv_times(device)
    backbone_fit(device)
    totals = {k: sum(v[f] for v in b6_timed.values())
              for k, f in (("conv_ms", "conv_ms"), ("gemm_ms", "gemm_ms"),
                           ("bound_ms", "bound_ms"))}
    log("b6-backbone-total", shapes=len(b6_timed), **totals)
    return launches, totals


def build_kernels():
    """One nvcc per source and the host library's g++, all started
    together."""
    libs = (b1.LIB, b2.LIB, b3.LIB, b4.LIB, b1.PROJ_LIB, b6.LIB, b7.LIB)

    def build(lib):
        t = time.monotonic()
        lib.build()
        return time.monotonic() - t

    with ThreadPoolExecutor(len(libs) + 1) as pool:
        host = pool.submit(build, native.LIB)
        seconds = list(pool.map(build, libs))
        log("build", source=native.LIB.source.name, seconds=host.result(),
            library=native.LIB.build().name)
    for lib, sec in zip(libs, seconds):
        lines = [ln.strip() for ln in lib.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln or "arning" in ln]
        log("build", source=lib.source.name, seconds=sec, ptxas=lines)


def parse_phases(argv):
    if not argv:
        return PHASES
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(f"usage: chip_smoke.py [--phases "
                         f"{','.join(PHASES)},parent,spread]")
    phases = tuple(argv[1].split(","))
    unknown = set(phases) - set(PHASES) - {"parent", "spread"}
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from "
                         f"{PHASES}")
    return phases


def main(argv=()) -> int:
    phases = parse_phases(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs capability (9, 0), got {cap}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    smi = nvidia_smi()
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        nvidia_smi=smi, capability=list(cap))

    ends = {}  # seconds from the start as each phase ended
    if "build" in phases:
        build_kernels()
        ends["build"] = time.monotonic() - t0
    errs, launches, timing, int8_shapes = {}, {}, {}, {}
    if "checks" in phases or "gn" in phases:
        gn_shapes = record_gn_shapes(device)
        ends["gn_shapes"] = time.monotonic() - t0
    if "checks" in phases:
        errs["b1"] = check_b1(device)
        ends["checks_b1"] = time.monotonic() - t0
        b2_mismatches, b2_largest_n = check_b2(device)
        errs["b2"] = float(b2_mismatches)
        errs["b3"] = check_b3(device)
        errs["b4"] = check_b4(device, gn_shapes)
        errs["b5"] = check_b5(device)
        errs["b7"] = check_b7(device)
        ends["checks"] = time.monotonic() - t0
    if "serving" in phases:
        launches.update(check_flagship(device))
        ends["serving"] = time.monotonic() - t0
    if "decode" in phases:
        decode_launches = check_decode(device)
        ends["decode"] = time.monotonic() - t0
    if "eval" in phases:
        eval_launches = check_eval(device)
        ends["eval"] = time.monotonic() - t0
    if "training" in phases:
        launches["b3"] = check_training(device)["b3"]
        ends["training"] = time.monotonic() - t0
    if "int8" in phases:
        int8_launches, int8_shapes = check_int8_serving(device)
        launches["b6"] = int8_launches["b6"]
        errs["b6"] = check_b6(device, {**int8_shapes,
                                       **fit_int8_shapes(device)})
        ends["int8"] = time.monotonic() - t0
    if "parent" in phases:
        if not int8_shapes and (PARENT_DIR / "int8_conv.py").exists():
            int8_shapes = check_int8_serving(device)[1]
        check_parent(device, int8_shapes)
        ends["parent"] = time.monotonic() - t0
    if "proj" in phases:
        launches["b5"] = check_fused_proj(device)["b5"]
        ends["proj"] = time.monotonic() - t0
    if "gn" in phases:
        launches["b4"] = check_gn_model(device, gn_shapes)["b4"]
        time_gn_model(device)
        ends["gn"] = time.monotonic() - t0
    if "entry" in phases:
        entry = drive_entry_points(device)
        launches["b7"] = entry["b7"]
        launches.setdefault("b4", entry["b4"])
        ends["entry"] = time.monotonic() - t0
    if "timing" in phases:
        timing = time_kernels(device)
        if int8_shapes:
            timing.update(time_new_kernels(device, int8_shapes))
        time_end_to_end(device)
        time_training(device)
        time_train_pipeline(device)
        ends["timing"] = time.monotonic() - t0
    if "breakdown" in phases:
        breakdown(device)
        ends["breakdown"] = time.monotonic() - t0
    backbone_launches, backbone_b6 = {}, {}
    if "backbones" in phases:
        backbone_launches, backbone_b6 = check_backbones(device)
        ends["backbones"] = time.monotonic() - t0
    if "distributed" in phases:
        dist_launches = check_distributed(device)
        ends["distributed"] = time.monotonic() - t0
    if "fit" in phases:
        # Last: a profile window loses its first kernels more the older
        # the process is (utils/profiling.py), and this phase takes
        # minutes without one.
        fit_launches = check_fit(device)
        ends["fit"] = time.monotonic() - t0
    if "spread" in phases:
        fit_spread(device)
        ends["spread"] = time.monotonic() - t0
    if B128_RATES:
        log_mfu()
    log("done", seconds=time.monotonic() - t0, phases=list(phases),
        phase_ends_s=ends, lossy_profile_windows=profiling.lossy_windows)
    if phases != PHASES:
        return 0

    sources = {
        "b1": ("fused_bottleneck", "bottleneck.cu",
               "retinanet_tpu/ops/pallas/bottleneck.py:372"),
        "b2": ("nms_keep_mask_batch", "nms.cu",
               "retinanet_tpu/ops/pallas/nms_kernel.py:162"),
        "b3": ("fused_bottleneck_bwd", "bottleneck_bwd.cu",
               "retinanet_tpu/ops/pallas/bottleneck_bwd.py:326"),
        "b4": ("fused_group_norm_act", "groupnorm.cu",
               "retinanet_tpu/ops/pallas/groupnorm.py:177"),
        "b5": ("fused_bottleneck_proj", "bottleneck_proj.cu",
               "retinanet_tpu/ops/pallas/bottleneck.py:328"),
        "b6": ("int8_conv", "int8_conv.cu",
               "retinanet_tpu/ops/pallas/int8_conv.py:76"),
        "b7": ("gn_relu_maxpool", "stem.cu",
               "retinanet_tpu/ops/pallas/stem.py:94"),
    }
    extra = {key: {"eval_launches_per_batch": {
        path: per_batch[key] for path, per_batch in eval_launches.items()},
        "fit_launches_kernel_path": fit_launches[key]}
        for key in sources}
    for key in ("b2", "b4", "b6"):
        extra[key]["backbones_launches_per_batch"] = {
            name: {path: per_batch.get(key, 0)
                   for path, per_batch in paths.items()}
            for name, paths in backbone_launches.items()}
    extra["b6"]["backbones_new_shapes_ms"] = backbone_b6
    for key in ("b1", "b3"):
        extra[key]["distributed_launches_per_step_each_rank"] = \
            dist_launches[key]
    extra["b2"]["distributed_eval_launches_per_batch_each_rank"] = \
        dist_launches["b2"]
    extra["b1"]["distributed_eval_launches_per_batch_each_rank"] = \
        dist_launches["b1_eval"]
    extra["b2"].update(largest_n_checked=b2_largest_n,
                       launches_reference_decode_every_candidate=sum(
                           decode_launches.values()))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"retinanet_tpu_torch/ops/csrc/{src}",
         "replaces": replaces, "launches": launches[key],
         "max_abs_err": errs[key],
         **{"library_ms": None, **timing[key]}, **extra.get(key, {})}
        for key, (name, src, replaces) in sources.items()]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
