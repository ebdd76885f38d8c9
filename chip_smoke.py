#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card (``nvidia-smi``) and build every kernel of the paths from
   ``uncertainty_model_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, in bf16 and f32 (``assemble_z``,
   ``gate_z``, ``se_squeeze``, ``assemble``, ``gated_conv_elu``;
   ``warp_rows`` forward and backward, grouped as the training step and
   the evaluation launch them); the decoder glue in bf16 bit for
   bit (``assemble_z``, ``gate_z``, ``assemble``), ``gate_z`` leaving
   channels >= Cso unwritten (they hold NaN before and after); the glue
   also at the stages other build options fuse (``OPTION_GLUE_STAGES``:
   dec0 and dec1, Cso 512 and 256 with no disparity; dec4 without the
   fold);
3. run the serving paths: the 22.5M-parameter flagship model's bf16 serving
   forward at 256x512, batch 8, from random weights made from a seed, with
   the kernel launch counters zeroed just before and read just after; the
   output is held against the f32 eval model.  First the bench path
   (``s2d_stages=()``, gate_fold: 3 ``assemble_z``), then the JAX
   package's default encoder, ``s2d_stages=(0, 1)``, with each decoder
   pipeline: (a) gate_fold, 8 ``gated_conv_elu`` + 3 ``assemble_z``;
   (b) gate_z, 8 + 3 + 3 ``gate_z``; (c) squeeze_first, 8 + 3
   ``se_squeeze`` + 3 ``assemble``.  Each also in f32 (TF32 off).  Then
   the build options of ``OPTION_PATHS`` (``fused_stages`` (0, ..., 4)
   with each pipeline, (1, ..., 4) and (); ``dec_fold=False``,
   ``smax`` "nomax" and "slice"; (0, ..., 4) with ``s2d_stages=(0, 1)``),
   each count as listed there, bf16 and f32 (``elu_fold`` changes nothing
   in the port, so it has no path of its own);
3b. run the training path: ``Trainer.train_one_epoch`` of the flagship in
   f32 (TF32 off) at batch 8, 256x512, a few steps on one seeded stereo
   batch, counters zeroed just before and read after (5 forward and 5
   backward ``warp_rows`` launches a step: the 8 reconstruction warps in
   one, the uncertainty term's pair at each scale in one); the loss must
   be finite and
   fall.  Then one step at batch 2 on the card against the same step on
   the CPU (the plain versions) from the same weights: the losses, the
   whole step's gradients by their median, and each link of the
   gradient's chain per scale and per parameter;
3c. run evaluation and checkpoints on the flagship in f32 (TF32 off) at
   256x512: ``evaluate_model`` at batch 8 over 2 seeded batches (1
   ``warp_rows`` forward launch a batch, counted); the card's
   ``eval_step`` at batch 2 against the CPU's with the same weights,
   inputs and noise; ``Trainer.train_model`` for 2 epochs of 2 batches with
   an evaluation and a checkpoint every epoch, then ``final`` loaded into a
   fresh trainer, which must hold the same parameters and Adam moments;
   then a run resumed from a JAX checkpoint: 3 adversarial steps of the
   flagship and its discriminator at batch 8, their state laid out as the
   JAX package's ``load_checkpoint`` restores one (numpy transposes, the
   head at the 8x16 final map), converted by ``convert.from_jax_train_state``,
   written and loaded into other weights, must equal the run's bit for
   bit, and the next step too (the losses; the state after Adam steps on
   the run's gradients; the resumed step's own gradients by their median:
   the card's backward sums in no fixed order), with 5 + 5 ``warp_rows``
   launches and nothing else;
3d. run the training CLI (``cli.main.main``, in this process) on
   ``configs/uncertainty.yml`` at 256x512 from a da Vinci tree of
   1024x1280 PNGs written first (16 train, 12 test pairs; the PNG decode
   library ``csrc/stereo_decode.cc`` is built in phase 1 beside the
   kernels): 2 epochs at batch 8 with an evaluation and a checkpoint each,
   counters zeroed just before and read just after, each step's and each
   evaluation batch's launches read on their own (5 + 5 ``warp_rows`` a
   step, 1 forward an evaluation batch, the partial last one included,
   nothing else); the checkpoints, comparison PNGs and ``results.json``
   (the JAX package's schema, finite values) checked; then
   ``--resume-from epoch_001``, which must run epoch 2 alone and write
   ``final``;
3e. run bf16 mixed-precision training (``dtype=torch.bfloat16``, with the
   switches ``--precision bfloat16`` sets: TF32 off, bf16 products summed
   in f32): phase 3b's path in bf16 (6 steps at batch 8, the loss must
   fall, 5 + 5 ``warp_rows`` launches a step and no other kernel; the
   warps take f32 disparities, so phase 2's groups are the bf16 step's);
   parameters, gradients, BatchNorm statistics and Adam state f32 after
   those steps; a batch-2 bf16 step on the card against the CPU's, link by
   link as in 3b, the model backward's gradients held against bf16's own
   noise (the CPU's bf16 against its f32 gradients) and the SE layers
   link by link, the whole step's median below 1; 5 bf16 steps within 5%
   of 5 f32 steps;
   the CLI with ``--precision bfloat16`` for one epoch on phase 3d's tree
   (launches per step and evaluation batch, outputs, ``final`` f32 and
   reloaded exactly);
3f. run adversarial training in f32: the flagship with its discriminator
   (``configs/uncertainty.yml``, 7,625,230 parameters) through
   ``train_one_epoch`` for 6 steps at batch 8, the perceptual term live
   from step 3 and the lagged clone refreshed every 2 steps (5 + 5
   ``warp_rows`` launches a step and no other kernel: the discriminator
   is cuDNN's convs and its step's reconstructions are detached; the
   clone refreshed just when due; the loss without its adversarial terms
   must fall; every state tensor f32 on the card); a batch-2 step on the
   card against the CPU's (the three losses, the whole step's model and
   discriminator gradients by their medians, and on the CPU's own
   pyramids the discriminator step's gradient per parameter and the
   clone's gradient in the reconstructions); the weight gradient of each
   stage-1 conv of the discriminator (and, in 3b, of the encoder) alone
   from the CPU's x and dy, on the CPU in f32 and on the card by cuDNN
   (heuristics, deterministic, benchmark) and without it, against the
   CPU's f64 (cuDNN's weight gradient of a 5x5 stride-1 conv is off by
   ~2e-3, see ``CUDNN_LOSSY_KERNEL``); the CLI with ``--adversarial`` for
   one epoch on phase 3d's tree (launches, ``results.json``'s
   discriminator list, ``final`` reloaded exactly), then resumed from
   ``epoch_001``;
3g. run data parallelism at a world of 1 (the machine has one card):
   ``cli.parallel_main --num-processes 1`` for one f32 epoch on phase 3d's
   tree (its own NCCL group; launches, outputs, losses against phase 3d's
   serial run); then this process as the one rank of an NCCL group: a
   DDP step (``Trainer(distributed=True)``) at batch 8 against the plain
   step from the same weights, link by link with phase 3b's limits (the
   losses, dL/dD at equal disparities, the model backward per parameter,
   each of the 40 synced BatchNorm layers against ``F.batch_norm``, the
   whole step's median); 6 DDP steps with 5 + 5 ``warp_rows`` launches a
   step; the all-reduces of a step (profiler) against 4 a synced layer +
   DDP's buckets + 1; the adversarial DDP step (every BatchNorm of the
   model, the discriminator and the clone synced; losses against the
   plain step's, 5 + 5 launches a step);
3h. run training with the encoder's s2d stages (``s2d_stages=(0, 1)``,
   f32, TF32 off): phase 3b's path (6 steps at batch 8 on one batch, the
   loss must fall, 5 + 5 ``warp_rows`` launches a step and no other
   kernel), then a batch-2 step against the direct model's from the same
   weights on the card: the losses, the BatchNorm running statistics, the
   model backward of an equal cotangent per parameter, the whole step's
   median;
4. time the bench path also with the package's forward timer
   (``utils/benchmark.py``: slopes of chained passes, 9 samples) at batch
   64 and 128 (``bench.py``'s), printed as the ``serving_timer`` line beside
   the 9 one-pass event timings at batch 64;
   time the serving forwards at batch 64 (the bench path, (a), (b), (c),
   (a) with ``s2d_conv_backend="lax"``, ``fused_stages`` (0, ..., 4) and
   (), ``smax="nomax"``; the glue kernels also at dec0 and dec1), the
   training step (and the s2d one) and the
   eval step at batch 8 (each with the device's idle share), the bf16
   training step at batch 8 and 32 (with its device-busy time, idle
   share and peak memory), the adversarial f32 step at batch 8 (the same,
   with its device time by operator and the discriminator's share of the
   device's busy time), the DDP f32 step at batch 8 beside the plain one
   (the same, with its device time by operator), and each
   kernel against its plain version, its bound and the PyTorch call that
   computes the same function (``warp_rows`` per launch of a training
   step's groups, and per one-problem call at each shape as a log; CUDA
   events, median of 9 with spread; ``conv_elu`` and ``upsample2x2``, which
   no path of the package runs, at the flagship's shapes named below;
   ``gated_conv_elu`` at each s2d stage with 1-4 inputs, so that the time
   at n = 1 against n = 4 for the same conv work gives the cost of
   staging the gated sum, beside the registers and spills of each
   instantiation of its kernel from the build log; the decoder glue per
   stage beside its bound and achieved TB/s, ``gate_z`` beside ``mul_``
   and the bytes of the sectors its z lanes touch, with the registers and
   spills of each glue instantiation), and break the bench path's, (a)'s,
   (b)'s, (c)'s, one step's and one eval step's device time down by
   operator (``torch.profiler``); time the CLI's loader alone (pairs/s,
   and beside a thread running Python without pause) with one file's
   decode stages, and the step fed by it beside the same batches as numpy
   arrays and on the card, with the device's idle share of a fed epoch;
5. print the ``kernels`` line, then the device line last.

Phase 2 also holds ``conv_elu`` (the SAME zero-pad conv, the ungated mode
of the ``gated_conv_elu`` kernel) at the native encoder's five interior
conv shapes, enc0-enc4, and ``upsample2x2`` at the decoder's 2x upsample
sites, at batch 64, in bf16 and f32.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 on the tensor cores
SEED = 0
SMOKE_BATCH = 8     # the main path's batch; the kernels are checked at it
TIMING_BATCH = 64
BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)   # one bf16 ulp of the output
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MEAN_RTOL = 1e-3
BF16_VS_F32_EVAL = 0.05    # max abs, bf16 serving vs f32 eval model
F32_VS_F32_EVAL = 1e-3     # max abs, f32 serving vs f32 eval model (no TF32)

TRAIN_BATCH = 8     # the training path's batch (the CLI's default)
BF16_TIMING_BATCH = 32   # the bf16 step is also timed at this batch
TRAIN_STEPS = 6
TRAIN_LR = 1e-4     # the CLI's default learning rate
CPU_CHECK_BATCH = 2
LOSS_RTOL = 1e-4    # card step vs CPU step, each loss
GRAD_REL, GRAD_FLOOR = 5e-3, 5e-3   # |g_card - g_cpu| < max(rel |g|, floor)
LOSS_GRAD_REL = 1e-5    # dL/dD card vs CPU at equal disparities, per scale
WHOLE_STEP_MEDIAN_REL = 3e-2   # whole-step gradients card vs CPU, median
# the bf16 step, card vs CPU.  bf16 rounding is the noise: on the CPU the
# flagship's bf16 gradients differ from its f32 ones by 5% (the model's
# backward of one dL/dD, median) and 96% (the whole step: the disparities
# are quantized to about half a pixel before the warp); the card's convs
# round a few f32 sums apart from the CPU's, and train-mode BatchNorm
# magnifies that as much as bf16's own rounding.  So the model backward is
# held against that noise, read in the same run: each parameter's distance
# from the CPU's within max(BF16_PARAM_NOISE times the CPU's bf16-vs-f32
# distance, BF16_PARAM_FLOOR), the median within BF16_NOISE_FACTOR times
# the CPU's.  Where the card's forward flips a ReLU gate of an SE layer (a
# hidden unit's input crossing 0), that layer's gradients jump and are
# held link by link instead (check_se_links).  The whole step is held by
# its median below BF16_WHOLE_STEP_MEDIAN: a missing or detached gradient
# reads 1, an unrelated one of the same norm sqrt(2), a flipped one 2
BF16_LOSS_RTOL = 1e-3          # each loss (tiny config vs JAX: 2.1e-4)
BF16_LOSS_GRAD_REL = 1e-3      # dL/dD at equal bf16 disparities, per scale
BF16_NOISE_FACTOR = 1.5        # the model backward's median
BF16_PARAM_NOISE, BF16_PARAM_FLOOR = 4.0, 0.25
BF16_SE_ALONE_REL = 1e-3       # an SE layer's gradients, card vs alone on the CPU
BF16_WHOLE_STEP_MEDIAN = 1.0
BF16_TRAJECTORY_REL = 0.05     # bf16 vs f32 loss per step (the JAX bound)
BF16_TRAJECTORY_LR = 1e-3      # tests/test_mixed_precision.py's
# the adversarial step (phase 3f): the perceptual term from batch
# ADV_PERCEPTUAL_START of the epoch on and the clone refreshed every
# ADV_UPDATE_FREQ batches, so that both happen within TRAIN_STEPS steps
# (the config's 5 and the CLI's 10 would not)
ADV_PERCEPTUAL_START = 3
ADV_UPDATE_FREQ = 2
FLAGSHIP_DISC_PARAMS = 7_625_230   # jax.eval_shape of the JAX module's init
FLAGSHIP_BN_LAYERS, FLAGSHIP_DISC_BN_LAYERS = 40, 25
# card vs CPU (readings on an NVIDIA H100 80GB HBM3), link by link on the
# same (CPU-computed) pyramids: the discriminator's loss within
# DISC_LOSS_RTOL (read: 1.4e-6; the whole step's loss moves ~60x that with
# the reconstructions' rounding); the discriminator step's gradient per
# parameter within max(DISC_GRAD_REL |g|, DISC_GRAD_FLOOR max |g|) (read:
# below 2e-5 relative; the conv biases ahead of train-mode BatchNorm have a
# gradient of 0 but for rounding, hence a floor relative to the largest),
# but for the weights of the 5x5 stride-1 convs (CUDNN_LOSSY_KERNEL), held
# within GRAD_REL and link by link instead (wgrad_links); the clone's
# dL/d(recon) per scale within LAG_GRAD_REL of its norm (read: 7.7e-6); the
# whole step's model and discriminator gradients by their medians
DISC_LOSS_RTOL = 1e-5
DISC_GRAD_REL, DISC_GRAD_FLOOR = 1e-3, 1e-5
# cuDNN's f32 weight gradient of a 5x5 stride-1 conv is off: at the 64 -> 64
# convs of the discriminator's and the encoder's stage 1 (64x128) it reads
# 1.6e-3 to 2.0e-3 from the f64 gradient of the same x and dy, in every
# cuDNN mode (heuristics, deterministic, benchmark: one algorithm, the
# profiler's wgrad_alg0_engine_NHWC<float, 128, 5, 5, ...>), while
# PyTorch's own CUDA conv (cuDNN off) and the CPU read 3e-7 to 6e-7
# (NVIDIA H100 80GB HBM3, cuDNN 9.2); between two steps whose x and dy
# differ by 1e-6 it moves by 3.9e-3 (without cuDNN 6.6e-6: phase 3g).  These weights' gradients are held
# within GRAD_REL of the CPU's (the model backward's limit), and each such
# conv alone against the CPU's f64 (the judge): cuDNN within GRAD_REL, the
# CPU's f32 and the card without cuDNN within WGRAD_JUDGE_REL, as cuDNN is
# for every other conv checked
CUDNN_LOSSY_KERNEL = 5
WGRAD_JUDGE_REL = 1e-5
LAG_GRAD_REL = 1e-4
DSRC_TOL = 1e-5     # warp_rows dsrc: 1e-5 * (1 + sum of the terms' |.|)
CONV_F32_TOL = 1e-5     # gated_conv_elu f32: 1e-5 * (1 + sum of the terms' |.|)
WARP_LIBRARY_TOL = 1e-2   # grid_sample vs the kernel (x -> grid rounding)
PORT_KERNELS = ("decoder_rows", "gate_z_flat", "gated_conv",
                "warp_rows", "upsample2x2")   # device kernel names, for the profiler
CLI_CONFIG = "configs/uncertainty.yml"
CLI_TRAIN_PAIRS = 16    # the CLI phase's da Vinci tree: 2 steps an epoch
CLI_TEST_PAIRS = 12     # evaluation batches of 8 and 4 (drop_last=False)
CLI_SOURCE_SHAPE = (1024, 1280)   # PNG size; the loader resizes to 256x512
CLI_SHIFT = 24          # the right view's shift against the left, pixels
CLI_EPOCHS = 2
CLI_WORKERS = 8         # --workers: the loader's decode threads
LOADER_REPEAT = 4       # the timed loader's epoch: the training pairs 4 times
EVAL_BATCH = 8      # the evaluation's batch (the CLI's default)
CONVERT_STEPS = 3   # phase 3c's run before it is converted and resumed
BENCH_BATCH = 128   # bench.py's batch: the timer's second batch
EVAL_BATCHES = 2
EVAL_SSIM_RTOL = 1e-4   # card eval step vs CPU, the summed SSIM of a view
# card eval step vs CPU, AUSE and AURG: both average over 100 steps the
# differences of curves near 1, read from an 11x11-pooled error map sorted
# by uncertainty; the card's disparities differ from the CPU's by ~2e-6,
# which moves the reconstructions and the error map by ~1e-5, reorders
# near-tied pooled uncertainties, and the card's cumulative sum rounds in
# another order than the CPU's over ~1.2e5 pixels a view.  Read: 6.0e-7
# and 7.4e-7 (NVIDIA H100 80GB HBM3); the limit leaves two orders of
# magnitude for other weights and inputs
SPARS_ATOL = 1e-4

# the flagship's fused decoder stages: (name, H, W, Cso, Cu, Cd, cf)
# (cf > 0: the SE conv's feature-map half is folded into the kernel)
ASSEMBLE_Z_STAGES = (
    ("dec2", 64, 128, 128, 32, 4, 0),
    ("dec3", 128, 256, 64, 16, 4, 0),
    ("dec4", 256, 512, 32, 8, 4, 3),
)


# the flagship's s2d encoder stages at 256x512 (name, H, W, C = Co, k): the
# 7x7 and 5x5 interior convs of 32 and 64 channels on the half-resolution
# grid; the interior nodes of their K5 graphs take 1, 2, 3 and 4 inputs
S2D_CONV_STAGES = (
    ("enc0", 64, 128, 128, 5),
    ("enc1", 32, 64, 256, 3),
)
GATED_INPUTS = (1, 2, 3, 4)

# the flagship's native encoder interior convs at 256x512, the convs the
# TPU's conv_elu was written for (name, H, W, C = Co, k)
NATIVE_CONV_STAGES = (
    ("enc0", 128, 256, 32, 7),
    ("enc1", 64, 128, 64, 5),
    ("enc2", 32, 64, 128, 3),
    ("enc3", 16, 32, 256, 3),
    ("enc4", 8, 16, 512, 3),
)

# the 2x upsample sites at 256x512 (name, H, W, C): the one the TPU's
# upsample2x2 was written for (the decoder's 128x256 skip upsample of 32
# channels), and the 2x resize_bilinear inputs of the unfused decoder
# stages 0 and 1 (their SE skip features)
UPSAMPLE_SITES = (
    ("dec_skip_32", 128, 256, 32),
    ("dec0_skip", 8, 16, 512),
    ("dec1_skip", 16, 32, 256),
)

# the flagship's stages that run the glue only under other build options
# (name, H, W, Cso, Cu, Cd, cf): dec0 and dec1 under fused_stages=(0, ...,
# 4), with no disparity to concat; dec4 under dec_fold=False (cf 0)
OPTION_GLUE_STAGES = (
    ("dec0", 16, 32, 512, 128, 0, 0),
    ("dec1", 32, 64, 256, 64, 0, 0),
    ("dec4_nofold", 256, 512, 32, 8, 4, 0),
)
TIMED_OPTION_GLUE_STAGES = OPTION_GLUE_STAGES[:2]

# the serving forward's other build options, and the launches a forward
# must make (every other serving kernel: 0)
ALL_FUSED = (0, 1, 2, 3, 4)
OPTION_PATHS = {
    "fused_0-4": ({"fused_stages": ALL_FUSED}, {"assemble_z": 5}),
    "fused_0-4_gate_z": ({"fused_stages": ALL_FUSED, "dec_pipeline": "gate_z"},
                         {"assemble_z": 5, "gate_z": 5}),
    "fused_0-4_squeeze_first": (
        {"fused_stages": ALL_FUSED, "dec_pipeline": "squeeze_first"},
        {"se_squeeze": 5, "assemble": 5}),
    "fused_1-4": ({"fused_stages": (1, 2, 3, 4)}, {"assemble_z": 4}),
    "fused_none": ({"fused_stages": ()}, {}),
    "dec_fold_off": ({"dec_fold": False}, {"assemble_z": 3}),
    "smax_nomax": ({"smax": "nomax"}, {"assemble_z": 3}),
    "smax_slice": ({"smax": "slice"}, {"assemble_z": 3}),
    "s2d_fused_0-4": ({"s2d_stages": (0, 1), "fused_stages": ALL_FUSED},
                      {"gated_conv_elu": 8, "assemble_z": 5}),
}
TIMED_OPTION_PATHS = ("fused_0-4", "fused_none", "smax_nomax")

# phase 3h: the training model with s2d encoder stages against the direct
# model on the card.  BatchNorm's running statistics within the JAX s2d
# test's limit for them (tests/test_s2d_training.py)
S2D_TRAIN_STAGES = (0, 1)
S2D_STATS_TOL = dict(rtol=2e-4, atol=1e-6)

# the JAX package's default encoder with each decoder pipeline, and the
# launches a forward must make (every other serving kernel: 0)
S2D_PATHS = {
    "a": ({"s2d_stages": (0, 1)}, {"gated_conv_elu": 8, "assemble_z": 3}),
    "b": ({"s2d_stages": (0, 1), "dec_pipeline": "gate_z"},
          {"gated_conv_elu": 8, "assemble_z": 3, "gate_z": 3}),
    "c": ({"s2d_stages": (0, 1), "dec_pipeline": "squeeze_first"},
          {"gated_conv_elu": 8, "se_squeeze": 3, "assemble": 3}),
}


def log(*args):
    print(*args, flush=True)


START = time.perf_counter()


def phase(name):
    log(f"phase {name} (at {time.perf_counter() - START:.1f} s)")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def build_kernels(sources):
    from uncertainty_model_tpu_torch import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(_build.library_path, sources))
    log(f"built {len(paths)} kernel librar{'y' if len(paths) == 1 else 'ies'} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------


def card_rng(seed):
    """A generator of the card's seeded with ``seed``: the inputs of the
    kernel checks and timings are drawn on the card (numpy's draws and the
    copy of b64 activations took most of phases 2 and 4)."""
    return torch.Generator(device="cuda").manual_seed(seed)


def normal(rng, *shape, scale=1.0, dtype=torch.float32):
    """N(0, scale^2) draws of ``rng`` on the card, in ``dtype``."""
    return (scale * torch.randn(shape, generator=rng, device="cuda")).to(dtype)


def assemble_z_inputs(seed, b, h, w, cso, cu, cd, cf, dtype):
    rng = card_rng(seed)
    h2, w2 = h // 2, w // 2

    def t(*shape, dt=dtype):
        return normal(rng, *shape, dtype=dt)

    se = t(b, h, w, cf or cso)
    skip, xc = t(b, h2, w2, cso), t(b, h2, w2, 4 * cu)
    disp = t(b, h2, w2, cd) if cd else None
    bias = t(cso, dt=torch.float32)
    k_fm = t(cf, cso, dt=torch.float32) if cf else None
    return se, skip, xc, disp, bias, k_fm


def within(got, want, rtol, atol):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def same_as_plain(got, want):
    """The decoder glue's tensors against their plain versions: bf16 bit
    for bit (each operation rounded on its own, as the plain version does
    it); f32 within ``F32_TOL`` (expm1 and the card's f32 paths may differ
    by an ulp)."""
    if got.dtype == torch.bfloat16:
        return torch.equal(got, want)
    return within(got, want, **F32_TOL)


def check_assemble_z():
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble_z, assemble_z_plain)

    worst = 0.0
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES + OPTION_GLUE_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_disp in (True, False) if cd else (False,):
                args = assemble_z_inputs(SEED + h, SMOKE_BATCH, h, w, cso, cu,
                                         cd if with_disp else 0, cf, dtype)
                cat, mean = assemble_z(*args)
                torch.cuda.synchronize()
                ref_cat, ref_mean = assemble_z_plain(*args)
                err_cat = (cat.float() - ref_cat.float()).abs().max().item()
                err_mean = (mean - ref_mean).abs().max().item()
                ok = (same_as_plain(cat, ref_cat)
                      and within(mean, ref_mean, MEAN_RTOL, 1e-5))
                log(f"  assemble_z {name} {str(dtype)[6:]:8s} "
                    f"disp={with_disp!s:5s} fold={bool(cf)!s:5s} "
                    f"max|cat err|={err_cat:.3g} max|mean err|={err_mean:.3g} "
                    f"{'ok' if ok else 'DISAGREES'}")
                if not ok:
                    fail(f"assemble_z kernel disagrees with its plain version "
                         f"at {name} {dtype} disp={with_disp}")
                worst = max(worst, err_cat, err_mean)
    log(f"tolerances: f32 cat rtol {F32_TOL['rtol']} atol {F32_TOL['atol']}; "
        f"bf16 cat bit for bit; mean rtol {MEAN_RTOL}")
    return worst


def warp_shapes(batch):
    """(rows, W, C) of each ``warp_rows`` problem of a training step, with
    its count per step: at each of the 4 pyramid scales the reconstruction
    warps image + opposite disparity (C 4) and the uncertainty term warps
    the disparity (C 1), once per view."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT

    h, w = FLAGSHIP_INPUT
    return [(batch * (h >> i), w >> i, c, 2) for c in (4, 1) for i in range(4)]


def warp_groups(batch):
    """The ``warp_rows`` launches of a training step, each way: (name,
    [(rows, W), ...], C).  ``reconstruct_pyramid_with_lr`` warps all 8
    reconstruction problems (4 scales x 2 views, C 4) in one launch; the
    uncertainty term's ``consistency_loss`` warps its 2 views (C 1) in one
    launch per scale."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT

    h, w = FLAGSHIP_INPUT
    scales = [(batch * (h >> i), w >> i) for i in range(4)]
    return ([("recon", [p for p in scales for _ in range(2)], 4)]
            + [(f"consistency{i}", [p] * 2, 1)
               for i, p in enumerate(scales)])


def eval_warp_group(batch):
    """The evaluation's one ``warp_rows`` launch a batch: both views of the
    full-scale images (C 3)."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT

    h, w = FLAGSHIP_INPUT
    return (f"eval_b{batch}", [(batch * h, w)] * 2, 3)


def cli_eval_sizes():
    """The batch sizes of the CLI phase's evaluation, in order: full
    batches of ``TRAIN_BATCH`` and a partial last one (``drop_last=False``)."""
    sizes = [TRAIN_BATCH] * (CLI_TEST_PAIRS // TRAIN_BATCH)
    if CLI_TEST_PAIRS % TRAIN_BATCH:
        sizes.append(CLI_TEST_PAIRS % TRAIN_BATCH)
    return sizes


def warp_inputs(seed, rows, w, c):
    """x over [-0.3 W - 1, 1.3 W + 1] (outside [0, W) included) with a third
    of it on integers, src and a cotangent, on the card."""
    rng = card_rng(seed)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((rows, w), generator=rng,
                                           device="cuda", dtype=torch.float64)

    x = uniform(-0.3 * w - 1, 1.3 * w + 1)
    x = torch.where(uniform(0.0, 1.0) < 1 / 3, x.round(), x).float()
    return x, normal(rng, rows, w, c), normal(rng, rows, w, c)


def group_inputs(seed, problems, c):
    """``warp_inputs`` of each problem of a group: (xs, srcs, douts)."""
    sets = [warp_inputs(seed + k, rows, w, c)
            for k, (rows, w) in enumerate(problems)]
    return tuple([s[i] for s in sets] for i in range(3))


def check_warp_rows():
    """Each direction of ``warp_rows`` against its plain version at the
    groups a training step launches (``warp_groups``) and at the
    evaluation's (``eval_warp_group``) for every evaluation batch size the
    main path gives it (``EVAL_BATCH`` and the CLI's partial last batch),
    one launch each way a group; returns the worst abs error of each."""
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_bwd_many, warp_rows_bwd_plain,
        warp_rows_fwd, warp_rows_fwd_many, warp_rows_plain)

    worst = {"fwd": 0.0, "bwd": 0.0}
    for k, (name, problems, c) in enumerate(
            warp_groups(TRAIN_BATCH)
            + [eval_warp_group(b)
               for b in sorted({EVAL_BATCH, *cli_eval_sizes()},
                               reverse=True)]):
        xs, srcs, douts = group_inputs(SEED + 10 * k, problems, c)
        before = (warp_rows_fwd.launches, warp_rows_bwd.launches)
        outs = warp_rows_fwd_many(xs, srcs)
        dxs, dsrcs = warp_rows_bwd_many(xs, srcs, douts)
        torch.cuda.synchronize()
        if (warp_rows_fwd.launches - before[0],
                warp_rows_bwd.launches - before[1]) != (1, 1):
            fail(f"warp_rows group {name} took more than one launch")
        for x, src, dout, out, dx, dsrc in zip(xs, srcs, douts, outs, dxs,
                                               dsrcs):
            ref = warp_rows_plain(x, src)
            ref_dx, ref_dsrc = warp_rows_bwd_plain(x, src, dout)
            _, dsrc_abs = warp_rows_bwd_plain(x, src, dout.abs())
            err = (out - ref).abs().max().item()
            err_dx = (dx - ref_dx).abs().max().item()
            err_dsrc = (dsrc - ref_dsrc).abs()
            ok = (within(out, ref, **F32_TOL)
                  and within(dx, ref_dx, **F32_TOL)
                  and bool((err_dsrc <= DSRC_TOL * (1 + dsrc_abs)).all()))
            err_dsrc = err_dsrc.max().item()
            rows, w = x.shape
            log(f"  warp_rows group {name} ({rows}, {w}, {c}): max|out err|="
                f"{err:.3g} max|dx err|={err_dx:.3g} max|dsrc err|="
                f"{err_dsrc:.3g} {'ok' if ok else 'DISAGREES'}")
            if not ok:
                fail(f"warp_rows kernels disagree with their plain versions "
                     f"in group {name} at ({rows}, {w}, {c})")
            worst["fwd"] = max(worst["fwd"], err)
            worst["bwd"] = max(worst["bwd"], err_dx, err_dsrc)
        del xs, srcs, douts, outs, dxs, dsrcs
    log(f"tolerances: out and dx rtol {F32_TOL['rtol']} atol "
        f"{F32_TOL['atol']}; dsrc (shared-memory atomics, any order) "
        f"{DSRC_TOL} * (1 + sum of its terms' magnitudes)")
    return worst


def decoder_gates(seed, b, cso, dtype):
    """SE gates in (0, 1), as the SE MLP's sigmoid gives them."""
    g = torch.rand((b, cso), generator=card_rng(seed), device="cuda")
    return (0.05 + 0.95 * g).to(dtype)


def check_decoder_glue():
    """``gate_z``, ``se_squeeze`` and ``assemble`` against their plain
    versions at the fused stages' shapes; on the card, ``assemble(g)``
    equals ``gate_z(assemble_z(), g)`` bit for bit and ``gate_z`` leaves the
    channels >= Cso untouched.  Returns the worst abs error of each."""
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble, assemble_plain, assemble_z, gate_z, gate_z_plain,
        se_squeeze, se_squeeze_plain)

    worst = {"gate_z": 0.0, "se_squeeze": 0.0, "assemble": 0.0}
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES + OPTION_GLUE_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_disp in (True, False) if cd else (False,):
                args = assemble_z_inputs(SEED + h + 1, SMOKE_BATCH, h, w, cso,
                                         cu, cd if with_disp else 0, cf, dtype)
                se, skip, xc, disp, bias, k_fm = args
                gates = decoder_gates(SEED + h, SMOKE_BATCH, cso, dtype)
                mean = se_squeeze(se, skip, bias, k_fm)
                cat = assemble(se, skip, gates, xc, disp, bias, k_fm)
                cat_z, _ = assemble_z(*args)
                ungated = cat_z.clone()
                gated = gate_z(cat_z, gates, cso)
                torch.cuda.synchronize()
                ref_mean = se_squeeze_plain(se, skip, bias, k_fm)
                ref_cat = assemble_plain(se, skip, gates, xc, disp, bias, k_fm)
                ref_gated = gate_z_plain(ungated.clone(), gates, cso)
                errs = {
                    "gate_z": (gated.float() - ref_gated.float()).abs().max().item(),
                    "se_squeeze": (mean - ref_mean).abs().max().item(),
                    "assemble": (cat.float() - ref_cat.float()).abs().max().item(),
                }
                ok = (same_as_plain(gated, ref_gated)
                      and within(mean, ref_mean, MEAN_RTOL, 1e-5)
                      and same_as_plain(cat, ref_cat))
                untouched = torch.equal(gated[..., cso:], ungated[..., cso:])
                composed = torch.equal(cat, gated)
                # channels >= Cso hold NaN: gate_z must not store there at
                # all, not even the value it read
                sentinel = ungated.clone()
                sentinel[..., cso:] = float("nan")
                gate_z(sentinel, gates, cso)
                unwritten = (bool(sentinel[..., cso:].isnan().all())
                             and torch.equal(sentinel[..., :cso],
                                             gated[..., :cso]))
                good = ok and untouched and composed and unwritten
                log(f"  {name} {str(dtype)[6:]:8s} disp={with_disp!s:5s} "
                    f"fold={bool(cf)!s:5s} max|err| gate_z {errs['gate_z']:.3g}"
                    f" se_squeeze {errs['se_squeeze']:.3g} assemble "
                    f"{errs['assemble']:.3g}; channels >= Cso untouched "
                    f"{untouched}, unwritten {unwritten}; assemble == "
                    f"gate_z(assemble_z) {composed} "
                    f"{'ok' if good else 'DISAGREES'}")
                if not good:
                    fail(f"decoder glue kernels disagree at {name} {dtype} "
                         f"disp={with_disp}")
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
    log(f"tolerances: f32 rtol {F32_TOL['rtol']} atol {F32_TOL['atol']}; bf16 "
        f"gate_z and assemble bit for bit; se_squeeze mean rtol {MEAN_RTOL}")
    return worst


def gated_conv_inputs(seed, b, h, w, c, k, n, dtype):
    """``n`` zero-padded (B, H+2p, W+2p, C) inputs, sigmoid gates, an HWIO
    kernel scaled to keep the output O(1), an f32 bias, on the card."""
    import torch.nn.functional as F

    rng = card_rng(seed)
    p = (k - 1) // 2

    def t(*shape, scale=1.0, dt=dtype):
        return normal(rng, *shape, scale=scale, dtype=dt)

    xs = [F.pad(t(b, h, w, c), (0, 0, p, p, p, p)) for _ in range(n)]
    gates = torch.sigmoid(t(n, dt=torch.float32))
    return xs, gates, t(k, k, c, c, scale=(k * k * c) ** -0.5), \
        t(c, scale=0.1, dt=torch.float32)


def check_gated_conv_elu():
    """``gated_conv_elu`` against its plain version at the s2d stages'
    (stage, inputs) shapes; returns the worst abs error."""
    from uncertainty_model_tpu_torch.ops.conv import (
        conv_magnitude, gated_conv_elu, gated_conv_elu_plain)

    worst = 0.0
    for name, h, w, c, k in S2D_CONV_STAGES:
        for n in GATED_INPUTS:
            for dtype in (torch.bfloat16, torch.float32):
                args = gated_conv_inputs(SEED + 10 * n + h, SMOKE_BATCH, h, w,
                                         c, k, n, dtype)
                out = gated_conv_elu(*args)
                torch.cuda.synchronize()
                ref = gated_conv_elu_plain(*args)
                err = (out.float() - ref.float()).abs()
                if dtype == torch.bfloat16:
                    ok = within(out, ref, **BF16_TOL)
                else:
                    terms = conv_magnitude(*args[:3])
                    ok = bool((err <= CONV_F32_TOL * (1 + terms)).all())
                err = err.max().item()
                log(f"  gated_conv_elu {name} n={n} {str(dtype)[6:]:8s} "
                    f"{tuple(out.shape)}: max|err|={err:.3g} "
                    f"{'ok' if ok else 'DISAGREES'}")
                if not ok:
                    fail(f"gated_conv_elu kernel disagrees with its plain "
                         f"version at {name} n={n} {dtype}")
                worst = max(worst, err)
                del args, out, ref
    log(f"tolerances: bf16 rtol 2^-7 atol {BF16_TOL['atol']} (the matrix "
        f"operands equal the plain version's; only the f32 sum's order "
        f"differs); f32 {CONV_F32_TOL} * (1 + sum of the terms' magnitudes), "
        f"for sums of up to 3,200 terms in another order")
    return worst


def conv_elu_inputs(seed, b, h, w, c, k, dtype):
    """Unpadded (B, H, W, C) input, an HWIO kernel scaled to keep the
    output O(1) and an f32 bias, on the card."""
    rng = card_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return normal(rng, *shape, scale=scale, dtype=dt)

    return (t(b, h, w, c), t(k, k, c, c, scale=(k * k * c) ** -0.5),
            t(c, scale=0.1, dt=torch.float32))


def check_conv_elu():
    """``conv_elu`` against its plain version at the native encoder's
    interior conv shapes at batch ``TIMING_BATCH``; returns the worst abs
    error."""
    import torch.nn.functional as F

    from uncertainty_model_tpu_torch.ops.conv import (
        conv_elu, conv_elu_plain, conv_magnitude)

    worst = 0.0
    for name, h, w, c, k in NATIVE_CONV_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            args = conv_elu_inputs(SEED + 60 + k, TIMING_BATCH, h, w, c, k,
                                   dtype)
            out = conv_elu(*args)
            torch.cuda.synchronize()
            ref = conv_elu_plain(*args)
            err = (out.float() - ref.float()).abs()
            if dtype == torch.bfloat16:
                ok = within(out, ref, **BF16_TOL)
            else:
                p = (k - 1) // 2
                terms = conv_magnitude([F.pad(args[0], (0, 0, p, p, p, p))],
                                       torch.ones(1, device="cuda"), args[1])
                ok = bool((err <= CONV_F32_TOL * (1 + terms)).all())
                del terms
            err = err.max().item()
            log(f"  conv_elu {name} {str(dtype)[6:]:8s} {tuple(out.shape)}: "
                f"max|err|={err:.3g} {'ok' if ok else 'DISAGREES'}")
            if not ok:
                fail(f"conv_elu kernel disagrees with its plain version at "
                     f"{name} {dtype}")
            worst = max(worst, err)
            del args, out, ref
    torch.cuda.empty_cache()
    log(f"tolerances: bf16 rtol 2^-7 atol {BF16_TOL['atol']}; f32 "
        f"{CONV_F32_TOL} * (1 + sum of the terms' magnitudes)")
    return worst


def upsample_input(seed, b, h, w, c, dtype):
    return normal(card_rng(seed), b, h, w, c, dtype=dtype)


def check_upsample2x2():
    """``upsample2x2`` against its plain version at the upsample sites at
    batch ``TIMING_BATCH``; returns the worst abs error."""
    from uncertainty_model_tpu_torch.ops.upsample import (
        upsample2x2, upsample2x2_plain)

    worst = 0.0
    for name, h, w, c in UPSAMPLE_SITES:
        for dtype in (torch.bfloat16, torch.float32):
            x = upsample_input(SEED + h, TIMING_BATCH, h, w, c, dtype)
            out = upsample2x2(x)
            torch.cuda.synchronize()
            ref = upsample2x2_plain(x)
            err = (out.float() - ref.float()).abs().max().item()
            ok = within(out, ref, **(BF16_TOL if dtype == torch.bfloat16
                                     else F32_TOL))
            log(f"  upsample2x2 {name} {str(dtype)[6:]:8s} {tuple(out.shape)}:"
                f" max|err|={err:.3g} bit for bit {torch.equal(out, ref)} "
                f"{'ok' if ok else 'DISAGREES'}")
            if not ok:
                fail(f"upsample2x2 kernel disagrees with its plain version "
                     f"at {name} {dtype}")
            worst = max(worst, err)
            del x, out, ref
    torch.cuda.empty_cache()
    log(f"tolerances: f32 rtol {F32_TOL['rtol']} atol {F32_TOL['atol']}; "
        f"bf16 rtol 2^-7 atol {BF16_TOL['atol']}")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------


def flagship_model():
    """The flagship eval model with random weights from ``SEED`` and
    BatchNorm statistics and gate weights drawn from a numpy seed (so that
    BN folding and the gates are exercised)."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_MODEL
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel

    model = RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL, seed=SEED,
                                               device="cuda").eval()
    rng = np.random.default_rng(SEED)

    def draw(t, values):
        t.copy_(torch.from_numpy(values.astype(np.float32)).to(t.device))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                draw(m.running_mean, rng.normal(0.0, 0.1, n))
                draw(m.running_var, rng.uniform(0.5, 1.5, n))
                draw(m.weight, rng.uniform(0.8, 1.2, n))
                draw(m.bias, rng.normal(0.0, 0.1, n))
        for key, p in model.named_parameters():
            if key.endswith("mean_weight"):
                draw(p, rng.normal(0.0, 1.0, p.shape))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship model: {n_params:,} parameters")
    return model


def images(batch, seed):
    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(batch, *FLAGSHIP_INPUT, 3)).astype(np.float32)
    return torch.from_numpy(x).to("cuda")


def run_main_path(model, counters):
    """The bench path's bf16 and f32 forwards at batch 8; returns
    (launches, forward, x, f32 eval model output)."""
    from uncertainty_model_tpu_torch.serving import make_serving_forward

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = images(SMOKE_BATCH, SEED + 1)
    with torch.no_grad():
        ref = model(x.permute(0, 3, 1, 2), disp_scale=1.0)[0]
    ref = ref.permute(0, 2, 3, 1).float()

    forward = make_serving_forward(model, dtype=torch.bfloat16)
    for fn in counters.values():
        fn.launches = 0
    out = forward(x)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}

    log(f"main path: bf16 serving forward {tuple(x.shape)} -> "
        f"{tuple(out.shape)} {out.dtype}; launches {launches}")
    if tuple(out.shape) != (SMOKE_BATCH, *x.shape[1:3], 4):
        fail(f"output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail("non-finite output")
    if launches["assemble_z"] != 3:
        fail(f"assemble_z launched {launches['assemble_z']} times, not 3")
    if any(n for name, n in launches.items() if name != "assemble_z"):
        fail(f"the bench path launched other kernels: {launches}")
    err_bf16 = (out.float() - ref).abs().max().item()
    log(f"  bf16 serving vs f32 eval model: max abs {err_bf16:.4g} "
        f"(limit {BF16_VS_F32_EVAL})")
    if not err_bf16 <= BF16_VS_F32_EVAL:
        fail("bf16 serving forward is not close to the f32 eval model")

    out32 = make_serving_forward(model, dtype=torch.float32)(x)
    err_f32 = (out32 - ref).abs().max().item()
    log(f"  f32 serving vs f32 eval model (TF32 off): max abs {err_f32:.4g} "
        f"(limit {F32_VS_F32_EVAL})")
    if not err_f32 <= F32_VS_F32_EVAL:
        fail("f32 serving forward is not close to the f32 eval model")
    log(f"  output range [{out.float().min().item():.4f}, "
        f"{out.float().max().item():.4f}]")
    return launches, forward, x, ref


def run_paths(model, counters, x, ref, paths):
    """The forwards of ``paths`` (``S2D_PATHS``: (a), (b), (c); or
    ``OPTION_PATHS``) at batch 8 on ``x``: bf16, counters zeroed just
    before and read just after, each count as listed; then f32 (TF32
    off).  Both are held against the f32 eval model's ``ref``.  Returns
    ({path: bf16 forward}, {path: launches}, {path: (bf16 err, f32
    err)})."""
    from uncertainty_model_tpu_torch.serving import make_serving_forward

    forwards, launches, errs = {}, {}, {}
    for key, (options, expected) in paths.items():
        forward = make_serving_forward(model, dtype=torch.bfloat16, **options)
        for fn in counters.values():
            fn.launches = 0
        out = forward(x)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        log(f"path ({key}) {options}: bf16 forward {tuple(x.shape)} -> "
            f"{tuple(out.shape)}; launches {got}")
        if got != {name: expected.get(name, 0) for name in counters}:
            fail(f"path ({key}) launched {got}, not {expected}")
        if tuple(out.shape) != tuple(ref.shape) or not torch.isfinite(out).all():
            fail(f"path ({key}) output {tuple(out.shape)} is not finite or "
                 "not of the eval model's shape")
        err_bf16 = (out.float() - ref).abs().max().item()
        out32 = make_serving_forward(model, dtype=torch.float32, **options)(x)
        err_f32 = (out32 - ref).abs().max().item()
        log(f"  vs the f32 eval model: bf16 max abs {err_bf16:.4g} (limit "
            f"{BF16_VS_F32_EVAL}), f32 max abs {err_f32:.4g} (limit "
            f"{F32_VS_F32_EVAL})")
        if not (err_bf16 <= BF16_VS_F32_EVAL and err_f32 <= F32_VS_F32_EVAL):
            fail(f"path ({key}) is not close to the f32 eval model")
        forwards[key], launches[key], errs[key] = forward, got, (err_bf16,
                                                                 err_f32)
        del out32
    return forwards, launches, errs


# ---------------------------------------------------------------------------
# phase 3b: the training path
# ---------------------------------------------------------------------------


def stereo_batch(batch, seed, device="cuda"):
    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT
    rng = np.random.default_rng(seed)
    return {side: torch.from_numpy(rng.uniform(
        size=(batch, *FLAGSHIP_INPUT, 3)).astype(np.float32)).to(device)
        for side in ("left", "right")}


def flagship_trainer(seed, device="cuda", dtype=None, distributed=False,
                     s2d_stages=()):
    """The flagship in train mode from ``seed`` with ``FLAGSHIP_LOSS``,
    computing in ``dtype`` (None: f32); ``distributed``: DDP in the
    process group (phase 3g); ``s2d_stages``: the encoder stages on the
    space-to-depth grid (phase 3h; the same weights)."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_LOSS, FLAGSHIP_MODEL
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
    from uncertainty_model_tpu_torch.train import Trainer

    model = RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL, dtype=dtype,
                                               seed=seed, device=device,
                                               s2d_stages=s2d_stages).train()
    return Trainer(model, FLAGSHIP_LOSS, device=device,
                   distributed=distributed)


def run_training_path(counters, dtype=None, distributed=False,
                      s2d_stages=()):
    """``train_one_epoch`` over ``TRAIN_STEPS`` repeats of one batch, the
    losses read after every step, the model computing in ``dtype`` (None:
    f32) with ``s2d_stages``; every ``warp_rows`` counter must grow by its
    launches a step, every other by none.  Returns (trainer, batch,
    disp_scale, launches)."""
    from uncertainty_model_tpu_torch.utils.schedules import adjust_disparity

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    disp_scale = adjust_disparity(0)
    trainer = flagship_trainer(SEED, dtype=dtype, distributed=distributed,
                               s2d_stages=s2d_stages)
    batch = stereo_batch(TRAIN_BATCH, SEED + 4)
    seen = []

    def progress(averages):
        seen.append(({k: fn.launches for k, fn in counters.items()},
                     averages["disp"] + averages["unc"]))

    for fn in counters.values():
        fn.launches = 0
    trainer.train_one_epoch([batch] * TRAIN_STEPS, disp_scale, TRAIN_LR,
                            progress=progress, metrics_every=1)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}

    # averages are running sums of batch means over the images so far:
    # step i's total loss is the difference of two of them, times the batch
    losses, previous = [], 0.0
    for i, (_, avg) in enumerate(seen):
        losses.append((avg * (i + 1) - previous) * TRAIN_BATCH)
        previous = avg * (i + 1)
    log(f"training path: flagship {dtype_name(dtype)}"
        f"{' DDP' if distributed else ''}"
        f"{f' s2d_stages={s2d_stages}' if s2d_stages else ''} b{TRAIN_BATCH} "
        f"256x512, disp_scale {disp_scale}, lr {TRAIN_LR}: total loss per "
        "step " + ", ".join(f"{v:.6f}" for v in losses)
        + f"; launches {launches}")
    if len(seen) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"training losses {losses}")
    per_step = len(warp_groups(TRAIN_BATCH))
    for i, (counts, _) in enumerate(seen):
        for name, n in counts.items():
            want = per_step * (i + 1) if name.startswith("warp_rows") else 0
            if n != want:
                fail(f"{name} launched {n} times in {i + 1} steps, not "
                     f"{want}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    return trainer, batch, disp_scale, launches


def dtype_name(dtype):
    return "f32" if dtype is None else str(dtype).removeprefix("torch.")


def step_disparities(trainer, batch, disp_scale):
    """The train-mode forward's NHWC f32 disparities, as the step takes
    them (with their graph to the parameters; through DDP's wrapper where
    the trainer has one)."""
    trainer.model.train()
    model = trainer.model if trainer.ddp_model is None else trainer.ddp_model
    left = batch["left"].to(trainer.device)
    return [d.permute(0, 2, 3, 1).float() for d in
            model(left.permute(0, 3, 1, 2), disp_scale=disp_scale)]


def loss_grad(trainer, batch, disparities):
    """The step's loss from the given disparities, and its gradient in
    them (on the CPU)."""
    from uncertainty_model_tpu_torch.ops import (
        reconstruct_pyramid_with_lr, scale_pyramid)

    dev = trainer.device
    images = torch.cat([batch["left"], batch["right"]], -1).to(dev)
    pyramid = scale_pyramid(images, trainer.scales)
    ds = [d.detach().to(dev).requires_grad_() for d in disparities]
    recon, lr = reconstruct_pyramid_with_lr(ds, pyramid)
    disp_loss, error_loss = trainer.loss(pyramid, ds, recon, lr_pyramid=lr)
    return [g.cpu() for g in torch.autograd.grad(disp_loss + error_loss, ds)]


def model_grads(trainer, batch, disp_scale, cotangents, se_seen=None):
    """Each parameter's gradient (on the CPU) of the forward, driven back
    from the disparities by the given cotangents.  A list ``se_seen``
    receives, per decoder stage, its SE layer's input ``x`` and output
    gradient ``dy`` in this forward and backward (on the CPU)."""
    handles = []
    if se_seen is not None:
        def hook(seen):
            def forward(module, args, out):
                seen["x"] = args[0].detach().cpu()
                out.register_hook(
                    lambda g: seen.__setitem__("dy", g.detach().cpu()))
            return forward
        for stage in trainer.model.decoder.layers:
            se_seen.append({})
            handles.append(stage.squeeze_excite[1].register_forward_hook(
                hook(se_seen[-1])))
    trainer.model.zero_grad(set_to_none=True)
    disparities = step_disparities(trainer, batch, disp_scale)
    torch.autograd.backward(disparities,
                            [c.to(trainer.device) for c in cotangents])
    for h in handles:
        h.remove()
    return {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}


def grad_check(got, want, worst=None):
    """(worst |diff| / limit, median relative |diff|) over the parameters,
    limit = max(GRAD_REL |g|, GRAD_FLOOR); a list ``worst`` receives the
    three worst (share, relative |diff|, name)."""
    rows = []
    for name, ref in want.items():
        ref = ref.double()
        diff = (got[name].double() - ref).norm().item()
        rows.append((diff / max(GRAD_REL * ref.norm().item(), GRAD_FLOOR),
                     diff / max(ref.norm().item(), 1e-30), name))
    if worst is not None:
        worst.extend(sorted(rows, reverse=True)[:3])
    return (max(r[0] for r in rows),
            float(np.median([r[1] for r in rows])))


def check_step_against_cpu(disp_scale):
    """One step at batch ``CPU_CHECK_BATCH`` on the card against the same
    step on the CPU (the plain versions), same weights and batch.

    The losses are held within ``LOSS_RTOL``.  The gradient is the chain
    dL/dparams = (dD/dparams)^T dL/dD through the disparities D, and each
    link is held on its own: the loss's gradient dL/dD at the same
    disparities (the warp kernels and losses) within ``LOSS_GRAD_REL`` of
    its norm per scale, and the model's backward of the same cotangent
    within max(GRAD_REL |g|, GRAD_FLOOR) per parameter.  The whole step's
    gradients are held by their median relative difference, within
    ``WHOLE_STEP_MEDIAN_REL``, not per parameter: the card's disparities
    differ from the CPU's by rounding (about 1e-6), that moves x by 1e-3
    pixels, and the bilinear warp's slope jumps where x crosses an integer
    and the L1 terms' signs flip where a residual crosses 0, so dL/dD
    itself moves by about 1% for that rounding on the CPU alone (logged
    below)."""
    cpu = flagship_trainer(SEED + 5, device="cpu")
    card = flagship_trainer(SEED + 5)
    batch = stereo_batch(CPU_CHECK_BATCH, SEED + 6, device="cpu")
    t0 = time.perf_counter()
    want = cpu.train_step(batch, disp_scale, 0.0)
    cpu_s = time.perf_counter() - t0
    got = card.train_step(batch, disp_scale, 0.0)
    torch.cuda.synchronize()
    result = {"loss_rel": 0.0}
    for key in want:
        w, g = want[key].item(), got[key].item()
        rel = abs(g - w) / abs(w)
        result["loss_rel"] = max(result["loss_rel"], rel)
        log(f"  {key}: card {g:.7f} cpu {w:.7f} (rel {rel:.3g}, limit "
            f"{LOSS_RTOL})")
        if not rel <= LOSS_RTOL:
            fail(f"card step {key} differs from the CPU step")
    cpu_grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    share, median = grad_check(
        {n: p.grad.cpu() for n, p in card.model.named_parameters()},
        cpu_grads)
    result.update(whole_step_worst_share=share, whole_step_median_rel=median)
    log(f"  whole step, card vs CPU gradients: median relative {median:.3g} "
        f"(limit {WHOLE_STEP_MEDIAN_REL}); worst at {share:.3g} of "
        f"max({GRAD_REL} |g|, {GRAD_FLOOR}) (reported)")
    if not median <= WHOLE_STEP_MEDIAN_REL:
        fail("the card step's gradients differ from the CPU step's")

    with torch.no_grad():
        d_cpu = step_disparities(cpu, batch, disp_scale)
        d_card = step_disparities(card, batch, disp_scale)
    result["disparity_max_abs"] = max((a - b.cpu()).abs().max().item()
                                      for a, b in zip(d_cpu, d_card))
    cot = loss_grad(cpu, batch, d_cpu)
    moved = loss_grad(cpu, batch, [d.cpu() for d in d_card])
    result["cpu_loss_grad_rel_at_card_disparities"] = [
        ((a - b).norm() / a.norm()).item() for a, b in zip(cot, moved)]
    log(f"  disparities card vs CPU: max abs {result['disparity_max_abs']:.3g}; "
        f"the CPU's dL/dD at the card's disparities moves by "
        + ", ".join(f"{v:.3g}" for v in
                    result["cpu_loss_grad_rel_at_card_disparities"])
        + " (relative, per scale)")

    card_cot = loss_grad(card, batch, d_cpu)
    result["loss_grad_rel"] = [((a - b).norm() / a.norm()).item()
                               for a, b in zip(card_cot, cot)]
    log(f"  dL/dD at the same disparities, card vs CPU: "
        + ", ".join(f"{v:.3g}" for v in result["loss_grad_rel"])
        + f" (relative, per scale; limit {LOSS_GRAD_REL})")
    if not max(result["loss_grad_rel"]) <= LOSS_GRAD_REL:
        fail("the card's loss gradient differs from the CPU's")

    convs = stage_convs(cpu.model.encoder.layers, 1)
    cpu_backward = {}
    convs_io = capture_conv_io(convs, lambda: cpu_backward.update(
        grads=model_grads(cpu, batch, disp_scale, cot)))
    worst = []
    share, median = grad_check(model_grads(card, batch, disp_scale, cot),
                               cpu_backward["grads"], worst)
    result.update(model_backward_worst_share=share,
                  model_backward_median_rel=median,
                  model_backward_worst=[n for _, _, n in worst])
    log(f"  model backward of the same dL/dD, card vs CPU: worst at "
        f"{share:.3g} of max({GRAD_REL} |g|, {GRAD_FLOOR}), median relative "
        f"{median:.3g}; CPU step {cpu_s:.1f} s; the worst: " + "; ".join(
            f"{n} at {sh:.3g} (relative {r:.3g})" for sh, r, n in worst))
    result["encoder_stage1_wgrad_vs_f64"], problems = wgrad_links(
        convs_io, convs, "the encoder's stage 1")
    if not share < 1:
        problems.append("the card's model backward differs from the CPU's")
    if problems:
        fail("; ".join(problems))
    return result, cpu_grads


# ---------------------------------------------------------------------------
# phase 3c: evaluation and checkpoints
# ---------------------------------------------------------------------------


def adjust_scale():
    """The disparity scale of the first epoch, at which evaluation runs."""
    from uncertainty_model_tpu_torch.utils.schedules import adjust_disparity
    return adjust_disparity(0)


def eval_batches(batch, seed, n=EVAL_BATCHES, device="cuda"):
    return [stereo_batch(batch, seed + i, device) for i in range(n)]


def run_evaluation(counters):
    """``evaluate_model`` of the flagship at batch ``EVAL_BATCH`` over
    ``EVAL_BATCHES`` seeded batches, the counters zeroed just before and
    read just after (1 ``warp_rows`` forward launch a batch, nothing
    else); the metrics must be finite.  Returns (model, loader, metrics,
    launches)."""
    from uncertainty_model_tpu_torch.train import evaluate_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = flagship_trainer(SEED + 20).model
    loader = eval_batches(EVAL_BATCH, SEED + 21)
    for fn in counters.values():
        fn.launches = 0
    metrics = evaluate_model(model, loader, scale=adjust_scale(), no_pbar=True)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"evaluation: flagship f32 b{EVAL_BATCH} 256x512 x{EVAL_BATCHES}: "
        f"ssim (left, right) {metrics[0]}, (ause, aurg) {metrics[1]}; "
        f"launches {launches}")
    want = {name: EVAL_BATCHES if name == "warp_rows_fwd" else 0
            for name in counters}
    if launches != want:
        fail(f"evaluation launched {launches}, not {want}")
    if not np.isfinite(np.ravel(metrics)).all():
        fail(f"evaluation metrics {metrics}")
    return model, loader, metrics, launches


def check_eval_step_against_cpu():
    """One ``eval_step`` at batch ``CPU_CHECK_BATCH`` on the card against
    the same step on the CPU (the plain versions), same weights, inputs and
    noise: SSIM sums within ``EVAL_SSIM_RTOL``, AUSE and AURG within
    ``SPARS_ATOL``."""
    from uncertainty_model_tpu_torch.train import eval_step

    cpu = flagship_trainer(SEED + 22, device="cpu").model
    card = flagship_trainer(SEED + 22).model
    batch = stereo_batch(CPU_CHECK_BATCH, SEED + 23, device="cpu")
    noise = torch.from_numpy(np.random.default_rng(SEED + 24).uniform(
        size=(CPU_CHECK_BATCH, *batch["left"].shape[1:3], 2)).astype(
            np.float32))
    t0 = time.perf_counter()
    want, _ = eval_step(cpu, batch, adjust_scale(), noise)
    cpu_s = time.perf_counter() - t0
    got, _ = eval_step(card, batch, adjust_scale(), noise)
    result = {}
    for key in want:
        w, g = want[key].item(), got[key].item()
        ok = (abs(g - w) <= EVAL_SSIM_RTOL * abs(w) if key.endswith("ssim")
              else abs(g - w) <= SPARS_ATOL)
        result[key] = {"card": g, "cpu": w, "abs": abs(g - w)}
        log(f"  eval step {key}: card {g:.7f} cpu {w:.7f} (abs {abs(g - w):.3g}"
            f", rel {abs(g - w) / max(abs(w), 1e-30):.3g}) "
            f"{'ok' if ok else 'DISAGREES'}")
        if not ok:
            fail(f"the card's eval step {key} differs from the CPU's")
    log(f"  limits: ssim rtol {EVAL_SSIM_RTOL}, ause/aurg atol {SPARS_ATOL}; "
        f"CPU eval step {cpu_s:.1f} s")
    return result


def run_train_model_with_checkpoints(counters, val_loader):
    """``Trainer.train_model`` for 2 epochs of 2 batches at batch
    ``TRAIN_BATCH`` with an evaluation and a checkpoint every epoch (5 + 5
    ``warp_rows`` launches a step, 1 forward a validation batch); then
    ``final`` loaded into a fresh trainer must hold the same parameters,
    BatchNorm statistics and Adam moments (``torch.equal``)."""
    import os
    import tempfile

    from uncertainty_model_tpu_torch.train import load_checkpoint

    epochs, steps = 2, 2
    trainer = flagship_trainer(SEED + 25)
    loader = eval_batches(TRAIN_BATCH, SEED + 26, n=steps)
    per_step = len(warp_groups(TRAIN_BATCH))
    with tempfile.TemporaryDirectory() as tmp:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses, metrics = trainer.train_model(
            loader, epochs, TRAIN_LR, val_loader=val_loader, evaluate_every=1,
            save_every=1, save_model_to=tmp, no_pbar=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        names = sorted(os.listdir(tmp))
        want = {"warp_rows_fwd": epochs * (steps * per_step
                                           + len(val_loader)),
                "warp_rows_bwd": epochs * steps * per_step}
        log(f"train_model: {epochs} epochs x {steps} batches, b{TRAIN_BATCH}, "
            f"{seconds:.1f} s: losses {losses}; validation {metrics}; "
            f"checkpoints {names}; launches {launches}")
        if launches != {**dict.fromkeys(counters, 0), **want}:
            fail(f"train_model launched {launches}, not {want}")
        if names != ["epoch_001", "epoch_002", "final"]:
            fail(f"train_model wrote {names}")
        values = [v for d, u, _ in losses for v in (d, u)]
        if len(metrics) != epochs or not np.isfinite(
                values + np.ravel(metrics).tolist()).all():
            fail(f"train_model losses {losses} or metrics {metrics}")
        fresh = flagship_trainer(SEED + 27)
        fresh.load_state(*load_checkpoint(os.path.join(tmp, "final")))
    same_params = all(torch.equal(a, b) for a, b in zip(
        trainer.model.state_dict().values(), fresh.model.state_dict().values()))
    sa, sb = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    same_moments = sa["state"].keys() == sb["state"].keys() and all(
        torch.equal(sa["state"][i][k], sb["state"][i][k])
        for i in sa["state"] for k in ("step", "exp_avg", "exp_avg_sq"))
    log(f"  final reloaded into a fresh trainer: parameters and statistics "
        f"equal {same_params}, Adam moments equal {same_moments}")
    if not (same_params and same_moments):
        fail("the final checkpoint does not restore the trained state")
    return {"seconds": seconds, "losses": losses, "metrics": metrics,
            "launches": launches, "checkpoints": names}


# the port's state_dict in the JAX package's variable layout, by numpy
# transposes (the inverse of convert.py's from_jax_variables and
# from_jax_discriminator_variables): phase 3c writes the port's own run as
# the JAX package's load_checkpoint would restore it
BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var")}
DECODER_CONVS = {"upsample.0": "upsample_conv",
                 "squeeze_excite.0": "se_conv", "iconv": "iconv"}


def conv_leaf(path, leaf, a):
    """A conv's weight (OIHW -> HWIO) or bias at ``path``."""
    if leaf == "weight":
        return "params", (*path, "kernel"), np.transpose(a, (2, 3, 1, 0))
    return "params", (*path, "bias"), a


def bn_leaf(path, leaf, a):
    collection, name = BN_LEAVES[leaf]
    return collection, (*path, name), a


def stage_entry(stage, rest, a):
    """An encoder (or discriminator) stage's entry: its graph's node blocks
    (``layers.0``) and attention (``layers.1``)."""
    m = re.fullmatch(r"layers\.0\.node_blocks\.(\d+)\.(.+)", rest)
    if m:
        node = (*stage, "graph", f"node_{m[1]}")
        if m[2] == "mean_weight":
            return "params", (*node, "mean_weight"), a
        c = re.fullmatch(r"convolution\.layers\.([01])\.(\w+)", m[2])
        if c and c[1] == "0":
            return conv_leaf((*node, "conv_block", "conv"), c[2], a)
        if c:
            return bn_leaf((*node, "conv_block", "bn"), c[2], a)
    m = re.fullmatch(r"layers\.1\.(\w+)\.(weight|bias)", rest)
    if m:
        return conv_leaf((*stage, "attention", m[1]), m[2], a)
    return None


def decoder_entry(stage, rest, a):
    m = re.fullmatch(r"(upsample\.0|squeeze_excite\.0|iconv)\.layers\."
                     r"(0\.layers\.0|1)\.(\w+)", rest)
    if m and m[2] == "1":
        return bn_leaf((*stage, DECODER_CONVS[m[1]], "bn"), m[3], a)
    if m:
        return conv_leaf((*stage, DECODER_CONVS[m[1]], "conv_layer", "conv"),
                         m[3], a)
    m = re.fullmatch(r"squeeze_excite\.1\.excite\.([02])\.(weight|bias)",
                     rest)
    if m:
        n = "1" if m[1] == "0" else "2"
        if a.ndim == 2:   # fc: Dense (in, out)
            return "params", (*stage, "se", f"fc{n}", "kernel"), a.T
        return conv_leaf((*stage, "se", f"conv{n}"), m[2], a)
    m = re.fullmatch(r"disp\.layers\.0\.(weight|bias)", rest)
    if m:
        return conv_leaf((*stage, "disp", "conv"), m[1], a)
    return None


def jax_entry(key, a, disc_hw=None):
    """(collection, path, array) of the port's ``state_dict`` entry ``key``
    in the JAX package's variables, or None for ``num_batches_tracked``
    (the JAX package keeps no count).  ``disc_hw``: the discriminator's
    final map, whose head the port flattens NCHW and the JAX package
    NHWC."""
    if key.endswith("num_batches_tracked"):
        return None
    entry = None
    if key == "linear.weight" and disc_hw is not None:
        h, w = disc_hw
        c = a.shape[1] // (h * w)
        entry = "params", ("linear", "kernel"), a.reshape(
            -1, c, h, w).transpose(0, 2, 3, 1).reshape(a.shape[0], -1).T
    elif key == "linear.bias" and disc_hw is not None:
        entry = "params", ("linear", "bias"), a
    elif m := re.fullmatch(r"encoder\.layers\.(\d+)\.(.+)", key):
        entry = stage_entry(("encoder", f"stage_{m[1]}"), m[2], a)
    elif m := re.fullmatch(r"decoder\.layers\.(\d+)\.(.+)", key):
        entry = decoder_entry(("decoder", f"stage_{m[1]}"), m[2], a)
    elif disc_hw is not None and (
            m := re.fullmatch(r"(?:layers\.(\d+)|conv)\.(.+)", key)):
        stage = f"stage_{m[1]}" if m[1] is not None else "final_conv"
        entry = stage_entry((stage,), m[2], a)
    if entry is None:
        fail(f"no JAX layout for the port's {key}")
    return entry


def jax_variables(tensors, disc_hw=None):
    """``tensors`` (a ``state_dict``, or a moment per parameter name) as
    the JAX package's ``{"params", "batch_stats"}`` of numpy arrays."""
    out = {"params": {}, "batch_stats": {}}
    for key, t in tensors.items():
        entry = jax_entry(key, t.detach().cpu().numpy(), disc_hw)
        if entry is None:
            continue
        collection, path, a = entry
        node = out[collection]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def jax_train_state(trainer, disc_hw, steps, epoch):
    """The trainer's model, discriminator and both Adams as the dict the
    JAX package's ``load_checkpoint`` restores: optax ``scale_by_adam``'s
    ``{"count", "mu", "nu"}``, the moments in the parameters' layout."""
    state = {"epoch": epoch}
    for prefix, module, optimizer, hw in (
            ("", trainer.model, trainer.optimizer, None),
            ("disc_", trainer.disc, trainer.disc_optimizer, disc_hw)):
        variables = jax_variables(module.state_dict(), hw)
        adam = {name: optimizer.state[p]
                for name, p in module.named_parameters()}
        counts = {s["step"].item() for s in adam.values()}
        if counts != {float(steps)}:
            fail(f"{prefix}optimizer steps {counts}, not {steps}")
        state[f"{prefix}params"] = variables["params"]
        state[f"{prefix}batch_stats"] = variables["batch_stats"]
        state[f"{prefix}opt_state"] = {"count": np.int32(steps), **{
            field: jax_variables({n: s[key] for n, s in adam.items()},
                                 hw)["params"]
            for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}}
    return state


def state_differences(a, b):
    """Where trainers ``a`` and ``b`` differ: the model's and the
    discriminator's parameters and BatchNorm statistics (not
    ``num_batches_tracked``: a converted checkpoint writes 0, and a
    momentum BatchNorm never reads it), the clone's parameters, and both
    Adams' state (step, moments) and hyper-parameters but the learning
    rate."""
    diff = []
    for label, x, y in (("model", a.model, b.model), ("disc", a.disc, b.disc)):
        sx, sy = x.state_dict(), y.state_dict()
        diff += [f"{label}.{k}" for k in sx
                 if not k.endswith("num_batches_tracked")
                 and not torch.equal(sx[k], sy[k])]
    diff += [f"disc_lag.{k}" for (k, p), q in zip(
        a.disc_lag.named_parameters(), b.disc_lag.parameters())
        if not torch.equal(p, q)]
    for label in ("optimizer", "disc_optimizer"):
        sx = getattr(a, label).state_dict()
        sy = getattr(b, label).state_dict()
        if ([dict(g, lr=0) for g in sx["param_groups"]]
                != [dict(g, lr=0) for g in sy["param_groups"]]):
            diff.append(f"{label}.param_groups")
        if sx["state"].keys() != sy["state"].keys():
            diff.append(f"{label}.state")
            continue
        diff += [f"{label}.{i}.{k}" for i in sx["state"]
                 for k in ("step", "exp_avg", "exp_avg_sq")
                 if not torch.equal(sx["state"][i][k], sy["state"][i][k])]
    return diff


def optimizer_params(optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def stepping_with(optimizer, grads, own):
    """Make ``optimizer``'s next step use ``grads`` (one a parameter) in
    place of its parameters' own gradients, which it appends to ``own``."""
    step = optimizer.step

    def stepped():
        params = optimizer_params(optimizer)
        own.append([p.grad.clone() for p in params])
        for p, g in zip(params, grads):
            p.grad.copy_(g)
        del optimizer.step
        return step()

    optimizer.step = stepped


def check_converted_resume(counters):
    """A run resumed from a checkpoint of ``convert.from_jax_train_state``,
    at flagship width with the discriminator (f32, b8, 256x512): the
    port's run takes ``CONVERT_STEPS`` adversarial steps (the clone
    refreshed at the last), its state is written as the JAX package's
    ``load_checkpoint`` restores one (``jax_train_state``: numpy
    transposes, the head at the 8x16 final map), converted, written with
    ``write_checkpoint`` and loaded into a trainer of other weights.  Its
    state must equal the run's bit for bit.  Then both take the next step
    on one batch (the perceptual term live): the losses must be equal bit
    for bit (the forward is deterministic), and the resumed trainer's Adam
    steps, given the run's gradients, must leave both states equal bit for
    bit.  The card's backward does not sum in a fixed order (cuDNN's
    convolution backward, ``warp_rows``' shared atomics), so the resumed
    step's own gradients are held against the run's by their median
    (``WHOLE_STEP_MEDIAN_REL``, the card-vs-CPU limit).  The resumed step
    launches 5 + 5 ``warp_rows`` and nothing else."""
    import tempfile

    from uncertainty_model_tpu_torch.config import (
        FLAGSHIP_DISCRIMINATOR, FLAGSHIP_INPUT, FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.convert import (
        discriminator_final_hw, from_jax_train_state)
    from uncertainty_model_tpu_torch.train import load_checkpoint
    from uncertainty_model_tpu_torch.train.checkpoint import write_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    disp_scale = adjust_scale()
    disc_hw = discriminator_final_hw(FLAGSHIP_DISCRIMINATOR, FLAGSHIP_INPUT)
    if disc_hw != (8, 16):
        fail(f"the flagship discriminator's final map {disc_hw}")
    run = adversarial_trainer(SEED + 60)
    batches = [stereo_batch(TRAIN_BATCH, SEED + 61 + i)
               for i in range(CONVERT_STEPS + 1)]
    for i in range(CONVERT_STEPS):
        run.train_step(batches[i], disp_scale, TRAIN_LR, i)
    t0 = time.perf_counter()
    restored = jax_train_state(run, disc_hw, CONVERT_STEPS, epoch=1)
    converted = from_jax_train_state(restored, FLAGSHIP_MODEL,
                                     FLAGSHIP_DISCRIMINATOR,
                                     image_hw=FLAGSHIP_INPUT)
    del restored
    resumed = adversarial_trainer(SEED + 62)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_checkpoint(os.path.join(tmp, "epoch_001"), *converted)
        del converted
        epoch = resumed.load_state(*load_checkpoint(path, adversarial=True))
    seconds = time.perf_counter() - t0
    loaded = state_differences(run, resumed)
    log(f"converted resume: flagship f32 b{TRAIN_BATCH} with the "
        f"discriminator (final map {disc_hw[0]}x{disc_hw[1]}), "
        f"{CONVERT_STEPS} steps, to the JAX layout, converted, written and "
        f"loaded in {seconds:.1f} s: epoch {epoch}; state tensors differing "
        f"from the run's {len(loaded)} {loaded[:5]}")
    if epoch != 1 or loaded:
        fail("the converted checkpoint does not resume the run's state")

    batch, step_idx = batches[CONVERT_STEPS], CONVERT_STEPS
    want = run.train_step(batch, disp_scale, TRAIN_LR, step_idx)
    grads = [[p.grad.clone() for p in optimizer_params(opt)]
             for opt in (run.optimizer, run.disc_optimizer)]
    own = []
    stepping_with(resumed.optimizer, grads[0], own)
    stepping_with(resumed.disc_optimizer, grads[1], own)
    for fn in counters.values():
        fn.launches = 0
    got = resumed.train_step(batch, disp_scale, TRAIN_LR, step_idx)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    losses_equal = {k: torch.equal(got[k], want[k]) for k in want}
    stepped = state_differences(run, resumed)
    rel = [((g - w).norm() / w.norm().clamp_min(1e-30)).item()
           for ours, theirs in zip(own, grads) for g, w in zip(ours, theirs)]
    median = statistics.median(rel)
    log(f"  the next step (batch index {step_idx}): losses "
        f"{ {k: v.item() for k, v in got.items()} }, equal to the run's bit "
        f"for bit {losses_equal}; after the Adam steps on the run's "
        f"gradients, state tensors differing {len(stepped)} {stepped[:5]}; "
        f"its own gradients vs the run's (relative, per parameter) median "
        f"{median:.3g} (limit {WHOLE_STEP_MEDIAN_REL}), max {max(rel):.3g}; "
        f"launches {launches}")
    per_step = len(warp_groups(TRAIN_BATCH))
    want_launches = {name: per_step if name.startswith("warp_rows") else 0
                     for name in counters}
    if not all(losses_equal.values()) or stepped:
        fail("the resumed step does not equal the run's")
    if not median < WHOLE_STEP_MEDIAN_REL:
        fail("the resumed step's gradients are not the run's")
    if launches != want_launches:
        fail(f"the resumed step launched {launches}, not {want_launches}")
    return {"steps": CONVERT_STEPS, "disc_final_map": list(disc_hw),
            "seconds": seconds, "epoch": epoch, "launches": launches,
            "losses_equal": losses_equal, "grad_median_rel": median,
            "grad_max_rel": max(rel)}


# ---------------------------------------------------------------------------
# phase 3d: the training CLI, fed by the data pipeline
# ---------------------------------------------------------------------------


def synthetic_pair(seed, shape, shift):
    """A stereo pair of (H, W, 3) float images in [0, 1]: a smooth random
    scene (a few sinusoids a channel), the right view the left moved by
    ``shift`` pixels, each with its own noise."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1 + shift / w, w + shift)[None, :]
    scene = np.empty((h, w + shift, 3))
    for c in range(3):
        f = rng.uniform(1, 6, (3, 2))
        phase = rng.uniform(0, 2 * np.pi, 3)
        scene[..., c] = 0.5 + sum(
            0.15 * np.sin(2 * np.pi * (fx * xx + fy * yy) + p)
            for (fx, fy), p in zip(f, phase))
    left = scene[:, shift:] + rng.normal(0, 0.04, (h, w, 3))
    right = scene[:, :w] + rng.normal(0, 0.04, (h, w, 3))
    return np.clip(left, 0, 1), np.clip(right, 0, 1)


def write_davinci_tree(root, seed):
    """``root/datasets/da-vinci/{train,test}/image_{0,1}/NNN.png``:
    ``CLI_TRAIN_PAIRS`` and ``CLI_TEST_PAIRS`` pairs of
    ``CLI_SOURCE_SHAPE`` PNGs by the port's writer (8-bit RGB, zlib level
    6), written on 8 threads."""
    import os

    from uncertainty_model_tpu_torch.utils.viz import save_image

    jobs = [(split, i) for split, n in (("train", CLI_TRAIN_PAIRS),
                                        ("test", CLI_TEST_PAIRS))
            for i in range(n)]
    for split in ("train", "test"):
        for side in ("image_0", "image_1"):
            os.makedirs(os.path.join(root, "datasets", "da-vinci", split,
                                     side), exist_ok=True)

    def one(job):
        split, i = job
        left, right = synthetic_pair((seed, int(split == "test"), i),
                                     CLI_SOURCE_SHAPE, CLI_SHIFT)
        base = os.path.join(root, "datasets", "da-vinci", split)
        save_image(left, os.path.join(base, "image_0", f"{i:03}.png"))
        save_image(right, os.path.join(base, "image_1", f"{i:03}.png"))
        return os.path.getsize(os.path.join(base, "image_0", f"{i:03}.png"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(one, jobs))
    log(f"  wrote {2 * len(jobs)} PNGs of {CLI_SOURCE_SHAPE[0]}x"
        f"{CLI_SOURCE_SHAPE[1]} in {time.perf_counter() - t0:.1f} s "
        f"(mean {statistics.mean(sizes) / 2 ** 20:.2f} MiB a file)")


def cli_argv(home, out, *extra):
    import os
    return [CLI_CONFIG, "da-vinci", "--epochs", str(CLI_EPOCHS),
            "--batch-size", str(TRAIN_BATCH), "--evaluate-every", "1",
            "--save-model-every", "1", "--no-pbar",
            "--workers", str(CLI_WORKERS), "--home", home,
            "--save-model-to", os.path.join(out, "trained"),
            "--save-results-to", os.path.join(out, "results"), *extra]


def run_cli(counters, argv, parallel=False):
    """``cli.main.main`` (``cli.parallel_main.main`` where ``parallel``)
    in this process on ``argv``, the counters zeroed just before and read
    just after; each training step's and evaluation batch's own launches
    recorded (``Trainer.train_step`` and ``train.evaluate.eval_step``
    wrapped, batch size beside).  Returns (args, printed output, run
    folder, launches, per-step launches, per-eval-batch launches)."""
    import contextlib
    import io
    import os

    from uncertainty_model_tpu_torch.cli import main as serial
    from uncertainty_model_tpu_torch.cli import parallel_main
    from uncertainty_model_tpu_torch.train import evaluate, trainer

    build_parser, main = ((parallel_main.build_parallel_parser,
                           parallel_main.main) if parallel else
                          (serial.build_parser, serial.main))

    def recorded(fn, into):
        def wrapper(*args, **kwargs):
            before = {k: c.launches for k, c in counters.items()}
            out = fn(*args, **kwargs)
            into.append((len(args[1]["left"]),
                         {k: c.launches - before[k]
                          for k, c in counters.items()}))
            return out
        return wrapper

    train_step, eval_step = trainer.Trainer.train_step, evaluate.eval_step
    steps, evals = [], []
    args = build_parser().parse_args(argv)
    printed = io.StringIO()
    trainer.Trainer.train_step = recorded(train_step, steps)
    evaluate.eval_step = recorded(eval_step, evals)
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        trainer.Trainer.train_step = train_step
        evaluate.eval_step = eval_step
    for line in printed.getvalue().splitlines():
        if not line.startswith("\t- "):  # the arguments, already in argv
            log(f"  | {line}")
    runs = os.listdir(args.save_model_to)
    if len(runs) != 1:
        fail(f"the CLI wrote run folders {runs}")
    log(f"  CLI run: {seconds:.1f} s; launches {launches}")
    return args, printed.getvalue(), runs[0], launches, steps, evals


def check_cli_launches(launches, steps, evals, epochs):
    """5 + 5 ``warp_rows`` launches every step, 1 forward every evaluation
    batch (the last one partial), nothing else; the totals their sums."""
    per_step = len(warp_groups(TRAIN_BATCH))
    n_steps = epochs * (CLI_TRAIN_PAIRS // TRAIN_BATCH)
    eval_sizes = cli_eval_sizes()
    zero = {name: 0 for name in launches}
    step_want = {**zero, "warp_rows_fwd": per_step, "warp_rows_bwd": per_step}
    eval_want = {**zero, "warp_rows_fwd": 1}
    if [b for b, _ in steps] != [TRAIN_BATCH] * n_steps:
        fail(f"the CLI ran steps of batch {[b for b, _ in steps]}")
    if [b for b, _ in evals] != eval_sizes * epochs:
        fail(f"the CLI evaluated batches of {[b for b, _ in evals]}")
    for kind, rows, want in (("step", steps, step_want),
                             ("evaluation batch", evals, eval_want)):
        for b, got in rows:
            if got != want:
                fail(f"a CLI {kind} of batch {b} launched {got}, not {want}")
    total = {**zero, "warp_rows_fwd": n_steps * per_step + len(evals),
             "warp_rows_bwd": n_steps * per_step}
    if launches != total:
        fail(f"the CLI launched {launches}, not {total}")
    log(f"  launches: {per_step} + {per_step} each of {n_steps} steps, 1 each "
        f"of {len(evals)} evaluation batches (sizes "
        f"{[b for b, _ in evals]}), {launches} in all")


def check_cli_outputs(args, run, epochs, first=1, adversarial=False):
    """Checkpoints (``model.pt`` and ``train_state.pt`` in each of
    ``epoch_NNN`` and ``final``), comparison PNGs, and ``results.json``:
    the JAX package's schema, finite losses and metrics, one entry for
    each of the ``epochs`` epochs the run ran, from epoch ``first`` (the
    discriminator's too where ``adversarial``, else None)."""
    import os

    from uncertainty_model_tpu_torch.config import load_config

    model_dir = os.path.join(args.save_model_to, run)
    results_dir = os.path.join(args.save_results_to, run)
    names = [f"epoch_{e:03}" for e in range(first, first + epochs)]
    if sorted(os.listdir(model_dir)) != names + ["final"]:
        fail(f"the CLI wrote checkpoints {sorted(os.listdir(model_dir))}")
    for name in names + ["final"]:
        if sorted(os.listdir(os.path.join(model_dir, name))) != [
                "model.pt", "train_state.pt"]:
            fail(f"checkpoint {name} holds {os.listdir(model_dir + '/' + name)}")
    for name in names:
        for png in ("prediction.png", "disparity.png", "uncertainty.png"):
            with open(os.path.join(results_dir, name, png), "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"{name}/{png} is not a PNG")
    with open(os.path.join(results_dir, "results.json")) as f:
        results = json.load(f)
    want = {"arguments": sorted(vars(args)), "config": None,
            "losses": {"training": ["discriminator", "disparity",
                                    "uncertainty"],
                       "validation": {"ssim": ["left", "right"],
                                      "sparsification": ["aurg", "ause"]}}}
    tree = {"arguments": sorted(results["arguments"]), "config": None,
            "losses": {"training": sorted(results["losses"]["training"]),
                       "validation": {k: sorted(v) for k, v in
                                      results["losses"]["validation"].items()}}}
    if sorted(results) != ["arguments", "config", "losses"] or tree != want:
        fail(f"results.json has the key tree {tree}, not {want}")
    if results["config"] != load_config(CLI_CONFIG):
        fail(f"results.json's config is not {CLI_CONFIG}")
    training = results["losses"]["training"]
    validation = results["losses"]["validation"]
    values = [training["disparity"], training["uncertainty"],
              validation["ssim"]["left"], validation["ssim"]["right"],
              validation["sparsification"]["ause"],
              validation["sparsification"]["aurg"]]
    if adversarial:
        values.append(training["discriminator"])
    elif training["discriminator"] is not None:
        fail(f"results.json losses {results['losses']}")
    if any(len(v) != epochs or not np.isfinite(v).all() for v in values):
        fail(f"results.json losses {results['losses']}")
    log(f"  outputs: checkpoints {names + ['final']}, comparison PNGs, "
        f"results.json with the JAX schema; losses {training['disparity']}, "
        f"{training['uncertainty']}, {training['discriminator']}; ssim "
        f"{validation['ssim']}; "
        f"sparsification {validation['sparsification']}")
    return results


def run_cli_path(counters, home, out):
    """The CLI on the flagship at full width from PNG files: 2 epochs with
    an evaluation and a checkpoint each, then ``--resume-from epoch_001``
    (epoch 2 alone, and ``final``)."""
    import os

    import uncertainty_model_tpu_torch.train.checkpoint as ckpt

    # PyTorch's defaults, as a user's process starts: the CLI's
    # ``--precision float32`` must turn TF32 off itself
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    args, printed, run, launches, steps, evals = run_cli(
        counters, cli_argv(home, os.path.join(out, "run")))
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("the CLI's --precision float32 left TF32 on")
    check_cli_launches(launches, steps, evals, CLI_EPOCHS)
    results = check_cli_outputs(args, run, CLI_EPOCHS)

    log("  resume from epoch_001:")
    epoch_1 = os.path.join(args.save_model_to, run, "epoch_001")
    r_args, r_printed, r_run, r_launches, r_steps, r_evals = run_cli(
        counters, cli_argv(home, os.path.join(out, "resumed"),
                           "--resume-from", epoch_1))
    if "Epoch #1:" in r_printed or "Epoch #2:" not in r_printed:
        fail("the resumed run did not run epoch 2 alone")
    check_cli_launches(r_launches, r_steps, r_evals, 1)
    r_results = check_cli_outputs(r_args, r_run, 1, first=CLI_EPOCHS)
    # the card's convolution backward sums in no fixed order, so the
    # resumed final is held only by the checks above; its distance from
    # the uninterrupted run's is logged
    a, _ = ckpt.load_checkpoint(os.path.join(args.save_model_to, run, "final"))
    b, _ = ckpt.load_checkpoint(os.path.join(r_args.save_model_to, r_run,
                                             "final"))
    diff = max((a[k].double() - b[k].double()).abs().max().item() for k in a)
    log(f"  resumed final vs uninterrupted final: max abs {diff:.3g} over "
        f"{len(a)} tensors (logged; cuDNN's backward is not deterministic)")
    return {"launches": launches, "step_launches": steps[0][1],
            "eval_batch_sizes": [b for b, _ in evals],
            "losses": results["losses"],
            "resumed": {"launches": r_launches,
                        "losses": r_results["losses"],
                        "final_max_abs_vs_uninterrupted": diff}}


# ---------------------------------------------------------------------------
# phase 3e: bf16 mixed-precision training
# ---------------------------------------------------------------------------


def bf16_matmuls():
    """What ``--precision bfloat16`` sets: f32 products in full f32 (TF32
    off), bf16 products summed in f32 by cuBLAS, as XLA sums them.
    Returns the previous reduced-precision switch, to restore."""
    previous = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return previous


def check_f32_state(trainer, label):
    """Every parameter, gradient, floating buffer and Adam state of the
    model, and of the discriminator and its clone where the trainer has
    them, is f32 and on the card (after bf16 or adversarial steps)."""
    modules = [("model", trainer.model, trainer.optimizer)]
    if trainer.disc is not None:
        modules += [("disc", trainer.disc, trainer.disc_optimizer),
                    ("lag", trainer.disc_lag, None)]
    bad = []
    for name, module, opt in modules:
        for n, t in [*module.named_parameters(), *module.named_buffers()]:
            for x in (t, t.grad):
                if x is not None and x.is_floating_point() and (
                        x.dtype != torch.float32 or x.device.type != "cuda"):
                    bad.append(f"{name}.{n}")
        if opt is None:
            continue
        state = opt.state_dict()["state"]
        bad += [f"{name} adam {i} {k}" for i, m in state.items()
                for k in ("exp_avg", "exp_avg_sq")
                if m[k].dtype != torch.float32 or m[k].device.type != "cuda"]
        if len(state) != len(list(module.parameters())):
            bad.append(f"{name}: {len(state)} Adam states")
    if bad:
        fail(f"{label}: not f32 on the card, or no Adam state: {bad[:5]}")
    log(f"  {label}: the parameters, gradients, buffers and Adam states of "
        + ", ".join(name for name, _, _ in modules) + " are f32 on the card")


def rel(a, b):
    """||a - b|| / ||b||, in f64."""
    return (a.double() - b.double()).norm().item() / max(
        b.double().norm().item(), 1e-30)


def noise_check(got, want, exact, exempt=()):
    """The bf16 gradients ``got`` (card) against ``want`` (CPU), with the
    CPU's f32 gradients ``exact`` as the noise yardstick.  Returns (worst
    share of the per-parameter limit, max(BF16_PARAM_NOISE x the CPU's
    bf16 gradient's distance from the f32 one, BF16_PARAM_FLOOR)
    relative, over the parameters not in ``exempt``; the card's median
    relative difference; the CPU's bf16-vs-f32 median; the largest norm
    ratio card / CPU where the exact gradient is 0, which holds only the
    reductions' rounding, in another order on each device: reported, not
    held)."""
    def norm(t):
        return t.double().norm().item()

    # an exact gradient of 0 (a conv bias ahead of train-mode BatchNorm,
    # the attention keys' bias): the f32 one under 1e-3 of the bf16 ones,
    # or under 1e-6 of the model's largest
    floor = 1e-6 * max(norm(w) for w in want.values())
    shares, zero = {}, {}
    for name, w in want.items():
        wn, gn = norm(w), norm(got[name])
        if norm(exact[name]) < max(1e-3 * max(wn, gn), floor):
            zero[name] = gn / max(wn, floor)
            continue
        if name in exempt:
            continue
        limit = max(BF16_PARAM_NOISE * rel(w, exact[name]), BF16_PARAM_FLOOR)
        shares[name] = rel(got[name], w) / limit
    median = float(np.median([rel(got[n], want[n]) for n in want]))
    noise = float(np.median([rel(want[n], exact[n]) for n in want]))
    for kind, rows in (("share of its limit", shares),
                       ("zero-gradient ratio", zero)):
        worst = sorted(rows, key=rows.get)[-3:]
        log(f"    worst {kind}: " + ", ".join(
            f"{n} {rows[n]:.3g} (card vs CPU {rel(got[n], want[n]):.3g}, "
            f"CPU bf16 vs f32 {rel(want[n], exact[n]):.3g})" for n in worst))
    return max(shares.values()), median, noise, max(zero.values(), default=0)


def se_alone(trainer, stage, x, dy):
    """The backward of a copy of ``trainer``'s (on the CPU) decoder stage
    ``stage`` SE layer alone, from the input ``x`` and output gradient
    ``dy``: its parameters' gradients, by the model's names, and the input
    of its ReLU."""
    layer = copy.deepcopy(
        trainer.model.decoder.layers[stage].squeeze_excite[1])
    seen = {}
    layer.excite[1].register_forward_hook(
        lambda m, args, out: seen.__setitem__("h", args[0].detach()))
    layer(x).backward(dy)
    prefix = f"decoder.layers.{stage}.squeeze_excite.1."
    return ({prefix + n: q.grad for n, q in layer.named_parameters()},
            seen["h"])


def check_se_links(cpu, f32, seen, card_grads, cpu_grads, exact):
    """The decoder's SE layers in the bf16 model backward of one dL/dD,
    link by link.  Per stage, held: the card's gradients of the layer's
    parameters equal those of the CPU's copy of the layer run alone from
    the input ``x`` and output gradient ``dy`` that the card's backward
    met, within ``BF16_SE_ALONE_REL``; and that ``x`` and ``dy`` lie within
    ``BF16_PARAM_NOISE`` times the CPU's bf16-vs-f32 distance of the CPU's.
    Reported: the ReLU gates (batch x hidden units) that the card's ``x``
    opens or closes against the CPU's (and the f32 model's against the
    CPU's bf16), and how far the card's ``x`` alone moves each gradient.
    Returns (rows, the parameters of the layers where a gate flipped)."""
    rows, flipped = [], []
    for i, (c, p, f) in enumerate(zip(seen["card"], seen["cpu"],
                                      seen["f32"])):
        prefix = f"decoder.layers.{i}.squeeze_excite.1."
        names = [n for n in cpu_grads if n.startswith(prefix)]
        base, h = se_alone(cpu, i, p["x"], p["dy"])
        own, h_card = se_alone(cpu, i, c["x"], c["dy"])
        card_x, _ = se_alone(cpu, i, c["x"], p["dy"])
        _, h_f32 = se_alone(f32, i, f["x"], f["dy"])
        gates = [int(((h_card > 0) != (h > 0)).sum()),
                 int(((h_f32 > 0) != (h > 0)).sum()), h.numel()]
        row = {"stage": i, "gates_flipped": gates,
               "x": [rel(c["x"], p["x"]), rel(p["x"], f["x"])],
               "dy": [rel(c["dy"], p["dy"]), rel(p["dy"], f["dy"])],
               "params": {n.removeprefix(prefix): {
                   "card_vs_cpu": rel(card_grads[n], cpu_grads[n]),
                   "cpu_bf16_vs_f32": rel(cpu_grads[n], exact[n]),
                   "card_vs_alone": rel(card_grads[n], own[n]),
                   "card_x_moves": rel(card_x[n], base[n])}
                   for n in names}}
        rows.append(row)
        if gates[0]:
            flipped += names
        log(f"    SE of decoder stage {i}: x card vs CPU {row['x'][0]:.3g} "
            f"(CPU bf16 vs f32 {row['x'][1]:.3g}), dy {row['dy'][0]:.3g} "
            f"({row['dy'][1]:.3g}) (limit {BF16_PARAM_NOISE} x); ReLU gates "
            f"flipped by the card's x {gates[0]} of {gates[2]} (by f32 "
            f"{gates[1]}); " + ", ".join(
                f"{n}: card vs CPU {v['card_vs_cpu']:.3g} (CPU bf16 vs f32 "
                f"{v['cpu_bf16_vs_f32']:.3g}), the card's x alone moves it "
                f"{v['card_x_moves']:.3g}, card vs the layer alone from the "
                f"card's x and dy {v['card_vs_alone']:.3g} (limit "
                f"{BF16_SE_ALONE_REL})" for n, v in row["params"].items()))
        if not (max(v["card_vs_alone"] for v in row["params"].values())
                <= BF16_SE_ALONE_REL
                and row["x"][0] <= BF16_PARAM_NOISE * row["x"][1]
                and row["dy"][0] <= BF16_PARAM_NOISE * row["dy"][1]):
            fail(f"the card's bf16 SE layer of decoder stage {i} differs from "
                 "the CPU's")
    return rows, flipped


def check_bf16_step_against_cpu(disp_scale, cpu_f32_grads):
    """One bf16 step at batch ``CPU_CHECK_BATCH`` on the card against the
    same step on the CPU (the plain versions), the weights and batch of
    phase 3b's check, link by link as there: the losses within
    ``BF16_LOSS_RTOL``; dL/dD at the CPU's bf16 disparities within
    ``BF16_LOSS_GRAD_REL`` per scale; the model backward of that dL/dD
    per parameter and by its median against the bf16 noise
    (``noise_check``, the f32 model's backward of the same dL/dD the exact
    side), the SE layers link by link (``check_se_links``); the whole
    step by its median below ``BF16_WHOLE_STEP_MEDIAN`` (the CPU's f32
    step of phase 3b read beside it)."""
    cpu = flagship_trainer(SEED + 5, device="cpu", dtype=torch.bfloat16)
    card = flagship_trainer(SEED + 5, dtype=torch.bfloat16)
    batch = stereo_batch(CPU_CHECK_BATCH, SEED + 6, device="cpu")
    t0 = time.perf_counter()
    want = cpu.train_step(batch, disp_scale, 0.0)
    cpu_s = time.perf_counter() - t0
    got = card.train_step(batch, disp_scale, 0.0)
    torch.cuda.synchronize()
    result = {"loss_rel": 0.0}
    for key in want:
        w, g = want[key].item(), got[key].item()
        loss_rel = abs(g - w) / abs(w)
        result["loss_rel"] = max(result["loss_rel"], loss_rel)
        log(f"  bf16 {key}: card {g:.7f} cpu {w:.7f} (rel {loss_rel:.3g}, "
            f"limit {BF16_LOSS_RTOL})")
        if not loss_rel <= BF16_LOSS_RTOL:
            fail(f"the card's bf16 step {key} differs from the CPU's")
    cpu_grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    card_grads = {n: p.grad.cpu() for n, p in card.model.named_parameters()}
    card.train_step(batch, disp_scale, 0.0)
    result["whole_step_card_repeat_median_rel"] = float(np.median(
        [rel(p.grad.cpu(), card_grads[n])
         for n, p in card.model.named_parameters()]))
    share, median, noise, zero = noise_check(card_grads, cpu_grads,
                                             cpu_f32_grads)
    result.update(whole_step_median_rel=median, cpu_bf16_vs_f32_median=noise,
                  whole_step_worst_share_reported=share)
    log(f"  bf16 whole step, card vs CPU gradients: median relative "
        f"{median:.3g} (limit {BF16_WHOLE_STEP_MEDIAN}; the CPU's bf16 vs f32 "
        f"{noise:.3g}; the card's step again "
        f"{result['whole_step_card_repeat_median_rel']:.3g}); per parameter "
        f"worst at {share:.3g} of its limit (reported)")
    if not median < BF16_WHOLE_STEP_MEDIAN:
        fail("the card's bf16 step gradients are no nearer the CPU's than "
             "zero is")

    with torch.no_grad():
        d_cpu = step_disparities(cpu, batch, disp_scale)
        d_card = step_disparities(card, batch, disp_scale)
    result["disparity_max_abs"] = max((a - b.cpu()).abs().max().item()
                                      for a, b in zip(d_cpu, d_card))
    cot = loss_grad(cpu, batch, d_cpu)
    card_cot = loss_grad(card, batch, d_cpu)
    result["loss_grad_rel"] = [((a - b).norm() / a.norm()).item()
                               for a, b in zip(card_cot, cot)]
    log(f"  bf16 disparities card vs CPU: max abs "
        f"{result['disparity_max_abs']:.3g}; dL/dD at the CPU's disparities, "
        f"card vs CPU: " + ", ".join(f"{v:.3g}" for v in
                                     result["loss_grad_rel"])
        + f" (relative, per scale; limit {BF16_LOSS_GRAD_REL})")
    if not max(result["loss_grad_rel"]) <= BF16_LOSS_GRAD_REL:
        fail("the card's loss gradient at bf16 disparities differs from the "
             "CPU's")

    seen = {"card": [], "cpu": [], "f32": []}
    f32 = flagship_trainer(SEED + 5, device="cpu")
    exact = model_grads(f32, batch, disp_scale, cot, seen["f32"])
    card_grads = model_grads(card, batch, disp_scale, cot, seen["card"])
    cpu_grads = model_grads(cpu, batch, disp_scale, cot, seen["cpu"])
    result["se_links"], flipped = check_se_links(
        cpu, f32, seen, card_grads, cpu_grads, exact)
    share, median, noise, zero = noise_check(card_grads, cpu_grads, exact,
                                             exempt=flipped)
    result.update(model_backward_worst_share=share,
                  model_backward_median_rel=median,
                  model_backward_cpu_noise=noise,
                  model_backward_zero_ratio=zero)
    log(f"  bf16 model backward of the same dL/dD, card vs CPU: worst at "
        f"{share:.3g} of max({BF16_PARAM_NOISE} x the bf16-vs-f32 distance, "
        f"{BF16_PARAM_FLOOR}) (held link by link instead: "
        f"{', '.join(flipped) or 'none'}); median relative {median:.3g} "
        f"(limit {BF16_NOISE_FACTOR} x the CPU's bf16 vs f32 {noise:.3g}); "
        f"where the exact gradient is 0 the card's at most {zero:.3g} of the "
        f"CPU's (reported); CPU bf16 step {cpu_s:.1f} s")
    if not (share <= 1 and median <= BF16_NOISE_FACTOR * noise):
        fail("the card's bf16 model backward differs from the CPU's by more "
             "than bf16's noise")
    return result


def check_bf16_trajectory(steps=5):
    """``steps`` steps on seeded batches of ``TRAIN_BATCH`` at lr
    ``BF16_TRAJECTORY_LR`` from the same weights, in bf16 and in f32 on the
    card: each step's total loss within ``BF16_TRAJECTORY_REL``."""
    batches = [stereo_batch(TRAIN_BATCH, SEED + 41 + i) for i in range(steps)]
    losses = {}
    for dtype in (None, torch.bfloat16):
        trainer = flagship_trainer(SEED + 40, dtype=dtype)
        run = [trainer.train_step(b, adjust_scale(), BF16_TRAJECTORY_LR, i)
               for i, b in enumerate(batches)]
        losses[dtype_name(dtype)] = [(m["disp_loss"] + m["error_loss"]).item()
                                     for m in run]
        del trainer
    rel = [abs(b - f) / abs(f) for b, f in zip(losses["bfloat16"],
                                               losses["f32"])]
    log(f"  bf16 vs f32 on the card, {steps} steps at b{TRAIN_BATCH}, lr "
        f"{BF16_TRAJECTORY_LR}: losses f32 "
        + ", ".join(f"{v:.6f}" for v in losses["f32"]) + "; bf16 "
        + ", ".join(f"{v:.6f}" for v in losses["bfloat16"])
        + f"; worst relative {max(rel):.3g} (limit {BF16_TRAJECTORY_REL})")
    if not (np.isfinite(losses["bfloat16"]).all()
            and max(rel) < BF16_TRAJECTORY_REL):
        fail("the bf16 trajectory leaves the f32 one")
    return {"losses": losses, "max_rel": max(rel)}


def run_bf16_cli(counters, home, out):
    """``--precision bfloat16`` for one epoch with an evaluation and a
    checkpoint, on phase 3d's tree: the launches of each step and
    evaluation batch, the outputs, the switches the CLI sets, and
    ``final`` (f32 tensors, equal to ``epoch_001``) reloaded into a fresh
    bf16 trainer exactly."""
    from uncertainty_model_tpu_torch.train import load_checkpoint

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    args, printed, run, launches, steps, evals = run_cli(
        counters, cli_argv(home, out, "--precision", "bfloat16",
                           "--epochs", "1"))
    if (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction):
        fail("the CLI's --precision bfloat16 left TF32 or bf16 reduced-"
             "precision sums on")
    check_cli_launches(launches, steps, evals, 1)
    results = check_cli_outputs(args, run, 1)
    model_dir = os.path.join(args.save_model_to, run)
    state, train_state = load_checkpoint(os.path.join(model_dir, "final"))
    epoch_1, _ = load_checkpoint(os.path.join(model_dir, "epoch_001"))
    moments = train_state["optimizer"]["state"]
    if not all(v.dtype == torch.float32 for k, v in state.items()
               if "num_batches_tracked" not in k) or not all(
                   m[k].dtype == torch.float32 for m in moments.values()
                   for k in ("exp_avg", "exp_avg_sq")):
        fail("a bf16 run's checkpoint holds tensors that are not f32")
    if not all(torch.equal(state[k], epoch_1[k]) for k in state):
        fail("the one-epoch run's final differs from its epoch_001")
    fresh = flagship_trainer(SEED + 29, dtype=torch.bfloat16)
    fresh.load_state(state, train_state)
    same_params = all(torch.equal(v.cpu(), state[k]) for k, v in
                      fresh.model.state_dict().items())
    loaded = fresh.optimizer.state_dict()["state"]
    same_moments = loaded.keys() == moments.keys() and all(
        torch.equal(loaded[i][k].cpu(), moments[i][k]) for i in moments
        for k in ("step", "exp_avg", "exp_avg_sq"))
    log(f"  bf16 CLI: final holds f32 tensors, equals epoch_001, and reloads "
        f"into a fresh bf16 trainer: parameters {same_params}, Adam moments "
        f"{same_moments}")
    if not (same_params and same_moments):
        fail("the bf16 run's final does not reload exactly")
    return {"launches": launches, "step_launches": steps[0][1],
            "eval_batch_sizes": [b for b, _ in evals],
            "losses": results["losses"]}


# ---------------------------------------------------------------------------
# phase 3f: adversarial training
# ---------------------------------------------------------------------------


def adversarial_trainer(seed, device="cuda", distributed=False):
    """The flagship and its discriminator (``configs/uncertainty.yml``,
    7,625,230 parameters) from ``seed`` in f32, the loss with
    ``perceptual_start`` ``ADV_PERCEPTUAL_START``, the clone refreshed
    every ``ADV_UPDATE_FREQ`` batches."""
    from uncertainty_model_tpu_torch.config import (
        FLAGSHIP_DISCRIMINATOR, FLAGSHIP_LOSS, FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.models import (
        RandomDiscriminator, RandomlyConnectedModel)
    from uncertainty_model_tpu_torch.train import Trainer

    model = RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL, seed=seed,
                                               device=device).train()
    disc = RandomDiscriminator.from_config(**FLAGSHIP_DISCRIMINATOR,
                                           init_seed=seed + 1, device=device)
    return Trainer(model, dict(FLAGSHIP_LOSS,
                               perceptual_start=ADV_PERCEPTUAL_START),
                   disc=disc, device=device,
                   perceptual_update_freq=ADV_UPDATE_FREQ,
                   distributed=distributed)


def plain_loss(trainer, batch, disp_scale):
    """The step's loss without its adversarial terms, on the model's
    train-mode forward of ``batch`` (no gradient)."""
    from uncertainty_model_tpu_torch.ops import (
        reconstruct_pyramid_with_lr, scale_pyramid)

    with torch.no_grad():
        disparities = step_disparities(trainer, batch, disp_scale)
        pyramid = scale_pyramid(torch.cat([batch["left"], batch["right"]],
                                          -1), trainer.scales)
        recon, lr = reconstruct_pyramid_with_lr(disparities, pyramid)
        disp_loss, error_loss = trainer.loss(pyramid, disparities, recon,
                                             lr_pyramid=lr)
    return (disp_loss + error_loss).item()


def run_adversarial_path(counters):
    """``train_one_epoch`` of the flagship with its discriminator in f32
    at batch ``TRAIN_BATCH``, ``TRAIN_STEPS`` repeats of one batch, the
    losses read after every step (the perceptual term live from step
    ``ADV_PERCEPTUAL_START``, the clone refreshed at the even steps); every
    ``warp_rows`` counter must grow by 5 a step and every other by none:
    the discriminator's convs are cuDNN's, and its step's detached
    reconstructions launch no warp.  The losses must be finite, the clone
    equal to the live discriminator just after each refresh and behind it
    otherwise, the state f32, and the loss without its adversarial terms
    (which move as the discriminator learns) must fall.  Returns (trainer,
    batch, launches, per-step losses)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    disp_scale = adjust_scale()
    trainer = adversarial_trainer(SEED + 50)
    batch = stereo_batch(TRAIN_BATCH, SEED + 4)
    before = plain_loss(trainer, batch, disp_scale)
    n_disc = sum(p.numel() for p in trainer.disc.parameters())
    seen = []

    def lag_is_live():
        return all(torch.equal(a, b) for a, b in zip(
            trainer.disc_lag.parameters(), trainer.disc.parameters()))

    def progress(averages):
        seen.append(({k: fn.launches for k, fn in counters.items()},
                     averages, lag_is_live()))

    for fn in counters.values():
        fn.launches = 0
    trainer.train_one_epoch([batch] * TRAIN_STEPS, disp_scale, TRAIN_LR,
                            progress=progress, metrics_every=1)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    after = plain_loss(trainer, batch, disp_scale)

    losses = {}
    for key in ("disp", "unc", "disc"):
        previous, losses[key] = 0.0, []
        for i, (_, avg, _) in enumerate(seen):
            losses[key].append((avg[key] * (i + 1) - previous) * TRAIN_BATCH)
            previous = avg[key] * (i + 1)
    lag_live = [live for _, _, live in seen]
    log(f"adversarial path: flagship f32 b{TRAIN_BATCH} 256x512 with the "
        f"discriminator ({n_disc:,} parameters), perceptual_start "
        f"{ADV_PERCEPTUAL_START}, clone refreshed every {ADV_UPDATE_FREQ}: "
        + "; ".join(f"{k} " + ", ".join(f"{v:.6f}" for v in vs)
                    for k, vs in losses.items())
        + f"; clone equal to the live one after each step {lag_live}; the "
        f"loss without its adversarial terms {before:.6f} -> {after:.6f}; "
        f"launches {launches}")
    if n_disc != FLAGSHIP_DISC_PARAMS:
        fail(f"the discriminator has {n_disc} parameters")
    if len(seen) != TRAIN_STEPS or not all(
            np.isfinite(v).all() for v in losses.values()):
        fail(f"adversarial losses {losses}")
    per_step = len(warp_groups(TRAIN_BATCH))
    for i, (counts, _, _) in enumerate(seen):
        for name, n in counts.items():
            want = per_step * (i + 1) if name.startswith("warp_rows") else 0
            if n != want:
                fail(f"{name} launched {n} times in {i + 1} adversarial "
                     f"steps, not {want}")
    if lag_live != [i % ADV_UPDATE_FREQ == 0 for i in range(TRAIN_STEPS)]:
        fail(f"the clone was refreshed after steps {lag_live}")
    if not after < before:
        fail(f"the loss did not fall: {before} -> {after}")
    check_f32_state(trainer, f"after {TRAIN_STEPS} adversarial steps")
    return trainer, batch, launches, losses


def disc_step_grads(trainer, pyramid, recon):
    """The discriminator step's loss and gradient per parameter (on the
    CPU) from the given image and reconstruction pyramids."""
    from uncertainty_model_tpu_torch.losses import discriminator_loss

    dev, disc = trainer.device, trainer.disc
    disc.train()
    disc.zero_grad(set_to_none=True)
    loss = discriminator_loss([p.to(dev) for p in pyramid],
                              [r.to(dev) for r in recon], disc,
                              len(pyramid[0]))
    loss.backward()
    return loss.item(), {n: p.grad.cpu() for n, p in disc.named_parameters()}


def lag_recon_grad(trainer, pyramid, recon):
    """The gradient (on the CPU) in the reconstructions of the clone's
    terms, the generator's and the perceptual one's as weighted in the
    loss."""
    from uncertainty_model_tpu_torch.losses import (
        generator_loss, perceptual_loss)

    dev, lag, loss = trainer.device, trainer.disc_lag, trainer.loss
    lag.train()
    images = [p.to(dev) for p in pyramid]
    recon = [r.to(dev).requires_grad_() for r in recon]
    terms = (generator_loss(recon, lag, loss.adversarial_loss_type)
             * loss.adversarial_weight
             + perceptual_loss(images, recon, lag.features)
             * loss.perceptual_weight)
    return [g.cpu() for g in torch.autograd.grad(terms, recon)]


def disc_grad_check(got, want, exempt=()):
    """(worst |diff| / limit, median relative |diff|) over the
    discriminator's parameters, limit = max(DISC_GRAD_REL |g|,
    DISC_GRAD_FLOOR max |g|), or GRAD_REL |g| for those in ``exempt`` (the
    lossy cuDNN weight gradients); the worst five logged."""
    floor = DISC_GRAD_FLOOR * max(g.double().norm().item()
                                  for g in want.values())
    rows = []
    for name, ref in want.items():
        diff = (got[name].double() - ref.double()).norm().item()
        norm = ref.double().norm().item()
        limit = (GRAD_REL * norm if name in exempt
                 else max(DISC_GRAD_REL * norm, floor))
        rows.append((diff / limit, diff / max(norm, 1e-30), norm, name))
    rows.sort(reverse=True)
    log("    worst: " + "; ".join(
        f"{n} at {share:.3g} (relative {r:.3g}, |g| {g:.3g})"
        for share, r, g, n in rows[:5]) + f"; floor {floor:.3g}")
    others = [share for share, _, _, n in rows if n not in exempt]
    log(f"    the parameters held at max({DISC_GRAD_REL} |g|, "
        f"{DISC_GRAD_FLOOR} max |g|): worst at {max(others):.3g} of it; the "
        f"{len(exempt)} lossy cuDNN weights' relative distances (limit "
        f"{GRAD_REL}): " + ", ".join(f"{r:.3g}" for _, r, _, n in rows
                                     if n in exempt))
    return rows[0][0], float(np.median([r for _, r, _, _ in rows]))


def stage_convs(stages, stage):
    """{node index: nn.Conv2d} of the graph block of ``stages[stage]`` (an
    encoder's or the discriminator's ``layers``)."""
    block = stages[stage].layers[0]
    return {i: nb.convolution.layers[0]
            for i, nb in enumerate(block.node_blocks)}


def capture_conv_io(convs, run):
    """Run ``run()`` with each conv of ``convs`` recording its input ``x``
    and its output's gradient ``dy`` (on the CPU, their layouts kept);
    returns {node: {"x", "dy"}}."""
    seen = {i: {} for i in convs}
    handles = []
    for i, conv in convs.items():
        def hook(module, args, out, s=seen[i]):
            s["x"] = args[0].detach().cpu()
            out.register_hook(lambda g, s=s: s.__setitem__(
                "dy", g.detach().cpu()))
        handles.append(conv.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return seen


def conv_wgrad(conv, x, dy, device, dtype=torch.float32, flags=None):
    """The weight gradient of ``conv`` at input ``x`` and output gradient
    ``dy`` alone (``aten.convolution_backward``, as autograd calls it), on
    ``device`` in ``dtype``, under ``torch.backends.cudnn.flags(**flags)``
    where given; on the CPU in f64."""
    def run():
        return torch.nn.grad.conv2d_weight(
            x.to(device, dtype), conv.weight.shape, dy.to(device, dtype),
            conv.stride, conv.padding)
    if flags is None:
        g = run()
    else:
        with torch.backends.cudnn.flags(**flags):
            g = run()
    return g.cpu().double()


# the card's ways to compute a conv's weight gradient: cuDNN as the step
# calls it (TF32 off, heuristics), cuDNN restricted to deterministic
# algorithms, cuDNN's fastest by trial, and PyTorch's own CUDA conv
# (cuDNN off: an im2col and a cuBLAS f32 GEMM)
WGRAD_FLAGS = {
    "cudnn": None,
    "cudnn_deterministic": dict(enabled=True, benchmark=False,
                                deterministic=True, allow_tf32=False),
    "cudnn_benchmark": dict(enabled=True, benchmark=True,
                            deterministic=False, allow_tf32=False),
    "no_cudnn": dict(enabled=False, benchmark=False, deterministic=False,
                     allow_tf32=False),
}


def cudnn_lossy(conv) -> bool:
    """Whether cuDNN's f32 weight gradient of ``conv`` is the lossy one (a
    5x5 stride-1 conv; see ``CUDNN_LOSSY_KERNEL``)."""
    return (conv.kernel_size[0] == CUDNN_LOSSY_KERNEL
            and conv.stride[0] == 1)


def wgrad_links(convs_io, convs, label):
    """Each conv's weight gradient from the same ``x`` and ``dy``: on the
    CPU in f32 and on the card in each way of ``WGRAD_FLAGS``, held
    against the CPU's f64 gradient (the judge): the CPU's and the card's
    without cuDNN within ``WGRAD_JUDGE_REL``, cuDNN's within it too but
    for a 5x5 stride-1 conv, within ``GRAD_REL`` there.  Returns ({node:
    {way: relative distance from the judge}}, the problems), logged."""
    out, problems = {}, []
    for i, io in convs_io.items():
        conv = convs[i]
        judge = conv_wgrad(conv, io["x"], io["dy"], "cpu", torch.float64)
        row = {"cpu_f32": rel(conv_wgrad(conv, io["x"], io["dy"], "cpu"),
                              judge)}
        for way, flags in WGRAD_FLAGS.items():
            row[way] = rel(conv_wgrad(conv, io["x"], io["dy"], "cuda",
                                      flags=flags), judge)
        out[i] = row
        cudnn_limit = GRAD_REL if cudnn_lossy(conv) else WGRAD_JUDGE_REL
        log(f"  {label} node {i} {tuple(conv.weight.shape)} stride "
            f"{conv.stride[0]} at x {tuple(io['x'].shape)}: weight gradient "
            "against the CPU's f64: " + ", ".join(
                f"{k} {v:.3g}" for k, v in row.items())
            + f" (limits: cuDNN {cudnn_limit}, else {WGRAD_JUDGE_REL})")
        for way, value in row.items():
            limit = cudnn_limit if way.startswith("cudnn") else WGRAD_JUDGE_REL
            if not value <= limit:
                problems.append(f"{label} node {i}'s weight gradient by "
                                f"{way} is {value:.3g} from the f64 one")
    return out, problems


def check_adversarial_step_against_cpu(disp_scale):
    """One adversarial step at batch ``CPU_CHECK_BATCH`` (the perceptual
    term live) on the card against the same step on the CPU, same weights
    and batch, lr 0: the three losses within ``LOSS_RTOL``; the whole
    step's model and discriminator gradients by their medians within
    ``WHOLE_STEP_MEDIAN_REL`` (the reconstructions differ by the
    disparities' rounding, phase 3b).  Then each adversarial link on the
    CPU's own pyramids: the discriminator's loss within ``DISC_LOSS_RTOL``
    (beside how far the CPU's moves at the card step's reconstructions),
    its step's gradient per parameter (``disc_grad_check``), and the
    clone's gradient in the reconstructions per scale within
    ``LAG_GRAD_REL``.  Every reading is
    logged before the first failure is reported."""
    from uncertainty_model_tpu_torch.ops import (
        reconstruct_pyramid_with_lr, scale_pyramid)

    cpu = adversarial_trainer(SEED + 51, device="cpu")
    card = adversarial_trainer(SEED + 51)
    batch = stereo_batch(CPU_CHECK_BATCH, SEED + 52, device="cpu")
    with torch.no_grad():
        pyramid = scale_pyramid(torch.cat([batch["left"], batch["right"]],
                                          -1), cpu.scales)
        recon, _ = reconstruct_pyramid_with_lr(
            step_disparities(cpu, batch, disp_scale), pyramid)
    t0 = time.perf_counter()
    want = cpu.train_step(batch, disp_scale, 0.0, ADV_PERCEPTUAL_START)
    cpu_s = time.perf_counter() - t0
    got = card.train_step(batch, disp_scale, 0.0, ADV_PERCEPTUAL_START)
    torch.cuda.synchronize()
    result, problems = {"loss_rel": {}}, []
    for key in want:
        w, g = want[key].item(), got[key].item()
        result["loss_rel"][key] = abs(g - w) / abs(w)
        log(f"  adversarial {key}: card {g:.7f} cpu {w:.7f} (rel "
            f"{result['loss_rel'][key]:.3g}, limit {LOSS_RTOL})")
        if not result["loss_rel"][key] <= LOSS_RTOL:
            problems.append(f"the card's adversarial step {key} differs "
                            "from the CPU's")
    for name, module in (("model", "model"), ("discriminator", "disc")):
        share, median = grad_check(
            {n: p.grad.cpu()
             for n, p in getattr(card, module).named_parameters()},
            {n: p.grad for n, p in getattr(cpu, module).named_parameters()})
        result[f"whole_step_{module}_median_rel"] = median
        log(f"  whole adversarial step, card vs CPU {name} gradients: median "
            f"relative {median:.3g} (limit {WHOLE_STEP_MEDIAN_REL})")
        if not median <= WHOLE_STEP_MEDIAN_REL:
            problems.append(f"the card step's {name} gradients differ from "
                            "the CPU's")

    t1 = time.perf_counter()
    card_loss, card_grads = disc_step_grads(card, pyramid, recon)
    convs = stage_convs(cpu.disc.layers, 1)
    cpu_step = {}
    convs_io = capture_conv_io(convs, lambda: cpu_step.update(
        zip(("loss", "grads"), disc_step_grads(cpu, pyramid, recon))))
    cpu_loss, cpu_grads = cpu_step["loss"], cpu_step["grads"]
    exempt = {f"layers.1.layers.0.node_blocks.{i}.convolution.layers.0"
              ".weight" for i, conv in convs.items() if cudnn_lossy(conv)}
    share, median = disc_grad_check(card_grads, cpu_grads, exempt)
    result["stage1_wgrad_vs_f64"], link_problems = wgrad_links(
        convs_io, convs, "the discriminator's stage 1")
    problems += link_problems
    # the CPU's discriminator loss at the card step's reconstructions
    with torch.no_grad():
        moved_recon, _ = reconstruct_pyramid_with_lr(
            [d.cpu() for d in step_disparities(card, batch, disp_scale)],
            pyramid)
    moved_loss, _ = disc_step_grads(cpu, pyramid, moved_recon)
    result.update(disc_step_worst_share=share, disc_step_median_rel=median,
                  disc_loss_rel_same_pyramids=abs(card_loss - cpu_loss)
                  / abs(cpu_loss),
                  cpu_disc_loss_rel_at_card_recon=abs(moved_loss - cpu_loss)
                  / abs(cpu_loss))
    log(f"  discriminator step on the same pyramids, card vs CPU: loss "
        f"relative {result['disc_loss_rel_same_pyramids']:.3g} (limit "
        f"{DISC_LOSS_RTOL}; the CPU's "
        f"at the card step's reconstructions moves by "
        f"{result['cpu_disc_loss_rel_at_card_recon']:.3g}); gradients worst "
        f"at {share:.3g} of max({DISC_GRAD_REL} |g|, {DISC_GRAD_FLOOR} max "
        f"|g|) (of {GRAD_REL} |g| for the {len(exempt)} lossy cuDNN "
        f"weights), median relative {median:.3g}")
    if not result["disc_loss_rel_same_pyramids"] <= DISC_LOSS_RTOL:
        problems.append("the card's discriminator loss differs from the "
                        "CPU's")
    if not share < 1:
        problems.append("the card's discriminator step differs from the "
                        "CPU's")
    card_g = lag_recon_grad(card, pyramid, recon)
    cpu_g = lag_recon_grad(cpu, pyramid, recon)
    result["lag_recon_grad_rel"] = [rel(a, b) for a, b in zip(card_g, cpu_g)]
    log("  the clone's dL/d(recon) on the same pyramids, card vs CPU: "
        + ", ".join(f"{v:.3g}" for v in result["lag_recon_grad_rel"])
        + f" (relative, per scale; limit {LAG_GRAD_REL}); CPU step "
        f"{cpu_s:.1f} s, links {time.perf_counter() - t1:.1f} s")
    if not max(result["lag_recon_grad_rel"]) <= LAG_GRAD_REL:
        problems.append("the card's clone gradient differs from the CPU's")
    if problems:
        fail("; ".join(problems))
    return result


def run_adversarial_cli(counters, home, out):
    """``--adversarial`` for one epoch with an evaluation and a checkpoint
    on phase 3d's tree (launches of each step and evaluation batch, the
    discriminator's parameter count, the outputs with ``results.json``'s
    discriminator list), ``final`` reloaded into a fresh adversarial
    trainer exactly (model, discriminator and both Adam states), then
    ``--resume-from epoch_001`` for epoch 2."""
    from uncertainty_model_tpu_torch.train import load_checkpoint

    args, printed, run, launches, steps, evals = run_cli(
        counters, cli_argv(home, out, "--adversarial", "--epochs", "1"))
    if (f"Discriminator has {FLAGSHIP_DISC_PARAMS:,} learnable parameters."
            not in printed):
        fail("the adversarial CLI did not print the discriminator's size")
    check_cli_launches(launches, steps, evals, 1)
    results = check_cli_outputs(args, run, 1, adversarial=True)
    model_dir = os.path.join(args.save_model_to, run)
    state, train_state, disc = load_checkpoint(
        os.path.join(model_dir, "final"), adversarial=True)
    fresh = adversarial_trainer(SEED + 53)
    fresh.load_state(state, train_state, disc)
    same = {}
    for name, module, weights in (("model", fresh.model, state),
                                  ("disc", fresh.disc, disc)):
        same[name] = all(torch.equal(v.cpu(), weights[k])
                         for k, v in module.state_dict().items())
    for name, opt in (("optimizer", fresh.optimizer),
                      ("disc_optimizer", fresh.disc_optimizer)):
        saved, loaded = (train_state[name]["state"],
                         opt.state_dict()["state"])
        same[name] = saved.keys() == loaded.keys() and all(
            torch.equal(loaded[i][k].cpu(), saved[i][k]) for i in saved
            for k in ("step", "exp_avg", "exp_avg_sq"))
    log(f"  adversarial CLI: final reloaded into a fresh trainer: {same}")
    if not all(same.values()):
        fail("the adversarial run's final does not reload exactly")

    log("  adversarial resume from epoch_001:")
    r_args, r_printed, r_run, r_launches, r_steps, r_evals = run_cli(
        counters, cli_argv(home, os.path.join(out, "resumed"), "--adversarial",
                           "--resume-from",
                           os.path.join(model_dir, "epoch_001")))
    if "Epoch #1:" in r_printed or "Epoch #2:" not in r_printed:
        fail("the resumed adversarial run did not run epoch 2 alone")
    check_cli_launches(r_launches, r_steps, r_evals, 1)
    r_results = check_cli_outputs(r_args, r_run, 1, first=CLI_EPOCHS,
                                  adversarial=True)
    return {"launches": launches, "step_launches": steps[0][1],
            "eval_batch_sizes": [b for b, _ in evals],
            "losses": results["losses"], "reloaded": same,
            "resumed": {"launches": r_launches,
                        "losses": r_results["losses"]}}


# ---------------------------------------------------------------------------
# phase 3g: data parallelism (DDP at a world of 1: the machine has one card)
# ---------------------------------------------------------------------------


def run_parallel_cli(counters, home, out, serial_losses):
    """``cli.parallel_main`` with ``--num-processes 1`` (its own NCCL group
    of one, set up and destroyed by the CLI) on phase 3d's tree for one
    f32 epoch with an evaluation and a checkpoint: 5 + 5 ``warp_rows``
    launches a step, 1 an evaluation batch, nothing else; the outputs; the
    first epoch's training losses within ``LOSS_RTOL`` of the serial CLI's
    on the same tree and seed (``serial_losses``, phase 3d's)."""
    import os

    from uncertainty_model_tpu_torch import parallel

    torch.backends.cudnn.allow_tf32 = True   # PyTorch's default
    args, printed, run, launches, steps, evals = run_cli(
        counters, cli_argv(home, out, "--epochs", "1", "--num-processes",
                           "1"), parallel=True)
    if parallel.is_distributed():
        fail("the parallel CLI left its process group")
    if torch.backends.cudnn.allow_tf32:
        fail("the parallel CLI's --precision float32 left TF32 on")
    check_cli_launches(launches, steps, evals, 1)
    results = check_cli_outputs(args, run, 1)
    rel_losses = {}
    for key in ("disparity", "uncertainty"):
        got = results["losses"]["training"][key][0]
        want = serial_losses["training"][key][0]
        rel_losses[key] = abs(got - want) / abs(want)
        log(f"  parallel CLI {key} loss {got:.7f}, the serial CLI's "
            f"{want:.7f} (rel {rel_losses[key]:.3g}, limit {LOSS_RTOL})")
        if not rel_losses[key] <= LOSS_RTOL:
            fail(f"the parallel CLI's {key} loss differs from the serial "
                 "CLI's")
    return {"launches": launches, "step_launches": steps[0][1],
            "eval_batch_sizes": [b for b, _ in evals],
            "losses": results["losses"], "loss_rel_vs_serial": rel_losses}


def init_world_of_one():
    """This process as the one rank of an NCCL group (tcp on a free port
    of localhost)."""
    from uncertainty_model_tpu_torch import parallel
    from uncertainty_model_tpu_torch.cli.parallel_main import free_address

    parallel.init_distributed(free_address(), 1, 0, torch.device("cuda", 0))
    log(f"  NCCL process group: world {parallel.world_size()}, rank "
        f"{parallel.rank()}, backend {torch.distributed.get_backend()}")


def synced_bn_layers(module):
    from uncertainty_model_tpu_torch.models.layers import TorchBatchNorm
    return [m for m in module.modules()
            if isinstance(m, TorchBatchNorm) and m.process_group is not None]


def check_synced_bn_outputs(trainer, batch, disp_scale):
    """Each synced BatchNorm layer's train-mode output in one forward of
    the DDP model against ``F.batch_norm``'s (cuDNN's) on the same input,
    within ``F32_TOL``; returns (layers, worst max |diff|)."""
    import torch.nn.functional as F

    worst, bad = [0.0], []

    def hook(module, args, out):
        with torch.no_grad():
            want = F.batch_norm(args[0], None, None, module.weight,
                                module.bias, True, 0.0, module.eps)
            worst[0] = max(worst[0], (out - want).abs().max().item())
            if not within(out, want, **F32_TOL):
                bad.append(module)

    layers = synced_bn_layers(trainer.model)
    handles = [m.register_forward_hook(hook) for m in layers]
    try:
        with torch.no_grad():
            step_disparities(trainer, batch, disp_scale)
    finally:
        for h in handles:
            h.remove()
    log(f"  synced BatchNorm, each of {len(layers)} layers against "
        f"F.batch_norm on its input: worst max abs {worst[0]:.3g} (limit "
        f"{F32_TOL})")
    if bad:
        fail(f"{len(bad)} synced BatchNorm layers differ from F.batch_norm")
    return len(layers), worst[0]


def check_ddp_step(disp_scale):
    """One DDP step at batch ``TRAIN_BATCH`` against the plain ``Trainer``
    step from the same weights and batch, on the card, link by link with
    phase 3b's limits: the losses within ``LOSS_RTOL``; dL/dD at equal
    disparities within ``LOSS_GRAD_REL``; the model backward of an equal
    cotangent per parameter within max(GRAD_REL |g|, GRAD_FLOOR) (through
    DDP's wrapper, its gradient all-reduce included); each synced
    BatchNorm layer's output against ``F.batch_norm``'s; the whole step's
    gradients by their median within ``WHOLE_STEP_MEDIAN_REL``."""
    plain = flagship_trainer(SEED + 60)
    ddp = flagship_trainer(SEED + 60, distributed=True)
    batch = stereo_batch(TRAIN_BATCH, SEED + 61)
    want = plain.train_step(batch, disp_scale, 0.0)
    got = ddp.train_step(batch, disp_scale, 0.0)
    result, problems = {"loss_rel": {}}, []
    for key in want:
        w, g = want[key].item(), got[key].item()
        result["loss_rel"][key] = abs(g - w) / abs(w)
        log(f"  DDP {key}: {g:.7f}, plain {w:.7f} (rel "
            f"{result['loss_rel'][key]:.3g}, limit {LOSS_RTOL})")
        if not result["loss_rel"][key] <= LOSS_RTOL:
            problems.append(f"the DDP step's {key} differs from the plain "
                            "step's")
    share, median = grad_check(
        {n: p.grad.cpu() for n, p in ddp.model.named_parameters()},
        {n: p.grad.cpu() for n, p in plain.model.named_parameters()})
    result["whole_step_median_rel"] = median
    log(f"  whole step, DDP vs plain gradients: median relative {median:.3g}"
        f" (limit {WHOLE_STEP_MEDIAN_REL}); worst at {share:.3g} of "
        f"max({GRAD_REL} |g|, {GRAD_FLOOR}) (reported)")
    if not median <= WHOLE_STEP_MEDIAN_REL:
        problems.append("the DDP step's gradients differ from the plain "
                        "step's")

    with torch.no_grad():
        disparities = step_disparities(plain, batch, disp_scale)
    cot = loss_grad(plain, batch, disparities)
    result["loss_grad_rel"] = [rel(a, b) for a, b in zip(
        loss_grad(ddp, batch, disparities), cot)]
    log("  dL/dD at the same disparities, DDP vs plain: "
        + ", ".join(f"{v:.3g}" for v in result["loss_grad_rel"])
        + f" (relative, per scale; limit {LOSS_GRAD_REL})")
    if not max(result["loss_grad_rel"]) <= LOSS_GRAD_REL:
        problems.append("the DDP trainer's loss gradient differs")
    worst, grads, convs_io = [], {}, {}
    for name, trainer in (("ddp", ddp), ("plain", plain)):
        convs_io[name] = capture_conv_io(
            stage_convs(trainer.model.encoder.layers, 1),
            lambda: grads.__setitem__(name, model_grads(
                trainer, batch, disp_scale, cot)))
    share, median = grad_check(grads["ddp"], grads["plain"], worst)
    result.update(model_backward_worst_share=share,
                  model_backward_median_rel=median)
    log(f"  model backward of the same dL/dD, DDP vs plain: worst at "
        f"{share:.3g} of max({GRAD_REL} |g|, {GRAD_FLOOR}), median relative "
        f"{median:.3g}; the worst: " + "; ".join(
            f"{n} at {sh:.3g}" for sh, _, n in worst))
    if not share < 1:
        problems.append("the DDP model backward differs from the plain one")
    # the encoder's stage-1 convs, where the worst reads: how far their
    # inputs and output gradients differ between the two steps, and their
    # weight gradients by cuDNN and without it (logged)
    convs = stage_convs(plain.model.encoder.layers, 1)
    links = {}
    for i, conv in convs.items():
        a, b = convs_io["ddp"][i], convs_io["plain"][i]
        links[i] = {"x": rel(a["x"], b["x"]), "dy": rel(a["dy"], b["dy"])}
        for way in ("cudnn", "no_cudnn"):
            links[i][way] = rel(
                conv_wgrad(conv, a["x"], a["dy"], "cuda",
                           flags=WGRAD_FLAGS[way]),
                conv_wgrad(conv, b["x"], b["dy"], "cuda",
                           flags=WGRAD_FLAGS[way]))
    result["encoder_stage1_links"] = links
    log("  the encoder's stage-1 convs, DDP vs plain (relative): " + "; ".join(
        f"node {i} x {v['x']:.3g} dy {v['dy']:.3g} weight gradient by cuDNN "
        f"{v['cudnn']:.3g}, without {v['no_cudnn']:.3g}"
        for i, v in links.items()))
    result["synced_bn_layers"], result["bn_max_abs"] = \
        check_synced_bn_outputs(ddp, batch, disp_scale)
    if result["synced_bn_layers"] != FLAGSHIP_BN_LAYERS:
        problems.append(f"{result['synced_bn_layers']} synced BatchNorm "
                        f"layers, not {FLAGSHIP_BN_LAYERS}")
    if problems:
        fail("; ".join(problems))
    return result


def ddp_buckets(trainer):
    """DDP's gradient buckets of the model: one all-reduce each a step."""
    return len(trainer.ddp_model.reducer._get_zeros_like_grad_buckets())


def count_collectives(trainer, batch, disp_scale):
    """The all-reduces one DDP step issues (``c10d::allreduce_`` in the
    profiler's host trace, one NCCL call each) and the NCCL kernels on the
    card, against the number the code predicts: 4 a synced BatchNorm layer
    (the sums and the squared deviations, forward and backward), one a
    DDP bucket, one for the losses."""
    from torch.autograd import DeviceType

    trainer.train_step(batch, disp_scale, TRAIN_LR)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_step(batch, disp_scale, TRAIN_LR)
        torch.cuda.synchronize()
    events = prof.key_averages()
    calls = sum(e.count for e in events if e.key == "c10d::allreduce_")
    kernels = {e.key: e.count for e in events
               if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()}
    n_bn, buckets = len(synced_bn_layers(trainer.model)), ddp_buckets(trainer)
    predicted = 4 * n_bn + buckets + 1
    log(f"  collectives a DDP step: {calls} all-reduces (predicted 4 x "
        f"{n_bn} BatchNorm layers + {buckets} DDP buckets + 1 = {predicted});"
        f" NCCL kernels on the card {kernels or 'none'}")
    if calls != predicted:
        fail(f"a DDP step issued {calls} all-reduces, not {predicted}")
    return {"all_reduces": calls, "predicted": predicted,
            "synced_bn_layers": n_bn, "ddp_buckets": buckets,
            "nccl_kernels": kernels}


def run_ddp_adversarial(counters, disp_scale):
    """The adversarial step through DDP (the model's and the live
    discriminator's wrappers, every BatchNorm of the model, the live
    discriminator and the clone synced) at batch ``TRAIN_BATCH``: one step
    at lr 0 (the perceptual term live) against the plain adversarial
    step's losses within ``LOSS_RTOL``; then 2 steps of ``train_one_epoch``
    with 5 + 5 ``warp_rows`` launches a step and nothing else, finite
    losses."""
    plain = adversarial_trainer(SEED + 50)
    ddp = adversarial_trainer(SEED + 50, distributed=True)
    layers = {name: len(synced_bn_layers(m)) for name, m in (
        ("model", ddp.model), ("disc", ddp.disc), ("clone", ddp.disc_lag))}
    batch = stereo_batch(TRAIN_BATCH, SEED + 4)
    want = plain.train_step(batch, disp_scale, 0.0, ADV_PERCEPTUAL_START)
    got = ddp.train_step(batch, disp_scale, 0.0, ADV_PERCEPTUAL_START)
    del plain
    loss_rel = {k: abs(got[k].item() - w.item()) / abs(w.item())
                for k, w in want.items()}
    seen = []
    for fn in counters.values():
        fn.launches = 0
    ddp.train_one_epoch([batch] * 2, disp_scale, TRAIN_LR, metrics_every=1,
                        progress=lambda a: seen.append(
                            ({k: fn.launches for k, fn in counters.items()},
                             a)))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  DDP adversarial step: synced BatchNorm layers {layers}; losses "
        + ", ".join(f"{k} {got[k].item():.7f} (rel {v:.3g})"
                    for k, v in loss_rel.items())
        + f" against the plain step's (limit {LOSS_RTOL}); 2 steps: "
        f"launches {launches}, averages {[a for _, a in seen]}")
    per_step = len(warp_groups(TRAIN_BATCH))
    for i, (counts, averages) in enumerate(seen):
        if not all(np.isfinite(averages[k]) for k in ("disp", "unc", "disc")):
            fail(f"DDP adversarial losses {averages}")
        for name, n in counts.items():
            want_n = per_step * (i + 1) if name.startswith("warp_rows") else 0
            if n != want_n:
                fail(f"{name} launched {n} times in {i + 1} DDP adversarial "
                     f"steps, not {want_n}")
    if layers != {"model": FLAGSHIP_BN_LAYERS, "disc": FLAGSHIP_DISC_BN_LAYERS,
                  "clone": FLAGSHIP_DISC_BN_LAYERS}:
        fail(f"synced BatchNorm layers {layers}")
    if not max(loss_rel.values()) <= LOSS_RTOL:
        fail("the DDP adversarial step's losses differ from the plain step's")
    return ddp, {"launches": launches, "loss_rel": loss_rel,
                 "synced_bn_layers": layers}


# ---------------------------------------------------------------------------
# phase 3h: training-mode s2d encoder stages
# ---------------------------------------------------------------------------


def bn_statistics(model):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def check_s2d_step_against_direct(disp_scale):
    """One step at batch ``CPU_CHECK_BATCH`` of the flagship with
    ``S2D_TRAIN_STAGES`` against the direct model from the same weights,
    both on the card, held as phase 3b holds the card against the CPU:
    the losses within ``LOSS_RTOL``; the BatchNorm running statistics
    within ``S2D_STATS_TOL``; the model backward of an equal cotangent per
    parameter within max(GRAD_REL |g|, GRAD_FLOOR); the whole step's
    gradients by their median within ``WHOLE_STEP_MEDIAN_REL``.  The two
    run other convs (the s2d interiors are 5x5 and 3x3 convs of four times
    the channels on the half-resolution grid), and the direct model's
    stage-1 interiors are the 5x5 stride-1 convs whose cuDNN weight
    gradient reads ~2e-3 from f64 (``CUDNN_LOSSY_KERNEL``, phase 3b): those
    weights are the model backward's worst, read at 0.334 of the limit
    (relative 1.67e-3; NVIDIA H100 80GB HBM3)."""
    direct = flagship_trainer(SEED + 5)
    s2d = flagship_trainer(SEED + 5, s2d_stages=S2D_TRAIN_STAGES)
    batch = stereo_batch(CPU_CHECK_BATCH, SEED + 6)
    want = direct.train_step(batch, disp_scale, 0.0)
    got = s2d.train_step(batch, disp_scale, 0.0)
    torch.cuda.synchronize()
    result = {"loss_rel": 0.0}
    for key in want:
        w, g = want[key].item(), got[key].item()
        rel_ = abs(g - w) / abs(w)
        result["loss_rel"] = max(result["loss_rel"], rel_)
        log(f"  {key}: s2d {g:.7f} direct {w:.7f} (rel {rel_:.3g}, limit "
            f"{LOSS_RTOL})")
        if not rel_ <= LOSS_RTOL:
            fail(f"the s2d step's {key} differs from the direct step's")
    stats_w, stats_g = bn_statistics(direct.model), bn_statistics(s2d.model)
    worst_stat = max(
        ((stats_g[k] - w).abs() / (S2D_STATS_TOL["atol"]
                                   + S2D_STATS_TOL["rtol"] * w.abs())
         ).max().item() for k, w in stats_w.items())
    result["bn_statistics_worst_share"] = worst_stat
    log(f"  BatchNorm running statistics ({len(stats_w)} buffers), s2d vs "
        f"direct: worst at {worst_stat:.3g} of rtol "
        f"{S2D_STATS_TOL['rtol']}, atol {S2D_STATS_TOL['atol']}")
    if not worst_stat <= 1:
        fail("the s2d step's BatchNorm statistics differ from the direct "
             "step's")
    share, median = grad_check(
        {n: p.grad.cpu() for n, p in s2d.model.named_parameters()},
        {n: p.grad.cpu() for n, p in direct.model.named_parameters()})
    result.update(whole_step_worst_share=share, whole_step_median_rel=median)
    log(f"  whole step, s2d vs direct gradients: median relative "
        f"{median:.3g} (limit {WHOLE_STEP_MEDIAN_REL}); worst at {share:.3g}"
        f" of max({GRAD_REL} |g|, {GRAD_FLOOR}) (reported)")
    if not median <= WHOLE_STEP_MEDIAN_REL:
        fail("the s2d step's gradients differ from the direct step's")
    with torch.no_grad():
        d_direct = step_disparities(direct, batch, disp_scale)
    cot = loss_grad(direct, batch, d_direct)
    worst = []
    share, median = grad_check(
        model_grads(s2d, batch, disp_scale, cot),
        model_grads(direct, batch, disp_scale, cot), worst)
    result.update(model_backward_worst_share=share,
                  model_backward_median_rel=median,
                  model_backward_worst=[(n, sh, r) for sh, r, n in worst])
    log(f"  model backward of the same dL/dD, s2d vs direct: worst at "
        f"{share:.3g} of max({GRAD_REL} |g|, {GRAD_FLOOR}), median relative "
        f"{median:.3g}; the worst: " + "; ".join(
            f"{n} at {sh:.3g} (relative {r:.3g})" for sh, r, n in worst))
    if not share < 1:
        fail("the s2d model's backward differs from the direct model's")
    return result


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def event_samples(fn, reps, samples=9, warmup=2):
    """``samples`` CUDA-event timings of ``reps`` calls each, in ms per
    call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def time_ms(fn, reps, samples=9, warmup=2):
    """Median and spread (max - min) of ``event_samples``."""
    times = event_samples(fn, reps, samples, warmup)
    return statistics.median(times), max(times) - min(times)


def time_graph_ms(fn, reps, samples=9):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, its replay timed with CUDA events (median and spread of
    ``samples``), so the host's per-call cost (the Python wrapper, the
    dispatcher) is not in it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times), max(times) - min(times)


def assemble_z_work(b, h, w, cso, cu, cd, cf, itemsize):
    """(bytes, f32 operations) that one assemble_z call must move and do:
    each input read once, each output written once."""
    h2, w2 = h // 2, w // 2
    pix = b * h * w
    nbytes = itemsize * (pix * (cf or cso) + b * h2 * w2 * (cso + 4 * cu + cd)
                         + pix * (cso + cu + cd)) + 4 * b * cso
    # per z element: 3 lerps (9), 2 adds, the ELU (1), the fold (2 cf)
    ops = pix * (cso * (12 + 2 * cf) + cu + 9 * cd)
    return nbytes, ops


def glue_row(name, nbytes, ops, k, p, library=None):
    """A phase-4 row of a decoder glue kernel at one stage: its time, the
    plain version's, the library call's, the bound and the achieved
    rate."""
    bound_ms, bound_by = bound(nbytes, ops)
    return {"stage": name, "batch": TIMING_BATCH, "dtype": "bfloat16",
            "bytes": nbytes, "ops": ops, "ms": k[0], "ms_spread": k[1],
            "plain_ms": p[0], "plain_ms_spread": p[1],
            "library_ms": library[0] if library else None,
            "library_ms_spread": library[1] if library else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tb_per_s": nbytes / k[0] / 1e9}


def log_glue_row(kernel, row, extra=""):
    log(f"  {kernel} {row['stage']} b{TIMING_BATCH}: kernel "
        f"{row['ms'] * 1e3:.1f} us (spread {row['ms_spread'] * 1e3:.1f}, "
        f"{row['tb_per_s']:.2f} TB/s), plain {row['plain_ms'] * 1e3:.1f} us, "
        + (f"library {row['library_ms'] * 1e3:.1f} us, "
           if row["library_ms"] else "")
        + f"bound {row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
        f"({row['bytes'] / 1e6:.1f} MB){extra}")


def time_assemble_z(stages=ASSEMBLE_Z_STAGES):
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble_z, assemble_z_plain)

    rows = []
    for name, h, w, cso, cu, cd, cf in stages:
        args = assemble_z_inputs(SEED + 7, TIMING_BATCH, h, w, cso, cu, cd, cf,
                                 torch.bfloat16)
        k = time_ms(lambda: assemble_z(*args), reps=10)
        p = time_ms(lambda: assemble_z_plain(*args), reps=2)
        nbytes, ops = assemble_z_work(TIMING_BATCH, h, w, cso, cu, cd, cf, 2)
        row = glue_row(name, nbytes, ops, k, p)
        log_glue_row("assemble_z", row)
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def time_forward(forward, label="bench path"):
    x = images(TIMING_BATCH, SEED + 2)
    ms, spread = time_ms(lambda: forward(x), reps=1)
    log(f"  serving forward ({label}) bf16 b{TIMING_BATCH} 256x512: {ms:.2f} "
        f"ms/pass (spread {spread:.2f} ms over 9), "
        f"{TIMING_BATCH / ms * 1e3:.1f} frames/s")
    return {"batch": TIMING_BATCH, "ms": ms, "ms_spread": spread,
            "fps": TIMING_BATCH / ms * 1e3}


def time_serving_timer(forward, forward_b64):
    """``utils/benchmark.py::measure_forward_samples`` (the bench path's
    timer: the slope of chains of k1 = 2 and k2 = 8 passes, each pass's
    input made from the one before, CUDA events) at ``TIMING_BATCH`` and
    ``BENCH_BATCH``, 9 samples each: their median and spread, beside
    ``time_forward``'s reading of the same forward at ``TIMING_BATCH`` in
    this run (9 event timings of one pass on one input).  Printed as the
    ``serving_timer`` line."""
    from uncertainty_model_tpu_torch.utils import measure_forward_samples

    line = {"method": "measure_forward_samples: per sample (t(k2) - t(k1))"
                      " / (k2 - k1), chained bf16 passes, CUDA events",
            "k1": 2, "k2": 8, "reps": 9,
            "time_forward": {"batch": TIMING_BATCH, "ms": forward_b64["ms"],
                             "ms_spread": forward_b64["ms_spread"]}}
    for batch in (TIMING_BATCH, BENCH_BATCH):
        ms = [t * 1e3 for t in measure_forward_samples(forward, batch,
                                                       reps=9)]
        torch.cuda.empty_cache()
        median = statistics.median(ms)
        line[f"b{batch}"] = {"batch": batch, "ms": median,
                             "ms_spread": max(ms) - min(ms),
                             "fps": batch / median * 1e3, "samples_ms": ms}
        log(f"  serving timer (bench path) bf16 b{batch} 256x512: "
            f"{median:.2f} ms/pass (spread {max(ms) - min(ms):.2f} ms over "
            f"9), {batch / median * 1e3:.1f} frames/s")
        if not all(np.isfinite(ms)) or min(ms) <= 0:
            fail(f"serving timer samples at b{batch}: {ms}")
    log(json.dumps({"serving_timer": line}))
    return line


def profile_device_time(fn, label, top=12):
    """Device time of one call of ``fn`` by PyTorch operator (self time:
    each kernel counted once, under the operator that launched it; the
    port's own kernels are launched outside any operator), and the device's
    idle share over the call's wall time."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def self_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    # device activity: the kernels, copies and sets; a range that code
    # annotated on the device (DDP's forward) is no work of its own
    events = [e for e in prof.key_averages()
              if not (e.device_type == DeviceType.CUDA
                      and getattr(e, "is_user_annotation", False))]
    busy_ms = sum(self_ms(e) for e in events if e.device_type == DeviceType.CUDA)
    if busy_ms <= 0:
        log("  profiler saw no device time")
        return {"wall_ms": wall_ms, "device_busy_ms": None, "ops": []}
    ops = [{"op": e.key, "device_ms": self_ms(e), "calls": e.count}
           for e in events
           if e.device_type == DeviceType.CPU and self_ms(e) > 0]
    outside = busy_ms - sum(op["device_ms"] for op in ops)
    ops.append({"op": "kernels launched outside aten ops (the port's own)",
                "device_ms": outside, "calls": None})
    ops = sorted(ops, key=lambda op: op["device_ms"], reverse=True)[:top]
    port = [{"kernel": e.key, "device_ms": self_ms(e), "calls": e.count}
            for e in events if e.device_type == DeviceType.CUDA
            and any(k in e.key for k in PORT_KERNELS)]
    kernels = sorted(({"kernel": e.key[:120], "device_ms": self_ms(e),
                       "calls": e.count} for e in events
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: k["device_ms"], reverse=True)[:5]
    log(f"  profiled {label}: wall {wall_ms:.2f} ms, device "
        f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for op in ops:
        log(f"    {op['device_ms']:8.3f} ms {100 * op['device_ms'] / busy_ms:5.1f}%"
            f"  x{op['calls']!s:<4s} {op['op']}")
    for k in port:
        log(f"    port kernel {k['kernel']}: {k['device_ms']:.3f} ms over "
            f"{k['calls']} launches")
    log("    top device activities: " + "; ".join(
        f"{k['kernel']} {k['device_ms']:.3f} ms x{k['calls']}"
        for k in kernels))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "ops": ops,
            "port_kernels": port, "top_device_activities": kernels}


def device_busy_and_gaps(fn):
    """Run ``fn`` under a trace of the device's activity alone (no CPU
    operators traced, so the host runs close to its untraced pace); returns
    (span, busy, gaps) in us: the union of the kernels' and copies'
    intervals, the span from the first start to the last end, and the idle
    gaps between them in order."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return 0.0, 0.0, []
    busy, gaps = 0.0, []
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            gaps.append(s - end)
            start = s
        end = max(end, e)
    busy += end - start
    return end - spans[0][0], busy, gaps


def queued_turnaround_us(n=500):
    """The device's gap from one kernel to the next when both already wait
    in its queue (so the host plays no part): ``n`` small adds enqueued
    behind a 50 ms device-side sleep, traced; the median gap between
    them."""
    x = torch.zeros(1024, device="cuda")

    def queued():
        torch.cuda._sleep(100_000_000)
        for _ in range(n):
            x.add_(1.0)

    _, _, gaps = device_busy_and_gaps(queued)
    return statistics.median(gaps[1:]) if len(gaps) > 1 else None


def device_idle(fn, calls=3):
    """The device's idle share over ``calls`` back-to-back calls of ``fn``
    (``device_busy_and_gaps``), and how much of the idle time the host
    causes: each gap beyond the device's own turnaround between queued
    kernels (``queued_turnaround_us``) is time the device waited for the
    host to enqueue work.  A host share near 0 says the device bounds
    ``fn``."""
    fn()
    turnaround = queued_turnaround_us()

    def repeated():
        for _ in range(calls):
            fn()

    span, busy, gaps = device_busy_and_gaps(repeated)
    if not span or turnaround is None:
        log("  device trace saw no device activity")
        return {"idle_share": None}
    host_wait = sum(max(0.0, g - turnaround) for g in gaps)
    buckets = {"under_5us": (0, 5), "5_to_100us": (5, 100),
               "over_100us": (100, float("inf"))}
    by_length = {}
    for name, (lo, hi) in buckets.items():
        part = [g for g in gaps if lo <= g < hi]
        by_length[name] = {"count_per_call": len(part) / calls,
                           "ms_per_call": sum(part) / calls / 1e3}
    result = {"calls": calls, "span_ms_per_call": span / calls / 1e3,
              "busy_ms_per_call": busy / calls / 1e3,
              "idle_share": 1 - busy / span,
              "queued_turnaround_us": turnaround,
              "host_wait_ms_per_call": host_wait / calls / 1e3,
              "host_wait_share": host_wait / span, "gaps": by_length,
              "longest_gap_ms": max(gaps, default=0.0) / 1e3}
    log(f"  device trace of {calls} calls: span {result['span_ms_per_call']:.2f} "
        f"ms/call, busy {result['busy_ms_per_call']:.2f} ms/call, idle share "
        f"{result['idle_share']:.4f}; queued turnaround {turnaround:.2f} us, "
        f"so the host holds the device {result['host_wait_ms_per_call']:.2f} "
        f"ms/call (share {result['host_wait_share']:.4f}); gaps per call "
        + ", ".join(f"{k}: {v['count_per_call']:.0f} ({v['ms_per_call']:.2f} ms)"
                    for k, v in by_length.items())
        + f"; longest {result['longest_gap_ms']:.3f} ms")
    return result


def time_train_step(trainer, batch, disp_scale, label="f32", step_idx=0):
    """CUDA-event time of a step at batch index ``step_idx`` (20 steps of
    warm-up: the first 15 or so after the training path run slower; then
    the median and spread of 9 samples of 5 back-to-back steps each), the
    device's idle share over 3 steps (``device_idle``) and the peak
    memory."""
    b = len(batch["left"])

    def step():
        trainer.train_step(batch, disp_scale, TRAIN_LR, step_idx)

    times = event_samples(step, reps=5, warmup=20)
    ms, spread = statistics.median(times), max(times) - min(times)
    log("  train step samples (ms/step): "
        + ", ".join(f"{t:.2f}" for t in times))
    idle = device_idle(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  train step {label} b{b} 256x512: {ms:.2f} ms/step (spread "
        f"{spread:.2f} ms over 9 samples of 5 steps), "
        f"{b / ms * 1e3:.1f} images/s, device busy "
        f"{idle.get('busy_ms_per_call') or float('nan'):.2f} ms/step, peak "
        f"memory {peak / 2 ** 30:.2f} GiB")
    return {"dtype": label, "batch": b, "ms": ms, "ms_spread": spread,
            "samples_ms": times, "images_per_s": b / ms * 1e3,
            "device_trace": idle,
            "max_memory_allocated": peak}


def time_bf16_steps(trainer, batch, disp_scale):
    """The bf16 step at batch ``TRAIN_BATCH`` (``trainer`` and ``batch``:
    phase 3e's) and ``BF16_TIMING_BATCH``, as ``time_train_step`` times the
    f32 one, and the larger one's device time by operator
    (``--precision bfloat16``'s switches set for it, restored after)."""
    previous = bf16_matmuls()
    rows = {f"b{TRAIN_BATCH}": time_train_step(trainer, batch, disp_scale,
                                               "bf16")}
    trainer = flagship_trainer(SEED, dtype=torch.bfloat16)
    batch = stereo_batch(BF16_TIMING_BATCH, SEED + 4)
    b = f"b{BF16_TIMING_BATCH}"
    rows[b] = time_train_step(trainer, batch, disp_scale, "bf16")
    rows[b]["breakdown"] = profile_device_time(
        lambda: trainer.train_step(batch, disp_scale, TRAIN_LR),
        f"bf16 train step {b}", top=20)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        previous)
    return rows


def forward_gflop():
    """The train-mode forward's conv and matmul GFLOP an image at 256x512
    of the flagship model, its discriminator and the discriminator's
    ``features`` (``FlopCounterMode`` on the meta device: shapes only)."""
    from torch.utils.flop_counter import FlopCounterMode

    from uncertainty_model_tpu_torch.config import (
        FLAGSHIP_DISCRIMINATOR, FLAGSHIP_INPUT, FLAGSHIP_MODEL)
    from uncertainty_model_tpu_torch.models import (
        RandomDiscriminator, RandomlyConnectedModel)

    h, w = FLAGSHIP_INPUT
    counts = {}
    with torch.device("meta"):
        model = RandomlyConnectedModel(**FLAGSHIP_MODEL).train()
        disc = RandomDiscriminator(**FLAGSHIP_DISCRIMINATOR).train()
        x = torch.zeros(1, 3, h, w)
        pyramid = [torch.zeros(1, h >> i, w >> i, 6) for i in range(4)]
        for name, fn in (("model", lambda: model(x)),
                         ("discriminator", lambda: disc(pyramid)),
                         ("discriminator_features",
                          lambda: disc.features(pyramid))):
            with FlopCounterMode(display=False) as counter:
                fn()
            counts[name] = counter.get_total_flops() / 1e9
    log("  forward GFLOP an image (shapes only): "
        + ", ".join(f"{k} {v:.2f}" for k, v in counts.items()))
    return counts


def time_adversarial_step(trainer, batch, disp_scale, f32_step):
    """The adversarial step (phase 3f's trainer and batch) at a batch index
    where the perceptual term runs and the clone is not refreshed (the
    CLI's steady state: 9 batches in 10), timed as ``time_train_step``
    times the f32 step, with its device time by operator; the
    discriminator's share of the device's busy time is what the step adds
    to the f32 step's (``f32_step``, timed in the same run)."""
    row = time_train_step(trainer, batch, disp_scale, "f32 adversarial",
                          ADV_PERCEPTUAL_START)
    row["forward_gflop_per_image"] = forward_gflop()
    row["breakdown"] = profile_device_time(
        lambda: trainer.train_step(batch, disp_scale, TRAIN_LR,
                                   ADV_PERCEPTUAL_START),
        f"adversarial train step b{TRAIN_BATCH}", top=20)
    busy = row["device_trace"].get("busy_ms_per_call")
    base = f32_step["device_trace"].get("busy_ms_per_call")
    if busy and base:
        row["disc_share_of_busy"] = 1 - base / busy
        log(f"  the discriminator's share of the adversarial step's device "
            f"time: {row['disc_share_of_busy']:.3f} ({busy:.2f} ms busy "
            f"against the f32 step's {base:.2f})")
    return row


def warp_rows_work(rows, w, c):
    """(bytes, f32 operations) of one forward and one backward call: each
    input read once, each output written once."""
    pix = rows * w
    fwd = (4 * pix * (2 * c + 1), pix * (3 * c + 4))
    bwd = (4 * pix * (3 * c + 2), pix * (7 * c + 4))
    return fwd, bwd


def bound(nbytes, ops, flop_per_s=F32_FLOP_PER_S):
    """The least time (ms) for ``nbytes`` at the memory rate and ``ops`` at
    ``flop_per_s`` (f32 on the CUDA cores unless named), and which bounds."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flop_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def rotating(fn, sets):
    """A call of ``fn`` on the next of ``sets``, round robin."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def grid_sample_operands(x, src, dout):
    """``F.grid_sample``'s operands for ``warp_rows(x, src)`` and the
    cotangent ``dout``: input (R, C, 1, W), grid (R, 1, W, 2) and the
    output's gradient (R, C, 1, W)."""
    w = x.shape[1]
    inp = src.permute(0, 2, 1).unsqueeze(2).contiguous()
    gx = (2 * x + 1) / w - 1
    grid = torch.stack([gx, torch.zeros_like(gx)], -1).unsqueeze(1)
    gout = dout.permute(0, 2, 1).unsqueeze(2).contiguous()
    return inp, grid, gout


def grid_sample_fwd(inp, grid, gout):
    import torch.nn.functional as F

    return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def grid_sample_bwd(inp, grid, gout):
    return torch.ops.aten.grid_sampler_2d_backward(
        gout, inp, grid, 0, 0, False, [True, True])


def time_warp_rows():
    """Each direction at each shape of a training step at batch
    ``TRAIN_BATCH``, one problem a call (the step launches them grouped,
    ``time_warp_groups``; these rows are a log per shape): the kernel, the
    plain version, and ``F.grid_sample`` on (R, C, 1, W) (forward;
    ``grid_sampler_2d_backward`` for the backward), which computes the same
    function.  Device time per call (``time_graph_ms``); input sets rotate
    so that about 200 MB pass per sample, more than the 50 MB L2 holds.
    The eager time per call of the kernel's wrapper (host cost included) is
    logged beside it."""
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_bwd_plain, warp_rows_fwd, warp_rows_plain)

    rows_out = []
    for rows, w, c, count in warp_shapes(TRAIN_BATCH):
        (fb, fo), (bb, bo) = warp_rows_work(rows, w, c)
        n_sets = max(2, min(16, -(-200_000_000 // bb)))
        sets = []
        for k in range(n_sets):
            x, src, dout = warp_inputs(SEED + 100 + k, rows, w, c)
            sets.append((x, src, dout, *grid_sample_operands(x, src, dout)))
        lib = grid_sample_fwd(*sets[0][3:])[:, :, 0].permute(0, 2, 1)
        lib_err = (lib - warp_rows_fwd(*sets[0][:2])).abs().max().item()
        if not lib_err <= WARP_LIBRARY_TOL:
            fail(f"grid_sample does not compute warp_rows at ({rows}, {w}, "
                 f"{c}): max abs {lib_err}")
        reps = max(n_sets, 16)
        calls = {
            "fwd": lambda x, s, *_: warp_rows_fwd(x, s),
            "fwd_plain": lambda x, s, *_: warp_rows_plain(x, s),
            "fwd_library": lambda x, s, d, *lib: grid_sample_fwd(*lib),
            "bwd": lambda x, s, d, *_: warp_rows_bwd(x, s, d),
            "bwd_plain": lambda x, s, d, *_: warp_rows_bwd_plain(x, s, d),
            "bwd_library": lambda x, s, d, *lib: grid_sample_bwd(*lib),
        }
        t = {k: time_graph_ms(rotating(fn, sets), reps)
             for k, fn in calls.items()}
        eager = {k: time_ms(rotating(calls[k], sets), reps)[0]
                 for k in ("fwd", "bwd")}
        fwd_bound, fwd_by = bound(fb, fo)
        bwd_bound, bwd_by = bound(bb, bo)
        row = {"rows": rows, "w": w, "c": c, "problems_per_step": count,
               "library_max_abs_vs_kernel": lib_err,
               "fwd_bytes": fb, "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
               "bwd_bytes": bb, "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               **{f"{k}_ms": v[0] for k, v in t.items()},
               **{f"{k}_ms_spread": v[1] for k, v in t.items()},
               **{f"{k}_eager_ms": v for k, v in eager.items()}}
        log(f"  warp_rows ({rows}, {w}, {c}) x{count}/step, one problem a "
            f"call: fwd kernel "
            f"{t['fwd'][0] * 1e3:.1f} us (spread {t['fwd'][1] * 1e3:.1f}), "
            f"plain {t['fwd_plain'][0] * 1e3:.1f}, grid_sample "
            f"{t['fwd_library'][0] * 1e3:.1f}, bound {fwd_bound * 1e3:.1f} us "
            f"({fb / 1e6:.1f} MB); bwd kernel {t['bwd'][0] * 1e3:.1f} us "
            f"(spread {t['bwd'][1] * 1e3:.1f}), plain "
            f"{t['bwd_plain'][0] * 1e3:.1f}, grid_sample backward "
            f"{t['bwd_library'][0] * 1e3:.1f}, bound {bwd_bound * 1e3:.1f} us "
            f"({bb / 1e6:.1f} MB); eager calls (host included) fwd "
            f"{eager['fwd'] * 1e3:.1f}, bwd {eager['bwd'] * 1e3:.1f} us")
        rows_out.append(row)
        del sets
        torch.cuda.empty_cache()
    return rows_out


def time_warp_groups():
    """Each direction of ``warp_rows`` at each group a training step at
    batch ``TRAIN_BATCH`` launches (``warp_groups``, one launch a group
    each way): the grouped kernel, the plain version problem by problem,
    and ``F.grid_sample`` (its backward op for the backward) on each
    problem, summed over the group.  Device time per group
    (``time_graph_ms``), input sets rotating so that about 200 MB pass per
    sample; the eager time per call of the grouped wrapper (host cost
    included) is logged beside it."""
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd_many, warp_rows_bwd_plain, warp_rows_fwd_many,
        warp_rows_plain)

    def each(fn):
        return lambda xs, srcs, douts, libs: [
            fn(*p) for p in zip(xs, srcs, douts)]

    calls = {
        "fwd": lambda xs, srcs, *_: warp_rows_fwd_many(xs, srcs),
        "fwd_plain": each(lambda x, s, d: warp_rows_plain(x, s)),
        "fwd_library": lambda *a: [grid_sample_fwd(*lib) for lib in a[3]],
        "bwd": lambda xs, srcs, douts, _: warp_rows_bwd_many(xs, srcs, douts),
        "bwd_plain": each(warp_rows_bwd_plain),
        "bwd_library": lambda *a: [grid_sample_bwd(*lib) for lib in a[3]],
    }
    rows_out = []
    for name, problems, c in warp_groups(TRAIN_BATCH):
        work = [warp_rows_work(rows, w, c) for rows, w in problems]
        fb, fo = (sum(f[i] for f, _ in work) for i in range(2))
        bb, bo = (sum(b[i] for _, b in work) for i in range(2))
        n_sets = max(2, min(16, -(-200_000_000 // bb)))
        sets = []
        for k in range(n_sets):
            xs, srcs, douts = group_inputs(SEED + 100 + 10 * k, problems, c)
            libs = [grid_sample_operands(*p) for p in zip(xs, srcs, douts)]
            sets.append((xs, srcs, douts, libs))
        reps = max(n_sets, 16)
        t = {k: time_graph_ms(rotating(fn, sets), reps)
             for k, fn in calls.items()}
        eager = {k: time_ms(rotating(calls[k], sets), reps)[0]
                 for k in ("fwd", "bwd")}
        fwd_bound, fwd_by = bound(fb, fo)
        bwd_bound, bwd_by = bound(bb, bo)
        row = {"group": name, "problems": problems, "c": c,
               "launches_per_step": 1,
               "fwd_bytes": fb, "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
               "bwd_bytes": bb, "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               **{f"{k}_ms": v[0] for k, v in t.items()},
               **{f"{k}_ms_spread": v[1] for k, v in t.items()},
               **{f"{k}_eager_ms": v for k, v in eager.items()}}
        log(f"  warp_rows group {name} ({len(problems)} problems, C {c}): "
            f"fwd kernel {t['fwd'][0] * 1e3:.1f} us (spread "
            f"{t['fwd'][1] * 1e3:.1f}), plain {t['fwd_plain'][0] * 1e3:.1f}, "
            f"grid_sample {t['fwd_library'][0] * 1e3:.1f}, bound "
            f"{fwd_bound * 1e3:.1f} us ({fb / 1e6:.1f} MB, "
            f"{fb / t['fwd'][0] / 1e9:.2f} TB/s); bwd kernel "
            f"{t['bwd'][0] * 1e3:.1f} us (spread {t['bwd'][1] * 1e3:.1f}), "
            f"plain {t['bwd_plain'][0] * 1e3:.1f}, grid_sample backward "
            f"{t['bwd_library'][0] * 1e3:.1f}, bound {bwd_bound * 1e3:.1f} us "
            f"({bb / 1e6:.1f} MB, {bb / t['bwd'][0] / 1e9:.2f} TB/s); eager "
            f"calls (host included) fwd {eager['fwd'] * 1e3:.1f}, bwd "
            f"{eager['bwd'] * 1e3:.1f} us")
        rows_out.append(row)
        del sets
        torch.cuda.empty_cache()
    for d in ("fwd", "bwd"):
        log(f"  warp_rows {d} per step ({len(rows_out)} launches): kernel "
            f"{per_step(rows_out, f'{d}_ms') * 1e3:.1f} us, bound "
            f"{per_step(rows_out, f'{d}_bound_ms') * 1e3:.1f}, plain "
            f"{per_step(rows_out, f'{d}_plain_ms') * 1e3:.1f}, grid_sample "
            f"{per_step(rows_out, f'{d}_library_ms') * 1e3:.1f}")
    return rows_out


def conv_build_report():
    """Registers and spills of each instantiation of the conv kernel, from
    the ``-Xptxas -v`` build log, and the count of wgmma waits or fences
    ptxas had to add (its C7517/C7519 notes: each may serialise wgmma
    groups the source pipelines)."""
    import re

    from uncertainty_model_tpu_torch import _build

    report, name = {}, None
    for line in _build.build_log("gated_conv_elu").splitlines():
        m = re.search(r"Compiling entry function '.*gated_conv_(wgmma|f32)"
                      r"ILb(\d)E(?:Li(\d+)ELi(\d+)E)?", line)
        if m:
            kind, gated, n, kc = m.groups()
            name = (f"{'gated' if gated == '1' else 'plain'} " + (
                f"bf16 wgmma N={n} kc={kc}" if kind == "wgmma" else "f32"))
            report[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    notes = len(re.findall(r"\(C75(?:17|19)\)",
                           _build.build_log("gated_conv_elu")))
    for name, r in report.items():
        log(f"  gated_conv_elu.cu {name}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B "
            f"spill loads")
    log(f"  gated_conv_elu.cu: {notes} wgmma waits or fences added by ptxas")
    return {"functions": report, "ptxas_wgmma_notes": notes}


def time_gated_conv():
    """``gated_conv_elu`` at each (stage, inputs) shape of a forward at
    batch ``TIMING_BATCH`` in bf16: the kernel, the plain version and
    ``F.conv2d`` (cuDNN) on the already gated sum, which computes the same
    conv.  The bound takes the conv's multiply-adds at the bf16 tensor-core
    peak (the gated sum's few operations per input element are left out)."""
    import torch.nn.functional as F

    from uncertainty_model_tpu_torch.ops.conv import (
        gated_conv_elu, gated_conv_elu_plain, gated_sum)

    rows = []
    for name, h, w, c, k in S2D_CONV_STAGES:
        for n in GATED_INPUTS:
            xs, gates, wt, b = gated_conv_inputs(SEED + 50 + n, TIMING_BATCH,
                                                 h, w, c, k, n, torch.bfloat16)
            hsum = gated_sum(xs, gates).permute(0, 3, 1, 2)
            w_lib = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b_lib = b.to(torch.bfloat16)
            k_ms, k_spread = time_ms(lambda: gated_conv_elu(xs, gates, wt, b),
                                     reps=3)
            p_ms, p_spread = time_ms(
                lambda: gated_conv_elu_plain(xs, gates, wt, b), reps=1)
            l_ms, l_spread = time_ms(lambda: F.conv2d(hsum, w_lib, b_lib),
                                     reps=3)
            p = (k - 1) // 2
            pix = TIMING_BATCH * h * w
            nbytes = 2 * (n * TIMING_BATCH * (h + 2 * p) * (w + 2 * p) * c
                          + pix * c + k * k * c * c) + 4 * c
            ops = 2 * pix * k * k * c * c
            bound_ms, bound_by = bound(nbytes, ops, BF16_FLOP_PER_S)
            row = {"stage": name, "inputs": n, "batch": TIMING_BATCH,
                   "dtype": "bfloat16", "bytes": nbytes, "flop": ops,
                   "ms": k_ms, "ms_spread": k_spread, "plain_ms": p_ms,
                   "plain_ms_spread": p_spread, "library_ms": l_ms,
                   "library_ms_spread": l_spread, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   "tflop_per_s": ops / k_ms / 1e9}
            log(f"  gated_conv_elu {name} n={n} b{TIMING_BATCH}: kernel "
                f"{k_ms * 1e3:.1f} us (spread {k_spread * 1e3:.1f}, "
                f"{row['tflop_per_s']:.1f} TFLOP/s), plain {p_ms * 1e3:.1f} "
                f"us, F.conv2d {l_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f}"
                f" us by {bound_by} ({ops / 1e12:.3f} TFLOP, "
                f"{nbytes / 1e6:.1f} MB)")
            rows.append(row)
            del xs, hsum
            torch.cuda.empty_cache()
    return rows


def z_sector_bytes(b, h, w, ccat, cso, itemsize=2):
    """Bytes of the 32-byte sectors that hold z lanes, read and written
    (what the memory moves for ``gate_z`` at the least, beside its bound's
    z bytes): each batch's slab starts on a sector here."""
    n = h * w * ccat
    z = np.flatnonzero(np.arange(n) % ccat < cso)
    return 2 * b * 32 * len(np.unique(z * itemsize // 32))


def time_decoder_glue(stages=ASSEMBLE_Z_STAGES):
    """``gate_z``, ``se_squeeze`` and ``assemble`` at ``stages`` (by
    default the bench path's fused stages) at batch ``TIMING_BATCH`` in
    bf16, beside their plain versions
    and, for ``gate_z``, ``cat[..., :cso].mul_(gates)`` (the plain version
    is that call too) and the bytes of the sectors its z lanes touch;
    ``se_squeeze`` and ``assemble`` have no single PyTorch call.
    ``gate_z`` scales the same tensor in place call after call, which
    leaves its cost unchanged.  The SE mean is the row kernel's own last
    block a batch (no launch of its own)."""
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble, assemble_plain, assemble_z, gate_z, gate_z_plain,
        se_squeeze, se_squeeze_plain)

    rows = {"gate_z": [], "se_squeeze": [], "assemble": []}
    for name, h, w, cso, cu, cd, cf in stages:
        args = assemble_z_inputs(SEED + 8, TIMING_BATCH, h, w, cso, cu, cd, cf,
                                 torch.bfloat16)
        se, skip, xc, disp, bias, k_fm = args
        gates = decoder_gates(SEED + 9, TIMING_BATCH, cso, torch.bfloat16)
        cat, _ = assemble_z(*args)
        g4 = gates[:, None, None, :]
        pix = TIMING_BATCH * h * w
        z_bytes, z_ops = assemble_z_work(TIMING_BATCH, h, w, cso, cu, cd, cf, 2)
        calls = {
            "gate_z": (lambda: gate_z(cat, gates, cso),
                       lambda: gate_z_plain(cat, gates, cso),
                       lambda: cat[..., :cso].mul_(g4),
                       2 * 2 * pix * cso + 2 * TIMING_BATCH * cso, pix * cso),
            "se_squeeze": (
                lambda: se_squeeze(se, skip, bias, k_fm),
                lambda: se_squeeze_plain(se, skip, bias, k_fm), None,
                2 * (pix * (cf or cso) + pix // 4 * cso) + 4 * TIMING_BATCH * cso,
                pix * cso * (12 + 2 * cf)),
            "assemble": (
                lambda: assemble(se, skip, gates, xc, disp, bias, k_fm),
                lambda: assemble_plain(se, skip, gates, xc, disp, bias, k_fm),
                None, z_bytes - 2 * TIMING_BATCH * cso, z_ops + pix * cso),
        }
        for kernel, (fn, plain, library, nbytes, ops) in calls.items():
            k = time_ms(fn, reps=10)
            p = time_ms(plain, reps=2)
            lib = time_ms(library, reps=10) if library else None
            row = glue_row(name, nbytes, ops, k, p, lib)
            extra = ""
            if kernel == "gate_z":
                row["sector_bytes"] = z_sector_bytes(TIMING_BATCH, h, w,
                                                     cso + cu + cd, cso)
                row["sector_tb_per_s"] = row["sector_bytes"] / k[0] / 1e9
                extra = (f"; z sectors {row['sector_bytes'] / 1e6:.1f} MB, "
                         f"{row['sector_tb_per_s']:.2f} TB/s")
            rows[kernel].append(row)
            log_glue_row(kernel, row, extra)
        del args, cat
        torch.cuda.empty_cache()
    return rows


def glue_build_report():
    """Registers, spills and stack of each instantiation of the decoder
    glue's kernels (the row kernel in its three modes, gate_z), from the
    ``-Xptxas -v`` build logs."""
    import re

    from uncertainty_model_tpu_torch import _build

    report = {}
    for lib in ("assemble_z", "decoder_fused"):
        name = None
        for line in _build.build_log(lib).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                mangled = m.group(1)
                k = re.search(r"decoder_rows(I\S+?)EEEv", mangled)
                g = re.search(r"gate_z_flatI(\S+?)EEv", mangled)
                name = (f"decoder_rows<{k.group(1)}>" if k else
                        f"gate_z_flat<{g.group(1)}>" if g else None)
                if name:
                    report[name] = {}
            elif name and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
                stack = re.search(r"(\d+) bytes stack frame", line)
                report[name].update(spill_stores=int(st), spill_loads=int(ld),
                                    stack=int(stack.group(1)) if stack else 0)
            elif name and "Used" in line and "registers" in line:
                report[name]["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    for name, r in report.items():
        log(f"  {name}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B "
            f"spill loads, {r.get('stack')} B stack")
    return report


def time_eval_step(model, loader):
    """CUDA-event time of one ``eval_step`` at batch ``EVAL_BATCH`` (median
    and spread of 9, after 2 warm-up calls), the device's idle share over 3
    steps (``device_idle``) and its device time by operator."""
    from uncertainty_model_tpu_torch.train import eval_step

    batch = loader[0]
    noise = torch.rand((EVAL_BATCH, *batch["left"].shape[1:3], 2),
                       generator=torch.Generator("cuda").manual_seed(SEED),
                       device="cuda")

    def step():
        eval_step(model, batch, adjust_scale(), noise)

    ms, spread = time_ms(step, reps=1)
    log(f"  eval step f32 b{EVAL_BATCH} 256x512: {ms:.2f} ms (spread "
        f"{spread:.2f} ms over 9), {EVAL_BATCH / ms * 1e3:.1f} images/s")
    idle = device_idle(step)
    breakdown = profile_device_time(step, f"eval step b{EVAL_BATCH}", top=15)
    return {"batch": EVAL_BATCH, "ms": ms, "ms_spread": spread,
            "images_per_s": EVAL_BATCH / ms * 1e3, "device_trace": idle,
            "breakdown": breakdown}


def repeated_train_set(home, times=LOADER_REPEAT):
    """The CLI's training set (its augmenting transform at 256x512) with
    its pairs listed ``times`` over: ``times * CLI_TRAIN_PAIRS`` pairs, so
    that an epoch has enough steps to time."""
    import os

    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT
    from uncertainty_model_tpu_torch.data import (
        DaVinciDataset, StereoPairDataset, default_augment_transform)

    ds = DaVinciDataset(os.path.join(home, "datasets", "da-vinci"), "train",
                        default_augment_transform(FLAGSHIP_INPUT))
    return StereoPairDataset(ds.lefts * times, ds.rights * times, ds.transform)


def median_ms(fn, n=5):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_loader(home):
    """The training loader alone (b8, ``CLI_WORKERS`` threads, the
    augmenting transform, shuffled; the files in the OS page cache),
    drained by a consumer that does nothing: pairs/s over 2 epochs of
    ``repeated_train_set`` after one of warm-up; then the same beside a
    thread that runs Python bytecode without pause (what the training
    step's enqueue does to the interpreter lock).  Beside it, on one thread,
    one file's decode stages (read + chunk checks + inflate; filters and
    expansion; the resize to 256x512), one batch's fused decode + resize of
    its 16 files on ``CLI_WORKERS`` threads, and the flip and augmentation
    of the batch's 8 pairs (medians of 5)."""
    import os

    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT
    from uncertainty_model_tpu_torch.data import Compose, DataLoader, native

    ds = repeated_train_set(home)
    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True,
                        num_workers=CLI_WORKERS, drop_last=True)

    def drain():
        """(pairs, seconds) of 2 epochs."""
        pairs, t0 = 0, time.perf_counter()
        for epoch in (1, 2):
            loader.set_epoch(epoch)
            for batch in loader:
                pairs += len(batch["left"])
        return pairs, time.perf_counter() - t0

    for _ in loader:
        pass
    pairs, seconds = drain()
    # the same with a thread that runs Python bytecode without pause, as
    # the training step's enqueue does: it holds the interpreter lock but
    # for the switch interval, and one core
    stop = threading.Event()

    def spin():
        n = 0
        while not stop.is_set():
            n += 1

    spinner = threading.Thread(target=spin)
    spinner.start()
    try:
        busy_pairs, busy_seconds = drain()
    finally:
        stop.set()
        spinner.join()

    h, w = FLAGSHIP_INPUT
    path = ds.lefts[0]
    image = native.decode_png(path)
    paths = ds.lefts[:TRAIN_BATCH] + ds.rights[:TRAIN_BATCH]
    decoded = native.decode_resize_batch(paths, h, w, CLI_WORKERS)
    rest = Compose(ds.transform.transforms[1:])
    rngs = [np.random.default_rng((SEED, i)) for i in range(TRAIN_BATCH)]

    def post_decode():
        for j, rng in enumerate(rngs):
            rest({"left": decoded[j], "right": decoded[TRAIN_BATCH + j]}, rng)

    stages = {
        "read_check_inflate_ms": median_ms(lambda: native._read_png(path)),
        "decode_png_ms": median_ms(lambda: native.decode_png(path)),
        "resize_ms": median_ms(lambda: native.resize_rgb8(image, h, w)),
        "batch_decode_resize_ms": median_ms(
            lambda: native.decode_resize_batch(paths, h, w, CLI_WORKERS)),
        "batch_flip_augment_ms": median_ms(post_decode),
    }
    result = {"batch": TRAIN_BATCH, "workers": CLI_WORKERS,
              "cpu_count": os.cpu_count(), "pairs": pairs,
              "seconds": seconds, "pairs_per_s": pairs / seconds,
              "pairs_per_s_beside_busy_thread": busy_pairs / busy_seconds,
              "switch_interval_s": sys.getswitchinterval(),
              "source_shape": list(CLI_SOURCE_SHAPE),
              "file_bytes": os.path.getsize(path), **stages}
    log(f"  loader alone: {pairs / seconds:.1f} pairs/s ({pairs} pairs in "
        f"{seconds:.2f} s; b{TRAIN_BATCH}, {CLI_WORKERS} workers, "
        f"os.cpu_count() {os.cpu_count()}, {CLI_SOURCE_SHAPE[0]}x"
        f"{CLI_SOURCE_SHAPE[1]} PNGs of {result['file_bytes'] / 2 ** 20:.2f} "
        f"MiB to 256x512); beside a thread running Python without pause "
        f"{busy_pairs / busy_seconds:.1f} pairs/s (switch interval "
        f"{sys.getswitchinterval() * 1e3:.1f} ms)")
    log("  one file on one thread: read + chunk checks + inflate "
        f"{stages['read_check_inflate_ms']:.2f} ms, whole decode "
        f"{stages['decode_png_ms']:.2f} ms, resize {stages['resize_ms']:.2f} "
        f"ms; a batch's 16 files on {CLI_WORKERS} threads "
        f"{stages['batch_decode_resize_ms']:.2f} ms, its flips and "
        f"augmentation {stages['batch_flip_augment_ms']:.2f} ms")
    return result


def time_fed_step(home):
    """The f32 flagship step at b8 three ways, each timed over an epoch of
    ``LOADER_REPEAT * CLI_TRAIN_PAIRS / 8`` steps of ``train_one_epoch``
    (the losses read at the epoch's end, as the CLI reads them), host clock
    to a synchronise, in turns (fed, host, device, device, host, fed, ...),
    medians of 3 after 2 warm-up epochs of each: fed by the CLI's loader
    (decoding and augmenting as it goes), the same epoch's batches decoded
    beforehand and held as numpy arrays (so the step still copies them to
    the card), and the same batches already on the card (phase 4's fixed
    batch).  Then the device's idle share over one fed epoch
    (``device_idle``; ``time_train_step`` traces the device batches'
    step)."""
    from uncertainty_model_tpu_torch.data import DataLoader

    trainer = flagship_trainer(SEED + 30)
    loader = DataLoader(repeated_train_set(home), TRAIN_BATCH, shuffle=True,
                        num_workers=CLI_WORKERS, drop_last=True)
    host = list(loader)
    device = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
              for b in host]
    scale = adjust_scale()
    variants = {"fed": loader, "host": host, "device": device}

    def epoch(name):
        trainer.train_one_epoch(variants[name], scale, TRAIN_LR)
        torch.cuda.synchronize()

    for _ in range(2):
        for name in variants:
            epoch(name)
    samples = {name: [] for name in variants}
    order = list(variants) + list(reversed(variants))
    for name in order + order[:3]:
        samples[name].append(median_ms(lambda: epoch(name), n=1) / len(host))
    ms = {name: statistics.median(v) for name, v in samples.items()}
    log(f"  train step f32 b{TRAIN_BATCH} over epochs of {len(host)} steps "
        f"(ms/step, median of 3): fed by the loader {ms['fed']:.2f}, "
        f"numpy batches {ms['host']:.2f}, device batches {ms['device']:.2f}; "
        "samples " + "; ".join(f"{k} " + ", ".join(f"{t:.2f}" for t in v)
                               for k, v in samples.items()))
    log("  fed epoch:")
    fed_idle = device_idle(lambda: epoch("fed"), calls=1)
    return {"steps_per_epoch": len(host), "ms_per_step": ms,
            "samples_ms": samples, "fed_images_per_s":
            TRAIN_BATCH / ms["fed"] * 1e3,
            "fed_device_trace": fed_idle}


def time_conv_elu():
    """``conv_elu`` at the native encoder's interior conv shapes at batch
    ``TIMING_BATCH`` in bf16: the kernel, the plain version and cuDNN's
    ``F.conv2d`` with bias then ``F.elu`` (two calls), device time per
    call (``time_graph_ms``).  The bound takes the conv's multiply-adds at
    the bf16 tensor-core peak."""
    import torch.nn.functional as F

    from uncertainty_model_tpu_torch.ops.conv import conv_elu, conv_elu_plain

    rows = []
    for name, h, w, c, k in NATIVE_CONV_STAGES:
        x, wt, b = conv_elu_inputs(SEED + 70 + k, TIMING_BATCH, h, w, c, k,
                                   torch.bfloat16)
        p = (k - 1) // 2
        x_lib = x.permute(0, 3, 1, 2)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_lib = b.to(torch.bfloat16)
        k_ms, k_spread = time_graph_ms(lambda: conv_elu(x, wt, b), reps=4)
        p_ms, p_spread = time_graph_ms(lambda: conv_elu_plain(x, wt, b),
                                       reps=2)
        l_ms, l_spread = time_graph_ms(
            lambda: F.elu(F.conv2d(x_lib, w_lib, b_lib, padding=p)), reps=4)
        pix = TIMING_BATCH * h * w
        nbytes = 2 * (2 * pix * c + k * k * c * c) + 4 * c
        ops = 2 * pix * k * k * c * c
        bound_ms, bound_by = bound(nbytes, ops, BF16_FLOP_PER_S)
        row = {"stage": name, "k": k, "c": c, "h": h, "w": w,
               "batch": TIMING_BATCH, "dtype": "bfloat16", "bytes": nbytes,
               "flop": ops, "ms": k_ms, "ms_spread": k_spread,
               "plain_ms": p_ms, "plain_ms_spread": p_spread,
               "library_ms": l_ms, "library_ms_spread": l_spread,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflop_per_s": ops / k_ms / 1e9}
        log(f"  conv_elu {name} {k}x{k} C={c} {h}x{w} b{TIMING_BATCH}: "
            f"kernel {k_ms * 1e3:.1f} us (spread {k_spread * 1e3:.1f}, "
            f"{row['tflop_per_s']:.1f} TFLOP/s), plain {p_ms * 1e3:.1f} us, "
            f"F.conv2d+F.elu "
            f"{l_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us by "
            f"{bound_by} ({ops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB)")
        rows.append(row)
        del x, x_lib
        torch.cuda.empty_cache()
    return rows


def time_upsample2x2():
    """``upsample2x2`` at the upsample sites at batch ``TIMING_BATCH`` in
    bf16: the kernel, the plain version and ``F.interpolate`` (bilinear,
    align_corners, on the channels-last NCHW view), which computes the same
    function; device time per call (``time_graph_ms``), input sets rotating
    so that about 200 MB pass per sample, more than the 50 MB L2 holds."""
    import torch.nn.functional as F

    from uncertainty_model_tpu_torch.ops.upsample import (
        upsample2x2, upsample2x2_plain)

    def library(x):
        return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                             mode="bilinear", align_corners=True)

    rows = []
    for name, h, w, c in UPSAMPLE_SITES:
        elems = TIMING_BATCH * h * w * c
        nbytes = 2 * 5 * elems + 4 * (2 * w + 4 * 2 * h)
        n_sets = max(2, min(16, -(-200_000_000 // nbytes)))
        sets = [(upsample_input(SEED + 80 + i, TIMING_BATCH, h, w, c,
                                torch.bfloat16),) for i in range(n_sets)]
        lib_err = (library(sets[0][0]).permute(0, 2, 3, 1).float()
                   - upsample2x2(sets[0][0]).float()).abs().max().item()
        reps = max(n_sets, 8)
        k_ms, k_spread = time_graph_ms(rotating(upsample2x2, sets), reps)
        p_ms, p_spread = time_graph_ms(rotating(upsample2x2_plain, sets), reps)
        l_ms, l_spread = time_graph_ms(rotating(library, sets), reps)
        bound_ms, bound_by = bound(nbytes, 18 * elems)
        rows.append({"site": name, "shape": [TIMING_BATCH, h, w, c],
                     "dtype": "bfloat16", "bytes": nbytes, "ms": k_ms,
                     "ms_spread": k_spread, "plain_ms": p_ms,
                     "plain_ms_spread": p_spread, "library_ms": l_ms,
                     "library_ms_spread": l_spread, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_max_abs_vs_kernel": lib_err})
        log(f"  upsample2x2 {name} ({TIMING_BATCH}, {h}, {w}, {c}): kernel "
            f"{k_ms * 1e3:.1f} us (spread {k_spread * 1e3:.1f}), plain "
            f"{p_ms * 1e3:.1f} us, F.interpolate {l_ms * 1e3:.1f} us (max abs "
            f"{lib_err:.3g} from the kernel), bound {bound_ms * 1e3:.1f} us "
            f"by {bound_by} ({nbytes / 1e6:.1f} MB)")
        del sets
        torch.cuda.empty_cache()
    return rows


def per_step(rows, key):
    """The sum over one training step's launches of a per-call column."""
    return sum(r[key] * r["launches_per_step"] for r in rows)


# ---------------------------------------------------------------------------


def summed(rows, name, source, replaces, launches, worst, library,
           unit=f"one serving forward at batch {TIMING_BATCH}"):
    """A ``kernels`` line entry whose times sum ``rows``: by default the
    launches of one serving forward at batch ``TIMING_BATCH``."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        # ms, plain_ms, bound_ms and library_ms cover these launches
        "timed_launches": len(rows),
        "timed_unit": unit,
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in rows) if library else None,
    }


def with_options(entry, option_launches, option_rows=()):
    """A ``kernels`` line entry with its kernel's launches summed over the
    option paths' bf16 forwards at batch 8 (``launches_options``), and,
    where given, its times at the option stages (dec0 and dec1, one call
    each at batch ``TIMING_BATCH``) summed."""
    entry["launches_options"] = sum(
        counts[entry["name"]] for counts in option_launches.values())
    if option_rows:
        entry["dec0_dec1"] = {
            "stages": [r["stage"] for r in option_rows],
            **{key: sum(r[key] for r in option_rows)
               for key in ("ms", "plain_ms", "bound_ms")}}
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from uncertainty_model_tpu_torch.ops.conv import conv_elu, gated_conv_elu
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble, assemble_z, gate_z, se_squeeze)
    from uncertainty_model_tpu_torch.ops.upsample import upsample2x2
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_fwd)
    from uncertainty_model_tpu_torch import parallel
    from uncertainty_model_tpu_torch.serving import make_serving_forward

    serving_counters = {"assemble_z": assemble_z, "gate_z": gate_z,
                        "se_squeeze": se_squeeze, "assemble": assemble,
                        "gated_conv_elu": gated_conv_elu,
                        "conv_elu": conv_elu, "upsample2x2": upsample2x2}
    train_counters = {"warp_rows_fwd": warp_rows_fwd,
                      "warp_rows_bwd": warp_rows_bwd}
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # f32 convs and matmuls in full f32 throughout: the plain versions and
    # the f32 forwards are references
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("1: build")
    build_kernels(["assemble_z", "decoder_fused", "gated_conv_elu",
                   "warp_rows", "upsample2x2", "stereo_decode"])

    phase("2: kernels vs plain versions")
    worst = check_assemble_z()
    glue_worst = check_decoder_glue()
    conv_worst = check_gated_conv_elu()
    warp_worst = check_warp_rows()
    conv_elu_worst = check_conv_elu()
    upsample_worst = check_upsample2x2()

    phase("3: serving paths")
    model = flagship_model()
    launches, forward, x8, ref = run_main_path(model, serving_counters)
    s2d_forwards, s2d_launches, s2d_errs = run_paths(
        model, serving_counters, x8, ref, S2D_PATHS)
    option_forwards, option_launches, option_errs = run_paths(
        model, serving_counters, x8, ref, OPTION_PATHS)
    option_forwards = {k: option_forwards[k] for k in TIMED_OPTION_PATHS}
    del x8, ref

    phase("3b: training path")
    trainer, batch, disp_scale, train_launches = run_training_path(
        train_counters)
    cpu_check, cpu_f32_grads = check_step_against_cpu(disp_scale)

    phase("3c: evaluation and checkpoints")
    all_counters = {**serving_counters, **train_counters}
    eval_model, eval_loader, eval_metrics, eval_launches = run_evaluation(
        all_counters)
    eval_vs_cpu = check_eval_step_against_cpu()
    train_model_run = run_train_model_with_checkpoints(train_counters,
                                                       eval_loader)
    converted_resume = check_converted_resume(all_counters)
    torch.cuda.empty_cache()

    phase("3d: the training CLI fed by the data pipeline")
    tree = tempfile.TemporaryDirectory()
    write_davinci_tree(tree.name, SEED + 28)
    cli_run = run_cli_path(all_counters, tree.name, tree.name)

    phase("3e: bf16 mixed-precision training")
    previous = bf16_matmuls()
    bf16_trainer, bf16_batch, _, bf16_launches = run_training_path(
        all_counters, torch.bfloat16)
    log("  warp_rows at the bf16 step's shapes: the disparities reach the "
        "warps in f32, so its groups are the f32 step's, held in phase 2")
    check_f32_state(bf16_trainer, f"after {TRAIN_STEPS} bf16 steps")
    bf16_vs_cpu = check_bf16_step_against_cpu(disp_scale, cpu_f32_grads)
    del cpu_f32_grads
    bf16_trajectory = check_bf16_trajectory()
    bf16_cli = run_bf16_cli(all_counters, tree.name,
                            os.path.join(tree.name, "bf16"))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        previous)
    torch.cuda.empty_cache()

    phase("3f: adversarial training")
    adv_trainer, adv_batch, adv_launches, adv_losses = run_adversarial_path(
        all_counters)
    adv_vs_cpu = check_adversarial_step_against_cpu(disp_scale)
    adv_cli = run_adversarial_cli(all_counters, tree.name,
                                  os.path.join(tree.name, "adversarial"))
    torch.cuda.empty_cache()

    phase("3g: data parallelism (DDP, a world of 1)")
    parallel_cli = run_parallel_cli(all_counters, tree.name,
                                    os.path.join(tree.name, "parallel"),
                                    cli_run["losses"])
    init_world_of_one()
    ddp_vs_plain = check_ddp_step(disp_scale)
    ddp_trainer, _, _, ddp_launches = run_training_path(
        all_counters, distributed=True)
    ddp_collectives = count_collectives(ddp_trainer, batch, disp_scale)
    ddp_adv_trainer, ddp_adv = run_ddp_adversarial(all_counters, disp_scale)
    del ddp_adv_trainer
    torch.cuda.empty_cache()

    phase("3h: training-mode s2d encoder stages")
    s2d_trainer, s2d_batch, _, s2d_train_launches = run_training_path(
        all_counters, s2d_stages=S2D_TRAIN_STAGES)
    s2d_vs_direct = check_s2d_step_against_direct(disp_scale)
    torch.cuda.empty_cache()

    phase("4: times")
    fwd = time_forward(forward)
    serving_timer = time_serving_timer(forward, fwd)
    s2d_fwd = {key: time_forward(f, f"({key}) {S2D_PATHS[key][0]}")
               for key, f in s2d_forwards.items()}
    s2d_fwd["a_lax"] = time_forward(
        make_serving_forward(model, dtype=torch.bfloat16, s2d_stages=(0, 1),
                             s2d_conv_backend="lax"),
        "(a) with s2d_conv_backend='lax'")
    option_fwd = {key: time_forward(f, f"{key} {OPTION_PATHS[key][0]}")
                  for key, f in option_forwards.items()}
    del option_forwards
    stages = time_assemble_z()
    option_stages = time_assemble_z(TIMED_OPTION_GLUE_STAGES)
    conv_build = conv_build_report()
    conv_rows = time_gated_conv()
    glue_build = glue_build_report()
    glue_rows = time_decoder_glue()
    option_glue_rows = time_decoder_glue(TIMED_OPTION_GLUE_STAGES)
    x = images(TIMING_BATCH, SEED + 3)
    breakdown = profile_device_time(lambda: forward(x),
                                    f"serving forward b{TIMING_BATCH}")
    breakdown_s2d = {
        key: profile_device_time(lambda f=f: f(x),
                                 f"serving forward ({key}) b{TIMING_BATCH}")
        for key, f in s2d_forwards.items()}
    del x, s2d_forwards
    torch.cuda.empty_cache()
    step = time_train_step(trainer, batch, disp_scale)
    s2d_step = time_train_step(s2d_trainer, s2d_batch, disp_scale,
                               label=f"f32 s2d_stages={S2D_TRAIN_STAGES}")
    del s2d_trainer, s2d_batch
    ddp_step = time_train_step(ddp_trainer, batch, disp_scale,
                               label="f32 DDP (world 1)")
    ddp_breakdown = profile_device_time(
        lambda: ddp_trainer.train_step(batch, disp_scale, TRAIN_LR),
        f"DDP train step b{TRAIN_BATCH}", top=30)
    del ddp_trainer
    parallel.destroy()
    warps = time_warp_groups()
    warp_shapes_log = time_warp_rows()
    step_breakdown = profile_device_time(
        lambda: trainer.train_step(batch, disp_scale, TRAIN_LR),
        f"train step b{TRAIN_BATCH}", top=30)
    del trainer, batch
    torch.cuda.empty_cache()
    adv_step = time_adversarial_step(adv_trainer, adv_batch, disp_scale,
                                     step)
    del adv_trainer, adv_batch
    torch.cuda.empty_cache()
    bf16_steps = time_bf16_steps(bf16_trainer, bf16_batch, disp_scale)
    del bf16_trainer, bf16_batch
    eval_time = time_eval_step(eval_model, eval_loader)
    del eval_model, eval_loader
    torch.cuda.empty_cache()
    loader_time = time_loader(tree.name)
    fed_step = time_fed_step(tree.name)
    tree.cleanup()
    torch.cuda.empty_cache()
    conv_elu_rows = time_conv_elu()
    upsample_rows = time_upsample2x2()
    log(json.dumps({"forward": fwd, "serving_timer": serving_timer,
                    "s2d_forwards": s2d_fwd,
                    "s2d_vs_eval_model": s2d_errs,
                    "option_forwards": option_fwd,
                    "option_launches": option_launches,
                    "option_vs_eval_model": option_errs,
                    "option_assemble_z_stages": option_stages,
                    "option_decoder_glue_stages": option_glue_rows,
                    "s2d_training": {"launches": s2d_train_launches,
                                     "vs_direct": s2d_vs_direct,
                                     "train_step": s2d_step},
                    "assemble_z_stages": stages,
                    "gated_conv_elu_shapes": conv_rows,
                    "gated_conv_elu_build": conv_build,
                    "decoder_glue_stages": glue_rows,
                    "decoder_glue_build": glue_build,
                    "se_mean": "the row kernel's last block of each batch "
                               "(no launch of its own)",
                    "breakdown": breakdown, "breakdown_s2d": breakdown_s2d,
                    "train_step": step, "bf16_train_steps": bf16_steps,
                    "train_vs_cpu": cpu_check,
                    "bf16": {"launches": bf16_launches,
                             "vs_cpu": bf16_vs_cpu,
                             "trajectory": bf16_trajectory, "cli": bf16_cli},
                    "adversarial": {"launches": adv_launches,
                                    "losses": adv_losses,
                                    "vs_cpu": adv_vs_cpu, "cli": adv_cli,
                                    "train_step": adv_step},
                    "ddp": {"launches": ddp_launches,
                            "vs_plain": ddp_vs_plain,
                            "collectives": ddp_collectives,
                            "adversarial": ddp_adv, "cli": parallel_cli,
                            "train_step": ddp_step,
                            "breakdown": ddp_breakdown},
                    "warp_rows_groups": warps,
                    "warp_rows_shapes": warp_shapes_log,
                    "train_breakdown": step_breakdown,
                    "evaluation": {"metrics": eval_metrics,
                                   "launches": eval_launches},
                    "eval_vs_cpu": eval_vs_cpu,
                    "train_model": train_model_run,
                    "converted_resume": converted_resume,
                    "eval_step": eval_time,
                    "cli": cli_run, "loader": loader_time,
                    "fed_step": fed_step,
                    "conv_elu_shapes": conv_elu_rows,
                    "upsample2x2_sites": upsample_rows}))

    csrc = "uncertainty_model_tpu_torch/csrc/"
    pallas = "uncertainty_model_tpu/ops/pallas/"
    kernels = [with_options(
        summed(stages, "assemble_z", csrc + "assemble_z.cu",
               pallas + "decoder_fused.py:250", launches["assemble_z"],
               worst, library=False), option_launches, option_stages)]
    # warp_rows: launches counts the whole epoch's; the times cover the 5
    # grouped launches of one training step; the library call is
    # grid_sample (its backward op for the backward) on each problem
    for name, d, line in (("warp_rows_fwd", "fwd", 115),
                          ("warp_rows_bwd", "bwd", 140)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "uncertainty_model_tpu_torch/csrc/warp_rows.cu",
            "replaces": f"uncertainty_model_tpu/ops/pallas/warp.py:{line}",
            "launches": train_launches[name],
            "launches_bf16": bf16_launches[name],
            "launches_cli": cli_run["launches"][name],
            "launches_cli_bf16": bf16_cli["launches"][name],
            "launches_adversarial": adv_launches[name],
            "launches_cli_adversarial": adv_cli["launches"][name],
            "launches_ddp": ddp_launches[name],
            "launches_ddp_adversarial": ddp_adv["launches"][name],
            "launches_cli_parallel": parallel_cli["launches"][name],
            "launches_s2d_training": s2d_train_launches[name],
            "launches_converted_resume": converted_resume["launches"][name],
            "timed_launches": sum(r["launches_per_step"] for r in warps),
            "timed_unit": f"one training step at batch {TRAIN_BATCH}",
            "max_abs_err": warp_worst[d],
            "ms": per_step(warps, f"{d}_ms"),
            "plain_ms": per_step(warps, f"{d}_plain_ms"),
            "bound_ms": per_step(warps, f"{d}_bound_ms"),
            "bound_by": "bytes" if all(r[f"{d}_bound_by"] == "bytes"
                                       for r in warps) else "operations",
            "library_ms": per_step(warps, f"{d}_library_ms"),
        })
    # the decoder glue and the gated conv: launches from the forward of the
    # path that runs each, (a), (b) or (c) of S2D_PATHS
    for name, path, line in (("gate_z", "b", 360), ("se_squeeze", "c", 448),
                             ("assemble", "c", 581)):
        kernels.append(with_options(summed(
            glue_rows[name], name, csrc + "decoder_fused.cu",
            pallas + f"decoder_fused.py:{line}", s2d_launches[path][name],
            glue_worst[name], library=name == "gate_z"), option_launches,
            option_glue_rows[name]))
    kernels.append(with_options(summed(
        conv_rows, "gated_conv_elu", csrc + "gated_conv_elu.cu", pallas + "conv.py:179",
        s2d_launches["a"]["gated_conv_elu"], conv_worst, library=True),
        option_launches))
    # conv_elu and upsample2x2: no path of the package launches them (0 in
    # every path's run above); the times sum one call at each shape
    kernels.append(summed(
        conv_elu_rows, "conv_elu", csrc + "gated_conv_elu.cu",
        pallas + "conv.py:76", launches["conv_elu"], conv_elu_worst,
        library=True,
        unit=f"one call at each native encoder interior conv shape, enc0-enc4,"
             f" batch {TIMING_BATCH}, bf16"))
    kernels.append(summed(
        upsample_rows, "upsample2x2", csrc + "upsample2x2.cu",
        pallas + "upsample.py:109", launches["upsample2x2"], upsample_worst,
        library=True,
        unit=f"one call at each 2x upsample site, batch {TIMING_BATCH}, bf16"))
    phase("5: the kernels line")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
