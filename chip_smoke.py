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
   channels >= Cso unwritten (they hold NaN before and after);
3. run the serving paths: the 22.5M-parameter flagship model's bf16 serving
   forward at 256x512, batch 8, from random weights made from a seed, with
   the kernel launch counters zeroed just before and read just after; the
   output is held against the f32 eval model.  First the bench path
   (``s2d_stages=()``, gate_fold: 3 ``assemble_z``), then the JAX
   package's default encoder, ``s2d_stages=(0, 1)``, with each decoder
   pipeline: (a) gate_fold, 8 ``gated_conv_elu`` + 3 ``assemble_z``;
   (b) gate_z, 8 + 3 + 3 ``gate_z``; (c) squeeze_first, 8 + 3
   ``se_squeeze`` + 3 ``assemble``.  Each also in f32 (TF32 off);
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
4. time the serving forwards at batch 64 (the bench path, (a), (b), (c),
   and (a) with ``s2d_conv_backend="lax"``), the training step and the
   eval step at batch 8 (each with the device's idle share), and each
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
   operator (``torch.profiler``);
5. print the ``kernels`` line, then the device line last.

Phase 2 also holds ``conv_elu`` (the SAME zero-pad conv, the ungated mode
of the ``gated_conv_elu`` kernel) at the native encoder's five interior
conv shapes, enc0-enc4, and ``upsample2x2`` at the decoder's 2x upsample
sites, at batch 64, in bf16 and f32.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
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
TRAIN_STEPS = 6
TRAIN_LR = 1e-4     # the CLI's default learning rate
CPU_CHECK_BATCH = 2
LOSS_RTOL = 1e-4    # card step vs CPU step, each loss
GRAD_REL, GRAD_FLOOR = 5e-3, 5e-3   # |g_card - g_cpu| < max(rel |g|, floor)
LOSS_GRAD_REL = 1e-5    # dL/dD card vs CPU at equal disparities, per scale
WHOLE_STEP_MEDIAN_REL = 3e-2   # whole-step gradients card vs CPU, median
DSRC_TOL = 1e-5     # warp_rows dsrc: 1e-5 * (1 + sum of the terms' |.|)
CONV_F32_TOL = 1e-5     # gated_conv_elu f32: 1e-5 * (1 + sum of the terms' |.|)
WARP_LIBRARY_TOL = 1e-2   # grid_sample vs the kernel (x -> grid rounding)
PORT_KERNELS = ("decoder_rows", "gate_z_flat", "gated_conv",
                "warp_rows", "upsample2x2")   # device kernel names, for the profiler
EVAL_BATCH = 8      # the evaluation's batch (the CLI's default)
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


def assemble_z_inputs(seed, b, h, w, cso, cu, cd, cf, dtype, device="cuda"):
    rng = np.random.default_rng(seed)
    h2, w2 = h // 2, w // 2

    def t(*shape, dt=dtype):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dt)

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
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_disp in (True, False):
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
    return ("eval", [(batch * h, w)] * 2, 3)


def warp_inputs(seed, rows, w, c):
    """x over [-0.3 W - 1, 1.3 W + 1] (outside [0, W) included) with a third
    of it on integers, src and a cotangent, on the card."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.3 * w - 1, 1.3 * w + 1, size=(rows, w))
    integer = rng.uniform(size=(rows, w)) < 1 / 3
    x[integer] = np.round(x[integer])

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")

    return t(x), t(rng.normal(size=(rows, w, c))), t(rng.normal(size=(rows, w, c)))


def group_inputs(seed, problems, c):
    """``warp_inputs`` of each problem of a group: (xs, srcs, douts)."""
    sets = [warp_inputs(seed + k, rows, w, c)
            for k, (rows, w) in enumerate(problems)]
    return tuple([s[i] for s in sets] for i in range(3))


def check_warp_rows():
    """Each direction of ``warp_rows`` against its plain version at the
    groups a training step launches (``warp_groups``) and at the
    evaluation's (``eval_warp_group``), one launch each way a group;
    returns the worst abs error of each."""
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_bwd_many, warp_rows_bwd_plain,
        warp_rows_fwd, warp_rows_fwd_many, warp_rows_plain)

    worst = {"fwd": 0.0, "bwd": 0.0}
    for k, (name, problems, c) in enumerate(
            warp_groups(TRAIN_BATCH) + [eval_warp_group(EVAL_BATCH)]):
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


def decoder_gates(seed, b, cso, dtype, device="cuda"):
    """SE gates in (0, 1), as the SE MLP's sigmoid gives them."""
    g = np.random.default_rng(seed).uniform(0.05, 1.0, (b, cso))
    return torch.from_numpy(g.astype(np.float32)).to(device=device, dtype=dtype)


def check_decoder_glue():
    """``gate_z``, ``se_squeeze`` and ``assemble`` against their plain
    versions at the fused stages' shapes; on the card, ``assemble(g)``
    equals ``gate_z(assemble_z(), g)`` bit for bit and ``gate_z`` leaves the
    channels >= Cso untouched.  Returns the worst abs error of each."""
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble, assemble_plain, assemble_z, gate_z, gate_z_plain,
        se_squeeze, se_squeeze_plain)

    worst = {"gate_z": 0.0, "se_squeeze": 0.0, "assemble": 0.0}
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_disp in (True, False):
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

    rng = np.random.default_rng(seed)
    p = (k - 1) // 2

    def t(*shape, scale=1.0, dt=dtype):
        a = (scale * rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(device="cuda", dtype=dt)

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
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        a = (scale * rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(device="cuda", dtype=dt)

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
    x = np.random.default_rng(seed).normal(size=(b, h, w, c))
    return torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)


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


def run_s2d_paths(model, counters, x, ref):
    """Forwards (a), (b), (c) of ``S2D_PATHS`` at batch 8 on ``x``: bf16,
    counters zeroed just before and read just after, each count as listed;
    then f32 (TF32 off).  Both are held against the f32 eval model's
    ``ref``.  Returns ({path: bf16 forward}, {path: launches}, {path: (bf16
    err, f32 err)})."""
    from uncertainty_model_tpu_torch.serving import make_serving_forward

    forwards, launches, errs = {}, {}, {}
    for key, (options, expected) in S2D_PATHS.items():
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


def flagship_trainer(seed, device="cuda"):
    """The flagship in train mode from ``seed`` with ``FLAGSHIP_LOSS``."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_LOSS, FLAGSHIP_MODEL
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
    from uncertainty_model_tpu_torch.train import Trainer

    model = RandomlyConnectedModel.from_config(**FLAGSHIP_MODEL, seed=seed,
                                               device=device).train()
    return Trainer(model, FLAGSHIP_LOSS, device=device)


def run_training_path(counters):
    """``train_one_epoch`` over ``TRAIN_STEPS`` repeats of one batch, the
    losses read after every step; returns (trainer, batch, disp_scale,
    launches)."""
    from uncertainty_model_tpu_torch.utils.schedules import adjust_disparity

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    disp_scale = adjust_disparity(0)
    trainer = flagship_trainer(SEED)
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
    log(f"training path: flagship f32 b{TRAIN_BATCH} 256x512, disp_scale "
        f"{disp_scale}, lr {TRAIN_LR}: total loss per step "
        + ", ".join(f"{v:.6f}" for v in losses) + f"; launches {launches}")
    if len(seen) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"training losses {losses}")
    per_step = len(warp_groups(TRAIN_BATCH))
    for i, (counts, _) in enumerate(seen):
        for name, n in counts.items():
            if n != per_step * (i + 1):
                fail(f"{name} launched {n} times in {i + 1} steps, not "
                     f"{per_step} a step")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    return trainer, batch, disp_scale, launches


def step_disparities(trainer, batch, disp_scale):
    """The train-mode forward's NHWC f32 disparities, as the step takes
    them (with their graph to the parameters)."""
    trainer.model.train()
    left = batch["left"].to(trainer.device)
    return [d.permute(0, 2, 3, 1).float() for d in
            trainer.model(left.permute(0, 3, 1, 2), disp_scale=disp_scale)]


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


def model_grads(trainer, batch, disp_scale, cotangents):
    """Each parameter's gradient (on the CPU) of the forward, driven back
    from the disparities by the given cotangents."""
    trainer.model.zero_grad(set_to_none=True)
    disparities = step_disparities(trainer, batch, disp_scale)
    torch.autograd.backward(disparities,
                            [c.to(trainer.device) for c in cotangents])
    return {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}


def grad_check(got, want):
    """(worst |diff| / limit, median relative |diff|) over the parameters,
    limit = max(GRAD_REL |g|, GRAD_FLOOR)."""
    shares, rels = [], []
    for name, ref in want.items():
        ref = ref.double()
        diff = (got[name].double() - ref).norm().item()
        shares.append(diff / max(GRAD_REL * ref.norm().item(), GRAD_FLOOR))
        rels.append(diff / max(ref.norm().item(), 1e-30))
    return max(shares), float(np.median(rels))


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
    share, median = grad_check(
        {n: p.grad.cpu() for n, p in card.model.named_parameters()},
        {n: p.grad for n, p in cpu.model.named_parameters()})
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

    share, median = grad_check(model_grads(card, batch, disp_scale, cot),
                               model_grads(cpu, batch, disp_scale, cot))
    result.update(model_backward_worst_share=share,
                  model_backward_median_rel=median)
    log(f"  model backward of the same dL/dD, card vs CPU: worst at "
        f"{share:.3g} of max({GRAD_REL} |g|, {GRAD_FLOOR}), median relative "
        f"{median:.3g}; CPU step {cpu_s:.1f} s")
    if not share < 1:
        fail("the card's model backward differs from the CPU's")
    return result


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


def time_assemble_z():
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble_z, assemble_z_plain)

    rows = []
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES:
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

    events = prof.key_averages()
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
    log(f"  profiled {label}: wall {wall_ms:.2f} ms, device "
        f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for op in ops:
        log(f"    {op['device_ms']:8.3f} ms {100 * op['device_ms'] / busy_ms:5.1f}%"
            f"  x{op['calls']!s:<4s} {op['op']}")
    for k in port:
        log(f"    port kernel {k['kernel']}: {k['device_ms']:.3f} ms over "
            f"{k['calls']} launches")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "ops": ops,
            "port_kernels": port}


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


def time_train_step(trainer, batch, disp_scale):
    """CUDA-event time of a step (20 steps of warm-up: the first 15 or so
    after the training path run slower; then the median and spread of 9
    samples of 5 back-to-back steps each), the device's idle share over 3
    steps (``device_idle``) and the peak memory."""
    def step():
        trainer.train_step(batch, disp_scale, TRAIN_LR)

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
    log(f"  train step f32 b{TRAIN_BATCH} 256x512: {ms:.2f} ms/step (spread "
        f"{spread:.2f} ms over 9 samples of 5 steps), "
        f"{TRAIN_BATCH / ms * 1e3:.1f} images/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return {"batch": TRAIN_BATCH, "ms": ms, "ms_spread": spread,
            "samples_ms": times, "images_per_s": TRAIN_BATCH / ms * 1e3,
            "device_trace": idle,
            "max_memory_allocated": peak}


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


def time_decoder_glue():
    """``gate_z``, ``se_squeeze`` and ``assemble`` at the fused stages of a
    forward at batch ``TIMING_BATCH`` in bf16, beside their plain versions
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
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES:
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

    log("phase 1: build")
    build_kernels(["assemble_z", "decoder_fused", "gated_conv_elu",
                   "warp_rows", "upsample2x2"])

    log("phase 2: kernels vs plain versions")
    worst = check_assemble_z()
    glue_worst = check_decoder_glue()
    conv_worst = check_gated_conv_elu()
    warp_worst = check_warp_rows()
    conv_elu_worst = check_conv_elu()
    upsample_worst = check_upsample2x2()

    log("phase 3: serving paths")
    model = flagship_model()
    launches, forward, x8, ref = run_main_path(model, serving_counters)
    s2d_forwards, s2d_launches, s2d_errs = run_s2d_paths(
        model, serving_counters, x8, ref)
    del x8, ref

    log("phase 3b: training path")
    trainer, batch, disp_scale, train_launches = run_training_path(
        train_counters)
    cpu_check = check_step_against_cpu(disp_scale)

    log("phase 3c: evaluation and checkpoints")
    all_counters = {**serving_counters, **train_counters}
    eval_model, eval_loader, eval_metrics, eval_launches = run_evaluation(
        all_counters)
    eval_vs_cpu = check_eval_step_against_cpu()
    train_model_run = run_train_model_with_checkpoints(train_counters,
                                                       eval_loader)

    log("phase 4: times")
    fwd = time_forward(forward)
    s2d_fwd = {key: time_forward(f, f"({key}) {S2D_PATHS[key][0]}")
               for key, f in s2d_forwards.items()}
    s2d_fwd["a_lax"] = time_forward(
        make_serving_forward(model, dtype=torch.bfloat16, s2d_stages=(0, 1),
                             s2d_conv_backend="lax"),
        "(a) with s2d_conv_backend='lax'")
    stages = time_assemble_z()
    conv_build = conv_build_report()
    conv_rows = time_gated_conv()
    glue_build = glue_build_report()
    glue_rows = time_decoder_glue()
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
    warps = time_warp_groups()
    warp_shapes_log = time_warp_rows()
    step_breakdown = profile_device_time(
        lambda: trainer.train_step(batch, disp_scale, TRAIN_LR),
        f"train step b{TRAIN_BATCH}", top=30)
    del trainer, batch
    torch.cuda.empty_cache()
    eval_time = time_eval_step(eval_model, eval_loader)
    del eval_model, eval_loader
    torch.cuda.empty_cache()
    conv_elu_rows = time_conv_elu()
    upsample_rows = time_upsample2x2()
    log(json.dumps({"forward": fwd, "s2d_forwards": s2d_fwd,
                    "s2d_vs_eval_model": s2d_errs,
                    "assemble_z_stages": stages,
                    "gated_conv_elu_shapes": conv_rows,
                    "gated_conv_elu_build": conv_build,
                    "decoder_glue_stages": glue_rows,
                    "decoder_glue_build": glue_build,
                    "se_mean": "the row kernel's last block of each batch "
                               "(no launch of its own)",
                    "breakdown": breakdown, "breakdown_s2d": breakdown_s2d,
                    "train_step": step,
                    "train_vs_cpu": cpu_check, "warp_rows_groups": warps,
                    "warp_rows_shapes": warp_shapes_log,
                    "train_breakdown": step_breakdown,
                    "evaluation": {"metrics": eval_metrics,
                                   "launches": eval_launches},
                    "eval_vs_cpu": eval_vs_cpu,
                    "train_model": train_model_run, "eval_step": eval_time,
                    "conv_elu_shapes": conv_elu_rows,
                    "upsample2x2_sites": upsample_rows}))

    csrc = "uncertainty_model_tpu_torch/csrc/"
    pallas = "uncertainty_model_tpu/ops/pallas/"
    kernels = [summed(stages, "assemble_z", csrc + "assemble_z.cu",
                      pallas + "decoder_fused.py:250", launches["assemble_z"],
                      worst, library=False)]
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
        kernels.append(summed(
            glue_rows[name], name, csrc + "decoder_fused.cu",
            pallas + f"decoder_fused.py:{line}", s2d_launches[path][name],
            glue_worst[name], library=name == "gate_z"))
    kernels.append(summed(
        conv_rows, "gated_conv_elu", csrc + "gated_conv_elu.cu", pallas + "conv.py:179",
        s2d_launches["a"]["gated_conv_elu"], conv_worst, library=True))
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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
