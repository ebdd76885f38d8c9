#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card (``nvidia-smi``) and build every kernel of the paths from
   ``uncertainty_model_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it (``assemble_z``; ``warp_rows`` forward and
   backward);
3. run the serving path: the 22.5M-parameter flagship model's bf16 serving
   forward at 256x512, batch 8, from random weights made from a seed, with
   the kernel launch counters zeroed just before and read just after; the
   output is held against the f32 eval model;
3b. run the training path: ``Trainer.train_one_epoch`` of the flagship in
   f32 (TF32 off) at batch 8, 256x512, a few steps on one seeded stereo
   batch, counters zeroed just before and read after (16 forward and 16
   backward ``warp_rows`` launches a step); the loss must be finite and
   fall.  Then one step at batch 2 on the card against the same step on
   the CPU (the plain versions) from the same weights: the losses, the
   whole step's gradients by their median, and each link of the
   gradient's chain per scale and per parameter;
4. time the serving forward at batch 64, the training step at batch 8, and
   each kernel against its plain version, its bound and the PyTorch call
   that computes the same function (CUDA events, median of 9 with spread),
   and break one forward's and one step's device time down by operator
   (``torch.profiler``);
5. print the ``kernels`` line, then the device line last.
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
WARP_LIBRARY_TOL = 1e-2   # grid_sample vs the kernel (x -> grid rounding)
PORT_KERNELS = ("assemble_z", "warp_rows", "se_mean")   # device kernel names

# the flagship's fused decoder stages: (name, H, W, Cso, Cu, Cd, cf)
# (cf > 0: the SE conv's feature-map half is folded into the kernel)
ASSEMBLE_Z_STAGES = (
    ("dec2", 64, 128, 128, 32, 4, 0),
    ("dec3", 128, 256, 64, 16, 4, 0),
    ("dec4", 256, 512, 32, 8, 4, 3),
)


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
            if "registers" in line or "spill" in line:
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
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                ok = (within(cat, ref_cat, **tol)
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
        f"bf16 cat rtol 2^-7 atol {BF16_TOL['atol']}; mean rtol {MEAN_RTOL}")
    return worst


def warp_shapes(batch):
    """(rows, W, C) of each ``warp_rows`` call of a training step, with its
    launches per step: at each of the 4 pyramid scales the reconstruction
    warps image + opposite disparity (C 4) and the uncertainty term warps
    the disparity (C 1), once per view."""
    from uncertainty_model_tpu_torch.config import FLAGSHIP_INPUT

    h, w = FLAGSHIP_INPUT
    return [(batch * (h >> i), w >> i, c, 2) for c in (4, 1) for i in range(4)]


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


def check_warp_rows():
    """Each direction of ``warp_rows`` against its plain version at the
    training path's shapes; returns the worst abs error of each."""
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_bwd_plain, warp_rows_fwd, warp_rows_plain)

    worst = {"fwd": 0.0, "bwd": 0.0}
    for rows, w, c, _ in warp_shapes(TRAIN_BATCH):
        x, src, dout = warp_inputs(SEED + rows + c, rows, w, c)
        out = warp_rows_fwd(x, src)
        dx, dsrc = warp_rows_bwd(x, src, dout)
        torch.cuda.synchronize()
        ref = warp_rows_plain(x, src)
        ref_dx, ref_dsrc = warp_rows_bwd_plain(x, src, dout)
        _, dsrc_abs = warp_rows_bwd_plain(x, src, dout.abs())
        err = (out - ref).abs().max().item()
        err_dx = (dx - ref_dx).abs().max().item()
        err_dsrc = (dsrc - ref_dsrc).abs()
        ok = (within(out, ref, **F32_TOL) and within(dx, ref_dx, **F32_TOL)
              and bool((err_dsrc <= DSRC_TOL * (1 + dsrc_abs)).all()))
        err_dsrc = err_dsrc.max().item()
        log(f"  warp_rows ({rows}, {w}, {c}): max|out err|={err:.3g} "
            f"max|dx err|={err_dx:.3g} max|dsrc err|={err_dsrc:.3g} "
            f"{'ok' if ok else 'DISAGREES'}")
        if not ok:
            fail(f"warp_rows kernels disagree with their plain versions at "
                 f"({rows}, {w}, {c})")
        worst["fwd"] = max(worst["fwd"], err)
        worst["bwd"] = max(worst["bwd"], err_dx, err_dsrc)
    log(f"tolerances: out and dx rtol {F32_TOL['rtol']} atol "
        f"{F32_TOL['atol']}; dsrc (shared-memory atomics, any order) "
        f"{DSRC_TOL} * (1 + sum of its terms' magnitudes)")
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
    return launches, forward


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
    per_step = sum(n for *_, n in warp_shapes(TRAIN_BATCH))
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


def time_assemble_z():
    from uncertainty_model_tpu_torch.ops.decoder_fused import (
        assemble_z, assemble_z_plain)

    rows = []
    for name, h, w, cso, cu, cd, cf in ASSEMBLE_Z_STAGES:
        args = assemble_z_inputs(SEED + 7, TIMING_BATCH, h, w, cso, cu, cd, cf,
                                 torch.bfloat16)
        k_ms, k_spread = time_ms(lambda: assemble_z(*args), reps=10)
        p_ms, p_spread = time_ms(lambda: assemble_z_plain(*args), reps=2)
        nbytes, ops = assemble_z_work(TIMING_BATCH, h, w, cso, cu, cd, cf, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        row = {"stage": name, "batch": TIMING_BATCH, "dtype": "bfloat16",
               "bytes": nbytes, "ms": k_ms, "ms_spread": k_spread,
               "plain_ms": p_ms, "plain_ms_spread": p_spread,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        log(f"  assemble_z {name} b{TIMING_BATCH}: kernel {k_ms * 1e3:.1f} us "
            f"(spread {k_spread * 1e3:.1f}), plain {p_ms * 1e3:.1f} us "
            f"(spread {p_spread * 1e3:.1f}), bound {row['bound_ms'] * 1e3:.1f} "
            f"us by {row['bound_by']} ({nbytes / 1e6:.1f} MB)")
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def time_forward(forward):
    x = images(TIMING_BATCH, SEED + 2)
    ms, spread = time_ms(lambda: forward(x), reps=1)
    log(f"  serving forward bf16 b{TIMING_BATCH} 256x512: {ms:.2f} ms/pass "
        f"(spread {spread:.2f} ms over 9), {TIMING_BATCH / ms * 1e3:.1f} "
        f"frames/s")
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


def bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def rotating(fn, sets):
    """A call of ``fn`` on the next of ``sets``, round robin."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_warp_rows():
    """Each direction at each shape of a training step at batch
    ``TRAIN_BATCH``: the kernel, the plain version, and ``F.grid_sample``
    on (R, C, 1, W) (forward; ``grid_sampler_2d_backward`` for the
    backward), which computes the same function.  Device time per call
    (``time_graph_ms``); input sets rotate so that about 200 MB pass per
    sample, more than the 50 MB L2 holds.  The eager time per call of the
    kernel's wrapper (host cost included) is logged beside it."""
    import torch.nn.functional as F

    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_bwd_plain, warp_rows_fwd, warp_rows_plain)

    def library_fwd(x, src, dout, inp, grid, gout):
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    def library_bwd(x, src, dout, inp, grid, gout):
        return torch.ops.aten.grid_sampler_2d_backward(
            gout, inp, grid, 0, 0, False, [True, True])

    rows_out = []
    for rows, w, c, per_step in warp_shapes(TRAIN_BATCH):
        (fb, fo), (bb, bo) = warp_rows_work(rows, w, c)
        n_sets = max(2, min(16, -(-200_000_000 // bb)))
        sets = []
        for k in range(n_sets):
            x, src, dout = warp_inputs(SEED + 100 + k, rows, w, c)
            inp = src.permute(0, 2, 1).unsqueeze(2).contiguous()
            gx = (2 * x + 1) / w - 1
            grid = torch.stack([gx, torch.zeros_like(gx)], -1).unsqueeze(1)
            gout = dout.permute(0, 2, 1).unsqueeze(2).contiguous()
            sets.append((x, src, dout, inp, grid, gout))
        lib = library_fwd(*sets[0])[:, :, 0].permute(0, 2, 1)
        lib_err = (lib - warp_rows_fwd(*sets[0][:2])).abs().max().item()
        if not lib_err <= WARP_LIBRARY_TOL:
            fail(f"grid_sample does not compute warp_rows at ({rows}, {w}, "
                 f"{c}): max abs {lib_err}")
        reps = max(n_sets, 16)
        calls = {
            "fwd": lambda x, s, *_: warp_rows_fwd(x, s),
            "fwd_plain": lambda x, s, *_: warp_rows_plain(x, s),
            "fwd_library": library_fwd,
            "bwd": lambda x, s, d, *_: warp_rows_bwd(x, s, d),
            "bwd_plain": lambda x, s, d, *_: warp_rows_bwd_plain(x, s, d),
            "bwd_library": library_bwd,
        }
        t = {k: time_graph_ms(rotating(fn, sets), reps)
             for k, fn in calls.items()}
        eager = {k: time_ms(rotating(calls[k], sets), reps)[0]
                 for k in ("fwd", "bwd")}
        fwd_bound, fwd_by = bound(fb, fo)
        bwd_bound, bwd_by = bound(bb, bo)
        row = {"rows": rows, "w": w, "c": c, "launches_per_step": per_step,
               "library_max_abs_vs_kernel": lib_err,
               "fwd_bytes": fb, "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
               "bwd_bytes": bb, "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               **{f"{k}_ms": v[0] for k, v in t.items()},
               **{f"{k}_ms_spread": v[1] for k, v in t.items()},
               **{f"{k}_eager_ms": v for k, v in eager.items()}}
        log(f"  warp_rows ({rows}, {w}, {c}) x{per_step}/step: fwd kernel "
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


def per_step(rows, key):
    """The sum over one training step's launches of a per-call column."""
    return sum(r[key] * r["launches_per_step"] for r in rows)


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from uncertainty_model_tpu_torch.ops.decoder_fused import assemble_z
    from uncertainty_model_tpu_torch.ops.warp_rows import (
        warp_rows_bwd, warp_rows_fwd)

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    build_kernels(["assemble_z", "warp_rows"])

    log("phase 2: kernels vs plain versions")
    worst = check_assemble_z()
    warp_worst = check_warp_rows()

    log("phase 3: serving path")
    model = flagship_model()
    launches, forward = run_main_path(model, {"assemble_z": assemble_z})

    log("phase 3b: training path")
    trainer, batch, disp_scale, train_launches = run_training_path(
        {"warp_rows_fwd": warp_rows_fwd, "warp_rows_bwd": warp_rows_bwd})
    cpu_check = check_step_against_cpu(disp_scale)

    log("phase 4: times")
    fwd = time_forward(forward)
    stages = time_assemble_z()
    x = images(TIMING_BATCH, SEED + 3)
    breakdown = profile_device_time(lambda: forward(x),
                                    f"serving forward b{TIMING_BATCH}")
    del x
    step = time_train_step(trainer, batch, disp_scale)
    warps = time_warp_rows()
    step_breakdown = profile_device_time(
        lambda: trainer.train_step(batch, disp_scale, TRAIN_LR),
        f"train step b{TRAIN_BATCH}", top=30)
    log(json.dumps({"forward": fwd, "assemble_z_stages": stages,
                    "breakdown": breakdown, "train_step": step,
                    "train_vs_cpu": cpu_check, "warp_rows_shapes": warps,
                    "train_breakdown": step_breakdown}))

    kernels = [{
        "name": "assemble_z",
        "route": "cuda",
        "source": "uncertainty_model_tpu_torch/csrc/assemble_z.cu",
        "replaces": "uncertainty_model_tpu/ops/pallas/decoder_fused.py:250",
        "launches": launches["assemble_z"],
        # ms, plain_ms, bound_ms and library_ms cover these launches
        "timed_launches": len(stages),
        "timed_unit": f"one serving forward at batch {TIMING_BATCH}",
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in stages),
        "plain_ms": sum(r["plain_ms"] for r in stages),
        "bound_ms": sum(r["bound_ms"] for r in stages),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in stages)
        else "operations",
        "library_ms": None,
    }]
    # warp_rows: launches counts the whole epoch's; the times cover the
    # launches of one training step; the library call is grid_sample (its
    # backward op for the backward)
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
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
