#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card (``nvidia-smi``) and build every kernel of the path from
   ``uncertainty_model_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it;
3. run the main path: the 22.5M-parameter flagship model's bf16 serving
   forward at 256x512, batch 8, from random weights made from a seed, with
   the kernel launch counters zeroed just before and read just after; the
   output is held against the f32 eval model;
4. time the forward at batch 64 and each kernel against its plain version
   and its bytes bound (CUDA events, median of 9 with spread), and break
   one forward's device time down by operator (``torch.profiler``);
5. print the ``kernels`` line, then the device line last.
"""

from __future__ import annotations

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


# ---------------------------------------------------------------------------
# phase 3: the main path
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
# phase 4: times
# ---------------------------------------------------------------------------


def time_ms(fn, reps, samples=9, warmup=2):
    """Median and spread (max - min) of ``samples`` CUDA-event timings of
    ``reps`` calls each, in ms per call."""
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


def profile_forward(forward, top=12):
    """Device time of one batch-64 forward by PyTorch operator (self time:
    each kernel counted once, under the operator that launched it; the
    port's own kernels are launched outside any operator), and the device's
    idle share over the forward's wall time."""
    from torch.autograd import DeviceType

    x = images(TIMING_BATCH, SEED + 3)
    forward(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward(x)
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
    log(f"  profiled forward b{TIMING_BATCH}: wall {wall_ms:.2f} ms, device "
        f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for op in ops:
        log(f"    {op['device_ms']:8.3f} ms {100 * op['device_ms'] / busy_ms:5.1f}%"
            f"  x{op['calls']!s:<4s} {op['op']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "ops": ops}


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from uncertainty_model_tpu_torch.ops.decoder_fused import assemble_z

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    build_kernels(["assemble_z"])

    log("phase 2: kernels vs plain versions")
    worst = check_assemble_z()

    log("phase 3: main path")
    model = flagship_model()
    launches, forward = run_main_path(model, {"assemble_z": assemble_z})

    log("phase 4: times")
    fwd = time_forward(forward)
    stages = time_assemble_z()
    breakdown = profile_forward(forward)
    log(json.dumps({"forward": fwd, "assemble_z_stages": stages,
                    "breakdown": breakdown}))

    kernels = [{
        "name": "assemble_z",
        "route": "cuda",
        "source": "uncertainty_model_tpu_torch/csrc/assemble_z.cu",
        "replaces": "uncertainty_model_tpu/ops/pallas/decoder_fused.py:250",
        "launches": launches["assemble_z"],
        "max_abs_err": worst,
        # the three launches of one forward at batch 64, summed
        "ms": sum(r["ms"] for r in stages),
        "plain_ms": sum(r["plain_ms"] for r in stages),
        "bound_ms": sum(r["bound_ms"] for r in stages),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in stages)
        else "operations",
        "library_ms": None,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
