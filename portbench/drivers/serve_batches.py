"""Closed loop of back-to-back batches through the port's serving forward.

Set-up: the configuration's weights from the seed, folded by
``serving.make_serving_forward`` with the configuration's build options; a
pool of ``pool`` distinct device-resident batches of ``batch`` frames; the
forward warmed up on them.  The window runs the forward on the pool's
batches in turn, keeping a seeded sample of ``samples`` answers (whole
batches) in buffers allocated at set-up, and ends with a synchronise once
``--seconds`` have passed on the host clock.  ``serve_fps`` is the frames
of every pass launched in the window over the window's length.  Traced:
a profiled sub-window of ``profile_passes`` passes follows.  The check
then holds every frame of the kept answers to the reference.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import checks, harness, trace


def run(r: harness.Run) -> None:
    cfg, tr, dev = r.config, r.traffic, r.device
    forward, params = checks.serving_forward(r)
    b, n_pool = tr["batch"], tr["pool"]
    pool = [harness.stereo_pairs(r.seed, f"frames{i}", b, cfg["image_hw"],
                                 dev, right=False)[0] for i in range(n_pool)]
    h, w = cfg["image_hw"]
    slots = torch.empty((tr["samples"], b, h, w, 4),
                        dtype=getattr(torch, cfg["dtype"]), device=dev)
    kept = harness.Reservoir(tr["samples"], r.seed)
    disp_scale = cfg["disp_scale"]
    for i in range(tr["warmup_passes"]):
        forward(pool[i % n_pool], disp_scale)
    harness.sync(dev)
    r.log("set-up done")

    start = r.open_window()
    end = start + r.seconds
    i = 0
    while True:
        out = forward(pool[i % n_pool], disp_scale)
        slot = kept.offer(i)
        if slot is not None:
            slots[slot].copy_(out)
        i += 1
        if time.perf_counter() >= end:
            break
    harness.sync(dev)
    r.close_window(start)
    r.counts["passes"] = i
    r.attempted = i * b
    r.e2e["serve_fps"] = i * b / r.window_s
    r.log(f"{i} passes of {b} in {r.window_s:.3f} s")

    if r.trace:
        k = tr["profile_passes"]
        r.profiled = trace.profile(
            lambda: [forward(pool[j % n_pool], disp_scale) for j in range(k)],
            k, dev)
    r.memory_peak_bytes = harness.peak_bytes(dev)
    r.e2e["peak_mem_gib"] = r.memory_peak_bytes / 2 ** 30
    r.e2e["setup_s"] = r.setup_s

    answers = slots[:len(kept.items)]
    frames = torch.cat([pool[i % n_pool] for i in kept.items])
    del forward, pool, out
    gc.collect()
    params = {k: v.to(dev) for k, v in params.items()}
    t0 = time.perf_counter()
    gaps = checks.serve_gaps(cfg, params, frames, answers.reshape(-1, h, w, 4))
    r.log(f"reference over {len(gaps)} frames of passes {kept.items} in "
          f"{time.perf_counter() - t0:.2f} s")
    r.gaps["out_gap"] = max(gaps)
    r.gaps["out_gap_median"] = sorted(gaps)[len(gaps) // 2]
    r.check("out_gap", max(gaps))
