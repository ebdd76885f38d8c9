"""One client in a closed loop of single-frame requests through the port's
serving forward.

Set-up: as ``serve_batches``, with a pool of ``pool`` distinct frames in
pageable host memory; the request path warmed up.  A request takes its
frame from the host to the device, runs the forward, and brings the
(1, H, W, 4) answer back to the host; the next is sent when it is there.
Its latency runs from its start to its answer on the host.
``frame_p95_ms`` is the 95th percentile (nearest rank) of every request
completed in the window.  The benchmark's own span ``host_ms.stream``
runs from a request's start to the forward's return, before the answer's
copy waits for the device.  A seeded sample of ``samples`` answers is
kept and held to the reference after the window.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench import checks, harness, trace


def percentile(values, q):
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def run(r: harness.Run) -> None:
    cfg, tr, dev = r.config, r.traffic, r.device
    forward, params = checks.serving_forward(r)
    n_pool = tr["pool"]
    frames = harness.stereo_pairs(r.seed, "frames", n_pool, cfg["image_hw"],
                                  dev, right=False)[0].cpu()
    kept = harness.Reservoir(tr["samples"], r.seed)
    answers = [None] * tr["samples"]
    disp_scale = cfg["disp_scale"]

    def request(i):
        t0 = time.perf_counter()
        x = frames[i % n_pool].unsqueeze(0).to(dev)
        out = forward(x, disp_scale)
        t1 = time.perf_counter()
        answer = out.cpu()
        return answer, t0, t1, time.perf_counter()

    for i in range(tr["warmup_requests"]):
        request(i)
    harness.sync(dev)
    r.log("set-up done")

    latencies = []
    start = r.open_window()
    end = start + r.seconds
    i = 0
    while True:
        answer, t0, t1, t2 = request(i)
        latencies.append((t2 - t0) * 1e3)
        if r.trace:
            r.span("host_ms.stream", (t1 - t0) * 1e3)
        slot = kept.offer(i)
        if slot is not None:
            answers[slot] = answer
        i += 1
        if t2 >= end:
            break
    r.close_window(start)
    r.counts["requests"] = i
    r.attempted = i
    r.e2e["frame_p95_ms"] = percentile(latencies, 0.95)
    r.log(f"{i} requests in {r.window_s:.3f} s; p50 "
          f"{percentile(latencies, 0.5):.3f} ms, p95 "
          f"{r.e2e['frame_p95_ms']:.3f} ms")

    if r.trace:
        k = tr["profile_requests"]
        r.profiled = trace.profile(lambda: [request(j) for j in range(k)], k,
                                   dev)
    r.memory_peak_bytes = harness.peak_bytes(dev)
    r.e2e["peak_mem_gib"] = r.memory_peak_bytes / 2 ** 30
    r.e2e["setup_s"] = r.setup_s

    n = len(kept.items)
    inputs = torch.stack([frames[i % n_pool] for i in kept.items]).to(dev)
    got = torch.cat(answers[:n]).to(dev)
    del forward
    gc.collect()
    params = {k: v.to(dev) for k, v in params.items()}
    t0 = time.perf_counter()
    gaps = checks.serve_gaps(cfg, params, inputs, got)
    r.log(f"reference over {n} answers in {time.perf_counter() - t0:.2f} s")
    r.gaps["out_gap"] = max(gaps)
    r.gaps["out_gap_median"] = sorted(gaps)[len(gaps) // 2]
    r.check("out_gap", max(gaps))
