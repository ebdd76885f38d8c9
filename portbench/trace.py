"""The profiled sub-window of a traced run and what is read from it.

The window procedure is a frozen copy of the port's
``tools/trace_chained.py::profile``: a ``torch.profiler`` schedule whose
warm-up step runs the work once with tracing on, then the device idle for
``PAD_S`` at both ends of the measured step, and every launch in the trace
joined to its device record by correlation id (a launch without one fails
the run: the profiler drops the first records of a window that opens
without a warm-up step).  The attribution is a frozen copy of the port's
``tools/analyze_trace.py``: a kernel belongs to the scope whose device-side
range (``gpu_user_annotation``) holds it, and a hand-written kernel is
named by its device function (``HAND_KERNELS``).

The trace is written under ``TMPDIR`` and read back; nothing else of it
is kept.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import time

PAD_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_NAME = re.compile(r"Launch|Memcpy|Memset")
PROFILER_STEP = re.compile(r"ProfilerStep#\d+$")
HAND_KERNELS = (
    ("assemble_z", re.compile(r"decoder_rows<[^,<>]*,\s*0\s*,")),
    ("se_squeeze", re.compile(r"decoder_rows<[^,<>]*,\s*1\s*,")),
    ("assemble", re.compile(r"decoder_rows<[^,<>]*,\s*2\s*,")),
    ("gate_z", re.compile(r"gate_z_flat")),
    ("gated_conv_elu", re.compile(r"gated_conv_(wgmma|f32)")),
    ("upsample2x2", re.compile(r"upsample2x2_kernel")),
    ("warp_rows_fwd", re.compile(r"warp_rows_fwd")),
    ("warp_rows_bwd", re.compile(r"warp_rows_bwd")),
)


class LostDeviceRecords(RuntimeError):
    """A profiled window whose trace lacks the device record of a launch."""


class Window:
    """A profiled sub-window: its trace events, the wall seconds of the
    work in it, and how many units (passes, steps, requests) it ran."""

    def __init__(self, events, wall_s, units):
        self.events, self.wall_s, self.units = events, wall_s, units
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, end = 0.0, None
        for s, e in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def hand_kernel_s(self, name: str) -> float:
        """Device seconds of the hand kernel ``name`` (``HAND_KERNELS``)."""
        return sum(float(e["dur"]) for e in self.device
                   if hand_kernel(e["name"]) == name) / 1e6

    def scope_s(self, prefix: str) -> float:
        """Device seconds of the work inside the scopes whose names start
        with ``prefix``, by the scopes' device-side ranges."""
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in self.events
                  if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
                  and e["name"].startswith(prefix)
                  and not PROFILER_STEP.match(e["name"])]
        eps = 1e-3
        total = 0.0
        for e in self.device:
            s = float(e["ts"])
            t = s + float(e["dur"])
            if any(a - eps <= s and t <= b + eps for a, b in ranges):
                total += float(e["dur"])
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host range open where each began."""
        ops = collections.Counter()
        for e in self.device:
            ops[hand_kernel(e["name"]) or e["name"][:120]] += float(e["dur"])
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device)
        gaps, end = [], None
        for s, t in spans:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = t if end is None else max(end, t)
        host = [e for e in self.events if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "user_annotation", "python_function")
                and not PROFILER_STEP.match(e.get("name", ""))]
        named = collections.Counter()
        for dur, start in sorted(gaps, reverse=True)[:top]:
            around = [e for e in host if float(e["ts"]) <= start
                      < float(e["ts"]) + float(e.get("dur", 0))]
            name = (min(around, key=lambda e: float(e.get("dur", 0)))["name"]
                    if around else "(no host range)")
            named[name[:120]] += dur
        return {"device_ops": [[k, v / 1e6] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v / 1e6] for k, v in named.most_common(top)]}


def hand_kernel(name: str):
    for kernel, pattern in HAND_KERNELS:
        if pattern.search(name):
            return kernel
    return None


def lost_device_records(events) -> list:
    ran = {e.get("args", {}).get("correlation") for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
            and LAUNCH_NAME.search(e.get("name", ""))
            and "HostFunc" not in e["name"]
            and e.get("args", {}).get("correlation") is not None
            and e["args"]["correlation"] not in ran]


def profile(fn, units: int, device) -> Window:
    """``fn()`` (``units`` passes, steps or requests) in a checked
    profiled window on ``device`` (see the module docstring)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities,
                                schedule=schedule) as prof:
        fn()
        torch.cuda.synchronize(device)
        prof.step()
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        time.sleep(PAD_S)
        prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    lost = lost_device_records(events)
    # every memset is left out: one of no bytes puts no work on the
    # device and leaves no device record, and its launch record does not
    # say its size
    lost = [e for e in lost if "Memset" not in e["name"]]
    if lost:
        names = sorted({e["name"] for e in lost})
        raise LostDeviceRecords(f"{len(lost)} launches in the profiled window "
                                f"have no device record ({', '.join(names)})")
    window = Window(events, wall, units)
    if not window.device:
        raise LostDeviceRecords("the profiled window holds no device work")
    return window
