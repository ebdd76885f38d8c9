"""What every cell's run shares: the manifest and the files it names, the
run's record, the seeded inputs, the sampler of answers, the guard against
JAX, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything else
is found by name:

* ``portbench/configs/<config>.json`` (the ``file`` of the configuration):
  the model section, its graphs, dtype, TF32 switch, and the serving build
  options or the loss and optimiser;
* ``portbench/traffic/<traffic>.json``: the driver that runs it and its
  parameters (batch, pool of distinct inputs, samples kept for the check);
* ``portbench/drivers/<driver>.py``: ``run(r)`` drives the port for the
  cell and fills ``r`` (a ``Run``);
* ``portbench/limits/<workload>.json``: the limit of each number the
  cell's check compares, with the readings it was set from;
* ``portbench/metrics/<metric>.py``: ``read(r)`` gives a per-layer metric
  from the run, or None where it finds nothing to read.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "uncertainty_model_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


# -- the manifest and the files it names --------------------------------------


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of the manifest with what it names."""

    def __init__(self, name: str, root: str = ROOT):
        bench = manifest(root)
        here = os.path.join(root, "portbench")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        w = found[0]
        self.name, self.chips = name, w["chips"]
        config = [c for c in bench["configs"] if c["name"] == w["config"]][0]
        self.config = load_json(os.path.join(root, config["file"]))
        self.traffic = load_json(os.path.join(here, "traffic",
                                              f"{w['traffic']}.json"))
        limits = os.path.join(here, "limits", f"{name}.json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.here = here

    def driver(self):
        return load_module(os.path.join(self.here, "drivers",
                                        f"{self.traffic['driver']}.py"))

    def reader(self, metric: str):
        return load_module(os.path.join(self.here, "metrics", f"{metric}.py"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_module(path: str):
    name = "portbench_" + os.path.relpath(path, ROOT).replace(os.sep, "_") \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- seeds -------------------------------------------------------------------


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``'s draws from the run's ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def generator(seed: int, tag: str, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def stereo_pairs(seed: int, tag: str, n: int, image_hw, device,
                 right: bool = True):
    """``n`` synthetic stereo pairs, NHWC float32 in [0, 1], drawn on
    ``device``: the left view a smooth texture of three octaves of seeded
    noise, the right view the left sampled at x + d for a smooth seeded
    disparity field d of 0.5-5% of the width.  Returns ``(left, right)``
    (``right`` None unless asked for)."""
    import torch
    import torch.nn.functional as F

    g = generator(seed, tag, device)
    h, w = image_hw
    texture = torch.zeros((n, 3, h, w), device=device)
    weights = ((8, 0.5), (32, 0.3), (128, 0.2))
    for rows, amp in weights:
        cols = rows * w // h
        u = torch.rand((n, 3, min(rows, h), min(cols, w)), generator=g,
                       device=device)
        texture += amp * F.interpolate(u, size=(h, w), mode="bilinear",
                                       align_corners=False)
    left = texture / sum(a for _, a in weights)
    if not right:
        return left.permute(0, 2, 3, 1).contiguous(), None
    d = torch.rand((n, 1, 4, 8), generator=g, device=device)
    d = 0.005 + 0.045 * F.interpolate(d, size=(h, w), mode="bicubic",
                                      align_corners=False).clamp(0, 1)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    grid = torch.stack([xs[None, None, :] + 2 * d[:, 0],
                        ys[None, :, None].expand(n, h, w)], -1)
    right_view = F.grid_sample(left, grid, mode="bilinear",
                               padding_mode="border", align_corners=True)
    return (left.permute(0, 2, 3, 1).contiguous(),
            right_view.permute(0, 2, 3, 1).contiguous())


class Reservoir:
    """A uniform sample, drawn from the seed, of at most ``size`` items of
    a stream of unknown length (algorithm R): ``offer(i)`` gives the slot
    the ``i``-th item (from 0) takes, or None."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(derive(seed, "reservoir"))
        self.items: list = []

    def offer(self, i: int):
        if i < self.size:
            self.items.append(i)
            return i
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.items[j] = i
            return j
        return None


# -- the run -------------------------------------------------------------------


class Run:
    """One run of a cell: its arguments, and what the driver records."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 t_start: float, device=None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.t_start = t_start
        self.device = device
        self.setup_s = None
        self.window_s = None
        self.attempted = 0
        self.failed = 0
        self.e2e: dict = {}           # end-to-end metrics, by name
        self.spans: dict = {}         # the benchmark's own spans, ms lists
        self.counts: dict = {}
        self.profiled = None          # trace.Window of a traced run
        self.memory_peak_bytes = None
        self.checks: list = []        # (name, value, limit)
        self.gaps: dict = {}          # every number the check computed

    def log(self, msg: str) -> None:
        print(f"[portbench {time.perf_counter() - self.t_start:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    def open_window(self) -> float:
        """The set-up ends and the measured window opens: returns the
        window's start on the host clock."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now

    def close_window(self, start: float) -> None:
        self.window_s = time.perf_counter() - start

    def span(self, name: str, ms: float) -> None:
        self.spans.setdefault(name, []).append(ms)

    def check(self, name: str, value: float) -> None:
        """Hold ``value`` to the cell's limit for ``name`` (None, which
        fails, where the cell has none yet)."""
        entry = self.cell.limits.get(name)
        limit = None if entry is None else float(entry["limit"])
        self.checks.append((name, float(value), limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            lim is not None and v <= lim for _, v, lim in self.checks)


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on a CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """Start the peak of allocated memory afresh: the program's build
    and everything after it set ``memory_peak_bytes``, not the
    benchmark's own draw of the weights and calibration before it."""
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The device's peak of allocated memory so far (0 on a CPU)."""
    import torch

    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def loaded_forbidden() -> list:
    """The top-level modules of ``FORBIDDEN`` that this process has loaded,
    compared by whole top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
