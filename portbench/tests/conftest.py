"""Fixtures of the benchmark's CPU tests: a temporary checkout holding the
benchmark's files and, added as files alone, a tiny configuration of each
kind with a cell for each of the benchmark's traffic mixes."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
TINY_HW = [64, 128]   # the smallest size whose encoder ends above 1 pixel
TINY_LIMITS = {"out_gap": {"limit": 0.08}, "loss_gap": {"limit": 1e-5},
               "grad_gap": {"limit": 1e-3}, "grad_diff": {"limit": 0.05},
               "change_gap": {"limit": 0.02},
               "change_diff_median": {"limit": 0.2}}


def tiny_model() -> dict:
    enc = [(3, 8), (8, 8), (8, 16), (16, 16), (16, 32)]
    dec = [(32, 16, 32, 8, 16, 32, False, False),
           (16, 16, 32, 4, 16, 16, False, True),
           (16, 8, 16, 4, 16, 16, True, True),
           (16, 8, 16, 4, 16, 16, True, True),
           (16, 3, 16, 4, 16, 16, True, True)]
    return {
        "encoder": {"load_graph": "graphs/nodes_5_seed_42", "nodes": 5,
                    "seed": 42,
                    "layers": [{"in_channels": i, "out_channels": o,
                                "kernel_size": 3, "heads": 2}
                               for i, o in enc]},
        "decoder": {"layers": [
            {"in_channels": a, "feature_in_channels": b,
             "skip_in_channels": c, "upsample_channels": d,
             "out_channels": e, "skip_out_channels": f, "concat_disp": g,
             "calculate_disp": h, "disp_channels": 4}
            for a, b, c, d, e, f, g, h in dec]}}


def add_tiny_cells(root: str) -> list:
    """Add to the checkout at ``root``, by new files and new entries only,
    a tiny copy of each configuration and a tiny cell (``tiny-<cell>``) for
    each cell, with its traffic file and limits.  Returns the new cells'
    names."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    here = os.path.join(root, "portbench")
    for entry in list(bench["configs"]):
        with open(os.path.join(root, entry["file"])) as f:
            cfg = json.load(f)
        cfg["model"], cfg["image_hw"] = tiny_model(), TINY_HW
        cfg["reduced"] = ["model", "image_hw"]
        name = f"tiny-{entry['name']}"
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({**entry, "name": name, "file": path,
                                 "reduced": cfg["reduced"]})
    names = []
    for w in list(bench["workloads"]):
        with open(os.path.join(here, "traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        traffic["batch"] = min(traffic["batch"], 4)
        traffic["pool"] = min(traffic["pool"], 4)
        traffic["samples"] = min(traffic.get("samples", 2), 2)
        for key in ("warmup_passes", "warmup_requests", "warmup_steps"):
            if key in traffic:
                traffic[key] = min(traffic[key], 2)
        tname, cname = f"tiny-{w['traffic']}", f"tiny-{w['name']}"
        with open(os.path.join(here, "traffic", f"{tname}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(here, "limits", f"{cname}.json"), "w") as f:
            json.dump(TINY_LIMITS, f)
        bench["workloads"].append({**w, "name": cname,
                                   "config": f"tiny-{w['config']}",
                                   "traffic": tname})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(cname)
        names.append(cname)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return names


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark's files with the tiny cells added."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(REPO, "graphs"), os.path.join(root, "graphs"))
    add_tiny_cells(root)
    return root


@pytest.fixture
def in_root(tiny_root, monkeypatch):
    """The tiny checkout as the working directory (the port resolves the
    configuration's graph directory against it)."""
    monkeypatch.chdir(tiny_root)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return tiny_root


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
