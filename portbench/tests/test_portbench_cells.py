"""Runs of cells on the CPU at a tiny size, past the harness's look for a
card: a cell added as files alone runs and is correct; the controls and
the faults planted under the measured path make it incorrect; the guard
against JAX compares whole top-level names."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, harness
from portbench import run as run_cli

CPU = torch.device("cpu")
SERVE = ("tiny-serve-b128", "tiny-stream-b1")


def run_cell(root, name, fault=None, seed=2 ** 31 + 5):
    cell = harness.Cell(name, root)
    r = harness.Run(cell, seed, 0.3, False, time.perf_counter(), CPU)
    with (control.FAULTS[fault]() if fault else contextlib.nullcontext()):
        cell.driver().run(r)
    return r


@contextlib.contextmanager
def unchanged_after(n_calls):
    """Training steps past the first ``n_calls`` leave the parameters as
    they found them, as a step captured after warm-up and replayed wrongly
    would."""
    from uncertainty_model_tpu_torch.train import trainer as port

    orig, calls = port.Trainer.train_step, [0]

    def step(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] <= n_calls:
            return orig(self, *args, **kwargs)
        saved = [p.detach().clone() for p in self.model.parameters()]
        out = orig(self, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        return out

    port.Trainer.train_step = step
    try:
        yield
    finally:
        port.Trainer.train_step = orig


@pytest.mark.parametrize("name", ["tiny-serve-b128", "tiny-stream-b1",
                                  "tiny-train-b8"])
def test_cell_added_as_files_runs_correct(in_root, name):
    r = run_cell(in_root, name)
    assert r.correct, r.checks
    assert r.attempted > 0 and r.window_s >= 0.3 and r.setup_s > 0
    metrics = run_cli.metrics_of(r)
    assert set(metrics) == {m["name"] for m in r.cell.end_to_end}
    assert all(v["value"] > 0 or k == "peak_mem_gib"
               for k, v in metrics.items())


@pytest.mark.parametrize("name,fault", [("tiny-serve-b128", "altered"),
                                        ("tiny-stream-b1", "altered"),
                                        ("tiny-train-b8", "unchanged"),
                                        ("tiny-train-b8", "half_batch"),
                                        ("tiny-train-b8", "flipped")])
def test_fault_under_the_timed_path_fails(in_root, name, fault):
    r = run_cell(in_root, name, fault)
    assert not r.correct, r.checks


def test_training_check_reads_steps_after_set_up(in_root):
    """A step that goes wrong only after as many steps as set-up runs and
    the check compares (as a step captured after warm-up could) fails the
    check: the checked steps run after the window, through the trainer the
    window used."""
    tr = harness.Cell("tiny-train-b8", in_root).traffic
    with unchanged_after(tr["warmup_steps"] + tr["checked_steps"]):
        r = run_cell(in_root, "tiny-train-b8")
    assert not r.correct, r.checks


@pytest.mark.parametrize("name", ["tiny-serve-b128", "tiny-train-b8"])
def test_control_fails_the_limits(in_root, name):
    cell = harness.Cell(name, in_root)
    failed = []
    for seed in (11, 2 ** 31 + 13, 7_000_000_001):
        gaps = control.control_reading(cell, seed, CPU)
        failed.append(any(gaps[k] > v["limit"]
                          for k, v in cell.limits.items() if k in gaps))
    assert all(failed)


def test_traced_reads_need_a_trace(in_root):
    """Without a profiled window the device readers return nothing (never
    0), and the span readers read the spans."""
    r = run_cell(in_root, "tiny-train-b8")
    r.trace = True
    for m in ("idle.train", "warp_rows_roofline"):
        assert r.cell.reader(m).read(r) is None
    r.spans["host_ms.train"] = [2.0, 4.0]
    assert r.cell.reader("host_ms.train").read(r) == 3.0
    assert r.cell.reader("mfu.train").read(r) > 0


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("uncertainty_model_tpu_torch", "jaxtyping", "flaxen",
                 "jaxlib_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert "uncertainty_model_tpu" not in harness.loaded_forbidden()
    assert not {"jax", "jaxlib", "flax"} & set(harness.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "uncertainty_model_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.loaded_forbidden() == ["jax", "uncertainty_model_tpu"]


def test_no_card_no_result(tiny_root):
    """Without CUDA (or without the port) a run exits non-zero and prints
    no result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "tiny-serve-b128", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tiny_root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_reservoir_is_uniform_and_seeded():
    a, b = harness.Reservoir(3, 9), harness.Reservoir(3, 9)
    for i in range(100):
        assert a.offer(i) == b.offer(i)
    assert len(a.items) == 3 and len(set(a.items)) == 3
    counts = [0] * 10
    for seed in range(2000):
        res = harness.Reservoir(2, seed)
        for i in range(10):
            res.offer(i)
        for i in res.items:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500


def test_inputs_are_seeded_and_sized(in_root):
    left, right = harness.stereo_pairs(2 ** 33 + 1, "t", 2, (64, 128), CPU)
    again, _ = harness.stereo_pairs(2 ** 33 + 1, "t", 2, (64, 128), CPU)
    other, _ = harness.stereo_pairs(2 ** 33 + 2, "t", 2, (64, 128), CPU)
    assert left.shape == right.shape == (2, 64, 128, 3)
    assert torch.equal(left, again) and not torch.equal(left, other)
    assert 0 <= float(left.min()) and float(left.max()) <= 1
    assert float((left - right).abs().mean()) > 1e-3


def test_limits_files_hold_their_readings():
    for name in os.listdir(os.path.join(harness.HERE, "limits")):
        with open(os.path.join(harness.HERE, "limits", name)) as f:
            for key, entry in json.load(f).items():
                assert entry["lower"] < entry["limit"] < entry["upper"]
