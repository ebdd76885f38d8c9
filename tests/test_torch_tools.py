"""The port's measurement path on the CPU (``utils/scopes.py`` and
``uncertainty_model_tpu_torch/tools/``), on the tiny configs:

- the serving forward's scopes: ``enc0``-``enc4`` then ``dec0``-``dec4``,
  once each, with and without the s2d stages; its output bit for bit the
  same under the profiler and with the scopes switched off;
- ``analyze_trace`` on a CPU trace: every operator's self time under
  exactly one scope or ``(outside)``, the sum equal to the trace's total
  (the top-level operators' durations, found here by containment) within
  ``TIME_RTOL``, and each scope's share equal to the top-level operators
  inside its range;
- ``perf_budget.Recorder``'s bytes: a conv's operands and output exactly,
  the hand kernels' through ``note_kernel`` (``gate_z``'s in-place buffer
  on both sides) with their plain versions not counted again, views 0;
- its FLOPs per scope against 2 x MACs counted by hand from the shapes of
  the JAX package's ``build_serving_params`` weights at each conv's output
  size, the attention's two einsums by the same rule on both sides, within
  ``FLOP_RTOL``;
- each tool's function API once with ``device="cpu"`` (and CUDA by
  default: it raises where there is none), ``perf_budget``'s command line
  on ``trace_chained``'s outdir;
- ``analyze_trace.lost_device_records`` on hand-built card traces: every
  launch (a runtime or driver kernel launch, a copy, a set, a graph
  launch) joined to its device record by correlation id; a kernel's or a
  copy's record missing is found, calls that enqueue nothing are not;
- the tools import nothing of JAX: the serving tests' scan covers them.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tiny_config import TINY_INPUT, TINY_LOSS, TINY_MODEL
from torch_port_helpers import PORT_MODEL, images, models as build_models

from uncertainty_model_tpu.serving import build_serving_params

from uncertainty_model_tpu_torch import serving
from uncertainty_model_tpu_torch.ops.conv import gated_conv_elu
from uncertainty_model_tpu_torch.ops.decoder_fused import assemble_z, gate_z
from uncertainty_model_tpu_torch.serving import make_serving_forward
from uncertainty_model_tpu_torch.tools import (
    analyze_trace, ladder_r5, measure_fps, measure_serving, perf_budget,
    profile_train_step, profiler_windows, trace_chained, trace_infer)
from uncertainty_model_tpu_torch.utils import scopes

from test_torch_serving import PORT, _FORBIDDEN, _imports

TIME_RTOL = 1e-6   # the attribution's sums: the same floats regrouped
FLOP_RTOL = 1e-2   # the budget's FLOPs vs the hand count
SCOPES = [f"enc{i}" for i in range(5)] + [f"dec{i}" for i in range(5)]
TOOLS = ("analyze_trace", "ladder_r5", "measure_fps", "measure_serving",
         "perf_budget", "profile_train_step", "trace_chained", "trace_infer")
CPU = dict(device="cpu", image_hw=TINY_INPUT, verbose=False)


@pytest.fixture(scope="module")
def models():
    return build_models("fc")


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, analyze_trace.load_events(prof)


@pytest.mark.parametrize("s2d", [(), (0, 1)], ids=["direct", "s2d"])
def test_serving_scopes_in_order_and_outputs_unchanged(models, s2d,
                                                       monkeypatch):
    _, _, model = models
    forward = make_serving_forward(model, torch.float32, "cpu",
                                   s2d_stages=s2d)
    x = torch.from_numpy(images(5))
    plain = forward(x)
    got, events = _profiled(lambda: forward(x))
    names = [e["name"] for e in sorted(
        (e for e in events if e.get("cat") == "user_annotation"),
        key=lambda e: e["ts"])]
    assert names == SCOPES
    assert torch.equal(got, plain)
    monkeypatch.setattr(serving, "scope",
                        lambda name: contextlib.nullcontext())
    assert torch.equal(forward(x), plain)


def _top_level_ms(events):
    """{(tid, span): ms} of the operators no other operator of their thread
    contains (containment tested pair by pair)."""
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    spans = [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in ops]
    top = []
    for i, (tid, s, t) in enumerate(spans):
        inside = any(j != i and tj == tid and sj <= s and t <= ej
                     and (sj, ej) != (s, t)
                     for j, (tj, sj, ej) in enumerate(spans))
        if not inside:
            top.append((tid, s, t))
    return top


def test_cpu_trace_attribution_sums(models):
    _, _, model = models
    forward = make_serving_forward(model, torch.float32, "cpu")
    x = torch.from_numpy(images(6))
    _, events = _profiled(lambda: forward(x))
    result = analyze_trace.attribute(events)
    assert not result["device"]
    assert set(result["by_scope"]) <= set(SCOPES) | {analyze_trace.OUTSIDE}
    assert set(SCOPES) <= set(result["by_scope"])
    top = _top_level_ms(events)
    total = sum(t - s for _, s, t in top) / 1e3
    assert abs(sum(result["by_scope"].values()) - total) <= TIME_RTOL * total
    assert abs(result["total_ms"] - total) <= TIME_RTOL * total
    assert abs(sum(ms for ms, _ in result["rows"].values())
               - total) <= TIME_RTOL * total
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    for r in ranges:
        s0, e0 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        inside = sum(t - s for _, s, t in top if s0 <= s and t <= e0) / 1e3
        assert abs(result["by_scope"][r["name"]] - inside) <= TIME_RTOL * total
    # depth and divisor
    halved = analyze_trace.attribute(events, divisor=2.0)
    assert abs(halved["total_ms"] - total / 2) <= TIME_RTOL * total
    assert analyze_trace.by_module(result, 1) == result["by_scope"]


def _event(cat, name, ts, dur, pid=1, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_device_trace_joins():
    """A card's trace, built by hand in the profiler's chrome format: the
    device join by the scopes' device ranges, the host join by the launch's
    correlation id, ``(outside)`` and ``(unattributed)``."""
    k1 = "void umt::decoder_rows<__nv_bfloat16, 0, 8>(umt::RowArgs)"
    events = [
        _event("gpu_user_annotation", "dec4", 100.0, 50.0, pid=0, tid=7),
        _event("kernel", k1, 110.0, 10.0, pid=0, tid=7, corr=1),
        _event("gpu_memset", "Memset (Device)", 140.0, 1.0, pid=0, tid=7,
               corr=5),
        _event("user_annotation", "enc0", 10.0, 30.0),
        _event("cpu_op", "aten::mul", 15.0, 10.0),
        _event("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, corr=2),
        _event("kernel", "elementwise_a", 200.0, 5.0, pid=0, tid=7, corr=2),
        _event("cpu_op", "aten::add", 45.0, 10.0),
        _event("cuda_driver", "cuLaunchKernel", 50.0, 2.0, corr=3),
        _event("kernel", "elementwise_b", 300.0, 5.0, pid=0, tid=7, corr=3),
        _event("kernel", "elementwise_c", 400.0, 2.0, pid=0, tid=7, corr=4),
    ]
    result = analyze_trace.attribute(events, divisor=2.0)
    assert result["device"]
    assert result["joins"] == {"device": 2, "host": 2, "none": 1}
    assert result["rows"] == {
        ("dec4", "assemble_z"): [0.005, 1],
        ("dec4", "Memset (Device)"): [0.0005, 1],
        ("enc0", "aten::mul"): [0.0025, 1],
        (analyze_trace.OUTSIDE, "aten::add"): [0.0025, 1],
        (analyze_trace.UNATTRIBUTED, "elementwise_c"): [0.001, 1]}
    assert result["unattributed"] == {analyze_trace.NO_LAUNCH: 0.001}
    assert abs(result["busy_ms"] - 0.0115) < 1e-12
    assert abs(result["total_ms"] - 0.0115) < 1e-12


def test_device_functions_apart_from_operators():
    """``by_function`` keeps apart the kernels one operator launches (a
    cuDNN conv and its padding copy, under one ``aten::convolution``),
    which the (scope, operator) rows sum; the report prints both."""
    events = [
        _event("gpu_user_annotation", "dec4", 100.0, 50.0, pid=0, tid=7),
        _event("user_annotation", "dec4", 10.0, 30.0),
        _event("cpu_op", "aten::convolution", 12.0, 20.0),
        _event("cuda_runtime", "cudaLaunchKernel", 14.0, 1.0, corr=1),
        _event("kernel", "nhwcAddPaddingKernel", 101.0, 4.0, pid=0, tid=7,
               corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 16.0, 1.0, corr=2),
        _event("kernel", "sm90_xmma_fprop", 106.0, 30.0, pid=0, tid=7,
               corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 18.0, 1.0, corr=3),
        _event("kernel", "nhwcAddPaddingKernel", 137.0, 2.0, pid=0, tid=7,
               corr=3),
    ]
    result = analyze_trace.attribute(events)
    assert result["rows"] == {
        ("dec4", "aten::convolution"): [pytest.approx(0.036), 3]}
    assert analyze_trace.by_function(result) == [
        (("dec4", "sm90_xmma_fprop"), [pytest.approx(0.03), 1]),
        (("dec4", "nhwcAddPaddingKernel"), [pytest.approx(0.006), 2])]
    printed = analyze_trace.report(result)
    assert "(scope, device function)" in printed
    assert "nhwcAddPaddingKernel" in printed


def _launched_trace():
    """A card's trace in which every launch has its device record: a
    runtime and a driver kernel launch, a copy, a set and a graph launch
    (two kernels under its one correlation id), beside runtime calls that
    enqueue nothing and a host function."""
    return [
        _event("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, corr=1),
        _event("kernel", "elementwise_a", 20.0, 5.0, pid=0, tid=7, corr=1),
        _event("cuda_driver", "cuLaunchKernelEx", 12.0, 2.0, corr=2),
        _event("kernel", "triton_b", 30.0, 5.0, pid=0, tid=7, corr=2),
        _event("cuda_runtime", "cudaMemcpyAsync", 14.0, 2.0, corr=3),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 40.0, 1.0,
               pid=0, tid=7, corr=3),
        _event("cuda_runtime", "cudaMemsetAsync", 16.0, 1.0, corr=4),
        _event("gpu_memset", "Memset (Device)", 45.0, 1.0, pid=0, tid=7,
               corr=4),
        _event("cuda_runtime", "cudaGraphLaunch", 17.0, 3.0, corr=5),
        _event("kernel", "graph_c", 50.0, 2.0, pid=0, tid=7, corr=5),
        _event("kernel", "graph_d", 53.0, 2.0, pid=0, tid=7, corr=5),
        _event("cuda_runtime", "cudaStreamSynchronize", 18.0, 40.0, corr=6),
        _event("cuda_runtime", "cudaLaunchHostFunc", 19.0, 1.0, corr=7),
        _event("cuda_runtime", "cudaEventRecord", 19.5, 0.5, corr=8),
    ]


@pytest.mark.parametrize("drop", ["none", "kernel", "memcpy"])
def test_lost_device_records(drop):
    """Every launch answered: nothing lost.  A kernel's or a copy's device
    record missing: that launch, and only it, comes back, from the event
    list and from a chrome JSON file alike."""
    events = _launched_trace()
    cat = {"none": None, "kernel": "kernel", "memcpy": "gpu_memcpy"}[drop]
    kept = [e for e in events if not (
        e["cat"] == cat and e["args"]["correlation"] in (1, 3))]
    assert len(analyze_trace.launch_records(kept)) == 5
    lost = analyze_trace.lost_device_records(kept)
    want = {"none": [], "kernel": ["cudaLaunchKernel"],
            "memcpy": ["cudaMemcpyAsync"]}[drop]
    assert [e["name"] for e in lost] == want


def test_profiler_windows_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler_windows.run(rounds=1, idle=0, verbose=False)


def test_lost_device_records_reads_a_chrome_file(tmp_path):
    events = _launched_trace()[2:]
    with open(tmp_path / analyze_trace.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": events}, f)
    lost = analyze_trace.lost_device_records(str(tmp_path))
    assert [e["args"]["correlation"] for e in lost] == []
    lost = analyze_trace.lost_device_records(events[:1] + events[3:])
    assert [e["args"]["correlation"] for e in lost] == [2]


def _rows(recorder):
    return {key: (calls, nbytes, flops)
            for key, (calls, nbytes, flops) in recorder.rows.items()}


def test_conv2d_bytes_and_flops_exact():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 10)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    with perf_budget.Recorder() as rec, scopes.scope("s"):
        y = F.conv2d(x, w, b, padding=1)
    rows = _rows(rec)
    assert list(rows) == [("s", "convolution")]
    calls, nbytes, flops = rows[("s", "convolution")]
    assert calls == 1
    assert nbytes == 4 * (x.numel() + w.numel() + b.numel() + y.numel())
    assert flops == 2 * y.numel() * 3 * 3 * 3


def test_model_flops_counts_its_share_of_a_conv():
    """Inside ``scopes.model_flops(share)`` a recorder counts ``share`` of
    a conv's FLOPs (a conv on zero input channels) and all of its bytes;
    outside, all of them again."""
    x = torch.rand(2, 8, 6, 6)
    x[:, 6:] = 0.0
    w = torch.rand(4, 8, 3, 3)
    with perf_budget.Recorder() as rec:
        with scopes.scope("half"), scopes.model_flops(6 / 8):
            F.conv2d(x, w)
        with scopes.scope("whole"):
            y = F.conv2d(x, w)
    rows = _rows(rec)
    full = 2 * y.numel() * 8 * 3 * 3
    half, whole = rows[("half", "convolution")], rows[("whole", "convolution")]
    assert half[2] == full * 6 / 8 and whole[2] == full
    assert half[1] == whole[1]
    assert scopes.flop_share() == 1.0


def test_views_count_zero_and_broadcasts_once():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    bias = torch.ones(4)
    with perf_budget.Recorder() as rec:
        x.view(6, 4).t()
        x.permute(2, 0, 1)[1:]
        y = x + bias.expand(2, 3, 4)
    rows = _rows(rec)
    assert all(n == 0 for (_, op), (_, n, _) in rows.items() if op != "add")
    assert rows[("(outside)", "add")][1] == 4 * (24 + 4 + 24)
    assert y.shape == x.shape


def _glue_inputs(seed, b=2, h=8, w=16, cso=6, cu=3, cd=2):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return (t(b, h, w, cso), t(b, h // 2, w // 2, cso),
            t(b, h // 2, w // 2, 4 * cu), t(b, h // 2, w // 2, cd), t(cso))


def test_hand_kernels_counted_by_note_kernel():
    se_fm, skip_h, xc, disp_h, bias = _glue_inputs(1)
    with perf_budget.Recorder() as rec, scopes.scope("dec4"):
        cat, mean = assemble_z(se_fm, skip_h, xc, disp_h, bias)
    rows = _rows(rec)
    assert list(rows) == [("dec4", "assemble_z")]
    want = sum(t.numel() * 4 for t in (se_fm, skip_h, xc, disp_h, bias,
                                       cat, mean))
    assert rows[("dec4", "assemble_z")] == (1, want, 0.0)
    assert rec.kernels == {"assemble_z"}

    cso = se_fm.shape[-1]
    gates = torch.rand(cat.shape[0], cso)
    with perf_budget.Recorder() as rec:
        gate_z(cat, gates, cso)
    rows = _rows(rec)
    z_bytes = cat[..., :cso].numel() * 4
    assert rows[("(outside)", "gate_z")] == (1, 2 * z_bytes + gates.numel() * 4,
                                             0.0)
    assert all(n == 0 for (_, op), (_, n, _) in rows.items() if op != "gate_z")

    xs = [torch.rand(1, 6, 8, 4) for _ in range(2)]
    w, b, g = torch.rand(3, 3, 4, 5), torch.rand(5), torch.rand(2)
    with perf_budget.Recorder() as rec:
        out = gated_conv_elu(xs, g, w, b)
    (_, nbytes, flops), = _rows(rec).values()
    assert flops == 2 * out.numel() * 3 * 3 * 4
    assert nbytes == 4 * (2 * 48 * 4 + 2 + w.numel() + 5 + out.numel())


def _hand_gflop(jmodel, variables, s2d, batch, hw):
    """2 x MACs per scope from the JAX package's serving weights (HWIO
    kernels) at each conv's output size: encoder stage i at 1/2^(i+1) of
    the input (an s2d stage's interiors, its stride-4 input conv and its
    attention on the half-resolution s2d grid); decoder stage i writes
    1/2^(4-i) of it, its upsample conv and the SE conv's skip half run at
    the input's resolution (below the 2x upsample), its fm half (unless
    folded into the glue kernel, which gives no FLOPs), iconv and disp
    conv at the output's; the SE MLP; each attention's two einsums 2 x B x
    tokens x c x c / heads."""
    (enc, dec), params = build_serving_params(jmodel, variables,
                                              s2d_stages=s2d, dtype=None)
    h, w = hw
    out = {}

    def conv(kernel, res):
        kh, kw, ci, co = np.asarray(kernel).shape
        return batch * res[0] * res[1] * kh * kw * ci * co

    for i, (spec, prm) in enumerate(zip(enc, params["encoder"])):
        native = (h >> (i + 1), w >> (i + 1))
        grid = (native[0] // 2, native[1] // 2) if spec.s2d else native
        macs = 0
        for nid, node in prm["nodes"].items():
            is_input = int(nid) in spec.graph.in_nodes
            res = native if (is_input and (spec.s2d_in or not spec.s2d)) \
                else grid
            macs += conv(node["kernel"], res)
        att = prm["attention"]
        for name in ("keys", "queries", "values", "reprojection"):
            macs += conv(att[name]["kernel"], grid)
        c = np.asarray(att["keys"]["kernel"]).shape[-1] // (4 if spec.s2d
                                                             else 1)
        macs += 2 * batch * native[0] * native[1] * c * c // spec.heads
        out[f"enc{i}"] = 2 * macs / 1e9
    for i, (spec, prm) in enumerate(zip(dec, params["decoder"])):
        res_out = (h >> (4 - i), w >> (4 - i))
        res_in = (res_out[0] // 2, res_out[1] // 2)
        macs = conv(prm["upsample_conv"]["kernel"], res_in)
        macs += conv(prm["iconv"]["kernel"], res_out)
        if "disp" in prm:
            macs += conv(prm["disp"]["kernel"], res_out)
        if spec.get("fused"):
            macs += conv(prm["se_skip"]["kernel"], res_in)
            if not spec["fold"]:
                macs += conv(prm["se_fm"]["kernel"], res_out)
        else:
            k = np.asarray(prm["se_conv"]["kernel"])
            cf = spec["feature_in_channels"]
            macs += conv(k[:, :, :cf], res_out) + conv(k[:, :, cf:], res_in)
        for fc in ("fc1", "fc2"):
            ci, co = np.asarray(prm["se"][fc]).shape
            macs += batch * ci * co
        out[f"dec{i}"] = 2 * macs / 1e9
    return out


@pytest.mark.parametrize("s2d", [(), (0, 1)], ids=["direct", "s2d"])
def test_flops_per_scope_match_jax_weights(models, s2d):
    jmodel, variables, model = models
    x = torch.from_numpy(images(7))
    forward = make_serving_forward(model, torch.float32, "cpu",
                                   s2d_stages=s2d)
    with perf_budget.Recorder() as rec:
        forward(x)
    got = {}
    for (path, _), (_, _, flops) in rec.rows.items():
        got[path] = got.get(path, 0.0) + flops / 1e9
    want = _hand_gflop(jmodel, variables, s2d, x.shape[0], TINY_INPUT)
    assert set(want) <= set(got)
    assert got.get(analyze_trace.OUTSIDE, 0.0) == 0.0
    for scope, gflop in want.items():
        assert abs(got[scope] - gflop) <= FLOP_RTOL * gflop, (scope, got, want)
    if s2d:
        assert "gated_conv_elu" in rec.kernels


def test_trace_chained_and_perf_budget_cli(tmp_path, capsys):
    result = trace_chained.run(2, str(tmp_path), 2, config=PORT_MODEL,
                               s2d=(0, 1), pipeline="squeeze_first",
                               smax="nomax", **CPU)
    assert set(SCOPES) <= set(result["by_scope"])
    assert {"se_squeeze", "assemble", "gated_conv_elu"} <= set(
        result["counts"]["kernels"])
    for name in (analyze_trace.TRACE_FILE, perf_budget.BUDGET_FILE,
                 "card.txt"):
        assert (tmp_path / name).exists()
    budget = perf_budget.main([str(tmp_path), "2"])
    printed = capsys.readouterr().out
    assert "TOTAL" in printed and "floor share" in printed
    assert "device: cpu" in printed
    assert set(SCOPES) <= set(budget["scopes"])
    assert abs(budget["total"]["ms"] - result["total_ms"]) <= (
        TIME_RTOL * result["total_ms"])
    again = analyze_trace.main([str(tmp_path), "1", "2"])
    assert again["by_scope"] == result["by_scope"]


def test_trace_infer_eval_model_in_stage_scopes(tmp_path):
    result = trace_infer.run(1, str(tmp_path), config=TINY_MODEL, **CPU)
    assert set(SCOPES) <= set(result["by_scope"])
    served = trace_infer.run(1, str(tmp_path), serving=True,
                             config=TINY_MODEL, **CPU)
    assert set(SCOPES) <= set(served["by_scope"])


def test_measure_tools_run_on_the_cpu():
    kw = dict(config=TINY_MODEL, **CPU)
    line = measure_serving.run(2, **kw)
    assert line["ms"] > 0 and line["fps"] > 0
    assert measure_serving.run(1, s2d=(), model_apply=True, **kw)["ms"] > 0
    lines = measure_fps.run((1, 2), **kw)
    assert [r["batch"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in lines)
    assert measure_fps.run((1,), f32=True, serving=True, **kw)[0]["ms"] > 0
    ladder = ladder_r5.run(("gz=gate_z,0", "f1234=gate_fold,1,nomax,1234"),
                           2, 2, **kw)
    assert set(ladder) == {"gz", "f1234"}
    assert all(len(r["samples_ms"]) == 2 for r in ladder.values())
    assert ladder_r5.parse("f=gate_fold,0,nomax,1234")[1] == {
        "s2d_stages": (), "dec_pipeline": "gate_fold", "elu_fold": False,
        "smax": "nomax", "fused_stages": (1, 2, 3, 4)}


def test_profile_train_step_runs_on_the_cpu():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    result = profile_train_step.run(
        2, device="cpu", model_config=TINY_MODEL, loss_config=TINY_LOSS,
        image_hw=TINY_INPUT, steps=2, verbose=False)
    assert [s["precision"] for s in result["steps"]] == ["f32", "bf16"]
    times = [result[k] for k in ("warp_fwd_f32_ms", "warp_fwd_bf16_ms",
                                 "warp_fwd_bwd_f32_ms")]
    times += [s["ms"] for s in result["steps"]]
    assert all(np.isfinite(t) and t > 0 for t in times)
    assert saved == (
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


@pytest.mark.parametrize("tool", ["trace_chained", "measure_fps",
                                  "ladder_r5", "profile_train_step"])
def test_tools_default_to_cuda(tool):
    module = {"trace_chained": trace_chained, "measure_fps": measure_fps,
              "ladder_r5": ladder_r5,
              "profile_train_step": profile_train_step}[tool]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(verbose=False)


def test_tools_scanned_and_import_without_jax():
    walked = {f for d, _, fs in os.walk(PORT) for f in fs
              if d.endswith(os.path.join("uncertainty_model_tpu_torch",
                                         "tools"))}
    assert {f"{t}.py" for t in TOOLS} | {"__init__.py"} <= walked
    for tool in (*TOOLS, "__init__"):
        path = os.path.join(PORT, "tools", f"{tool}.py")
        for name in _imports(path):
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml', 'uncertainty_model_tpu'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import uncertainty_model_tpu_torch.tools.{t}\n"
                      for t in TOOLS)
            + "import uncertainty_model_tpu_torch.utils.scopes\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=os.path.dirname(PORT), timeout=120)
    assert proc.returncode == 0, proc.stderr
