"""The plain reference against the port on the tiny configuration, the
controls' rounding, and the work counts."""

from __future__ import annotations

import ast
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import checks, harness
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.precision import precision, round_fp8, round_tf32
from portbench.tests.conftest import TINY_HW, tiny_model
from portbench.work import flops, kernels

REF_DIR = os.path.join(harness.HERE, "reference")


def tiny_config(kind="flagship-f32-train"):
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         f"{kind}.json"))
    cfg["model"], cfg["image_hw"] = tiny_model(), TINY_HW
    return cfg


def test_reference_imports_only_torch():
    for name in os.listdir(REF_DIR):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF_DIR, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("torch", "__future__", "math",
                                             "typing"), (name, mod)


def test_eval_forward_equals_the_port(in_root):
    cfg = tiny_config("flagship-bf16-serve")
    params = checks.weights(cfg, 2 ** 31 + 3, "cpu", calibrate=True)
    model = checks.program_model(cfg, params, "cpu").eval()
    x = harness.stereo_pairs(4, "x", 3, TINY_HW, "cpu", right=False)[0]
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(x, disp_scale=0.7)
        want = ref_model.forward(params, cfg["model"], checks.graphs_of(cfg),
                                 x, disp_scale=0.7)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_train_step_losses_and_gradients_equal_the_port(in_root):
    cfg = tiny_config()
    seed = 77
    params = checks.weights(cfg, seed, "cpu", calibrate=False)
    model = checks.program_model(cfg, params, "cpu").train()
    from uncertainty_model_tpu_torch.losses import TukraUncertaintyLoss
    from uncertainty_model_tpu_torch.ops import (reconstruct_pyramid_with_lr,
                                                 scale_pyramid)

    left, right = harness.stereo_pairs(seed, "p", 2, TINY_HW, "cpu")
    pyr = scale_pyramid(torch.cat([left, right], -1), 4)
    disps = [d.permute(0, 2, 3, 1) for d in
             model(left.permute(0, 3, 1, 2), disp_scale=0.3)]
    recon, lr = reconstruct_pyramid_with_lr(disps, pyr)
    port = TukraUncertaintyLoss(**cfg["loss"])(pyr, disps, recon, lr)
    sum(port).backward()
    out = ref_train.train_steps(params, cfg["model"], checks.graphs_of(cfg),
                                cfg["loss"], [(left, right)], 1e-4, 0.3)
    for a, b in zip(port, out["losses"][0]):
        assert abs(float(a.detach()) - b) <= 1e-5 * abs(b)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, out["first_grad"][name],
                                   rtol=1e-3, atol=1e-6)


def test_controls_round_as_named():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.0000002])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1 + 2 ** -9, -3.0]
    y = torch.linspace(-3, 5, 101)
    q = round_fp8(y)
    assert float((q - y).abs().max()) <= 5 * 2 ** -4
    p = precision("tf32")
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    p.conv(torch.randn(1, 3, 8, 8), w).sum().backward()
    assert float(w.grad.abs().sum()) > 0


def test_flops_against_the_flop_counter(in_root):
    cfg = tiny_config("flagship-bf16-serve")
    params = checks.weights(cfg, 1, "cpu", calibrate=False)
    model = checks.program_model(cfg, params, "cpu").eval()
    x = torch.zeros(2, 3, *TINY_HW)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    counted = counter.get_total_flops()
    mine = flops.forward_flops(cfg["model"], checks.graphs_of(cfg), 2,
                               TINY_HW)
    # the model runs each squeeze conv on the 2x-resized skip, the count
    # on the skip itself (the same map: they commute)
    layers = cfg["model"]["decoder"]["layers"]
    h, w = TINY_HW[0] >> 5, TINY_HW[1] >> 5
    extra = 0
    for d in layers:
        extra += 2 * 2 * 3 * h * w * d["skip_in_channels"] * d[
            "skip_out_channels"]
        h, w = 2 * h, 2 * w
    assert counted == mine + extra


def test_flagship_flops_near_the_budget():
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "flagship-bf16-serve.json"))
    total = flops.forward_flops(cfg["model"], checks.graphs_of(cfg), 128,
                                cfg["image_hw"])
    assert abs(total / 6570.0e9 - 1) < 0.02


def test_kernel_work_matches_the_flagship_shapes():
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "flagship-bf16-serve.json"))
    stages = kernels.assemble_z_stages(cfg["model"], cfg["serving"],
                                       cfg["image_hw"])
    assert stages == [("dec2", 64, 128, 128, 32, 4, 0),
                      ("dec3", 128, 256, 64, 16, 4, 0),
                      ("dec4", 256, 512, 32, 8, 4, 3)]
    nbytes = sum(kernels.assemble_z_work(64, *s[1:], 2)[0] for s in stages)
    assert abs(nbytes / 2207e6 - 1) < 0.005     # K1 at b64: 2,207 MB
    groups = kernels.warp_groups(8, (256, 512))
    assert len(groups) == 5 and groups[0][1] == 4 and len(groups[0][0]) == 8
    fwd = sum(kernels.warp_rows_work(r, w, c)[0][0]
              for problems, c in groups for r, w in problems)
    bwd = sum(kernels.warp_rows_work(r, w, c)[1][0]
              for problems, c in groups for r, w in problems)
    assert abs(fwd / 133.7e6 - 1) < 0.005 and abs(bwd / 211.7e6 - 1) < 0.005


@pytest.mark.gpu
def test_serve_cell_on_the_card(card, tmp_path):
    """One short run of serve-b128 on the card, correct."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "serve-b128", "--seed", "123456789012", "--seconds",
                          "2", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
