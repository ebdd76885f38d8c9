"""The readings a cell's limits are set from::

    python3 -m portbench.control --workload <name> --kind <kind> \\
        --seeds <n,n,...> [--seconds S] [--out FILE]

prints one JSON line a seed (``workload``, ``kind``, ``seed``, ``gaps``:
every number the cell's check computes) and appends it to ``FILE``.
Kinds:

* ``program``: a run of the cell (a window of ``--seconds``, default 2),
  sound; the largest reading over a dozen seeds or more is the lower one;
* ``control``: the plain reference put in the program's place, computed
  in the next precision below the configuration's (bf16 -> fp8, f32 with
  TF32 off -> TF32; ``reference/precision.py``), against the float32
  reference, on as many answers or steps as a run compares;
* ``unchanged``, ``half_batch``, ``flipped`` (training) and ``altered``
  (serving): a run with the port broken underneath (``FAULTS``).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import checks, harness
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.precision import precision

CONTROL_PRECISION = {"bfloat16": "fp8", "float32": "tf32"}


@contextlib.contextmanager
def unchanged():
    """Each training step leaves the parameters as it found them."""
    from uncertainty_model_tpu_torch.train import trainer as port

    orig = port.Trainer.train_step

    def step(self, *args, **kwargs):
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


@contextlib.contextmanager
def half_batch():
    """Each training step sees the first half of its batch only, its
    losses the mean over that half."""
    from uncertainty_model_tpu_torch.train import trainer as port

    orig = port.Trainer.train_step

    def step(self, batch, *args, **kwargs):
        n = len(batch["left"]) // 2
        return orig(self, {k: v[:n] for k, v in batch.items()}, *args,
                    **kwargs)

    port.Trainer.train_step = step
    try:
        yield
    finally:
        port.Trainer.train_step = orig


@contextlib.contextmanager
def flipped():
    """Each training step hands Adam its gradients negated: the step moves
    every weight by as much as it should, the wrong way."""
    from uncertainty_model_tpu_torch.train import trainer as port

    orig = port.Trainer.train_step

    def step(self, *args, **kwargs):
        adam_step = self.optimizer.step

        def negated(*a, **k):
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.neg_()
            return adam_step(*a, **k)

        self.optimizer.step = negated
        try:
            return orig(self, *args, **kwargs)
        finally:
            del self.optimizer.step

    port.Trainer.train_step = step
    try:
        yield
    finally:
        port.Trainer.train_step = orig


@contextlib.contextmanager
def altered():
    """Each serving call answers its first frame with the previous call's
    first answer."""
    from uncertainty_model_tpu_torch import serving as port

    orig = port.make_serving_forward

    def make(*args, **kwargs):
        forward = orig(*args, **kwargs)
        last = []

        def altered_forward(x, *a, **k):
            out = forward(x, *a, **k)
            first = out[:1].clone()
            if last:
                out[:1] = last[0]
                last[0] = first
            else:
                last.append(first)
            return out

        return altered_forward

    port.make_serving_forward = make
    try:
        yield
    finally:
        port.make_serving_forward = orig


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "flipped": flipped, "altered": altered}


def program_reading(cell, seed, seconds, device, fault=None) -> dict:
    """The gaps of one run of ``cell`` (with ``fault`` planted)."""
    r = harness.Run(cell, seed, seconds, False, time.perf_counter(), device)
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        cell.driver().run(r)
    return {k: v for k, v in r.gaps.items() if isinstance(v, (float, str))}


def control_reading(cell, seed, device) -> dict:
    """The gaps of the reference in the control precision against the
    float32 reference, on what a run of ``cell`` compares."""
    cfg, tr = cell.config, cell.traffic
    low = precision(CONTROL_PRECISION[cfg["dtype"]])
    if tr["driver"].startswith("serve"):
        params = checks.weights(cfg, seed, device, calibrate=True)
        n = tr["samples"] * tr["batch"]
        frames = harness.stereo_pairs(seed, "control", n, cfg["image_hw"],
                                      device, right=False)[0]
        graphs = checks.graphs_of(cfg)
        answers = []
        with torch.no_grad():
            for i in range(0, n, 16):
                x = frames[i:i + 16].permute(0, 3, 1, 2)
                answers.append(ref_model.forward(
                    params, cfg["model"], graphs, x, prec=low,
                    disp_scale=cfg["disp_scale"])[0].permute(0, 2, 3, 1))
        gaps = checks.serve_gaps(cfg, params, frames, torch.cat(answers))
        return {"out_gap": max(gaps)}
    pairs = [harness.stereo_pairs(seed, f"pairs{i}", tr["batch"],
                                  cfg["image_hw"], device)
             for i in range(tr["checked_steps"])]
    params = checks.weights(cfg, seed, device, calibrate=False)
    opt = cfg["optimizer"]
    checks.set_tf32(False)
    low_run = ref_train.train_steps(
        dict(params), cfg["model"], checks.graphs_of(cfg), cfg["loss"],
        pairs, opt["lr"], cfg["disp_scale"], cfg["scales"], low,
        tuple(opt["betas"]), opt["eps"])
    after = {k: v.detach().clone() for k, v in params.items()}
    params = checks.weights(cfg, seed, device, calibrate=False)
    gaps = checks.train_gaps(cfg, params, pairs, low_run["losses"],
                             low_run["first_grad"], after)
    return {k: v for k, v in gaps.items() if isinstance(v, (float, str))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", required=True,
                   choices=("program", "control", *FAULTS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    cell = harness.Cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.kind == "control":
            gaps = control_reading(cell, seed, device)
        else:
            gaps = program_reading(cell, seed, args.seconds, device,
                                   None if args.kind == "program"
                                   else args.kind)
        line = json.dumps({"workload": args.workload, "kind": args.kind,
                           "seed": seed, "gaps": gaps,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
