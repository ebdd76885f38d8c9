"""Training-path timings (the port of ``tools/profile_train_step.py``)::

    python -m uncertainty_model_tpu_torch.tools.profile_train_step \\
        [--batch 8] [--precision f32,bf16] [--device cpu]

(the JAX tool's environment variables ``B`` and ``PREC`` are the flags
``--batch`` and ``--precision``):

- the stereo warp ``ops/warp.py::warp_by_disparity`` (the ``warp_rows``
  kernel, K2) forward at (batch, 256, 512, 3), ``K`` calls of slightly
  different disparities timed together, ms a call; in f32, and with bf16
  disparities (the bf16 model's output type) over the f32 images, as the
  bf16 training step warps (the kernel is f32);
- its forward and backward in f32 (one call);
- ``Trainer.train_step`` of the flagship (``configs/uncertainty.yml``'s
  model and loss, weights from seed 0) on one random batch, disparity
  scale 0.3, learning rate 1e-4: the best of 6 steps after one warm-up
  step, each ending in a synchronise, in f32 and bf16 (the CLI's
  ``--precision float32`` and ``bfloat16``, with its switches: no TF32,
  bf16 products summed in f32; restored afterwards), with images/s.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli.main import fix_precision
from ..device import resolve_device
from ..entry import load_flagship_config
from ..models import RandomlyConnectedModel
from ..ops import warp_by_disparity
from ..train import Trainer
from . import IMAGE_HW, best_seconds, card, device_argument

K = 6
STEPS = 6
PRECISIONS = {"f32": "float32", "bf16": "bfloat16"}


def _switches():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


def _restore(saved) -> None:
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = saved


def warp_times(batch: int, dev, image_hw=IMAGE_HW) -> dict:
    """ms a warp call: forward f32, forward with bf16 disparities, and
    forward + backward f32."""
    rng = np.random.default_rng(0)
    disp = torch.from_numpy(rng.uniform(0, 0.3, (batch, *image_hw, 1)).astype(
        np.float32)).to(dev)
    src = torch.from_numpy(rng.uniform(size=(batch, *image_hw, 3)).astype(
        np.float32)).to(dev)
    out = {}
    for label, d in (("warp_fwd_f32_ms", disp),
                     ("warp_fwd_bf16_ms", disp.to(torch.bfloat16))):
        def loop(d=d):
            with torch.no_grad():
                for i in range(K):
                    warp_by_disparity(d * (1 + 1e-3 * i), src)
        out[label] = best_seconds(loop, dev, 3) / K * 1e3

    def grad():
        d = disp.clone().requires_grad_()
        s = src.clone().requires_grad_()
        (warp_by_disparity(d, s) ** 2).sum().backward()
    out["warp_fwd_bwd_f32_ms"] = best_seconds(grad, dev, 3) * 1e3
    return out


def step_time(precision: str, batch: int, dev, model_config, loss_config,
              image_hw=IMAGE_HW, steps: int = STEPS) -> dict:
    """The best of ``steps`` timed ``Trainer.train_step``s after a warm-up
    step, in ``precision`` ("f32" or "bf16")."""
    saved = _switches()
    try:
        dtype = fix_precision(PRECISIONS[precision])
        model = RandomlyConnectedModel.from_config(**model_config, dtype=dtype,
                                                   seed=0, device=dev)
        trainer = Trainer(model, loss_config, device=dev)
        rng = np.random.default_rng(1)
        batch_ = {side: torch.from_numpy(rng.uniform(size=(
            batch, *image_hw, 3)).astype(np.float32)).to(dev)
            for side in ("left", "right")}
        losses = []

        def step():
            metrics = trainer.train_step(batch_, 0.3, 1e-4)
            losses.append(float(metrics["disp_loss"]))
        best = best_seconds(step, dev, steps)
    finally:
        _restore(saved)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"train step ({precision}): losses {losses}")
    return {"precision": precision, "batch": batch, "ms": best * 1e3,
            "images_per_s": batch / best}


def run(batch: int = 8, precisions=("f32", "bf16"), device=None,
        model_config=None, loss_config=None, image_hw=IMAGE_HW,
        steps: int = STEPS, verbose: bool = True) -> dict:
    """The warp's times and one ``step_time`` a precision."""
    dev = resolve_device(device)
    config = load_flagship_config()
    model_config = config["model"] if model_config is None else model_config
    loss_config = config["loss"] if loss_config is None else loss_config
    result = warp_times(batch, dev, image_hw)
    if verbose:
        print(card(dev), flush=True)
        for key, ms in result.items():
            print(f"{key[:-3].replace('_', ' ')} b{batch}: {ms:8.3f} ms",
                  flush=True)
    result["steps"] = []
    for precision in precisions:
        line = step_time(precision, batch, dev, model_config, loss_config,
                         image_hw, steps)
        result["steps"].append(line)
        if verbose:
            print(f"train step {precision} b{batch}: {line['ms']:.1f} ms -> "
                  f"{line['images_per_s']:.1f} img/s", flush=True)
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.tools.profile_train_step",
        description="Warp and training-step timings.")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--precision", default="f32,bf16",
                        help="comma-separated: f32, bf16")
    device_argument(parser)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    precisions = tuple(p for p in args.precision.split(",") if p)
    unknown = set(precisions) - set(PRECISIONS)
    if unknown:
        parser.error(f"unknown precision {sorted(unknown)}")
    return run(args.batch, precisions, args.device)


if __name__ == "__main__":
    main()
