"""The port's measurement tools (the JAX system's ``tools/`` that measure
the serving forward and the training step), each a module with a
``main(argv)`` and a function API::

    python -m uncertainty_model_tpu_torch.tools.trace_chained [batch] [outdir] \\
        [--s2d 0,1] [--k K] [--decoder fused|direct] [--pipeline P] \\
        [--elu-fold 0|1] [--smax window|slice|nomax]
    python -m uncertainty_model_tpu_torch.tools.perf_budget <outdir> [k] [depth]
    python -m uncertainty_model_tpu_torch.tools.analyze_trace <trace> [depth] [divisor]
    python -m uncertainty_model_tpu_torch.tools.trace_infer [batch] [outdir] \\
        [--serving [--s2d 0,1]]
    python -m uncertainty_model_tpu_torch.tools.measure_serving [batch] ...
    python -m uncertainty_model_tpu_torch.tools.measure_fps [batch ...] \\
        [--dtype=f32] [--serving]
    python -m uncertainty_model_tpu_torch.tools.profile_train_step \\
        [--batch 8] [--precision f32,bf16]
    python -m uncertainty_model_tpu_torch.tools.ladder_r5 [name=spec ...]
    python -m uncertainty_model_tpu_torch.tools.profiler_windows \
        [--rounds 5] [--idle 50]

Each runs on CUDA unless given ``--device cpu``, and raises where CUDA is
asked for and there is none.  Their model is the flagship
(``configs/uncertainty.yml``, graphs ``graphs/nodes_5_seed_42``, weights
from seed 0) at 256x512 unless a caller of the function API (each
module's ``run``) passes another ``model:`` section and image size.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..bench import card_line
from ..device import resolve_device
from ..entry import load_flagship_config
from ..models import RandomlyConnectedModel

IMAGE_HW = (256, 512)


def stages(text: str) -> tuple:
    """``"0,1"`` -> ``(0, 1)``; ``""`` -> ``()``."""
    return tuple(int(v) for v in text.split(",") if v != "")


def device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: CUDA)")


def eval_model(device=None, config=None, dtype=None):
    """The eval model of ``config`` (a ``model:`` section; default the
    flagship's), its weights from seed 0, on ``device`` (CUDA unless asked
    otherwise).  With ``dtype`` bf16 it is the JAX tools' "f32 eval model
    in bf16": bf16 compute, and its weights and statistics cast to bf16."""
    config = load_flagship_config()["model"] if config is None else config
    model = RandomlyConnectedModel.from_config(
        **config, dtype=dtype, seed=0, device=resolve_device(device)).eval()
    return model if dtype is None else model.to(dtype)


def eval_forward(model, dtype=None):
    """``forward(x)``: the eval model's full-resolution output (B, H, W, 4)
    of an NHWC image batch cast to ``dtype`` (default f32), for the
    timers."""
    @torch.no_grad()
    def forward(x):
        image = x.permute(0, 3, 1, 2).to(dtype or torch.float32)
        return model(image, disp_scale=1.0)[0].permute(0, 2, 3, 1)
    return forward


def best_seconds(fn, dev: torch.device, reps: int) -> float:
    """The best of ``reps`` wall times of ``fn()`` after one warm-up call,
    each ending in a synchronise on CUDA."""
    def once():
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0
    once()
    return min(once() for _ in range(reps))


def card(dev: torch.device) -> str:
    """The line that names what a tool's numbers were measured on."""
    if dev.type == "cuda":
        return f"card: {card_line()}"
    return f"device: {dev} (the CPU: no device time)"
