"""The comparisons that decide ``correct``, and the program's model built
from the benchmark's own weights.

Serving: every answer kept from the window (a seeded sample) against the
plain reference's evaluation forward of the same frame, computed after the
window in blocks.  The number compared is the widest relative gap of any
kept answer: for each frame and each of its 4 channels, the L2 norm of the
program's map less the reference's, over the reference's norm.

Training: the checked steps, run after the window through the measured
call by the trainer the window used, against the reference's steps from
the same weights and batches: each step's two losses (the largest
relative gap), the first gradient as Adam holds it after step 1
(``exp_avg / (1 - beta1)``), and each tensor's change after the checked
steps.  The last two are read per tensor twice, each over the larger of
the reference's norm of that tensor and the median tensor's, and the worst
tensor counts: ``grad_gap``/``change_gap`` take the gap between the
program's norm and the reference's; ``grad_diff``/``change_diff`` the norm
of their difference, which also sees a gradient of the right size in the
wrong direction.  Adam's first steps move each weight by about lr whatever
the size of its gradient, so a near-zero gradient's sign, which round-off
decides, moves the change by 2 lr: the worst tensor's ``change_diff``
swings with that, and the median tensor's (``change_diff_median``) is the
steady reading.  Tensors whose reference gradient is under a thousandth of
the median tensor's are left out of all four (Adam moves them by
round-off alone).
"""

from __future__ import annotations

import statistics

import torch

from . import harness
from .reference import model as ref_model
from .reference import train as ref_train
from .reference.precision import precision

MEDIAN_FLOOR = 1e-3


def graphs_of(config):
    return [ref_model.graph_from_adjacency(config["graph_adjacency"][
        f"stage_{s}"]) for s in range(1, len(config["model"]["encoder"]
                                           ["layers"]) + 1)]


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def weights(config, seed, device, calibrate: bool):
    """The configuration's weights from ``seed`` on ``device`` (float32;
    with ``calibrate`` the BatchNorm statistics set from 8 seeded frames,
    ``reference.model.calibrate``)."""
    graphs = graphs_of(config)
    spec = ref_model.param_spec(config["model"], graphs)
    params = ref_model.init_params(spec, harness.derive(seed, "weights"),
                                   device)
    if calibrate:
        left, _ = harness.stereo_pairs(seed, "calibration", 8,
                                       config["image_hw"], device, right=False)
        set_tf32(False)
        ref_model.calibrate(params, config["model"], graphs,
                            left.permute(0, 3, 1, 2),
                            harness.derive(seed, "statistics"))
        set_tf32(config["tf32"])
    return params


def program_model(config, params, device, dtype=None):
    """The port's ``RandomlyConnectedModel`` of ``config`` holding
    ``params``, on ``device`` in channels-last memory."""
    from uncertainty_model_tpu_torch.models import RandomlyConnectedModel

    model_cfg = config["model"]
    with torch.device("meta"):
        model = RandomlyConnectedModel(model_cfg["encoder"],
                                       model_cfg["decoder"], dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(params, strict=True)
    return model.to(memory_format=torch.channels_last)


def serving_forward(r):
    """The port's serving forward of the run's configuration, holding its
    weights from the seed, and those weights on the host (the
    reference's, after the window)."""
    from uncertainty_model_tpu_torch.serving import make_serving_forward

    cfg, dev = r.config, r.device
    set_tf32(cfg["tf32"])
    params = weights(cfg, r.seed, dev, calibrate=True)
    harness.reset_peak(dev)
    model = program_model(cfg, params, dev).eval()
    opts = dict(cfg["serving"])
    opts["s2d_stages"] = tuple(opts["s2d_stages"])
    opts["fused_stages"] = tuple(opts["fused_stages"])
    forward = make_serving_forward(model, getattr(torch, cfg["dtype"]), dev,
                                   **opts)
    return forward, {k: v.cpu() for k, v in params.items()}


@torch.no_grad()
def serve_gaps(config, params, frames, answers, block: int = 16) -> list:
    """For each frame (NHWC) and the program's answer to it ((H, W, 4)),
    the widest relative gap over its channels against the float32
    reference."""
    graphs = graphs_of(config)
    prec = precision("f32")
    set_tf32(False)
    gaps = []
    for i in range(0, len(frames), block):
        x = frames[i:i + block].float().permute(0, 3, 1, 2)
        ref = ref_model.forward(params, config["model"], graphs, x, prec=prec,
                                disp_scale=config["disp_scale"])[0]
        got = answers[i:i + block].float().permute(0, 3, 1, 2)
        diff = (got - ref).pow(2).sum((2, 3)).sqrt()
        norm = ref.pow(2).sum((2, 3)).sqrt()
        gaps += (diff / norm).amax(1).tolist()
    return gaps


def _norm_gaps(prog: dict, ref: dict, keys) -> list:
    """Each tensor's gap of norms over the larger of its reference norm
    and the median tensor's."""
    ref_norms = {k: float(ref[k].norm()) for k in keys}
    median = statistics.median(ref_norms.values())
    return [abs(float(prog[k].norm()) - ref_norms[k])
            / max(ref_norms[k], median) for k in keys]


def _diff_gaps(prog: dict, ref: dict, keys) -> list:
    """Each tensor's norm of the difference over the larger of its
    reference norm and the median tensor's."""
    ref_norms = {k: float(ref[k].norm()) for k in keys}
    median = statistics.median(ref_norms.values())
    return [float((prog[k] - ref[k]).norm()) / max(ref_norms[k], median)
            for k in keys]


def train_gaps(config, params, batches, prog_losses, prog_grad,
               prog_after) -> dict:
    """The training numbers (see the module docstring) of the
    program's ``prog_losses`` [(disp, error) a step], ``prog_grad`` (the
    first gradient by key) and ``prog_after`` (the trainable tensors after
    the steps), against the reference's steps from ``params`` over
    ``batches``."""
    opt = config["optimizer"]
    set_tf32(False)
    ref = ref_train.train_steps(params, config["model"], graphs_of(config),
                                config["loss"], batches, opt["lr"],
                                config["disp_scale"], config["scales"],
                                precision("f32"), tuple(opt["betas"]),
                                opt["eps"])
    step_gaps = [max(abs(p - q) / abs(q) for p, q in zip(step_p, step_q))
                 for step_p, step_q in zip(prog_losses, ref["losses"])]
    grad_norms = {k: float(g.norm()) for k, g in ref["first_grad"].items()}
    median = statistics.median(grad_norms.values())
    keys = [k for k, n in grad_norms.items() if n >= MEDIAN_FLOOR * median]
    prog_grad = {k: prog_grad[k].to(g.device)
                 for k, g in ref["first_grad"].items()}
    grad_gap = _norm_gaps(prog_grad, ref["first_grad"], keys)
    grad_diff = _diff_gaps(prog_grad, ref["first_grad"], keys)
    start = ref["start"]
    ref_change = {k: params[k] - start[k] for k in keys}
    prog_change = {k: prog_after[k].to(start[k].device) - start[k]
                   for k in keys}
    change_gap = _norm_gaps(prog_change, ref_change, keys)
    change_diff = _diff_gaps(prog_change, ref_change, keys)
    return {"loss_gap": max(step_gaps), "loss_gap_step1": step_gaps[0],
            "grad_gap": max(grad_gap),
            "grad_gap_median": statistics.median(grad_gap),
            "grad_diff": max(grad_diff),
            "grad_diff_median": statistics.median(grad_diff),
            "change_gap": max(change_gap),
            "change_gap_median": statistics.median(change_gap),
            "grad_worst": keys[grad_gap.index(max(grad_gap))],
            "change_worst": keys[change_gap.index(max(change_gap))],
            "change_diff": max(change_diff),
            "change_diff_median": statistics.median(change_diff),
            "grad_diff_worst": keys[grad_diff.index(max(grad_diff))],
            "change_diff_worst": keys[change_diff.index(max(change_diff))],
            "ref_losses": ref["losses"],
            "left_out": sorted(set(grad_norms) - set(keys))}
