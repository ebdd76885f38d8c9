"""What the per-layer metrics' readers (``metrics/<name>.py``) share.  A
reader returns None where the run gives it nothing to read."""

from __future__ import annotations

import statistics

from portbench import checks
from portbench.work import flops, kernels, peaks


def idle_percent(r):
    """The device's idle share of the profiled sub-window, in %."""
    w = r.profiled
    if w is None or w.wall_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.wall_s)


def scope_ms(r, prefix):
    """Device ms a pass inside the scopes named ``prefix``*."""
    w = r.profiled
    if w is None:
        return None
    s = w.scope_s(prefix)
    return s * 1e3 / w.units if s > 0 else None


def span_mean_ms(r, name):
    spans = r.spans.get(name)
    return statistics.fmean(spans) if spans else None


def roofline_percent(r, kernel_names, bound_s_per_unit):
    """The least time of the kernels' work a unit, over their device time
    a unit in the profiled sub-window, in %."""
    w = r.profiled
    if w is None:
        return None
    device_s = sum(w.hand_kernel_s(k) for k in kernel_names)
    if device_s <= 0:
        return None
    return 100.0 * bound_s_per_unit * w.units / device_s


def assemble_z_bound_s(r):
    cfg, b = r.config, r.traffic["batch"]
    itemsize = 2 if cfg["dtype"] == "bfloat16" else 4
    nbytes = ops = 0
    for _, h, w, cso, cu, cd, cf in kernels.assemble_z_stages(
            cfg["model"], cfg["serving"], cfg["image_hw"]):
        nb, op = kernels.assemble_z_work(b, h, w, cso, cu, cd, cf, itemsize)
        nbytes, ops = nbytes + nb, ops + op
    return peaks.bound(nbytes, ops)[0]


def warp_rows_bound_s(r):
    nbytes, ops = kernels.warp_step_work(r.traffic["batch"],
                                         r.config["image_hw"],
                                         r.config["scales"])
    return peaks.bound(nbytes, ops)[0]


def mfu_percent(r, flop_per_unit, unit_count, peak):
    if not r.window_s or not unit_count:
        return None
    return 100.0 * flop_per_unit * unit_count / r.window_s / peak


def forward_flops(r, batch):
    cfg = r.config
    return flops.forward_flops(cfg["model"], checks.graphs_of(cfg), batch,
                               cfg["image_hw"])
