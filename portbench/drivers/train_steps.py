"""Closed loop of the port's training step, ``train.Trainer.train_step``.

Set-up builds one ``Trainer`` over the port's model holding the
configuration's weights from the seed, and a pool of ``pool`` distinct
device-resident batches of ``batch`` stereo pairs, and runs
``warmup_steps`` steps through the window's own call.  The window steps
the same trainer on the pool's batches in turn until ``--seconds`` have
passed, and synchronises.  ``train_images_per_s`` is the images of every
step launched in the window over its length.  Traced: each step's span
from the call to its return (``host_ms.train``), and a profiled
sub-window of ``profile_steps`` steps.

After the window the same trainer, in the state the window left it
(whatever it captured or cached on the way), is put back to the seed's
weights and a fresh Adam in place, and ``checked_steps`` more steps on the
pool's first batches go through the window's own call.  They are what the
check compares: the losses, the first gradient as Adam holds it, and the
trainable tensors after them (copied to the host).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import checks, harness, trace


def trainer_for(r: harness.Run):
    from uncertainty_model_tpu_torch.train import Trainer

    cfg, dev = r.config, r.device
    checks.set_tf32(cfg["tf32"])
    params = checks.weights(cfg, r.seed, dev, calibrate=False)
    harness.reset_peak(dev)
    model = checks.program_model(cfg, params, dev, getattr(torch, cfg["dtype"])
                                 if cfg["dtype"] != "float32" else None)
    del params
    trainer = Trainer(model, loss_config=cfg["loss"], device=dev,
                      scales=cfg["scales"])
    group = trainer.optimizer.param_groups[0]
    opt = cfg["optimizer"]
    if (tuple(group["betas"]), group["eps"]) != (tuple(opt["betas"]),
                                                 opt["eps"]):
        raise harness.RunError(f"the port's Adam is {group['betas']}, "
                               f"{group['eps']}, not the configuration's")
    return trainer


def batch_pool(r: harness.Run):
    cfg, tr = r.config, r.traffic
    out = []
    for i in range(tr["pool"]):
        left, right = harness.stereo_pairs(r.seed, f"pairs{i}", tr["batch"],
                                           cfg["image_hw"], r.device)
        out.append({"left": left, "right": right})
    return out


def adam_first_grad(trainer) -> dict:
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    return {name: (trainer.optimizer.state[p]["exp_avg"] / (1 - beta1)).cpu()
            for name, p in trainer.model.named_parameters()}


def restart(trainer, params) -> None:
    """The seed's ``params`` back into ``trainer``'s model (parameters and
    BatchNorm statistics) and its Adam's moments and step counts to nought,
    each in place, so that the next step is a first step from the seed."""
    with torch.no_grad():
        for name, t in trainer.model.state_dict().items():
            t.copy_(params[name])
        for state in trainer.optimizer.state.values():
            for v in state.values():
                v.zero_()


def run(r: harness.Run) -> None:
    cfg, tr, dev = r.config, r.traffic, r.device
    trainer = trainer_for(r)
    pool = batch_pool(r)
    n_pool = len(pool)
    lr, scale = cfg["optimizer"]["lr"], cfg["disp_scale"]

    def step(i):
        return trainer.train_step(pool[i % n_pool], scale, lr, i)

    for i in range(tr["warmup_steps"]):
        step(i)
    harness.sync(dev)
    r.log("set-up done")

    start = r.open_window()
    end = start + r.seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        step(i)
        t1 = time.perf_counter()
        if r.trace:
            r.span("host_ms.train", (t1 - t0) * 1e3)
        i += 1
        if t1 >= end:
            break
    harness.sync(dev)
    r.close_window(start)
    r.counts["steps"] = i
    r.attempted = i
    r.e2e["train_images_per_s"] = i * tr["batch"] / r.window_s
    r.log(f"{i} steps of {tr['batch']} in {r.window_s:.3f} s")

    if r.trace:
        k = tr["profile_steps"]
        r.profiled = trace.profile(lambda: [step(j) for j in range(k)], k, dev)
    # the program's peak, before the benchmark draws its weights again
    r.memory_peak_bytes = harness.peak_bytes(dev)
    r.e2e["peak_mem_gib"] = r.memory_peak_bytes / 2 ** 30
    r.e2e["setup_s"] = r.setup_s

    params = checks.weights(cfg, r.seed, dev, calibrate=False)
    restart(trainer, params)
    losses, first_grad = [], None
    for j in range(tr["checked_steps"]):
        losses.append(step(j))
        if j == 0:
            first_grad = adam_first_grad(trainer)
    losses = [(float(m["disp_loss"]), float(m["error_loss"])) for m in losses]
    after = {name: p.detach().to("cpu", copy=True)
             for name, p in trainer.model.named_parameters()}
    r.log(f"checked steps' losses {losses}")

    batches = [(pool[j]["left"], pool[j]["right"])
               for j in range(tr["checked_steps"])]
    del trainer, pool
    gc.collect()
    t0 = time.perf_counter()
    gaps = checks.train_gaps(cfg, params, batches, losses, first_grad, after)
    r.log(f"reference over {len(batches)} steps in "
          f"{time.perf_counter() - t0:.2f} s; losses {gaps['ref_losses']}; "
          f"left out {len(gaps['left_out'])} tensors")
    r.gaps = gaps
    for name in ("loss_gap", "loss_gap_step1", "grad_gap", "grad_diff",
                 "change_gap", "change_diff_median"):
        if name in r.cell.limits:
            r.check(name, gaps[name])
