"""Entry points (the port of the repo's ``__graft_entry__.py``):

- ``entry()`` -> ``(forward, example_args)``: the flagship's f32 eval
  forward on one device and its example arguments;
- ``dryrun_multichip(n)``: one training step over n devices, a process
  each, in three legs (the JAX dryrun's): a full adversarial step of a
  tiny model and discriminator, the flagship's forward and loss, and a
  flagship step.

    python -m uncertainty_model_tpu_torch.entry --dryrun-multichip N \\
        [--platform cpu]

Both run on CUDA unless the caller names the CPU.  ``dryrun_multichip(n)``
needs n cards (rank r on ``cuda:r``, NCCL) and raises where fewer are
visible: the JAX dryrun re-runs itself on an n-device virtual CPU mesh
where the process has fewer devices, which would hide the missing cards.
``platform="cpu"`` asks for n gloo processes on the CPU explicitly.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import parallel
from .config import FLAGSHIP_INPUT, load_config
from .device import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(REPO_ROOT, "configs", "uncertainty.yml")
FLAGSHIP_GRAPHS = os.path.join(REPO_ROOT, "graphs", "nodes_5_seed_42")

# the JAX dryrun's tiny configs (__graft_entry__.py:112-160): the
# flagship's topology (5 + 5 stages, K5 graphs) with small channels, at
# 32x64, 2 images a device.  Its graphs come from networkx (seed 42 x
# stage); here from the saved graphs/nodes_5_seed_42, which are the same
# graphs (tests/test_torch_entry.py) and need no networkx, which the
# card's machine lacks.  The discriminator's head (linear_in_features 32:
# 16 channels of the 1x2 final map) fixes the input at 32x64.
DRYRUN_MODEL = {
    "encoder": {
        "load_graph": FLAGSHIP_GRAPHS, "nodes": 5, "seed": 42,
        "layers": [
            {"in_channels": 3, "out_channels": 8, "kernel_size": 3, "heads": 2},
            {"in_channels": 8, "out_channels": 8, "kernel_size": 3, "heads": 2},
            {"in_channels": 8, "out_channels": 16, "kernel_size": 3, "heads": 2},
            {"in_channels": 16, "out_channels": 16, "kernel_size": 3, "heads": 2},
            {"in_channels": 16, "out_channels": 32, "kernel_size": 3, "heads": 2},
        ],
    },
    "decoder": {
        "layers": [
            {"in_channels": 32, "feature_in_channels": 16, "skip_in_channels": 32,
             "upsample_channels": 8, "out_channels": 16, "skip_out_channels": 32,
             "concat_disp": False, "calculate_disp": False},
            {"in_channels": 16, "feature_in_channels": 16, "skip_in_channels": 32,
             "upsample_channels": 4, "out_channels": 16, "skip_out_channels": 16,
             "concat_disp": False, "calculate_disp": True, "disp_channels": 4},
            {"in_channels": 16, "feature_in_channels": 8, "skip_in_channels": 16,
             "upsample_channels": 4, "out_channels": 16, "skip_out_channels": 16,
             "concat_disp": True, "calculate_disp": True, "disp_channels": 4},
            {"in_channels": 16, "feature_in_channels": 8, "skip_in_channels": 16,
             "upsample_channels": 4, "out_channels": 16, "skip_out_channels": 16,
             "concat_disp": True, "calculate_disp": True, "disp_channels": 4},
            {"in_channels": 16, "feature_in_channels": 3, "skip_in_channels": 16,
             "upsample_channels": 4, "out_channels": 16, "skip_out_channels": 16,
             "concat_disp": True, "calculate_disp": True, "disp_channels": 4},
        ],
    },
}
DRYRUN_DISC = {
    "load_graph": FLAGSHIP_GRAPHS, "nodes": 5, "seed": 42,
    "layers": [
        {"in_channels": 6, "out_channels": 8, "kernel_size": 3, "heads": 2},
        {"in_channels": 14, "out_channels": 8, "kernel_size": 3, "heads": 2},
        {"in_channels": 14, "out_channels": 16, "kernel_size": 3, "heads": 2},
        {"in_channels": 22, "out_channels": 16, "kernel_size": 3, "heads": 2},
    ],
    "final_conv": {"in_channels": 16, "out_channels": 16,
                   "kernel_size": 3, "heads": 2},
    "linear_in_features": 32,
}
DRYRUN_LOSS = {
    "wssim_alpha": 0.85,
    "perceptual_start": 0,  # the perceptual term from the first step
    "error_loss_config": {"loss_type": "l1", "smoothness_weight": 0,
                          "consistency_weight": 0.5, "pooling": False},
}
TINY_HW = (32, 64)
TINY_PER_DEVICE = 2
DISP_SCALE = 0.3
LR = 1e-4


def load_flagship_config() -> dict:
    """``configs/uncertainty.yml`` with the encoder's and the
    discriminator's graphs at ``graphs/nodes_5_seed_42`` (the JAX
    package's ``__graft_entry__._load_config``)."""
    config = load_config(FLAGSHIP_CONFIG)
    config["model"]["encoder"]["load_graph"] = FLAGSHIP_GRAPHS
    config["discriminator"]["load_graph"] = FLAGSHIP_GRAPHS
    return config


def _model(config: dict, seed: int, device):
    from .models import RandomlyConnectedModel
    return RandomlyConnectedModel.from_config(**config, seed=seed,
                                              device=device)


def entry(device=None, model_config=None):
    """``(forward, example_args)``: ``forward(model, image)`` is the eval
    model's full-resolution output ``model(image, disp_scale=1.0)[0]``,
    (B, H, W, 4) of an NHWC (B, H, W, 3) f32 image, as the JAX entry's
    ``model.apply(variables, image, disp_scale=1.0)[0]``; ``example_args``
    are the flagship's f32 eval model (``model_config``: another
    ``model:`` section), its weights from seed 0, and a zero image (1,
    256, 512, 3), on ``device`` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    config = (load_flagship_config()["model"] if model_config is None
              else model_config)
    model = _model(config, 0, dev).eval()

    @torch.no_grad()
    def forward(model, image):
        out = model(image.permute(0, 3, 1, 2), disp_scale=1.0)[0]
        return out.permute(0, 2, 3, 1)

    return forward, (model, torch.zeros((1, *FLAGSHIP_INPUT, 3),
                                        device=dev))


def _f32() -> None:
    """Full f32 convolutions and matmuls (the CLI's ``--precision
    float32``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _launches():
    from .ops.warp_rows import warp_rows_bwd, warp_rows_fwd
    return {"warp_rows_fwd": warp_rows_fwd.launches,
            "warp_rows_bwd": warp_rows_bwd.launches}


def _rows(rng, n: int, hw, rank: int, per_device: int) -> dict:
    """A global stereo batch of ``n * per_device`` images drawn from
    ``rng`` as the JAX dryrun draws it (left, then right), and this rank's
    rows of it."""
    batch = {side: rng.uniform(size=(n * per_device, *hw, 3)).astype(
        np.float32) for side in ("left", "right")}
    return {k: v[rank * per_device:(rank + 1) * per_device]
            for k, v in batch.items()}


def _step_leg(trainer, batch) -> dict:
    """One ``train_step`` at step 0: the global batch's losses and the
    ``warp_rows`` launches of the step on this rank."""
    before = _launches()
    metrics = trainer.train_step(batch, DISP_SCALE, LR, 0)
    out = {k: v.item() for k, v in metrics.items()}
    out["launches"] = {k: n - before[k] for k, n in _launches().items()}
    return out


def _check(name: str, losses: dict) -> None:
    bad = {k: v for k, v in losses.items()
           if k != "launches" and not np.isfinite(v)}
    if bad:
        raise FloatingPointError(f"dryrun leg {name}: non-finite {bad}")


def dryrun_rank(rank: int, world: int, device, flagship_hw=FLAGSHIP_INPUT
                ) -> dict:
    """Rank ``rank``'s part of ``dryrun_multichip(world)`` (in a process
    group): the three legs' global losses and ``warp_rows`` launches;
    raises on a non-finite loss.  Rank 0 prints the JAX dryrun's lines."""
    from .losses import TukraUncertaintyLoss
    from .models import RandomDiscriminator
    from .ops import reconstruct_pyramid_with_lr, scale_pyramid
    from .train import Trainer

    _f32()
    rng = np.random.default_rng(0)
    lead = rank == 0
    result = {"device": str(device)}

    # leg 1: a full adversarial step of the tiny model and discriminator
    disc = RandomDiscriminator.from_config(**DRYRUN_DISC, init_seed=0,
                                           device=device)
    trainer = Trainer(_model(DRYRUN_MODEL, 0, device), DRYRUN_LOSS,
                      disc=disc, device=device, distributed=True)
    result["tiny"] = leg = _step_leg(
        trainer, _rows(rng, world, TINY_HW, rank, TINY_PER_DEVICE))
    _check("tiny", leg)
    if lead:
        print(f"dryrun_multichip({world}) ok: disp={leg['disp_loss']:.4f} "
              f"unc={leg['error_loss']:.4f} disc={leg['disc_loss']:.4f}",
              flush=True)
    del trainer, disc

    # leg 2: the flagship's eval forward and loss, an image a device
    config = load_flagship_config()
    flagship = _model(config["model"], 0, device).eval()
    batch = _rows(rng, world, flagship_hw, rank, 1)
    before = _launches()
    with torch.no_grad():
        left, right = (torch.from_numpy(batch[k]).to(device)
                       for k in ("left", "right"))
        pyramid = scale_pyramid(torch.cat([left, right], dim=-1), 4)
        disparities = [d.permute(0, 2, 3, 1).float() for d in flagship(
            left.permute(0, 3, 1, 2), disp_scale=DISP_SCALE)]
        recons, lr_pyramid = reconstruct_pyramid_with_lr(disparities,
                                                         pyramid)
        losses = TukraUncertaintyLoss(**config["loss"])(
            pyramid, disparities, recons, lr_pyramid=lr_pyramid, step=0)
        losses = parallel.all_reduce_mean(torch.stack(losses)).tolist()
    result["flagship"] = leg = {
        "disp_loss": losses[0], "error_loss": losses[1],
        "launches": {k: n - before[k] for k, n in _launches().items()}}
    _check("flagship", leg)
    if lead:
        print(f"dryrun_multichip({world}) flagship ok: "
              f"disp={leg['disp_loss']:.4f} unc={leg['error_loss']:.4f}",
              flush=True)
    del flagship

    # leg 3: one flagship step (gradients, DDP's all-reduce, Adam)
    trainer = Trainer(_model(config["model"], 1, device), config["loss"],
                      device=device, distributed=True)
    result["flagship_train"] = leg = _step_leg(
        trainer, _rows(rng, world, flagship_hw, rank, 1))
    _check("flagship train-step", leg)
    if lead:
        print(f"dryrun_multichip({world}) flagship train-step ok: "
              f"disp={leg['disp_loss']:.4f} unc={leg['error_loss']:.4f}",
              flush=True)
    return result


def dryrun_multichip(n: int, platform=None, *, flagship_hw=FLAGSHIP_INPUT
                     ) -> list:
    """One training step over ``n`` devices, a process each (rank r on
    ``cuda:r`` over NCCL; ``platform="cpu"``: n gloo processes), in the
    JAX dryrun's three legs (``__graft_entry__.py:102-272``), with its
    configs, scale 0.3, lr 1e-4, step 0 and batches from
    ``np.random.default_rng(0)``, each rank taking its rows:

    1. a full adversarial step (``Trainer(distributed=True)``: gradients,
       DDP's all-reduce, BatchNorm over the global batch, Adam, the
       discriminator's step) of ``DRYRUN_MODEL`` and ``DRYRUN_DISC`` at
       32x64, 2 images a device;
    2. the flagship's eval forward and ``TukraUncertaintyLoss`` at
       ``flagship_hw``, an image a device;
    3. one flagship step at ``flagship_hw``, an image a device.

    The JAX dryrun runs legs 2 and 3 at 128x256 and 64x128 to bound its
    CPU compile time; here there is no compile, and both run at the
    flagship's 256x512 unless ``flagship_hw`` says otherwise (the tests'
    CPU runs).  Convolutions and matmuls are full f32 (TF32 off), as in
    the CLI's default.

    Rank 0 prints the JAX dryrun's three ``dryrun_multichip(n) ... ok``
    lines; every rank raises on a non-finite loss, and a rank's failure
    fails the call.  Returns each rank's losses (the global batch's means)
    and ``warp_rows`` launches per leg, in rank order.  Raises where CUDA
    is asked for and fewer than ``n`` cards are visible."""
    if platform is None or torch.device(platform).type == "cuda":
        resolve_device("cuda")
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} CUDA devices, "
                f"{torch.cuda.device_count()} visible (platform='cpu' runs "
                f"{n} CPU processes instead)")
    return parallel.spawn(dryrun_rank, n, platform,
                          flagship_hw=tuple(flagship_hw))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m uncertainty_model_tpu_torch.entry",
        description="The JAX package's multi-device dryrun on the port.")
    parser.add_argument("--dryrun-multichip", type=int, required=True,
                        metavar="N", help="one training step over N devices")
    parser.add_argument("--platform", default=None,
                        help="cpu: N gloo processes (default: N cards)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.dryrun_multichip, args.platform)


if __name__ == "__main__":
    main()
