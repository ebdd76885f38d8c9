"""The evaluation loop (the port of the JAX package's ``train/evaluate.py``;
reference train/evaluate.py).

Per batch: the full-resolution eval-mode forward, the stereo
reconstructions by warp (one ``warp_rows`` launch on CUDA), gaussian SSIM
(k=11, sum-reduced), the WSSIM(alpha=1) image error, and the
sparsification curves -> AUSE/AURG, all on the model's device; the running
averages and the first batch's comparison PNGs live on the host.  A bf16
model's prediction is cast to f32 for the metrics, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import parallel
from ..losses import wssim_image_error
from ..ops import resize_bilinear, warp_by_disparities
from ..utils.progress import progress_bar
from ..utils.viz import get_comparison, save_image
from . import sparsification as spars
from .metrics import gaussian_ssim


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def eval_step(model, batch: dict, scale: float, noise: torch.Tensor):
    """One evaluation batch (the JAX package's ``_eval_step``).

    ``batch``: ``left`` and ``right`` (B, H, W, 3), numpy or tensors;
    ``noise``: the (B, H, W, 2) uniform draw of the random curve.  Returns
    ``(metrics, viz)``: the summed SSIM of each view, AUSE and AURG as
    0-dimensional tensors, and the NHWC tensors the comparison grids
    show."""
    dev = _device_of(model)
    left = torch.as_tensor(batch["left"], dtype=torch.float32).to(dev)
    right = torch.as_tensor(batch["right"], dtype=torch.float32).to(dev)
    images = torch.cat([left, right], dim=-1)

    model.eval()
    prediction = model(left.permute(0, 3, 1, 2), disp_scale=scale)[0]
    prediction = prediction.permute(0, 2, 3, 1).float()  # metrics in f32
    disparity = prediction[..., :2]
    uncertainty = prediction[..., 2:]

    # the left view from the right image (reconstruct_left_image), the
    # right view from the left, in one warp
    left_recon, right_recon = warp_by_disparities(
        [-disparity[..., 0:1], disparity[..., 1:2]], [right, left])

    left_ssim = gaussian_ssim(left_recon, left).sum()
    right_ssim = gaussian_ssim(right_recon, right).sum()

    recon = torch.cat([left_recon, right_recon], dim=-1)
    h, w = recon.shape[1], recon.shape[2]
    error = resize_bilinear(wssim_image_error(images, recon, alpha=1.0),
                            (h, w))

    oracle = spars.curve(error, error)
    predicted = spars.curve(error, uncertainty)
    random = spars.curve(error, noise.to(dev))

    metrics = {"left_ssim": left_ssim, "right_ssim": right_ssim,
               "ause": spars.ause(oracle, predicted),
               "aurg": spars.aurg(predicted, random)}
    viz = {"images": images, "disparity": disparity,
           "uncertainty": uncertainty, "recon": recon, "error": error}
    return metrics, viz


def save_comparisons(viz: dict, directory: str,
                     epoch_number: Optional[int] = None,
                     is_final: bool = True) -> None:
    """Three comparison grids of the first sample (reference
    train/evaluate.py:25-63)."""
    first = {k: v[0].float().cpu().numpy() for k, v in viz.items()}
    image = first["images"]

    prediction_image = get_comparison(image, first["disparity"],
                                      first["uncertainty"], add_scaled=False)
    disparity_image = get_comparison(image, first["disparity"], first["recon"],
                                     add_scaled=True)
    uncertainty_image = get_comparison(image, first["uncertainty"],
                                       first["error"], add_scaled=True)

    dirname = "final" if is_final else f"epoch_{epoch_number:03}"
    epoch_directory = os.path.join(directory, dirname)
    os.makedirs(epoch_directory, exist_ok=True)

    print(f"Saving comparisons to:\n\t{epoch_directory}")
    save_image(prediction_image, os.path.join(epoch_directory, "prediction.png"))
    save_image(disparity_image, os.path.join(epoch_directory, "disparity.png"))
    save_image(uncertainty_image,
               os.path.join(epoch_directory, "uncertainty.png"))


def evaluate_model(model, loader, save_evaluation_to: Optional[str] = None,
                   epoch_number: Optional[int] = None, scale: float = 1.0,
                   is_final: bool = True, seed: int = 0,
                   no_pbar: bool = False):
    """Returns ``((left_ssim, right_ssim), (ause, aurg))``: SSIM averaged
    per image, AUSE and AURG per batch (reference train/evaluate.py:66-196).
    The random curve's noise is drawn per batch by a ``torch.Generator`` on
    the model's device seeded with ``seed``.

    In a process group (``parallel``), every rank evaluates its shard and
    the metrics are the global batch's, as the JAX package's
    (evaluate.py:128-186): the SSIM sums over every rank's images divided
    by the global count, AUSE and AURG of the global batch's curves (the
    mean of the ranks', the shards being equal: the ranks first check that
    they give the same batches, and raise if not).  The noise is drawn at
    the global batch's shape on every rank, each taking its own rows in
    rank order, so the metrics equal one process's on the concatenated
    batches.  The first batch's tensors are gathered from every rank
    (whether or not anything is saved: it is a collective), and rank 0
    alone saves the grids and prints."""
    dev = _device_of(model)
    generator = torch.Generator(dev).manual_seed(seed)
    running = {"left_ssim": 0.0, "right_ssim": 0.0, "ause": 0.0, "aurg": 0.0}
    averages = dict(running)
    world, rank = parallel.world_size(), parallel.rank()
    distributed = parallel.is_distributed()
    if distributed:
        parallel.require_equal_shards(loader, "evaluation")
    lead = rank == 0

    tepoch = None if no_pbar or not lead else progress_bar(loader,
                                                           "Evaluation")
    for i, batch in enumerate(loader if tepoch is None else tepoch):
        b, h, w = batch["left"].shape[:3]
        noise = torch.rand((world * b, h, w, 2), generator=generator,
                           device=dev)[rank * b:(rank + 1) * b]
        metrics, viz = eval_step(model, batch, scale, noise)

        values = torch.stack([metrics[k] for k in running])
        if distributed:  # the SSIM sums summed, the curves' areas averaged
            values = parallel.all_reduce_sum(values) / torch.tensor(
                [1.0, 1.0, world, world], device=values.device)
            if i == 0:
                viz = {k: parallel.all_gather_rows(v) for k, v in viz.items()}
        fetched = values.cpu().tolist()
        for key, value in zip(running, fetched):
            running[key] += value
        n_images = (i + 1) * b * world
        averages = {
            "left_ssim": running["left_ssim"] / n_images,
            "right_ssim": running["right_ssim"] / n_images,
            "ause": running["ause"] / (i + 1),
            "aurg": running["aurg"] / (i + 1),
        }
        if tepoch is not None:
            tepoch.set_postfix(
                ssim=(averages["left_ssim"] + averages["right_ssim"]) / 2,
                ause=averages["ause"], aurg=averages["aurg"])

        if save_evaluation_to is not None and i == 0 and lead:
            save_comparisons(viz, save_evaluation_to, epoch_number, is_final)

    if not no_pbar and lead:
        print("Evaluation:"
              f"\n\tleft ssim: {averages['left_ssim']:.2f}"
              f"\n\tright ssim: {averages['right_ssim']:.2f}"
              f"\n\tause: {averages['ause']:.2f}"
              f"\n\taurg: {averages['aurg']:.2f}"
              f"\n\tdisparity scale: {scale:.2f}")

    return ((averages["left_ssim"], averages["right_ssim"]),
            (averages["ause"], averages["aurg"]))
