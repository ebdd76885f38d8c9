"""The self-supervised training loop (the port of the JAX package's
``train/trainer.py``; reference train/train.py), without the adversarial
branch.

One step: the 4-scale image pyramid of the stereo pair, the model's
train-mode forward on the left view (BatchNorm on batch statistics), the
fused reconstruction and LR-consistency warps (``warp_rows``, a kernel on
CUDA), the composite loss, backward, and an Adam update.  Adam is
``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` with the learning rate
set each step: the same update as the JAX package's
``optax.scale_by_adam`` times ``-lr`` (eps after the bias-corrected square
root).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..losses import TukraUncertaintyLoss
from ..ops import reconstruct_pyramid_with_lr, scale_pyramid
from ..utils.schedules import adjust_disparity, learning_rate_for_epoch

_METRICS = ("disp_loss", "error_loss")


class Trainer:
    """Trains ``model`` (the port's ``RandomlyConnectedModel``), moved to
    ``device`` (CUDA unless asked otherwise), under ``loss_config`` (the
    config's ``loss:`` section)."""

    def __init__(self, model, loss_config: Optional[dict] = None, device=None,
                 scales: int = 4) -> None:
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.loss = TukraUncertaintyLoss(**(loss_config or {}))
        self.scales = scales
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=0.0,
                                          betas=(0.9, 0.999), eps=1e-8)

    def _input(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device,
                                                          non_blocking=True)

    def train_step(self, batch: dict, disp_scale: float, lr: float,
                   step_idx: int = 0) -> dict:
        """One optimisation step on ``batch`` (``left`` and ``right``, NHWC
        (B, H, W, 3), numpy or tensors).  Returns the two losses as
        0-dimensional device tensors; the parameters' ``.grad`` hold this
        step's gradients until the next step."""
        left, right = self._input(batch["left"]), self._input(batch["right"])
        image_pyramid = scale_pyramid(torch.cat([left, right], dim=-1),
                                      self.scales)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        disparities = self.model(left.permute(0, 3, 1, 2),
                                 disp_scale=disp_scale)
        # the losses in f32, NHWC
        disparities = [d.permute(0, 2, 3, 1).float() for d in disparities]
        recon_pyramid, lr_pyramid = reconstruct_pyramid_with_lr(
            disparities, image_pyramid)
        disp_loss, error_loss = self.loss(image_pyramid, disparities,
                                          recon_pyramid, step=step_idx,
                                          lr_pyramid=lr_pyramid)
        (disp_loss + error_loss).backward()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return {"disp_loss": disp_loss.detach(),
                "error_loss": error_loss.detach()}

    def train_one_epoch(self, loader, disp_scale: float, lr: float,
                        epoch_number: Optional[int] = None, log_every: int = 0,
                        progress: Optional[Callable[[dict], None]] = None,
                        pbar: bool = False, metrics_every: int = 10) -> dict:
        """One pass over ``loader`` (reference train/train.py:51-170).

        The losses stay on the device and are read every ``metrics_every``
        batches (or ``gcd(metrics_every, log_every)``), so the host does not
        wait for each step.  Returns the per-image average losses, as the
        reference computes them (the sum of batch means over the images)."""
        running = dict.fromkeys(_METRICS, 0.0)
        n_images = 0
        averages = {"disp": float("nan"), "unc": float("nan"), "disc": None,
                    "scale": disp_scale}
        pending: list[dict] = []

        iterator = loader
        tepoch = None
        if pbar:
            import tqdm

            description = (f"Epoch #{epoch_number}" if epoch_number is not None
                           else "Epoch")
            tepoch = tqdm.tqdm(loader, description, unit="batch")
            iterator = tepoch

        def drain():
            fetched = torch.stack([torch.stack([m[k] for k in _METRICS])
                                   for m in pending]).cpu().tolist()
            for row in fetched:
                for key, value in zip(_METRICS, row):
                    running[key] += value
            pending.clear()
            return {"disp": running["disp_loss"] / n_images,
                    "unc": running["error_loss"] / n_images, "disc": None,
                    "scale": disp_scale}

        drain_every = max(metrics_every, 1)
        if log_every:
            drain_every = math.gcd(drain_every, log_every)

        for i, batch in enumerate(iterator):
            pending.append(self.train_step(batch, disp_scale, lr, i))
            n_images += len(batch["left"])
            if (i + 1) % drain_every != 0:
                continue
            averages = drain()
            if tepoch is not None:
                tepoch.set_postfix(disp=averages["disp"], unc=averages["unc"],
                                   scale=disp_scale)
            elif progress is not None:
                progress({"batch": i, **averages})
            elif log_every and (i + 1) % log_every == 0:
                print(f"Epoch #{epoch_number} [{i + 1}/{len(loader)}] "
                      f"disp={averages['disp']:.2e} unc={averages['unc']:.2e}")
        if pending:
            averages = drain()
        return averages

    def train_model(self, loader, epochs: int, learning_rate: float,
                    val_loader=None, evaluate_every: Optional[int] = None,
                    save_evaluation_to: Optional[str] = None,
                    save_every: Optional[int] = None,
                    save_model_to: Optional[str] = None,
                    finetune: bool = False, no_pbar: bool = False,
                    start_epoch: int = 0):
        """Epochs ``start_epoch`` .. ``epochs - 1`` with the learning-rate
        schedule and the disparity-scale curriculum (reference
        train/train.py:173-267).  Returns ``(training_losses,
        validation_metrics)``: per epoch ``(disp, unc, disc)`` averages, and
        an empty list until evaluation is ported."""
        if (val_loader is not None or evaluate_every is not None
                or save_evaluation_to is not None):
            raise NotImplementedError(
                "evaluation belongs to a later slice of the port")
        if save_every is not None or save_model_to is not None:
            raise NotImplementedError(
                "checkpoints belong to a later slice of the port")

        training_losses = []
        for epoch in range(start_epoch, epochs):
            lr = learning_rate_for_epoch(epoch, learning_rate, finetune)
            disp_scale = 1.0 if finetune else adjust_disparity(epoch)
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            t0 = time.time()
            averages = self.train_one_epoch(
                loader, disp_scale, lr, epoch_number=epoch + 1,
                log_every=10 if no_pbar else 0, pbar=not no_pbar)
            training_losses.append(
                (averages["disp"], averages["unc"], averages["disc"]))
            print(f"Epoch #{epoch + 1}:"
                  f"\n\tdisparity loss: {averages['disp']:.2e}"
                  f"\n\tuncertainty loss: {averages['unc']:.2e}"
                  f"\n\tdisparity scale: {disp_scale:.2f}"
                  f"\n\ttime: {time.time() - t0:.1f}s")
        print("Training completed.")
        return training_losses, []
