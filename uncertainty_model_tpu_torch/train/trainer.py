"""The self-supervised training loop (the port of the JAX package's
``train/trainer.py``; reference train/train.py), without the adversarial
branch, with evaluation and checkpoints between epochs.

One step: the 4-scale image pyramid of the stereo pair, the model's
train-mode forward on the left view (BatchNorm on batch statistics), the
fused reconstruction and LR-consistency warps of every scale
(``warp_rows``, one kernel launch on CUDA), the composite loss, backward,
and an Adam update.  Adam is
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
from ..utils.progress import progress_bar
from ..utils.schedules import adjust_disparity, learning_rate_for_epoch
from .checkpoint import save_checkpoint
from .evaluate import evaluate_model

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
        self.optimizer = self._adam()

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.model.parameters(), lr=0.0,
                                betas=(0.9, 0.999), eps=1e-8)

    def load_state(self, state_dict: dict, train_state: Optional[dict] = None,
                   disc_state_dict: Optional[dict] = None) -> int:
        """Load restored weights (``checkpoint.load_checkpoint``, or a
        reference ``.pt`` through ``load_torch_checkpoint``); returns the
        epoch to start from.

        With ``train_state`` (the JAX CLI's ``--resume-from``) the Adam
        moments and step counts are restored too, so that
        ``train_model(start_epoch=<returned epoch>)`` continues exactly as
        an uninterrupted run would.  Without it (``--finetune-from``) the
        weights alone are loaded and the optimizer starts afresh, the
        reference's semantics (the JAX package's ``Trainer.load_state``)."""
        if disc_state_dict is not None:
            raise NotImplementedError(
                "the discriminator belongs to a later slice of the port")
        self.model.load_state_dict(state_dict, strict=True)
        self.optimizer = self._adam()
        if train_state is None:
            return 0
        self.optimizer.load_state_dict(train_state["optimizer"])
        return int(train_state["epoch"] or 0)

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
        wait for each step.  ``pbar`` shows a ``tqdm`` bar, or where
        ``tqdm`` is not installed prints a line every ``log_every`` (else
        10) batches.  Returns the per-image average losses, as the
        reference computes them (the sum of batch means over the images)."""
        running = dict.fromkeys(_METRICS, 0.0)
        n_images = 0
        averages = {"disp": float("nan"), "unc": float("nan"), "disc": None,
                    "scale": disp_scale}
        pending: list[dict] = []

        tepoch = None
        if pbar:
            tepoch = progress_bar(loader, f"Epoch #{epoch_number}"
                                  if epoch_number is not None else "Epoch")
            if tepoch is None:  # no tqdm: the printed lines instead
                log_every = log_every or 10

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

        for i, batch in enumerate(loader if tepoch is None else tepoch):
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
        train/train.py:173-267): every ``evaluate_every`` epochs an
        evaluation on ``val_loader`` at the epoch's disparity scale, every
        ``save_every`` epochs a checkpoint ``epoch_{NNN}`` in
        ``save_model_to``, and ``final`` there at the end.  Returns
        ``(training_losses, validation_metrics)``: per epoch ``(disp, unc,
        disc)`` averages, and per evaluation ``((left_ssim, right_ssim),
        (ause, aurg))``."""
        training_losses, validation_metrics = [], []
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

            if evaluate_every is not None and (epoch + 1) % evaluate_every == 0:
                validation_metrics.append(evaluate_model(
                    self.model, val_loader,
                    save_evaluation_to=save_evaluation_to,
                    epoch_number=epoch + 1, is_final=False, scale=disp_scale))
            if (save_every is not None and (epoch + 1) % save_every == 0
                    and save_model_to is not None):
                save_checkpoint(save_model_to, self.model, self.optimizer,
                                epoch_number=epoch + 1)
        print("Training completed.")
        if save_model_to is not None:
            save_checkpoint(save_model_to, self.model, self.optimizer,
                            is_final=True)
        return training_losses, validation_metrics
