"""The self-supervised training loop (the port of the JAX package's
``train/trainer.py``; reference train/train.py), with evaluation and
checkpoints between epochs.

One step: the 4-scale image pyramid of the stereo pair, the model's
train-mode forward on the left view (BatchNorm on batch statistics), the
fused reconstruction and LR-consistency warps of every scale
(``warp_rows``, one kernel launch on CUDA), the composite loss, backward,
and an Adam update.  Adam is
``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` with the learning rate
set each step: the same update as the JAX package's
``optax.scale_by_adam`` times ``-lr`` (eps after the bias-corrected square
root).

With a discriminator (the CLI's ``--adversarial``) the loss adds the
generator and perceptual terms, computed by a lagged clone of the
discriminator (the reference's ``disc_clone``, train/train.py:107,151-152):
a deep copy that takes no gradient, run in train mode, whose parameters
are refreshed from the live discriminator every ``perceptual_update_freq``
batches.  After the model's update the live discriminator takes its own
Adam step on the real and the (detached) reconstructed pyramids.  The
clone's BatchNorm buffers take its forwards' updates and are never read
(train-mode BatchNorm normalises by the batch's statistics), as the JAX
package discards them (its ``_apply_disc``); the live discriminator's
move once a step.

A model built with ``dtype=torch.bfloat16`` trains in the JAX package's
mixed precision: its modules compute in bf16 while the parameters, their
gradients (each cast back to f32 where a module cast its weight), the
BatchNorm statistics and Adam stay f32; the disparities reach the warps
and the losses in f32.  Adversarial training is f32 only: the JAX
package's bf16 adversarial step does not run (see ``BF16_ADVERSARIAL``).

``distributed=True`` (in a process group, ``parallel.init_distributed``)
computes the JAX package's data-parallel step over every rank's batch
together: the model and the live discriminator are each wrapped in
``DistributedDataParallel``, which averages their gradients (every loss
is a batch mean, so with equal shards the average of the ranks' means is
the global batch's), and every ``TorchBatchNorm`` of the model, the live
discriminator and the lagged clone takes the process group, so that its
statistics (and their gradients) cover the global batch as GSPMD's do.
``self.model`` and ``self.disc`` stay the unwrapped modules: checkpoints
and ``state_dict`` keys are the serial run's.  The clone is not wrapped:
it copies the live discriminator's parameters, which DDP keeps equal on
every rank.  Each step's losses are the global batch's means on every
rank.

Each step runs in ``utils/scopes.py::scope("train.step")``, partitioned by
``train.forward`` (the inputs to the device, the pyramid, ``zero_grad``,
the model's forward), ``train.loss`` (the layout change, the warps, the
composite loss), ``train.backward`` and ``train.adam`` (the learning rate
and ``optimizer.step``), with ``train.disc`` (the discriminator's step)
and ``train.reduce`` (the losses' all-reduce) where they run; an epoch
waits for each batch in ``train.load``.  They are profiler ranges (the
CLI's ``--profile-dir`` trace shows them) and the span recorder's.
"""

from __future__ import annotations

import copy
import itertools
import math
import time
import warnings
from typing import Callable, Optional

import torch

from .. import parallel
from ..device import resolve_device
from ..losses import TukraUncertaintyLoss, discriminator_loss
from ..ops import reconstruct_pyramid_with_lr, scale_pyramid
from ..utils.progress import progress_bar
from ..utils.schedules import adjust_disparity, learning_rate_for_epoch
from ..utils.scopes import scope
from .checkpoint import save_checkpoint
from .evaluate import evaluate_model

_METRICS = ("disp_loss", "error_loss")
BF16_ADVERSARIAL = (
    "adversarial training runs in f32 only: the JAX package's bf16 "
    "adversarial step fails (its losses/total.py:97-101 gates the "
    "perceptual term with lax.cond, whose branches return bf16 and f32), "
    "so it has no bf16 reference")


def adam(module) -> torch.optim.Adam:
    """The optimizer of ``module``'s parameters that ``Trainer`` steps (the
    learning rate is set before each step)."""
    return torch.optim.Adam(module.parameters(), lr=0.0,
                            betas=(0.9, 0.999), eps=1e-8)


class Trainer:
    """Trains ``model`` (the port's ``RandomlyConnectedModel``), moved to
    ``device`` (CUDA unless asked otherwise), under ``loss_config`` (the
    config's ``loss:`` section); with ``disc`` (a ``RandomDiscriminator``)
    adversarially, its lagged clone refreshed every
    ``perceptual_update_freq`` batches."""

    def __init__(self, model, loss_config: Optional[dict] = None, disc=None,
                 device=None, scales: int = 4,
                 perceptual_update_freq: int = 10,
                 distributed: bool = False) -> None:
        if disc is not None and (model.dtype is not None
                                 or disc.dtype is not None):
            raise NotImplementedError(BF16_ADVERSARIAL)
        self.device = resolve_device(device)
        self.group = parallel.world_group() if distributed else None
        self.model = self._place(model)
        self.loss = TukraUncertaintyLoss(**(loss_config or {}))
        self.scales = scales
        self.perceptual_update_freq = perceptual_update_freq
        self.optimizer = adam(self.model)
        self.disc = self.disc_lag = self.disc_optimizer = None
        if disc is not None:
            self.disc = self._place(disc)
            self.disc_lag = self._lag()
            self.disc_optimizer = adam(self.disc)
        # DistributedDataParallel's wrappers, which the step calls where
        # distributed (else None)
        self.ddp_model = self._wrap(self.model)
        self.ddp_disc = self._wrap(self.disc)

    def _place(self, module):
        """``module`` on the device; in a process group with its BatchNorm
        layers on the global batch and its buffers rank 0's (DDP
        broadcasts the parameters)."""
        module = module.to(self.device, memory_format=torch.channels_last)
        if self.group is not None:
            parallel.sync_batchnorm(module, self.group)
            parallel.broadcast_(module.buffers())
        return module

    def _wrap(self, module):
        """``module`` in ``DistributedDataParallel`` where distributed (its
        buffers move alike on every rank, so DDP need not broadcast them
        each forward), else None."""
        if module is None or self.group is None:
            return None
        with warnings.catch_warnings():  # newer torch renames the option
            warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                    FutureWarning)
            return torch.nn.parallel.DistributedDataParallel(
                module, device_ids=([self.device]
                                    if self.device.type == "cuda" else None),
                broadcast_buffers=False, process_group=self.group)

    def _lag(self):
        """A deep copy of the live discriminator (without its gradients)
        that takes no gradient; its BatchNorm layers share the live one's
        process group."""
        memo = {} if self.group is None else {id(self.group): self.group}
        return copy.deepcopy(self.disc, memo).requires_grad_(False)

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
        reference's semantics (the JAX package's ``Trainer.load_state``).

        A trainer with a discriminator needs ``disc_state_dict`` (and, to
        resume, the discriminator's Adam state in ``train_state``).  Its
        lagged clone starts as a copy of the restored discriminator, as in
        the JAX package: checkpoints do not hold the clone, so a resumed
        adversarial run equals the JAX package's resumed run, and equals
        an uninterrupted one only where the clone was last refreshed at
        the checkpoint's step."""
        if (disc_state_dict is None) != (self.disc is None):
            raise ValueError(
                "a discriminator's weights need a trainer with a "
                "discriminator" if self.disc is None else
                "this trainer has a discriminator: give its weights "
                "(disc_state_dict)")
        self.model.load_state_dict(state_dict, strict=True)
        self.optimizer = adam(self.model)
        if self.disc is not None:
            self.disc.load_state_dict(disc_state_dict, strict=True)
            self.disc_lag = self._lag()
            self.disc_optimizer = adam(self.disc)
        if train_state is None:
            return 0
        self.optimizer.load_state_dict(train_state["optimizer"])
        if self.disc is not None:
            self.disc_optimizer.load_state_dict(train_state["disc_optimizer"])
        return int(train_state["epoch"] or 0)

    def _input(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device,
                                                          non_blocking=True)

    def train_step(self, batch: dict, disp_scale: float, lr: float,
                   step_idx: int = 0) -> dict:
        """One optimisation step on ``batch`` (``left`` and ``right``, NHWC
        (B, H, W, 3), numpy or tensors); ``step_idx`` is the batch index
        within the epoch.  Returns the losses as 0-dimensional device
        tensors (``disc_loss`` too with a discriminator); the parameters'
        ``.grad`` hold this step's gradients until the next step.

        With a discriminator, in the JAX step's order: the loss with the
        lagged clone's terms, the model's backward and Adam step; the live
        discriminator's loss on ``[images; reconstructions]`` (one forward
        at twice the batch, so its BatchNorm statistics move once), its
        backward and Adam step; then, every ``perceptual_update_freq``
        batches, the clone takes the updated parameters."""
        with scope("train.step"):
            with scope("train.forward"):
                left = self._input(batch["left"])
                right = self._input(batch["right"])
                image_pyramid = scale_pyramid(torch.cat([left, right], dim=-1),
                                              self.scales)
                self.model.train()
                self.optimizer.zero_grad(set_to_none=True)
                model = (self.model if self.ddp_model is None
                         else self.ddp_model)
                disparities = model(left.permute(0, 3, 1, 2),
                                    disp_scale=disp_scale)
            with scope("train.loss"):
                # the losses in f32, NHWC
                disparities = [d.permute(0, 2, 3, 1).float()
                               for d in disparities]
                recon_pyramid, lr_pyramid = reconstruct_pyramid_with_lr(
                    disparities, image_pyramid)
                lag = self.disc_lag
                if lag is not None:
                    lag.train()
                disp_loss, error_loss = self.loss(
                    image_pyramid, disparities, recon_pyramid, step=step_idx,
                    lr_pyramid=lr_pyramid, disc_apply=lag,
                    disc_features=None if lag is None else lag.features)
                metrics = {"disp_loss": disp_loss.detach(),
                           "error_loss": error_loss.detach()}
            with scope("train.backward"):
                (disp_loss + error_loss).backward()
                # the autograd graph goes here, not when the step returns
                # (the discriminator reads the reconstructions detached)
                recon_pyramid = [r.detach() for r in recon_pyramid]
                del disparities, lr_pyramid, disp_loss, error_loss
            with scope("train.adam"):
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
            if self.disc is not None:
                with scope("train.disc"):
                    metrics["disc_loss"] = self._disc_step(
                        image_pyramid, recon_pyramid, lr, step_idx)
            if self.group is not None:  # the global batch's means
                with scope("train.reduce"):
                    metrics = dict(zip(metrics, parallel.all_reduce_mean(
                        torch.stack(list(metrics.values())))))
            return metrics

    def _disc_step(self, image_pyramid, recon_pyramid, lr: float,
                   step_idx: int) -> torch.Tensor:
        self.disc.train()
        self.disc_optimizer.zero_grad(set_to_none=True)
        disc = self.disc if self.ddp_disc is None else self.ddp_disc
        disc_loss = discriminator_loss(image_pyramid, recon_pyramid, disc,
                                       len(image_pyramid[0]))
        disc_loss.backward()
        for group in self.disc_optimizer.param_groups:
            group["lr"] = lr
        self.disc_optimizer.step()
        if step_idx % self.perceptual_update_freq == 0:
            with torch.no_grad():
                for lagged, live in zip(self.disc_lag.parameters(),
                                        self.disc.parameters()):
                    lagged.copy_(live)
        return disc_loss.detach()

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
        reference computes them (the sum of batch means over the images):
        ``disp``, ``unc`` and, with a discriminator, ``disc`` (else
        None).  Distributed, the batch means are the global batch's and
        the images this process's own, as in the JAX package
        (trainer.py:353-357); the ranks first check that their shards
        give the same batches, and raise if not (one rank would wait for
        the others in a collective)."""
        if self.group is not None:
            parallel.require_equal_shards(loader, "training")
        keys = _METRICS + (("disc_loss",) if self.disc is not None else ())
        running = dict.fromkeys(keys, 0.0)
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
            fetched = torch.stack([torch.stack([m[k] for k in keys])
                                   for m in pending]).cpu().tolist()
            for row in fetched:
                for key, value in zip(keys, row):
                    running[key] += value
            pending.clear()
            return {"disp": running["disp_loss"] / n_images,
                    "unc": running["error_loss"] / n_images,
                    "disc": (running["disc_loss"] / n_images
                             if self.disc is not None else None),
                    "scale": disp_scale}

        drain_every = max(metrics_every, 1)
        if log_every:
            drain_every = math.gcd(drain_every, log_every)

        batches = iter(loader if tepoch is None else tepoch)
        for i in itertools.count():
            with scope("train.load"):
                batch = next(batches, None)
            if batch is None:
                break
            pending.append(self.train_step(batch, disp_scale, lr, i))
            n_images += len(batch["left"])
            if (i + 1) % drain_every != 0:
                continue
            averages = drain()
            if tepoch is not None:
                shown = {k: averages[k] for k in ("disp", "unc", "disc")
                         if averages[k] is not None}
                tepoch.set_postfix(**shown, scale=disp_scale)
            elif progress is not None:
                progress({"batch": i, **averages})
            elif log_every and (i + 1) % log_every == 0:
                print(f"Epoch #{epoch_number} [{i + 1}/{len(loader)}] "
                      f"disp={averages['disp']:.2e} unc={averages['unc']:.2e}")
        if pending:
            averages = drain()
        return averages

    def _profiler(self, profile_dir: str) -> torch.profiler.profile:
        """The CLI's ``--profile-dir`` trace of an epoch, written for
        TensorBoard.  It is no measurement and is not checked: unlike the
        measurement tools' windows (``tools/trace_chained.py::profile``) it
        opens without a warm-up step, so its first device records may be
        missing."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir))

    def train_model(self, loader, epochs: int, learning_rate: float,
                    val_loader=None, evaluate_every: Optional[int] = None,
                    save_evaluation_to: Optional[str] = None,
                    save_every: Optional[int] = None,
                    save_model_to: Optional[str] = None,
                    finetune: bool = False, no_pbar: bool = False,
                    profile_dir: Optional[str] = None, start_epoch: int = 0):
        """Epochs ``start_epoch`` .. ``epochs - 1`` with the learning-rate
        schedule and the disparity-scale curriculum (reference
        train/train.py:173-267): every ``evaluate_every`` epochs an
        evaluation on ``val_loader`` at the epoch's disparity scale, every
        ``save_every`` epochs a checkpoint ``epoch_{NNN}`` in
        ``save_model_to``, and ``final`` there at the end.  Returns
        ``(training_losses, validation_metrics)``: per epoch ``(disp, unc,
        disc)`` averages, and per evaluation ``((left_ssim, right_ssim),
        (ause, aurg))``.

        ``profile_dir``: a ``torch.profiler`` trace of epoch 0 (host
        operators, and the device's kernels on CUDA), written there as a
        Chrome/TensorBoard trace (``*.pt.trace.json``) when the epoch
        ends, after the device has finished its work.

        Distributed, every rank evaluates (the metrics are collectives)
        and returns the same lists; rank 0 alone prints, shows the
        progress and writes (the comparison grids and the checkpoints,
        which every rank waits for)."""
        lead = parallel.rank() == 0
        training_losses, validation_metrics = [], []
        for epoch in range(start_epoch, epochs):
            lr = learning_rate_for_epoch(epoch, learning_rate, finetune)
            disp_scale = 1.0 if finetune else adjust_disparity(epoch)
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            t0 = time.time()
            profiler = (self._profiler(profile_dir)
                        if profile_dir is not None and epoch == 0 else None)
            if profiler is not None:
                profiler.start()
            averages = self.train_one_epoch(
                loader, disp_scale, lr, epoch_number=epoch + 1,
                log_every=10 if no_pbar and lead else 0,
                pbar=not no_pbar and lead)
            if profiler is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                profiler.stop()
            training_losses.append(
                (averages["disp"], averages["unc"], averages["disc"]))
            if lead:
                print(f"Epoch #{epoch + 1}:"
                      f"\n\tdisparity loss: {averages['disp']:.2e}"
                      f"\n\tuncertainty loss: {averages['unc']:.2e}"
                      f"\n\tdisparity scale: {disp_scale:.2f}"
                      f"\n\ttime: {time.time() - t0:.1f}s")

            if evaluate_every is not None and (epoch + 1) % evaluate_every == 0:
                validation_metrics.append(evaluate_model(
                    self.model, val_loader,
                    save_evaluation_to=save_evaluation_to,
                    epoch_number=epoch + 1, is_final=False, scale=disp_scale,
                    no_pbar=not lead))
            if (save_every is not None and (epoch + 1) % save_every == 0
                    and save_model_to is not None):
                save_checkpoint(save_model_to, self.model, self.optimizer,
                                epoch_number=epoch + 1, disc=self.disc,
                                disc_optimizer=self.disc_optimizer)
        if lead:
            print("Training completed.")
        if save_model_to is not None:
            save_checkpoint(save_model_to, self.model, self.optimizer,
                            is_final=True, disc=self.disc,
                            disc_optimizer=self.disc_optimizer)
        return training_losses, validation_metrics
