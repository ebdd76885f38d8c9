"""Checkpoints (the port of the JAX package's ``train/checkpoint.py``;
reference train/train.py:18-48, main.py:126-137).

A checkpoint is a directory named ``epoch_{NNN:03}`` or ``final``, as the
JAX package names its own, holding two files:

- ``model.pt``: the model's ``state_dict`` as the reference saves it, a bare
  dict of CPU tensors under the reference's keys, which the reference and
  the JAX package's ``load_torch_checkpoint`` read as it is; with a
  discriminator, the adversarial reference's ``{"model": ..., "disc":
  ...}``;
- ``train_state.pt``: the optimizer's ``state_dict`` (Adam's moments and
  step counts), with a discriminator its optimizer's as
  ``disc_optimizer``, and the epoch number (None for ``final``, as in the
  JAX package).  The discriminator's lagged clone is not saved, as in the
  JAX package.

``Trainer.load_state`` restores both to resume a run exactly
(``--resume-from``), or the weights alone with a fresh optimizer
(``--finetune-from``, the reference's semantics).
``load_torch_checkpoint`` reads a reference ``.pt`` file, which holds
weights only.  A model that computes in bf16 holds f32 parameters, so its
checkpoints are f32 and load into a model of either compute type.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import parallel

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _weights(module) -> dict:
    return {k: v.detach().cpu().contiguous()
            for k, v in module.state_dict().items()}


def save_checkpoint(directory: str, model, optimizer,
                    epoch_number: Optional[int] = None,
                    is_final: bool = False, disc=None,
                    disc_optimizer=None) -> str:
    """Write ``directory/epoch_{NNN}`` (or ``directory/final``), with the
    discriminator ``disc`` and its optimizer where given; returns its
    path.  In a process group rank 0 alone writes (every rank holds the
    same state), and every rank waits for it before going on."""
    name = "final" if is_final else f"epoch_{epoch_number:03}"
    path = os.path.abspath(os.path.join(directory, name))
    if parallel.rank() == 0:
        train_state = {"optimizer": optimizer.state_dict(),
                       "epoch": epoch_number}
        if disc is not None:
            train_state["disc_optimizer"] = disc_optimizer.state_dict()
        write_checkpoint(path, _weights(model), train_state,
                         None if disc is None else _weights(disc))
    parallel.barrier()
    return path


def write_checkpoint(path: str, state_dict: dict, train_state: dict,
                     disc_state_dict: Optional[dict] = None) -> str:
    """Write the checkpoint directory ``path`` from what
    ``load_checkpoint(path)`` returns (its inverse; ``save_checkpoint``
    writes through it, and so does the converter of JAX checkpoints,
    ``tools/orbax_to_torch.py``); returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    print(f"Saving model to:\n\t{path}")
    weights = (state_dict if disc_state_dict is None
               else {"model": state_dict, "disc": disc_state_dict})
    torch.save(weights, os.path.join(path, MODEL_FILE))
    torch.save(train_state, os.path.join(path, TRAIN_STATE_FILE))
    return path


def _is_adversarial(payload: dict) -> bool:
    return "model" in payload and "disc" in payload


def load_checkpoint(path: str, adversarial: bool = False) -> tuple:
    """``(state_dict, train_state)`` of a checkpoint directory, on the CPU:
    the model's weights (a discriminator's, where the checkpoint has one,
    are left out).  With ``adversarial``, ``(state_dict, train_state,
    disc_state_dict)``; a checkpoint without a discriminator raises."""
    def load(name):
        return torch.load(os.path.join(path, name), map_location="cpu",
                          weights_only=True)

    weights, train_state = load(MODEL_FILE), load(TRAIN_STATE_FILE)
    if not adversarial:
        return (weights["model"] if _is_adversarial(weights) else weights,
                train_state)
    if not _is_adversarial(weights):
        raise ValueError(f"{path} holds no discriminator: an adversarial "
                         f"run needs a checkpoint of one")
    return weights["model"], train_state, weights["disc"]


def _strip_ddp(state_dict: dict) -> dict:
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> tuple[dict, Optional[dict]]:
    """A reference ``.pt`` file (weights only, the finetune path) ->
    ``(model state_dict, discriminator state_dict or None)``, with DDP's
    ``module.`` prefix stripped (reference train/utils.py:328-330).  A file
    of the adversarial reference holds ``{"model": ..., "disc": ...}``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if _is_adversarial(payload):
        return _strip_ddp(payload["model"]), _strip_ddp(payload["disc"])
    return _strip_ddp(payload), None
