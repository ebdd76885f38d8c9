"""Checkpoints (the port of the JAX package's ``train/checkpoint.py``;
reference train/train.py:18-48, main.py:126-137).

A checkpoint is a directory named ``epoch_{NNN:03}`` or ``final``, as the
JAX package names its own, holding two files:

- ``model.pt``: the model's ``state_dict`` as the reference saves it, a bare
  dict of CPU tensors under the reference's keys, which the reference and
  the JAX package's ``load_torch_checkpoint`` read as it is;
- ``train_state.pt``: the optimizer's ``state_dict`` (Adam's moments and
  step counts) and the epoch number (None for ``final``, as in the JAX
  package).

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

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def save_checkpoint(directory: str, model, optimizer,
                    epoch_number: Optional[int] = None,
                    is_final: bool = False) -> str:
    """Write ``directory/epoch_{NNN}`` (or ``directory/final``); returns its
    path."""
    name = "final" if is_final else f"epoch_{epoch_number:03}"
    path = os.path.abspath(os.path.join(directory, name))
    os.makedirs(path, exist_ok=True)
    print(f"Saving model to:\n\t{path}")
    weights = {k: v.detach().cpu().contiguous()
               for k, v in model.state_dict().items()}
    torch.save(weights, os.path.join(path, MODEL_FILE))
    torch.save({"optimizer": optimizer.state_dict(), "epoch": epoch_number},
               os.path.join(path, TRAIN_STATE_FILE))
    return path


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """``(state_dict, train_state)`` of a checkpoint directory, on the
    CPU."""
    def load(name):
        return torch.load(os.path.join(path, name), map_location="cpu",
                          weights_only=True)

    return load(MODEL_FILE), load(TRAIN_STATE_FILE)


def _strip_ddp(state_dict: dict) -> dict:
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> tuple[dict, Optional[dict]]:
    """A reference ``.pt`` file (weights only, the finetune path) ->
    ``(model state_dict, discriminator state_dict or None)``, with DDP's
    ``module.`` prefix stripped (reference train/utils.py:328-330).  A file
    of the adversarial reference holds ``{"model": ..., "disc": ...}``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in payload and "disc" in payload:
        return _strip_ddp(payload["model"]), _strip_ddp(payload["disc"])
    return _strip_ddp(payload), None
