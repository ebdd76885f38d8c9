"""The training loop, its evaluation and checkpoints."""

from .checkpoint import load_checkpoint, load_torch_checkpoint, save_checkpoint
from .evaluate import eval_step, evaluate_model
from .trainer import Trainer

__all__ = ["Trainer", "eval_step", "evaluate_model", "load_checkpoint",
           "load_torch_checkpoint", "save_checkpoint"]
