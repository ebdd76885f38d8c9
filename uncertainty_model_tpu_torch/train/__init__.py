"""The training loop, its evaluation and checkpoints."""

from . import sparsification
from .checkpoint import load_checkpoint, load_torch_checkpoint, save_checkpoint
from .evaluate import eval_step, evaluate_model, save_comparisons
from .metrics import gaussian_ssim
from .trainer import Trainer

__all__ = ["Trainer", "eval_step", "evaluate_model", "gaussian_ssim",
           "load_checkpoint", "load_torch_checkpoint", "save_checkpoint",
           "save_comparisons", "sparsification"]
