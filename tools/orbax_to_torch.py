#!/usr/bin/env python3
"""Convert a JAX (orbax) training checkpoint into a checkpoint directory of
the PyTorch port, which the port resumes exactly.

Usage:
    python tools/orbax_to_torch.py <orbax_dir> <config.yml> <out_dir>
        [--image-size H W]

``orbax_dir`` is a checkpoint the JAX package wrote (``epoch_NNN`` or
``final``).  The tool reads it with the JAX package's
``train/checkpoint.py::load_checkpoint``, converts the weights, BatchNorm
statistics, Adam moments and step count and the epoch (a discriminator's
too, where the checkpoint holds one) with the port's
``convert.py::from_jax_train_state``, and writes them as the port's
``train/checkpoint.py::save_checkpoint`` does (``write_checkpoint``) into
``<out_dir>/epoch_NNN`` or ``<out_dir>/final``, the name the JAX package
gave the source.  Resume it with the port's CLI:

    python -m uncertainty_model_tpu_torch.cli.main <config.yml> <dataset> \\
        --resume-from <out_dir>/epoch_NNN [--adversarial] ...

``--image-size`` is the size the run trained at (the CLI's default,
256 512): it fixes the discriminator's final map, whose rows the head
reorders; a size that does not match the head's kernel is refused.

Run it where JAX and orbax are installed, on the CPU: the conversion is
file work, and the port itself needs neither.  It edits nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("orbax_dir", help="a JAX (orbax) checkpoint directory")
    parser.add_argument("config", help="the config .yml the run trained")
    parser.add_argument("out_dir", help="where to write the port's checkpoint")
    parser.add_argument("--image-size", default=(256, 512), nargs=2, type=int,
                        help="the training image size (H W)")
    return parser


def main(argv=None) -> str:
    """Convert ``argv``'s checkpoint; returns the written directory."""
    args = build_parser().parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from uncertainty_model_tpu.train.checkpoint import load_checkpoint
    from uncertainty_model_tpu_torch.config import load_config
    from uncertainty_model_tpu_torch.convert import from_jax_train_state
    from uncertainty_model_tpu_torch.train.checkpoint import write_checkpoint

    restored = load_checkpoint(args.orbax_dir)
    config = load_config(args.config)
    adversarial = "disc_params" in restored
    if adversarial and "discriminator" not in config:
        raise ValueError(f"{args.orbax_dir} holds a discriminator, but "
                         f"{args.config} has no discriminator section")
    converted = from_jax_train_state(
        restored, config["model"],
        config["discriminator"] if adversarial else None,
        image_hw=tuple(args.image_size))
    epoch = converted[1]["epoch"]
    name = "final" if epoch is None else f"epoch_{epoch:03}"
    return write_checkpoint(os.path.join(args.out_dir, name), *converted)


if __name__ == "__main__":
    main()
