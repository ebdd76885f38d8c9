"""Training CLI (the port of the JAX package's ``cli/main.py``; reference
main.py)::

    python -m uncertainty_model_tpu_torch.cli.main <config.yml> \\
        <da-vinci|scared|cityscapes> [--epochs N] [--batch-size B]
        [--learning-rate LR] [--adversarial]
        [--finetune-from PATH] [--resume-from DIR]
        [--training-size N] [--validation-size N] [--workers W]
        [--save-model-to DIR] [--save-results-to DIR]
        [--save-model-every N] [--evaluate-every N]
        [--no-pbar] [--no-augment] [--home DIR] [--image-size H W]
        [--seed S] [--platform cpu] [--profile-dir DIR]

The JAX CLI's flags and defaults, so ``results.json`` has the same
``arguments`` keys and the same schema.  It runs on CUDA unless
``--platform cpu`` is given, in one process (the loader's
``shard_index=0, num_shards=1``), or in each process of a process group
(``cli/parallel_main.py``): then each loads ``--batch-size // world``
pairs a step from its shard (``shard_index=rank``), trains the global
batch's step through ``Trainer(distributed=True)``, and rank 0's run
folder (its timestamp, broadcast) is every rank's; rank 0 alone makes the
directories and writes ``results.json``, the grids and the checkpoints
(JAX ``cli/main.py:133-145,194-217``).

``--precision float32`` (the default) turns TF32 off for cuDNN and
matmuls.  ``--precision bfloat16`` is the JAX CLI's mixed precision: the
model computes in bf16 (``RandomlyConnectedModel.from_config(dtype=
torch.bfloat16)``), while the parameters, BatchNorm statistics, Adam state
and losses stay f32.  TF32 is off there too, so the f32 products outside
the modules (the losses, Adam) are full f32, and cuBLAS sums bf16 products
in f32 (``allow_bf16_reduced_precision_reduction`` off), as XLA does.  The
JAX CLI also sets ``jax_default_matmul_precision="bfloat16"``, which does
not change an f32 product on the CPU (a 64x256x64 f32 ``jnp.dot`` is the
same with and without it), so on the CPU the two CLIs compute the same
products.

``--adversarial`` trains against the config's ``discriminator`` (a
``RandomDiscriminator`` initialised from ``--seed`` + 1), whose loss
``results.json`` records per epoch; its checkpoints hold the
discriminator and its optimizer, and ``--resume-from`` /
``--finetune-from`` restore it from a checkpoint directory of the port or
a reference ``{"model", "disc"}`` ``.pt`` file.  Without
``--adversarial`` such a file loads the model alone.  ``--adversarial``
runs in f32 only: with ``--precision bfloat16`` it is refused, as the JAX
package's bf16 adversarial step does not run.

Not ported, and refused: ``--data-backend pil`` (the port decodes with its
own PNG decoder).  ``--resume-from`` / ``--finetune-from`` read the port's
checkpoint directories (``train/checkpoint.py``) or reference ``.pt``
files; a JAX (orbax) checkpoint is refused with the command that converts
it, run where JAX is installed::

    python tools/orbax_to_torch.py <orbax_dir> <config.yml> <out_dir> \\
        [--image-size H W]

which writes a directory of the port holding the JAX run's weights, Adam
moments and step count, epoch and discriminator, so that ``--resume-from``
continues that run.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

# files of a JAX (orbax) checkpoint directory
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str,
                        help="The config file path to build the model from.")
    parser.add_argument("dataset", choices=["da-vinci", "scared", "cityscapes"],
                        help="The dataset to use for training.")
    parser.add_argument("--epochs", "-e", default=200, type=int)
    parser.add_argument("--learning-rate", "-lr", default=1e-4, type=float)
    parser.add_argument("--batch-size", "-b", default=8, type=int,
                        help="Batch size.")
    parser.add_argument("--adversarial", action="store_true", default=False,
                        help="Train against the config's discriminator "
                             "(f32 only).")
    parser.add_argument("--finetune-from", default=None, type=str,
                        help="Path to a checkpoint dir of the port or a "
                             "reference .pt file. Reference finetune "
                             "semantics: schedules restart (lr/4, scale=1, "
                             "reference train/utils.py:345-346).")
    parser.add_argument("--resume-from", default=None, type=str,
                        help="Path to a checkpoint dir of the port "
                             "(epoch_NNN). Restores weights + Adam moments "
                             "+ epoch and continues schedules from there — "
                             "identical to an uninterrupted run.")
    parser.add_argument("--training-size", default=None, nargs="?", type=int)
    parser.add_argument("--validation-size", default=None, nargs="?", type=int)
    parser.add_argument("--workers", "-w", default=8, type=int)
    parser.add_argument("--save-model-to", default=None, type=str)
    parser.add_argument("--save-results-to", default=None, type=str)
    parser.add_argument("--save-model-every", default=10, type=int)
    parser.add_argument("--evaluate-every", default=10, type=int)
    parser.add_argument("--no-pbar", action="store_true", default=False)
    parser.add_argument("--no-augment", action="store_true", default=False)
    parser.add_argument("--home", default=os.environ.get("HOME", "."), type=str)
    parser.add_argument("--image-size", default=(256, 512), nargs=2, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--platform", default=None, type=str,
                        help="The torch device: CUDA unless given (cpu for "
                             "smoke tests).")
    parser.add_argument("--precision", default="float32",
                        choices=["float32", "bfloat16"],
                        help="Module compute precision: bfloat16 is mixed "
                             "precision (f32 parameters, Adam and losses).")
    parser.add_argument("--data-backend", default="auto",
                        choices=["auto", "native", "pil"],
                        help="auto and native: the port's PNG decoder "
                             "(data/native.py); pil is refused.")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="Write a torch.profiler trace of epoch 0 here "
                             "(view with TensorBoard or Perfetto).")
    return parser


def _refuse_unported(args: argparse.Namespace) -> None:
    from ..train.trainer import BF16_ADVERSARIAL

    if args.adversarial and args.precision != "float32":
        raise NotImplementedError(
            f"--adversarial --precision {args.precision}: "
            f"{BF16_ADVERSARIAL}")
    if args.resume_from is not None and args.finetune_from is not None:
        raise SystemExit("--resume-from and --finetune-from are exclusive")


def fix_precision(precision: str):
    """The model's compute type for ``precision`` (None: f32).  f32
    convolutions and matmuls are full f32 in both: PyTorch runs cuDNN's
    convolutions in TF32 unless told otherwise, so the switches are set
    here rather than left to the process; bf16 matmuls sum in f32."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "float32":
        return None
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.bfloat16


def _restore(args: argparse.Namespace, trainer) -> int:
    """Load ``--resume-from`` or ``--finetune-from`` into ``trainer``;
    returns the epoch to start from."""
    from ..train.checkpoint import (MODEL_FILE, load_checkpoint,
                                    load_torch_checkpoint)

    path = args.resume_from or args.finetune_from
    if path is None:
        return 0
    if path.endswith(".pt"):
        if args.resume_from is not None:
            raise SystemExit("--resume-from needs a checkpoint directory "
                             "(.pt files carry no optimiser state/epoch)")
        state_dict, disc_state_dict = load_torch_checkpoint(path)
        if not args.adversarial:
            return trainer.load_state(state_dict)
        if disc_state_dict is None:
            raise ValueError(f"{path} holds no discriminator: --adversarial "
                             f"needs a {{'model', 'disc'}} checkpoint")
        return trainer.load_state(state_dict, disc_state_dict=disc_state_dict)
    if not os.path.isfile(os.path.join(path, MODEL_FILE)):
        if os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES):
            raise ValueError(
                f"{path} is a JAX (orbax) checkpoint, which the port cannot "
                f"read: convert it, where JAX is installed, with `python "
                f"tools/orbax_to_torch.py {path} {args.config} <out_dir> "
                f"--image-size {args.image_size[0]} {args.image_size[1]}`, "
                f"and give the directory it writes")
        raise FileNotFoundError(f"{path}: no {MODEL_FILE}, not a checkpoint "
                                f"directory of the port")
    state_dict, train_state, *disc = load_checkpoint(
        path, adversarial=args.adversarial)
    if args.resume_from is None:  # finetune: the weights alone
        train_state = None
    return trainer.load_state(state_dict, train_state, *disc)


def main(args: argparse.Namespace) -> None:
    from ..config import load_config
    from ..data import (
        CityScapesDataset,
        DaVinciDataset,
        DataLoader,
        SCAREDDataset,
        default_augment_transform,
        default_eval_transform,
    )
    from .. import parallel
    from ..device import resolve_device
    from ..models import RandomDiscriminator, RandomlyConnectedModel
    from ..train import Trainer

    _refuse_unported(args)
    distributed = parallel.is_distributed()
    rank, world = parallel.rank(), parallel.world_size()
    device = (parallel.local_device(rank, args.platform) if distributed
              else resolve_device(args.platform))
    dtype = fix_precision(args.precision)

    print("Arguments passed:")
    for key, value in vars(args).items():
        print(f"\t- {key}: {value}")

    dataset_path = os.path.join(args.home, "datasets", args.dataset)
    dataset_class = {
        "da-vinci": DaVinciDataset,
        "scared": SCAREDDataset,
        "cityscapes": CityScapesDataset,
    }[args.dataset]

    config = load_config(args.config)

    size = tuple(args.image_size)
    train_transform = (
        default_eval_transform(size) if args.no_augment
        else default_augment_transform(size)
    )
    eval_split = "test" if args.dataset != "cityscapes" else "val"
    train_dataset = dataset_class(dataset_path, "train", train_transform,
                                  args.training_size)
    val_dataset = dataset_class(dataset_path, eval_split,
                                default_eval_transform(size), args.validation_size)

    print(f"Dataset size:"
          f"\n\tTrain: {len(train_dataset):,} images."
          f"\n\tTest: {len(val_dataset):,} images.")

    # each process loads its shard's 1/world of every global batch
    per_process_batch = args.batch_size // world
    train_loader = DataLoader(train_dataset, per_process_batch, shuffle=True,
                              seed=args.seed, num_workers=args.workers,
                              drop_last=True, backend=args.data_backend,
                              shard_index=rank, num_shards=world)
    # evaluation keeps the last partial batch
    val_loader = DataLoader(val_dataset, per_process_batch, shuffle=False,
                            num_workers=args.workers, drop_last=False,
                            backend=args.data_backend,
                            shard_index=rank, num_shards=world)

    model = RandomlyConnectedModel.from_config(**config["model"], dtype=dtype,
                                               seed=args.seed, device=device)
    disc = (RandomDiscriminator.from_config(**config["discriminator"],
                                            dtype=dtype,
                                            init_seed=args.seed + 1,
                                            device=device)
            if args.adversarial else None)
    trainer = Trainer(model, config["loss"], disc=disc, device=device,
                      distributed=distributed)
    start_epoch = _restore(args, trainer)

    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"Model has {n_params:,} learnable parameters."
          f"\n\tPlatform: {device.type}")
    if disc is not None:
        n_disc = sum(p.numel() for p in trainer.disc.parameters())
        print(f"Discriminator has {n_disc:,} learnable parameters.")

    date = datetime.now().strftime("%Y%m%d%H%M%S")
    folder = f"model_{date}"
    if distributed:  # every rank writes into rank 0's folder
        folder = parallel.broadcast_str(folder)
    model_directory = (os.path.join(args.save_model_to, folder)
                       if args.save_model_to else None)
    results_directory = (os.path.join(args.save_results_to, folder)
                         if args.save_results_to else None)
    if rank == 0:
        for d in (model_directory, results_directory):
            if d:
                os.makedirs(d, exist_ok=True)

    training_losses, validation_metrics = trainer.train_model(
        train_loader, args.epochs, args.learning_rate,
        val_loader=val_loader,
        evaluate_every=args.evaluate_every,
        save_evaluation_to=results_directory,
        save_every=args.save_model_every,
        save_model_to=model_directory,
        finetune=(args.finetune_from is not None),
        no_pbar=args.no_pbar,
        profile_dir=args.profile_dir,
        start_epoch=start_epoch,
    )

    if results_directory is not None and rank == 0:
        _write_results(results_directory, args, config,
                       training_losses, validation_metrics)


def _write_results(results_directory, args, config, training_losses,
                   validation_metrics) -> None:
    """results.json with the reference's schema (reference main.py:165-205),
    as the JAX package's ``_write_results`` writes it."""
    losses_filepath = os.path.join(results_directory, "results.json")

    disp, unc, disc = (zip(*training_losses) if training_losses
                       else ((), (), ()))
    results_dict = {
        "arguments": vars(args),
        "config": config,
        "losses": {
            "training": {
                "disparity": list(disp),
                "uncertainty": list(unc),
                "discriminator": list(disc) if args.adversarial else None,
            }
        },
    }

    if validation_metrics:
        ssims, spars = zip(*validation_metrics)
        left_ssim, right_ssim = zip(*ssims)
        ause, aurg = zip(*spars)
        results_dict["losses"]["validation"] = {
            "ssim": {"left": list(left_ssim), "right": list(right_ssim)},
            "sparsification": {"ause": list(ause), "aurg": list(aurg)},
        }

    print(f"Saving args and losses to:\n\t{losses_filepath}")
    with open(losses_filepath, "w") as f:
        json.dump(results_dict, f, indent=4)


if __name__ == "__main__":
    main(build_parser().parse_args())
