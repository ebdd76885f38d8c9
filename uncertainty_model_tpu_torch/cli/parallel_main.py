"""Data-parallel training CLI (the port of the JAX package's
``cli/parallel_main.py``; reference parallel_main.py)::

    python -m uncertainty_model_tpu_torch.cli.parallel_main <config.yml> \\
        <dataset> [the serial CLI's flags] \\
        --coordinator-address HOST:PORT --num-processes N --process-id I \\
        [--init-seed S] [--debug-distributed] [--platform cpu]

Start it once per process, one process per GPU (``cuda:{I % the card
count}``, NCCL), or with ``--platform cpu`` per CPU process (gloo).  The
processes meet at ``tcp://HOST:PORT`` (process 0 listens there; with
``--num-processes 1`` and no address, a free port of localhost), then run
the serial CLI (``cli/main.py``) as one data-parallel job: each process
loads ``--batch-size // N`` pairs a step from its shard, the step is the
global batch's (``Trainer(distributed=True)``: DDP's averaged gradients,
BatchNorm statistics over every process's rows), and process 0 alone
writes.

``--init-seed`` is the seed of the weights, the shuffle and the
augmentation, the same in every process (it replaces ``--seed``).
``--debug-distributed`` sets ``TORCH_DISTRIBUTED_DEBUG=DETAIL`` and the
``torch.distributed`` loggers to DEBUG, as the JAX flag turns on its
rendezvous, compile and collective logs.  Process 0 lists the live Python
processes where ``psutil`` is installed.  All processes pass a final
barrier, so that none leaves while process 0 still writes.
"""

from __future__ import annotations

import argparse

from ..parallel.launch import free_address
from .main import build_parser, main as serial_main


def build_parallel_parser() -> argparse.ArgumentParser:
    parser = build_parser()
    parser.add_argument("--coordinator-address", default=None, type=str,
                        help="host:port of process 0 (needed with more "
                             "than one process).")
    parser.add_argument("--num-processes", default=1, type=int)
    parser.add_argument("--process-id", default=0, type=int)
    parser.add_argument("--init-seed", default=0, type=int)
    parser.add_argument("--debug-distributed", action="store_true",
                        help="verbose process-group diagnostics: "
                             "TORCH_DISTRIBUTED_DEBUG=DETAIL and the "
                             "torch.distributed loggers (reference "
                             "parallel_main.py:80-81,275-277).")
    return parser


def main(args: argparse.Namespace) -> None:
    from .. import parallel

    if args.debug_distributed:
        parallel.debug_logging()
    address = args.coordinator_address
    if address is None:
        if args.num_processes > 1:
            raise SystemExit("--coordinator-address is needed with "
                             f"{args.num_processes} processes")
        address = free_address()
    device = parallel.local_device(args.process_id, args.platform)
    parallel.init_distributed(address, args.num_processes, args.process_id,
                              device)
    try:
        if args.process_id == 0:
            _print_live_processes()
        args.seed = args.init_seed
        serial_main(args)
        # all ranks leave together, after rank 0's writes
        parallel.barrier()
    finally:
        parallel.destroy()


def _print_live_processes() -> None:
    """Rank 0's list of the live Python processes (reference
    parallel_main.py:96-104), where ``psutil`` is installed."""
    try:
        from datetime import datetime

        import psutil
    except ImportError:
        return

    print("Live Python Processes:")
    for p in psutil.process_iter():
        try:
            if "python" not in p.name():
                continue
            created = datetime.fromtimestamp(p.create_time()) \
                .strftime("%d-%m-%Y %H:%M:%S")
            print(f"\t- {p.name()} ({p.pid}) created {created}.")
        except (psutil.NoSuchProcess, psutil.AccessDenied):
            continue


if __name__ == "__main__":
    main(build_parallel_parser().parse_args())
