"""One process per device: ``spawn`` runs a function in ``world`` fresh
processes (``torch.multiprocessing``'s ``spawn`` start method), rank r on
``local_device(r, platform)`` (``cuda:r``, or the CPU for ``platform=
"cpu"``), joined in one process group that meets on a free port of
localhost, and returns what each rank returned, in rank order.

The JAX package runs a multi-device program in one process over a mesh;
here every rank is a process (``mesh.py``), so an entry point that drives
n devices (``entry.dryrun_multichip``) starts n of them.  A rank that
raises fails the call, and the ranks still running are stopped: they
would wait in their next collective for the rank that left.  Every wait
has a timeout.

``fn`` must be importable by name (a module-level function): the
processes start from a fresh interpreter and unpickle it and its keyword
arguments.  Its result comes back pickled by value (``pickle``, not
``torch.multiprocessing``'s sharing of a tensor's memory, which needs the
rank's process alive until the parent has read it).
"""

from __future__ import annotations

import pickle
import queue
import socket
import time
import traceback

import torch.multiprocessing as mp

from .mesh import destroy, init_distributed, local_device

TIMEOUT_S = 900.0
GRACE_S = 5.0


def free_address() -> str:
    """``localhost:<a port free now>``."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def _worker(fn, rank, world, platform, address, results, kwargs):
    try:
        device = local_device(rank, platform)
        init_distributed(address, world, rank, device)
        try:
            value = fn(rank, world, device, **kwargs)
        finally:
            destroy()
        out = ("ok", pickle.dumps(value))
    except Exception:  # reported to the parent, which raises it
        out = ("error", traceback.format_exc())
    results.put((rank, *out))


def _gather(procs, results, timeout: float) -> dict:
    """Each rank's result by rank.  Raises ``RuntimeError`` where a rank
    failed (with what every rank reported within ``GRACE_S`` of the first
    failure: a rank that raises first may make the others fail in their
    collectives), ended without a result or is late."""
    world, got, errors = len(procs), {}, []
    deadline = time.monotonic() + timeout
    while len(got) + len(errors) < world:
        try:
            rank, status, value = results.get(timeout=1.0)
        except queue.Empty:
            # a rank cannot end before the parent has read the result it
            # put (its queue's feeder thread is joined at exit)
            reported = set(got) | {r for r, _ in errors}
            dead = [r for r, p in enumerate(procs)
                    if r not in reported and p.exitcode is not None]
            if dead and results.empty():
                errors += [(r, f"ended without a result (exit code "
                               f"{procs[r].exitcode})") for r in dead]
            elif time.monotonic() > deadline:
                if errors:
                    break
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} did not answer within {timeout} s") from None
            continue
        if status == "ok":
            got[rank] = pickle.loads(value)
        else:
            errors.append((rank, f"failed:\n{value}"))
        if errors:
            deadline = min(deadline, time.monotonic() + GRACE_S)
    if errors:
        raise RuntimeError("\n".join(f"rank {r} of {world} {what}"
                                     for r, what in sorted(errors)))
    return got


def spawn(fn, world: int, platform=None, *, timeout: float = TIMEOUT_S,
          **kwargs) -> list:
    """``fn(rank, world, device, **kwargs)`` in ``world`` processes, each
    in the process group of all of them (NCCL between CUDA devices, gloo
    on the CPU); returns each rank's result in rank order.  Raises ``RuntimeError`` with the rank's
    traceback if a rank raised, ended without a result, or has not
    answered within ``timeout`` seconds; no process outlives the call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = free_address()
    procs = [ctx.Process(target=_worker, args=(fn, rank, world, platform,
                                               address, results, kwargs))
             for rank in range(world)]
    for p in procs:
        p.start()
    ok = False
    try:
        got = _gather(procs, results, timeout)
        ok = True
    finally:
        for p in procs:
            p.join(timeout=30 if ok else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[rank] for rank in range(world)]
