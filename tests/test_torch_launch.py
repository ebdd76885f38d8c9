"""``parallel.spawn`` (``uncertainty_model_tpu_torch/parallel/launch.py``)
on 2 CPU processes (gloo): results in rank order from ranks that share a
process group; a rank that raises, ends without a result or is late fails
the call, naming it, within the timeout, and no process outlives the
call; keyword arguments reach every rank.  The jobs below run in the
spawned processes."""

import os
import time

import pytest
import torch

from uncertainty_model_tpu_torch import parallel

WORLD = 2
# a failing call must end well before this: the ranks still running are
# stopped, not waited for
FAIL_FAST_S = 60


def sum_of_ranks_job(rank, world, device):
    t = torch.tensor([float(rank)])
    return {"rank": rank, "world": world, "device": str(device),
            "group_rank": parallel.rank(),
            "sum": parallel.all_reduce_sum(t).item()}


def raise_on_rank_1_job(rank, world, device):
    if rank == 1:
        raise ValueError("planted on rank 1")
    parallel.all_reduce_sum(torch.zeros(1))  # waits for rank 1 forever
    return rank


def exit_on_rank_1_job(rank, world, device):
    if rank == 1:
        os._exit(3)
    return rank


def sleep_job(rank, world, device):
    time.sleep(30)
    return rank


def echo_job(rank, world, device, payload):
    return {"rank": rank, "payload": payload,
            "world_size": parallel.world_size()}


def test_results_in_rank_order():
    got = parallel.spawn(sum_of_ranks_job, WORLD, "cpu")
    assert [r["rank"] for r in got] == [r["group_rank"] for r in got] == [0, 1]
    assert all(r["world"] == WORLD and r["device"] == "cpu"
               and r["sum"] == 1.0 for r in got)


@pytest.mark.parametrize("job,message", [
    (raise_on_rank_1_job, "(?s)rank 1 of 2 failed.*planted on rank 1"),
    (exit_on_rank_1_job, r"rank 1 of 2 ended without a result"),
])
def test_a_failed_rank_fails_the_call(job, message):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=message) as err:
        parallel.spawn(job, WORLD, "cpu", timeout=FAIL_FAST_S)
    assert time.monotonic() - t0 < FAIL_FAST_S
    if job is raise_on_rank_1_job:
        assert "Traceback" in str(err.value)


def test_a_late_rank_fails_the_call():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not answer within 3"):
        parallel.spawn(sleep_job, WORLD, "cpu", timeout=3)
    assert time.monotonic() - t0 < 25


def test_keyword_arguments_reach_every_rank():
    payload = {"rows": [1, 2, 3], "name": "x"}
    got = parallel.spawn(echo_job, WORLD, "cpu", payload=payload)
    assert got == [{"rank": r, "payload": payload, "world_size": WORLD}
                   for r in range(WORLD)]
