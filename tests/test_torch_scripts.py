"""The port's launch scripts (``scripts/torch_*.sh``) on the CPU.

Each runs under ``bash`` with a stub ``python`` first on ``PATH`` that
records its working directory and argv (and a stub ``nvidia-smi`` that
lists ``STUB_CARDS`` cards).  Each script calls the port's CLI module
(``python -m uncertainty_model_tpu_torch.cli.main`` or
``.cli.parallel_main``) from the repository's root, never ``main.py``,
``parallel_main.py`` or the JAX package; it passes its JAX counterpart's
flags with the same values (the JAX script run under the same stub), but
for the process layout that replaces the JAX package's devices; the
port's own parsers take every recorded command.  The multi-process scripts
start one process per card (two gloo processes on the CPU) with distinct
``--process-id``s, and fail, the other processes stopped, when one fails.
One real run of ``torch_local_test.sh`` (the flagship at 32x64, one epoch)
writes ``results.json`` with the serial CLI's key tree.
"""

import contextlib
import io
import json
import os
import subprocess
import time

import pytest

from test_torch_cli import data_home  # noqa: F401  (a fixture)

from uncertainty_model_tpu_torch.cli.main import build_parser, main
from uncertainty_model_tpu_torch.cli.parallel_main import build_parallel_parser
from uncertainty_model_tpu_torch.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULE = "uncertainty_model_tpu_torch.cli."
# each script: its JAX counterpart and the port's CLI module it runs
SCRIPTS = {
    "torch_local_test.sh": ("local_test.sh", "main"),
    "torch_finetune_test.sh": ("finetune_test.sh", "main"),
    "torch_parallel_test.sh": ("parallel_test.sh", "parallel_main"),
    "torch_demo_train.sh": ("demo_train.sh", "main"),
    "torch_multi_gpu_job.sh": ("tpu_pod_job.sh", "parallel_main"),
}
# the JAX pod job's process layout, which the port's job sets per card
LAYOUT = {"--coordinator-address", "--num-processes", "--process-id"}
POD_ENV = {"COORDINATOR": "host0:8476", "NUM_PROCESSES": "1",
           "PROCESS_ID": "0"}

STUB_PYTHON = r"""#!/bin/bash
printf '%s\0' "$PWD" "$@" > "$STUB_LOG_DIR/call.$$"
id=
while (($#)); do
    [[ $1 == --process-id ]] && id=$2
    shift
done
if [[ -n $STUB_FAIL_ID && $id == "$STUB_FAIL_ID" ]]; then
    sleep "${STUB_FAIL_AFTER:-0}"
    exit 3
fi
[[ -n $STUB_SLEEP ]] && exec sleep "$STUB_SLEEP"
exit 0
"""
STUB_NVIDIA_SMI = r"""#!/bin/bash
for ((i = 0; i < ${STUB_CARDS:-1}; i++)); do
    echo "GPU $i: NVIDIA H100 80GB HBM3 (UUID: GPU-0000000$i)"
done
"""


@pytest.fixture
def stubbed(tmp_path):
    """``run(script, *args, **env)``: ``bash scripts/<script>`` with the
    stubs first on ``PATH``; returns (exit code, [(cwd, argv)], seconds)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, text in (("python", STUB_PYTHON),
                       ("nvidia-smi", STUB_NVIDIA_SMI)):
        (bin_dir / name).write_text(text)
        (bin_dir / name).chmod(0o755)

    def run(script, *args, **env):
        log_dir = tmp_path / f"calls_{len(list(tmp_path.iterdir()))}"
        log_dir.mkdir()
        full = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}",
                "STUB_LOG_DIR": str(log_dir), **env}
        t0 = time.monotonic()
        proc = subprocess.run(["bash", os.path.join(REPO, "scripts", script),
                               *args], cwd=tmp_path, env=full,
                              capture_output=True, text=True, timeout=60)
        seconds = time.monotonic() - t0
        calls = []
        for path in sorted(log_dir.iterdir()):
            cwd, *argv = path.read_bytes().decode().split("\0")[:-1]
            calls.append((cwd, argv))
        return proc.returncode, calls, seconds

    return run


def _flags(argv):
    """(positional arguments, {flag: values}) of a command line."""
    positional, flags, key = [], {}, None
    for token in argv:
        if token.startswith("--"):
            key = token
            flags[key] = ()
        elif key is None:
            positional.append(token)
        else:
            flags[key] += (token,)
    return positional, flags


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_runs_the_port_with_the_jax_flags(stubbed, script):
    jax_script, module = SCRIPTS[script]
    extra = ("--home", "/data/home")
    # the finetune scripts take the checkpoint first
    first = ("runs/model/final",) if "finetune" in script else ()
    code, calls, _ = stubbed(script, *first, *extra, STUB_CARDS="2")
    assert code == 0 and calls
    j_code, j_calls, _ = stubbed(jax_script, *first, *extra, **POD_ENV)
    assert j_code == 0 and len(j_calls) == 1
    j_positional, j_flags = _flags(j_calls[0][1][1:])
    parser = (build_parallel_parser if module == "parallel_main"
              else build_parser)()
    for cwd, argv in calls:
        assert cwd == REPO
        assert argv[:2] == ["-m", PORT_MODULE + module]
        for token in argv:
            assert token not in ("main.py", "parallel_main.py")
            assert not token.startswith("uncertainty_model_tpu.")
            assert token != "uncertainty_model_tpu"
        assert argv[-2:] == list(extra)
        positional, flags = _flags(argv[2:])
        assert positional == j_positional
        for flag, values in j_flags.items():
            if flag not in LAYOUT:
                assert flags.get(flag) == values, flag
        args = parser.parse_args(argv[2:])
        assert args.home == "/data/home"
        if first:
            assert args.finetune_from == first[0]


def _process_ids(calls):
    return sorted(int(_flags(argv)[1]["--process-id"][0])
                  for _, argv in calls)


@pytest.mark.parametrize("env, ids, world, address", [
    ({"STUB_CARDS": "4"}, [0, 1, 2, 3], 4, "localhost:29500"),
    ({"STUB_CARDS": "4", "NUM_HOSTS": "2", "HOST_ID": "1",
      "COORDINATOR": "host0:8476"}, [4, 5, 6, 7], 8, "host0:8476"),
    ({"STUB_CARDS": "1", "LOCAL_CARDS": "3", "GLOBAL_BATCH": "24"},
     [0, 1, 2], 3, "localhost:29500"),
], ids=["one_host", "second_of_two_hosts", "local_cards"])
def test_multi_gpu_job_starts_a_process_per_card(stubbed, env, ids, world,
                                                 address):
    code, calls, _ = stubbed("torch_multi_gpu_job.sh", **env)
    assert code == 0
    assert _process_ids(calls) == ids
    for _, argv in calls:
        flags = _flags(argv)[1]
        assert flags["--num-processes"] == (str(world),)
        assert flags["--coordinator-address"] == (address,)
        assert flags["--batch-size"] == (env.get("GLOBAL_BATCH", "64"),)
        assert flags["--learning-rate"] == ("2e-4",)


def test_parallel_test_starts_two_gloo_processes(stubbed):
    code, calls, _ = stubbed("torch_parallel_test.sh")
    assert code == 0
    assert _process_ids(calls) == [0, 1]
    for _, argv in calls:
        flags = _flags(argv)[1]
        assert flags["--platform"] == ("cpu",)
        assert flags["--num-processes"] == ("2",)


@pytest.mark.parametrize("script, env", [
    ("torch_multi_gpu_job.sh", {"STUB_CARDS": "4", "STUB_FAIL_ID": "2"}),
    ("torch_parallel_test.sh", {"STUB_FAIL_ID": "1"}),
], ids=["multi_gpu_job", "parallel_test"])
def test_a_failed_process_fails_the_script(stubbed, script, env):
    """The other processes would wait for the failed one: they are stopped
    (here they sleep 30 s) and the script fails at once.  The failing one
    fails 2 s in, once every process has started and recorded its call."""
    code, calls, seconds = stubbed(script, STUB_SLEEP="30",
                                   STUB_FAIL_AFTER="2", **env)
    assert code != 0
    assert len(calls) == (4 if "STUB_CARDS" in env else 2)
    assert seconds < 15


@pytest.mark.parametrize("env", [{"STUB_CARDS": "0"},
                                 {"NUM_HOSTS": "2", "HOST_ID": "1"}],
                         ids=["no_card", "hosts_without_coordinator"])
def test_multi_gpu_job_refuses(stubbed, env):
    code, calls, _ = stubbed("torch_multi_gpu_job.sh", **env)
    assert code != 0 and not calls


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()}
    return None


def test_local_test_trains_on_the_cpu(data_home, tmp_path):  # noqa: F811
    """``torch_local_test.sh`` for real (the flagship at 32x64, one epoch
    on ``data_home``'s 8 + 4 pairs): exit 0, one run folder, and a
    ``results.json`` whose key tree is the serial CLI's (run here on the
    tiny config with the same flags) and whose config is the flagship's."""
    def outputs(root):
        return ["--save-model-to", str(root / "trained"),
                "--save-results-to", str(root / "results")]

    flags = ["--home", data_home, "--image-size", "32", "64", "--epochs",
             "1", "--workers", "2"]
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "torch_local_test.sh"), *flags,
         *outputs(tmp_path / "script")], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    results_dir = tmp_path / "script" / "results"
    (run,) = os.listdir(results_dir)
    with open(results_dir / run / "results.json") as f:
        got = json.load(f)

    argv = ["configs/tiny.yml", "da-vinci", "--platform", "cpu",
            "--training-size", "16", "--validation-size", "16",
            "--batch-size", "8", "--save-model-every", "1",
            "--evaluate-every", "1", "--no-pbar", *flags,
            *outputs(tmp_path / "serial")]
    with contextlib.redirect_stdout(io.StringIO()):
        main(build_parser().parse_args(argv))
    results_dir = tmp_path / "serial" / "results"
    (run,) = os.listdir(results_dir)
    with open(results_dir / run / "results.json") as f:
        want = json.load(f)
    assert _key_tree(got["arguments"]) == _key_tree(want["arguments"])
    assert _key_tree(got["losses"]) == _key_tree(want["losses"])
    assert sorted(got) == sorted(want)
    assert got["config"] == load_config(
        os.path.join(REPO, "configs", "uncertainty.yml"))
    assert got["arguments"]["config"] == "configs/uncertainty.yml"
