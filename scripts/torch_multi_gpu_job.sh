#!/bin/bash
# Data-parallel training of the PyTorch port over the NVIDIA cards of this
# host (the port's tpu_pod_job.sh): one process per card, NCCL, each on
# cuda:{process id % cards}.  Any process that fails fails the job.
#
#   bash scripts/torch_multi_gpu_job.sh [other flags]
#
# LOCAL_CARDS: the processes started here (default: the cards that
#   `nvidia-smi -L` lists).
# GLOBAL_BATCH: the batch over all processes (default 64).
# COORDINATOR: host:port where process 0 listens (default localhost:29500).
# For several hosts, run it once on each with COORDINATOR=<host 0>:<port>
# NUM_HOSTS=<hosts> HOST_ID=<this host, 0 ...>: process ids are
# HOST_ID x LOCAL_CARDS + i.  Cards on more than one host have not been
# measured: the port has run on one host only (up to four cards).
set -e
cd "$(dirname "$0")/.."
. scripts/torch_ranks.sh

LOCAL_CARDS="${LOCAL_CARDS:-$(nvidia-smi -L | grep -c '^GPU' || true)}"
NUM_HOSTS="${NUM_HOSTS:-1}"
HOST_ID="${HOST_ID:-0}"
if ((LOCAL_CARDS < 1)); then
    echo "torch_multi_gpu_job.sh: no NVIDIA card found" >&2
    exit 1
fi
if ((NUM_HOSTS > 1)); then
    : "${COORDINATOR:?set COORDINATOR=host:port when NUM_HOSTS > 1}"
fi

run_ranks "$LOCAL_CARDS" $((HOST_ID * LOCAL_CARDS)) -- \
    python -m uncertainty_model_tpu_torch.cli.parallel_main \
    configs/uncertainty.yml da-vinci \
    --epochs 120 \
    --batch-size "${GLOBAL_BATCH:-64}" \
    --learning-rate 2e-4 \
    --coordinator-address "${COORDINATOR:-localhost:29500}" \
    --num-processes $((NUM_HOSTS * LOCAL_CARDS)) \
    --process-id @PROCESS_ID@ \
    --save-model-every 10 \
    --evaluate-every 10 \
    --save-model-to trained \
    --save-results-to results \
    "$@"
