#!/bin/bash
# Data-parallel smoke test of the PyTorch port, the adversarial branch
# included (the port's parallel_test.sh): two processes on the CPU joined by
# gloo, in place of the JAX test's 8 virtual devices.  Both start at once;
# the test fails if either does.
#
#   bash scripts/torch_parallel_test.sh [--home DIR] [other flags]
#
# COORDINATOR (default localhost:29512) is where process 0 listens.
set -e
cd "$(dirname "$0")/.."
. scripts/torch_ranks.sh

run_ranks 2 0 -- \
    python -m uncertainty_model_tpu_torch.cli.parallel_main \
    configs/uncertainty.yml da-vinci \
    --platform cpu \
    --coordinator-address "${COORDINATOR:-localhost:29512}" \
    --num-processes 2 \
    --process-id @PROCESS_ID@ \
    --epochs 2 \
    --training-size 16 \
    --validation-size 16 \
    --batch-size 8 \
    --adversarial \
    --save-model-every 1 \
    --evaluate-every 1 \
    --save-model-to trained \
    --save-results-to results \
    --no-pbar \
    "$@"
