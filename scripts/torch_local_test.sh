#!/bin/bash
# Serial smoke test of the PyTorch port on the CPU (the port's local_test.sh):
# full train+eval path, 16-sample subsets, 2 epochs.
#
#   bash scripts/torch_local_test.sh [--home DIR] [other flags]
set -e
cd "$(dirname "$0")/.."

python -m uncertainty_model_tpu_torch.cli.main configs/uncertainty.yml da-vinci \
    --platform cpu \
    --epochs 2 \
    --training-size 16 \
    --validation-size 16 \
    --batch-size 8 \
    --save-model-every 1 \
    --evaluate-every 1 \
    --save-model-to trained \
    --save-results-to results \
    --no-pbar \
    "$@"
