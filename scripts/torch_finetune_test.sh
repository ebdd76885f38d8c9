#!/bin/bash
# Finetune/restore smoke test of the PyTorch port on the CPU (the port's
# finetune_test.sh): restores a checkpoint (a run directory of the port,
# such as <run>/final, or a reference .pt) and trains 2 epochs.
#
#   bash scripts/torch_finetune_test.sh [CHECKPOINT] [other flags]
set -e
cd "$(dirname "$0")/.."

CHECKPOINT="${1:-trained/davinci/l1/final}"
shift || true

python -m uncertainty_model_tpu_torch.cli.main configs/uncertainty.yml da-vinci \
    --platform cpu \
    --epochs 2 \
    --training-size 16 \
    --validation-size 16 \
    --batch-size 8 \
    --finetune-from "$CHECKPOINT" \
    --evaluate-every 1 \
    --no-pbar \
    "$@"
