#!/bin/bash
# Full production training recipe of the PyTorch port on one NVIDIA card
# (the port's demo_train.sh): batch 8, 120 epochs, lr 1e-4 at 256x512.
#
#   bash scripts/torch_demo_train.sh [--home DIR] [other flags]
set -e
cd "$(dirname "$0")/.."

python -m uncertainty_model_tpu_torch.cli.main configs/uncertainty.yml da-vinci \
    --epochs 120 \
    --batch-size 8 \
    --learning-rate 1e-4 \
    --save-model-every 10 \
    --evaluate-every 10 \
    --save-model-to trained \
    --save-results-to results \
    "$@"
