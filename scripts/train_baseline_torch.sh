#!/usr/bin/env bash
# Stage 3 — frozen-backbone baseline fine-tune through the PyTorch port.
# Equivalent of train_run_baseline.sh (1xH100, 12 h): one process per card
# under torchrun, NPROC of them (default 1); mesh.fsdp=-1 spans them.
set -euo pipefail
SUBJECT=${1:?usage: train_baseline_torch.sh <sub-XX> [extra overrides...]}
shift || true
export SCRATCH_PATH=${SCRATCH_PATH:-/data/lazyload}
export TRANSFORMERS_OFFLINE=1

torchrun --standalone --nproc_per_node="${NPROC:-1}" -m phantom_vlb_tpu_torch.cli.train \
  experiment=vlb_friends_baseline "subject=$SUBJECT" \
  "model.checkpoint_path=${CKPT:-/data/models/VideoLLaMA2-7B}" "$@"
