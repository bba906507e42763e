#!/usr/bin/env bash
# Stage 3 — LoRA fine-tune through the PyTorch port. Equivalent of
# train_run_lora.sh: one process per card under torchrun, NPROC of them
# (default 1).
set -euo pipefail
SUBJECT=${1:?usage: train_lora_torch.sh <sub-XX> [extra overrides...]}
shift || true
export SCRATCH_PATH=${SCRATCH_PATH:-/data/lazyload}
export TRANSFORMERS_OFFLINE=1

torchrun --standalone --nproc_per_node="${NPROC:-1}" -m phantom_vlb_tpu_torch.cli.train \
  experiment=vlb_friends_lora "subject=$SUBJECT" \
  "model.checkpoint_path=${CKPT:-/data/models/VideoLLaMA2-7B}" "$@"
