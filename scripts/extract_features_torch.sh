#!/usr/bin/env bash
# Stage 1 — feature extraction through the PyTorch port, one Friends season
# per invocation. Equivalent of the reference's SLURM script
# (src/preprocessing/vllama2_vlb_extract_features.sh: 1xV100, 32 CPU, 12 h).
set -euo pipefail
SEASON=${1:?usage: extract_features_torch.sh <season> (e.g. s1)}
DATA=${DATA:-/data/friends}
MODELS=${MODELS:-/data/models/VideoLLaMA2-7B}
OUT=${OUT:-/data/features}

export TRANSFORMERS_OFFLINE=1
python -m phantom_vlb_tpu_torch.cli.extract \
  --input_transcript_path "$DATA/transcripts/$SEASON" \
  --input_seg_path "$DATA/segments/$SEASON" \
  --input_video_path "$DATA/videos/$SEASON" \
  --lazy_load_path "$OUT/friends_${SEASON}_features.h5" \
  --model_path "$MODELS"
