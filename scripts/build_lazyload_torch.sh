#!/usr/bin/env bash
# Stage 2 — lazy-load dataset build through the PyTorch port, per subject x
# season (CPU only). Equivalent of src/preprocessing/vllama2_vlb_lazyloading.sh
# (32 CPU, 1 h).
set -euo pipefail
SUBJECT=${1:?usage: build_lazyload_torch.sh <sub-XX> <season>}
SEASON=${2:?usage: build_lazyload_torch.sh <sub-XX> <season>}
FEATURES=${FEATURES:-/data/features}
BOLD=${BOLD:-/data/bold}
SCRATCH_PATH=${SCRATCH_PATH:-/data/lazyload}

python -m phantom_vlb_tpu_torch.cli.build_lazyload \
  --features_path "$FEATURES/friends_${SEASON}_features.h5" \
  --timeseries_path "$BOLD/${SUBJECT}_timeseries.h5" \
  --lazyload_path "$SCRATCH_PATH" \
  --subject "$SUBJECT" --season "$SEASON"
