#!/usr/bin/env bash
# Stage 4 — accuracy brain maps through the PyTorch port. Equivalent of
# src/postprocessing/make_bmaps.sh.
set -euo pipefail
SUBJECT=${1:?usage: make_brainmaps_torch.sh <sub-XX> <metrics_dir>}
METRICS=${2:?usage: make_brainmaps_torch.sh <sub-XX> <metrics_dir>}
ATLAS=${ATLAS:-/data/atlas/${SUBJECT}_task-friends_space-MNI152NLin2009cAsym_atlas-Schaefer18_desc-1000Parcels7Networks_dseg.nii.gz}
OUT=${OUT:-/data/brainmaps}

python -m phantom_vlb_tpu_torch.cli.brainmaps \
  --metrics_path "$METRICS" --atlas_path "$ATLAS" \
  --out_path "$OUT/$SUBJECT"
