#!/usr/bin/env bash
# Multi-subject multi-season orchestration through the PyTorch port
# (BASELINE.md config #5): train every subject in turn (each run on NPROC
# cards under torchrun, default 1), then project accuracy brain maps. The
# per-subject data covers all configured seasons (the experiment yaml's
# datamodule.seasons list).
set -euo pipefail
EXPERIMENT=${EXPERIMENT:-vlb_friends_lora}
SUBJECTS=${SUBJECTS:-"sub-01 sub-02 sub-03 sub-05"}   # CNeuroMod Friends cohort
ATLAS_DIR=${ATLAS_DIR:-/data/atlas}
RESULTS=${RESULTS:-./results}

for SUBJECT in $SUBJECTS; do
  echo "=== $SUBJECT ==="
  torchrun --standalone --nproc_per_node="${NPROC:-1}" -m phantom_vlb_tpu_torch.cli.train \
    "experiment=$EXPERIMENT" "subject=$SUBJECT" "$@"

  METRICS_DIR=$(ls -d "$RESULTS"/videollama2/brain_finetune/friends/tpu_ckpt/*/"$SUBJECT"/*/version_* 2>/dev/null | tail -1 || true)
  if [ -n "$METRICS_DIR" ]; then
    python -m phantom_vlb_tpu_torch.cli.brainmaps \
      --metrics_path "$METRICS_DIR" \
      --atlas_path "$ATLAS_DIR/${SUBJECT}_task-friends_space-MNI152NLin2009cAsym_atlas-Schaefer18_desc-1000Parcels7Networks_dseg.nii.gz" \
      --out_path "$RESULTS/brainmaps/$SUBJECT"
  fi
done
