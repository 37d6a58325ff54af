#!/usr/bin/env bash
# Sweep driver (reference: scripts/run.sh): run every SpMV schedule over
# every .mtx in a dataset directory, appending per-kernel CSV logs.
# Usage: scripts/run.sh <dataset_dir> <out_dir> [timeout_s]
set -u
DATASETS=${1:-datasets}
OUT=${2:-sweep_logs}
TIMEOUT=${3:-60}
mkdir -p "$OUT"
for mtx in "$DATASETS"/*.mtx; do
  [ -e "$mtx" ] || continue
  for sched in row_mapped group_mapped work_oriented merge_path; do
    timeout "$TIMEOUT" python examples/spmv.py -m "$mtx" \
      --schedule "$sched" 2>/dev/null | head -1 >> "$OUT/$sched.csv" \
      || echo "TIMEOUT,$(basename "$mtx")" >> "$OUT/$sched.csv"
  done
done
