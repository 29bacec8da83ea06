#!/bin/bash
# The tabular run of record on one CUDA card through the PyTorch port
# (tpu2048_torch): the protocol of scripts/r5_tabular_rerun.sh, 200k games
# at batch 1024 on a 2**25-slot packed Q-table with the shaped reward, 256
# steps a chunk, seed 0; then greedy eval of the saved table over 2048 games
# on the default env, and scripts/qtable_audit.py's counts of the table. The
# ~1 GiB table is written to a temporary directory and deleted; the
# metrics, the eval summary, the audit and the programs' output go to DIR
# (default docs/tabular_200k_torch).
#
#   scripts/torch_tabular_rerun.sh [DIR]
set -u
cd "$(dirname "$0")/.."
d=${1:-docs/tabular_200k_torch}
mkdir -p "$d"
rm -f "$d/metrics.jsonl"  # the logger appends
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
{
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
} > "$d/stdout.log" 2>&1
start=$(date +%s)
timeout 3000 python -m tpu2048_torch train tabular \
  --episodes 200000 --batch 1024 --capacity-log2 25 --reward shaped \
  --steps-per-chunk 256 --seed 0 \
  --save "$tmp/qtable.npz" --log "$d/metrics.jsonl" \
  >> "$d/stdout.log" 2>&1
rc=$?
echo "train tabular: rc=$rc, $(( $(date +%s) - start )) s" >> "$d/stdout.log"
if [ "$rc" -eq 0 ]; then
  start=$(date +%s)
  timeout 1200 python -m tpu2048_torch eval --policy tabular \
    --table "$tmp/qtable.npz" --games 2048 --eval-batch 2048 \
    > "$d/eval_greedy.json" 2>> "$d/stdout.log"
  rc=$?
  echo "eval --policy tabular: rc=$rc, $(( $(date +%s) - start )) s" \
    >> "$d/stdout.log"
fi
if [ "$rc" -eq 0 ]; then
  audit=$PWD/scripts/qtable_audit.py
  (cd "$tmp" && python "$audit" qtable.npz) > "$d/audit.json" \
    2>> "$d/stdout.log"
  rc=$?
fi
echo "torch tabular rerun rc=$rc"
exit "$rc"
