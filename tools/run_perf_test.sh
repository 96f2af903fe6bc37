#!/usr/bin/env bash
# Multi-process throughput harness — the test/performance_tests/
# run_perf_test.sh analog: run N processes x T threads of the qztest
# mode-4 loop and sum the per-process Gbps lines with awk
# (reference run_perf_test.sh:53-125).
#
# Usage: tools/run_perf_test.sh [-p processes] [-t threads] [-l loops]
#        [-b block_sz] [-D comp|decomp|both] [-s]   (-s = software only)
#
# Without -s every process drives the device engine on a GPU of its own
# (CUDA_VISIBLE_DEVICES): a JAX process reserves most of a card's memory,
# so two processes cannot share one. More processes than GPUs is refused.

set -u
cd "$(dirname "$0")/.."

PROCS=4
THREADS=4
LOOPS=20
BLOCK=65536
DIRECTION=both
FORCE_SW=""

while getopts "p:t:l:b:D:s" opt; do
  case $opt in
    p) PROCS=$OPTARG ;;
    t) THREADS=$OPTARG ;;
    l) LOOPS=$OPTARG ;;
    b) BLOCK=$OPTARG ;;
    D) DIRECTION=$OPTARG ;;
    s) FORCE_SW=1 ;;
    *) echo "usage: $0 [-p N] [-t N] [-l N] [-b N] [-D comp|decomp|both] [-s]"; exit 2 ;;
  esac
done

if [ -z "$FORCE_SW" ]; then
  NGPU=$(nvidia-smi -L 2>/dev/null | grep -c '^GPU ')
  if [ "$PROCS" -gt "$NGPU" ]; then
    echo "[perf] $PROCS device processes need one GPU each; found $NGPU (use -s for software)" >&2
    exit 2
  fi
fi

TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT

echo "[perf] $PROCS procs x $THREADS threads, loops=$LOOPS block=$BLOCK dir=$DIRECTION sw=${FORCE_SW:-0}"

pids=()
for p in $(seq 1 "$PROCS"); do
  if [ -z "$FORCE_SW" ]; then
    export CUDA_VISIBLE_DEVICES=$((p - 1))
  fi
  QZTPU_FORCE_SW=${FORCE_SW:-0} python tools/qztest.py \
      -m 4 -t "$THREADS" -l "$LOOPS" -b "$BLOCK" -D "$DIRECTION" -v \
      > "$TMP/proc$p.log" 2>/dev/null &
  pids+=($!)
done

rc=0
for pid in "${pids[@]}"; do
  wait "$pid" || rc=1
done

cat "$TMP"/proc*.log | grep '\[INFO\]'
# sum per-thread Gbps across all processes (awk, like the reference)
total=$(cat "$TMP"/proc*.log | grep '\[INFO\]' \
        | awk -F', ' '{for(i=1;i<=NF;i++) if ($i ~ / Gbps/) {sub(/ Gbps/,"",$i); s+=$i}} END {printf "%.3f", s}')
echo "[perf] TOTAL: ${total:-0} Gbps across $PROCS processes"
exit $rc
