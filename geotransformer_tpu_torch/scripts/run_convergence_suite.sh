#!/usr/bin/env bash
# Convergence suite (the port's scripts/run_convergence_suite.sh): the
# synthetic 3DMatch-protocol workflow four times, {kernels, plain PyTorch
# modules} x model seeds {7351, 4242}, on fixed synthetic data (data seed 0,
# 10 fragments a test scene at full scale, ~90 test pairs), trained to a
# schedule-compressed plateau: lr 3e-4 x decay^epoch.
#
# Usage: run_convergence_suite.sh <out_dir> [steps] [lr_decay] [scale] [options]
#   steps: 3510 (45 epochs of 78 pairs); lr_decay: 0.90 (the terminal lr of a
#   90-epoch 0.95 schedule); scale: full | small. The arguments from the first
#   one that starts with -- on go to every run (e.g. --num_workers 2, or
#   --precision jax: every run, kernels and plain, trained and tested at the
#   JAX package's precision point).
#   Each run writes <out_dir>/<name>/ and <out_dir>/<name>.log; the
#   starts and exit codes go to <out_dir>/suite.log. Exits 1 if a run failed.
#   JOBS (default 1) runs that many at once: the runs share the card and the
#   host's cores, so a short smoke run may take 4, a timed one should not.
set -u
POSITIONAL=()
while [[ $# -gt 0 && "$1" != --* ]]; do POSITIONAL+=("$1"); shift; done
OUT=${POSITIONAL[0]:?output directory}
STEPS=${POSITIONAL[1]:-3510}
DECAY=${POSITIONAL[2]:-0.90}
SCALE=${POSITIONAL[3]:-full}
PYTHON=${PYTHON:-python}
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
JOBS=${JOBS:-1}
run_one() {
    local name=$1 force=$2 seed=$3
    shift 3
    echo "=== $name start $(date -u +%H:%M:%S) ===" >> "$OUT/suite.log"
    "$PYTHON" -m geotransformer_tpu_torch.scripts.synthetic_benchmark --out "$OUT/$name" \
        --scale "$SCALE" --steps "$STEPS" --seed 0 --test_fragments 10 --lr 3e-4 \
        --lr_decay "$DECAY" --model_seed "$seed" --force_pallas "$force" "$@" \
        > "$OUT/$name.log" 2>&1
    local code=$?
    echo "=== $name exit $code $(date -u +%H:%M:%S) ===" >> "$OUT/suite.log"
    return $code
}
failed=0
pids=()
for run in kernels_s0:true:7351 plain_s0:false:7351 kernels_s1:true:4242 plain_s1:false:4242; do
    IFS=: read -r name force seed <<< "$run"
    if [[ $JOBS -le 1 ]]; then
        run_one "$name" "$force" "$seed" "$@" || failed=1
        continue
    fi
    while [[ ${#pids[@]} -ge $JOBS ]]; do
        wait "${pids[0]}" || failed=1
        pids=("${pids[@]:1}")
    done
    run_one "$name" "$force" "$seed" "$@" &
    pids+=($!)
done
for pid in "${pids[@]}"; do wait "$pid" || failed=1; done
echo "SUITE_DONE $(date -u +%H:%M:%S)" >> "$OUT/suite.log"
exit $failed
