#!/usr/bin/env bash
# Epoch-sweep evaluation: scripts.test, then scripts.eval, for each saved
# epoch of a training run (the port's scripts/eval_all.sh; the reference's
# experiments/.../eval_all.sh:1-4).
#
# Usage: eval_all.sh <dataset> <data_root> <checkpoint_root> [benchmark] \
#            [first_epoch] [last_epoch] [scripts.test options]
#   checkpoint_root: the trainer's <output_dir>/checkpoints, one <epoch>/state.pt
#   a saved epoch; an epoch without one is skipped. Defaults: 3DMatch, 20, 40.
#   The arguments from the first one that starts with -- on go to
#   scripts.test; its --device goes to scripts.eval too. PYTHON names the
#   interpreter (default: python). Features go to output/<dataset>/epoch-<n>.
set -euo pipefail
POSITIONAL=()
while [[ $# -gt 0 && "$1" != --* ]]; do POSITIONAL+=("$1"); shift; done
DATASET=${POSITIONAL[0]:?dataset (3dmatch|kitti|modelnet)}
DATA_ROOT=${POSITIONAL[1]:?data root}
CKPT_ROOT=${POSITIONAL[2]:?checkpoint root}
BENCHMARK=${POSITIONAL[3]:-3DMatch}
FIRST=${POSITIONAL[4]:-20}
LAST=${POSITIONAL[5]:-40}
PYTHON=${PYTHON:-python}
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

DEVICE=cuda
ARGS=("$@")
for ((i = 0; i + 1 < ${#ARGS[@]}; i++)); do
    if [[ "${ARGS[i]}" == --device ]]; then DEVICE=${ARGS[i + 1]}; fi
done

for n in $(seq "$FIRST" "$LAST"); do
    if [[ ! -f "$CKPT_ROOT/$n/state.pt" ]]; then
        echo "skip epoch $n (no checkpoint)"
        continue
    fi
    echo "=== epoch $n ==="
    "$PYTHON" -m geotransformer_tpu_torch.scripts.test --dataset "$DATASET" \
        --data_root "$DATA_ROOT" --benchmark "$BENCHMARK" --checkpoint_dir "$CKPT_ROOT" \
        --test_epoch "$n" --output_dir "output/$DATASET/epoch-$n" "$@"
    "$PYTHON" -m geotransformer_tpu_torch.scripts.eval --dataset "$DATASET" \
        --feature_dir "output/$DATASET/epoch-$n/features/$BENCHMARK" --benchmark "$BENCHMARK" \
        --benchmark_root "$DATA_ROOT/metadata/benchmarks/$BENCHMARK" --method lgr \
        --device "$DEVICE"
done
