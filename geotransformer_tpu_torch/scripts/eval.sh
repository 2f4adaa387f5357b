#!/usr/bin/env bash
# Benchmark inference, then the offline evaluation (the port's scripts/eval.sh;
# the reference's experiments/.../eval.sh:1-7).
#
# Usage: eval.sh <dataset> <data_root> [benchmark] [snapshot] [scripts.test options]
#   dataset: 3dmatch | kitti | modelnet; benchmark: 3DMatch (default) | 3DLoMatch;
#   snapshot: a reference state_dict (.pth.tar) for --torch_snapshot.
#   The arguments from the first one that starts with -- on go to
#   scripts.test (e.g. --checkpoint_dir DIR, --device cpu); its --device goes
#   to scripts.eval too. PYTHON names the interpreter (default: python).
# The features go to output/<dataset>/features/<benchmark> under the working
# directory; the 3DMatch protocol files are read from
# <data_root>/metadata/benchmarks/<benchmark>.
set -euo pipefail
POSITIONAL=()
while [[ $# -gt 0 && "$1" != --* ]]; do POSITIONAL+=("$1"); shift; done
DATASET=${POSITIONAL[0]:?dataset (3dmatch|kitti|modelnet)}
DATA_ROOT=${POSITIONAL[1]:?data root}
BENCHMARK=${POSITIONAL[2]:-3DMatch}
SNAPSHOT=${POSITIONAL[3]:-}
PYTHON=${PYTHON:-python}
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

DEVICE=cuda
ARGS=("$@")
for ((i = 0; i + 1 < ${#ARGS[@]}; i++)); do
    if [[ "${ARGS[i]}" == --device ]]; then DEVICE=${ARGS[i + 1]}; fi
done
EXTRA=()
if [[ -n "$SNAPSHOT" ]]; then EXTRA+=(--torch_snapshot "$SNAPSHOT"); fi

"$PYTHON" -m geotransformer_tpu_torch.scripts.test --dataset "$DATASET" \
    --data_root "$DATA_ROOT" --benchmark "$BENCHMARK" ${EXTRA[@]+"${EXTRA[@]}"} "$@"
"$PYTHON" -m geotransformer_tpu_torch.scripts.eval --dataset "$DATASET" \
    --feature_dir "output/$DATASET/features/$BENCHMARK" --benchmark "$BENCHMARK" \
    --benchmark_root "$DATA_ROOT/metadata/benchmarks/$BENCHMARK" --device "$DEVICE"
