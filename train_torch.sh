#!/usr/bin/env bash
# Train monodetr_torch from a config: bash train_torch.sh configs/monodetr.yaml
# NGPU > 1 starts one data-parallel process per card under torchrun
# (`dataset.batch_size` is then the global batch).  Extra arguments go to
# tools/train_val_torch.py (e.g. --device cpu); outputs go under the
# config's save_path, relative to the working directory.
set -euo pipefail
tool="$(dirname "$0")/tools/train_val_torch.py"
config=$1
shift
if [ "${NGPU:-1}" -gt 1 ]; then
  exec torchrun --standalone --nproc_per_node="$NGPU" "$tool" --config "$config" "$@"
fi
exec python "$tool" --config "$config" "$@"
