#!/usr/bin/env bash
# Evaluate monodetr_torch's checkpoint for a config: bash test_torch.sh configs/monodetr.yaml
# Under NGPU > 1 (torchrun) rank 0 evaluates and the other ranks exit.
# Extra arguments go to tools/train_val_torch.py (e.g. --device cpu);
# checkpoints and txts are read and written relative to the working
# directory.
set -euo pipefail
tool="$(dirname "$0")/tools/train_val_torch.py"
config=$1
shift
if [ "${NGPU:-1}" -gt 1 ]; then
  exec torchrun --standalone --nproc_per_node="$NGPU" "$tool" --config "$config" -e "$@"
fi
exec python "$tool" --config "$config" -e "$@"
