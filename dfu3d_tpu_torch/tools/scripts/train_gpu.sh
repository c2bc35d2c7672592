#!/usr/bin/env bash
# One-card training: one process drives the card (the counterpart of
# tools/scripts/train_tpu.sh). Run from the repository root:
#   dfu3d_tpu_torch/tools/scripts/train_gpu.sh CFG_FILE [tools.train flags]
# On N cards of one host, one process per card:
#   torchrun --nproc_per_node N -m dfu3d_tpu_torch.tools.train --cfg_file CFG_FILE ...
# (under SLURM: tools/scripts/slurm_train_gpu.sh).
set -e
CFG=$1
shift
python -m dfu3d_tpu_torch.tools.train --cfg_file "$CFG" "$@"
