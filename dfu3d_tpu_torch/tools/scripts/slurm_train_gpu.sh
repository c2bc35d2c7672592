#!/usr/bin/env bash
# Multi-card training under SLURM: one task per card (the counterpart of
# tools/scripts/slurm_train_tpu.sh, which runs one task per TPU host).
# dfu3d_tpu_torch.parallel.init_distributed reads the rank, the world and
# the card from SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID, and meets the
# other tasks at the first node of SLURM_STEP_NODELIST on MASTER_PORT
# (default 12567). --batch_size is the global batch. Run from the
# repository root:
#   sbatch --nodes=N --ntasks-per-node=GPUS --gpus-per-node=GPUS \
#       dfu3d_tpu_torch/tools/scripts/slurm_train_gpu.sh CFG_FILE [tools.train flags]
set -e
CFG=$1
shift
srun python -m dfu3d_tpu_torch.tools.train --cfg_file "$CFG" "$@"
