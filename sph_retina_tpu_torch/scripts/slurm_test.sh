#!/usr/bin/env bash
# Data-parallel evaluation of the PyTorch port under SLURM: one task a GPU,
# each on its shard of the test set, the results gathered before scoring
# (see slurm_train.sh for the variables).
#
# Usage: slurm_test.sh PARTITION JOB_NAME CONFIG CHECKPOINT [test.py args...]
#   GPUS=8 GPUS_PER_NODE=8 CPUS_PER_TASK=5 PORT=29500 PYTHON=python3 (env)
set -eu
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
shift 4
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
PORT=${PORT:-29500}
PYTHON=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)

PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" PORT="$PORT" srun \
  -p "$PARTITION" --job-name="$JOB_NAME" \
  --gres=gpu:"$GPUS_PER_NODE" --ntasks="$GPUS" \
  --ntasks-per-node="$GPUS_PER_NODE" --cpus-per-task="$CPUS_PER_TASK" \
  --kill-on-bad-exit=1 \
  bash -c 'MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1) \
MASTER_PORT=$PORT WORLD_SIZE=$SLURM_NTASKS RANK=$SLURM_PROCID \
LOCAL_RANK=$SLURM_LOCALID exec "$@"' _ \
  "$PYTHON" -m sph_retina_tpu_torch.test "$CONFIG" "$CHECKPOINT" \
  --launcher torch "$@"
