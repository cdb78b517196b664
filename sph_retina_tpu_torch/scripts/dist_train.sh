#!/usr/bin/env bash
# Data-parallel training of the PyTorch port, NPROC processes on this host.
#
# torchrun (python -m torch.distributed.run) starts each process as
# `python -m sph_retina_tpu_torch.train CONFIG --launcher torch ...` and sets
# MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, which
# parallel/distributed.py reads: NCCL with rank r on cuda:r, or gloo with
# --device cpu. The package is taken from the checkout this script lies in.
#
# Usage: dist_train.sh CONFIG NPROC [train.py args...]
#   PORT=29500 (env) picks the rendezvous port, PYTHON=python3 the interpreter.
set -eu
CONFIG=$1
NPROC=$2
shift 2
PORT=${PORT:-29500}
PYTHON=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)

PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" exec "$PYTHON" \
  -m torch.distributed.run --nnodes=1 --nproc_per_node="$NPROC" \
  --master_addr=127.0.0.1 --master_port="$PORT" \
  -m sph_retina_tpu_torch.train "$CONFIG" --launcher torch "$@"
