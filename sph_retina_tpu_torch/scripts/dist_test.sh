#!/usr/bin/env bash
# Data-parallel evaluation of the PyTorch port, NPROC processes on this host.
#
# torchrun starts each process as `python -m sph_retina_tpu_torch.test CONFIG
# CHECKPOINT --launcher torch ...`: each reads its shard of the test set and
# the results are gathered to every process before scoring (see
# dist_train.sh for the variables and devices).
#
# Usage: dist_test.sh CONFIG CHECKPOINT NPROC [test.py args...]
#   PORT=29500 (env) picks the rendezvous port, PYTHON=python3 the interpreter.
set -eu
CONFIG=$1
CHECKPOINT=$2
NPROC=$3
shift 3
PORT=${PORT:-29500}
PYTHON=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)

PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" exec "$PYTHON" \
  -m torch.distributed.run --nnodes=1 --nproc_per_node="$NPROC" \
  --master_addr=127.0.0.1 --master_port="$PORT" \
  -m sph_retina_tpu_torch.test "$CONFIG" "$CHECKPOINT" --launcher torch "$@"
