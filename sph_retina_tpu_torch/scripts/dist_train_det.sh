#!/usr/bin/env bash
# Seeded data-parallel training: dist_train.sh with --seed 42.
#
# One seed drives the weights' initialisation, the train step's generator
# (seed + rank), the epoch's shuffle (shared by the ranks, so that the
# shards partition it) and the augmentation stream. cuDNN keeps its default
# algorithm choice, so two runs on the card may differ in rounding.
#
# Usage: dist_train_det.sh CONFIG NPROC [train.py args...]
set -eu
CONFIG=$1
NPROC=$2
shift 2
exec "$(dirname "$0")/dist_train.sh" "$CONFIG" "$NPROC" --seed 42 "$@"
