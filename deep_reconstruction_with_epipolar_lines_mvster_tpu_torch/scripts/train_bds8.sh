#!/usr/bin/env bash
# BDS8 synthetic-bin fine-tune recipe of the PyTorch port on the card(s),
# the flags of the JAX package's scripts/train_bds8.sh (reference
# scripts/train_BDS8.sh:33-66); warm-starts from a prior checkpoint:
#   NPROC=8 bash deep_reconstruction_with_epipolar_lines_mvster_tpu_torch/scripts/train_bds8.sh <exp_name> <warmstart_ckpt> [extra args]
# One process a card under torchrun; --batch_size is the host's batch, split
# over its NPROC ranks (see train_dtu.sh).
set -euo pipefail

TRAIN_DATASET=${TRAIN_DATASET:-/data/BDS8}
TRAINLIST=${TRAINLIST:-lists/BDS8/train.txt}
TESTLIST=${TESTLIST:-lists/BDS8/test.txt}
PAIRFILE=${PAIRFILE:-pair_49x10.txt}
NPROC=${NPROC:-1}

exp=$1
CHKPT=$2
PY_ARGS=${@:3}

LOG_DIR="./outputs/$exp"
mkdir -p "$LOG_DIR"

torchrun --standalone --nproc_per_node "$NPROC" \
  -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.train \
  --logdir "$LOG_DIR" \
  --trainpath "$TRAIN_DATASET" \
  --trainlist "$TRAINLIST" \
  --testlist "$TESTLIST" \
  --pair_fname "$PAIRFILE" \
  --dataset=blender4 \
  --train_nviews 5 \
  --Nlights="3:7" \
  --interval_scale=1.34 \
  --ndepths="8,8,4,4" \
  --depth_inter_r="0.5,0.5,0.5,1" \
  --epochs=32 \
  --lr=0.00001 \
  --wd=0.001 \
  --l1ce_lw="0.003,1" \
  --lrepochs="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,22:1.2" \
  --batch_size=6 \
  --summary_freq 100 \
  --group_cor \
  --group_cor_dim="8,8,4,4" \
  --rt \
  --mono \
  --inverse_depth \
  --attn_temp 2 \
  --loadckpt "$CHKPT" \
  --bf16 \
  $PY_ARGS 2>&1 | tee "$LOG_DIR/log_${exp}.txt"
