#!/usr/bin/env bash
# DTU training recipe of the PyTorch port on the card(s), the flags of the
# JAX package's scripts/train_dtu.sh (reference scripts/train_dtu.sh:20-45):
#   NPROC=8 bash deep_reconstruction_with_epipolar_lines_mvster_tpu_torch/scripts/train_dtu.sh <exp_name> [extra args]
# One process a card under torchrun (NPROC cards of this host, default 1).
# --batch_size is the samples of the host's batch, as in the JAX package:
# the NPROC ranks split it (it must divide by NPROC); --dp_impl gspmd
# (default: global-batch BatchNorm and masked means) or shard_map (per-rank,
# the reference's DDP). The TPU layout flags of the JAX recipe
# (--warp_band, --warp_xband, --no_remat) change nothing in the port and
# are left out.
set -euo pipefail

TRAIN_DATASET=${TRAIN_DATASET:-/data/DTU/mvs_training_512x640}
TRAINLIST=${TRAINLIST:-lists/dtu/train.txt}
TESTLIST=${TESTLIST:-lists/dtu/val.txt}
NPROC=${NPROC:-1}

exp=$1
PY_ARGS=${@:2}

LOG_DIR="./outputs/$exp"
mkdir -p "$LOG_DIR"
echo "====== Check log: tail -f ${LOG_DIR}/log_${exp}.txt"

torchrun --standalone --nproc_per_node "$NPROC" \
  -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.train \
  --logdir "$LOG_DIR" \
  --trainpath "$TRAIN_DATASET" \
  --trainlist "$TRAINLIST" \
  --testlist "$TESTLIST" \
  --dataset=dtu_yao4 \
  --train_nviews 5 \
  --interval_scale=1.0625 \
  --epochs=22 \
  --batch_size=6 \
  --l1ce_lw="0.003,1" \
  --wd=0.0001 \
  --lr=0.001 \
  --lrepochs="2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21:1.2" \
  --summary_freq 100 \
  --group_cor \
  --group_cor_dim="8,8,4,4" \
  --ndepths="8,8,4,4" \
  --depth_inter_r="0.5,0.5,0.5,1" \
  --rt \
  --mono \
  --mono_stg_itrpl="nearest" \
  --inverse_depth \
  --attn_temp 2 \
  --seed 0 \
  --bf16 \
  $PY_ARGS 2>&1 | tee "$LOG_DIR/log_${exp}.txt"
