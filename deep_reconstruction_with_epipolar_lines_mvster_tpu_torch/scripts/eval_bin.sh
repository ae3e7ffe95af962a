#!/usr/bin/env bash
# Bin-picking rig eval recipe of the PyTorch port on the card, the flags of
# the JAX package's scripts/eval_bin.sh (BDS8-trained weights on real
# captures):
#   bash deep_reconstruction_with_epipolar_lines_mvster_tpu_torch/scripts/eval_bin.sh <ckpt> <outdir> [extra args]
set -euo pipefail

DATAPATH=${DATAPATH:-data/Bin_picking/Bin_2048x3072_merlin_calib/scene}
TESTLIST=${TESTLIST:-lists/Bin/eval_scene2.txt}
PAIRFILE=${PAIRFILE:-eval_pair_4x4.txt}

CHKPT=$1
OUTDIR=$2
PY_ARGS=${@:3}

python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.test \
  --dataset=dataloader_eval \
  --dataset_name=bin \
  --datapath "$DATAPATH" \
  --testlist "$TESTLIST" \
  --pair_fname "$PAIRFILE" \
  --loadckpt "$CHKPT" \
  --outdir "$OUTDIR" \
  --interval_scale=1.34 \
  --max_h 512 --max_w 640 \
  --mono --group_cor --attn_temp 2 --inverse_depth \
  --run_gendepth --NviewGen 4 --depthgen_thres 0.5 \
  --run_filter --NviewFilter 4 --photomask 0.5 --geomask 2 \
  --condmask_pixel 1 --condmask_depth 0.01 \
  $PY_ARGS
