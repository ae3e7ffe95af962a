#!/usr/bin/env bash
# Blender BDS8 eval + reconstruction recipe of the PyTorch port on the
# card, the flags of the JAX package's scripts/eval_bds8.sh:
#   bash deep_reconstruction_with_epipolar_lines_mvster_tpu_torch/scripts/eval_bds8.sh <ckpt> <outdir> [extra args]
set -euo pipefail

DATAPATH=${DATAPATH:-data/Blender/BDS8_mvs_train_512x640}
TESTLIST=${TESTLIST:-lists/BDS8/eval_scene191.txt}
PAIRFILE=${PAIRFILE:-eval_pair_4x4_30-34-46-47.txt}

CHKPT=$1
OUTDIR=$2
PY_ARGS=${@:3}

python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.test \
  --dataset=dataloader_eval \
  --dataset_name=blender \
  --datapath "$DATAPATH" \
  --testlist "$TESTLIST" \
  --pair_fname "$PAIRFILE" \
  --loadckpt "$CHKPT" \
  --outdir "$OUTDIR" \
  --interval_scale=1.34 \
  --max_h 512 --max_w 640 \
  --mono --group_cor --attn_temp 2 --inverse_depth \
  --run_gendepth --NviewGen 4 --depthgen_thres 0.75 \
  --run_filter --NviewFilter 4 --photomask 0.75 --geomask 2 \
  --condmask_pixel 1 --condmask_depth 0.01 \
  $PY_ARGS
