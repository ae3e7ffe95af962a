#!/usr/bin/env bash
# DTU eval + reconstruction recipe of the PyTorch port on the card, the
# flags of the JAX package's scripts/eval_dtu.sh:
#   bash deep_reconstruction_with_epipolar_lines_mvster_tpu_torch/scripts/eval_dtu.sh <ckpt> <outdir> [extra args]
# Extra args: --space S row-shards each forward over cards 0..S-1 (raises
# with fewer cards); --debug_model BITS writes debug dumps under <outdir>/debug.
set -euo pipefail

DATAPATH=${DATAPATH:-/data/DTU/dtu_eval}
TESTLIST=${TESTLIST:-lists/dtu/test.txt}

CHKPT=$1
OUTDIR=$2
PY_ARGS=${@:3}

python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.test \
  --dataset=dataloader_eval \
  --dataset_name=dtu \
  --datapath "$DATAPATH" \
  --testlist "$TESTLIST" \
  --loadckpt "$CHKPT" \
  --outdir "$OUTDIR" \
  --interval_scale=1.0625 \
  --max_h 512 --max_w 640 \
  --run_gendepth --NviewGen 4 --depthgen_thres 0.3 \
  --run_filter --NviewFilter 4 --photomask 0.3 --geomask 2 \
  --condmask_pixel 1.0 --condmask_depth 0.01 \
  --group_cor --group_cor_dim="8,8,4,4" \
  --ndepths="8,8,4,4" --depth_inter_r="0.5,0.5,0.5,1" \
  --inverse_depth --attn_temp 2 --save_ply \
  $PY_ARGS
