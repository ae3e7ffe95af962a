"""Eval / reconstruction CLI of the PyTorch port, flag-compatible with the
JAX package's ``cli/test.py`` (and the reference ``test_mvs4.py:27-124``):
``--run_gendepth`` generates the per-view depth, confidence, camera and
image artifacts; ``--run_filter`` runs the geometric-consistency filter and
fuses each scene into a PLY.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.test \\
        --dataset=dataloader_eval --dataset_name=dtu --datapath DTU/dtu_eval \\
        --testlist lists/dtu/test.txt --loadckpt model.ckpt --outdir out \\
        --interval_scale=1.0625 --run_gendepth --run_filter ...

Everything runs on ``--device`` (default: the card; ``--device cpu`` runs
the plain PyTorch versions of the kernels), set up by
``config.setup_device`` (TF32 off, so that the float32 default computes
in float32). The TPU layout flags
(``--warp_impl``, ``--warp_band``, ``--warp_tile_rows``, ``--warp_xband``,
``--warp_tile_cols``, ``--pack_conv``, ``--fused_topdown``,
``--kernel_coords``, ``--fuse_attn``, ``--d_pack_mids``) are accepted and
ignored, as ``config.py`` documents. Not ported yet: ``--space`` > 1 (the
row-sharded eval) and the numeric debug dumps of ``--debug_model``,
``--debug_depth_gen``, ``--vis_ETA`` and ``--vis_stg_features``; each
raises when asked for.
"""

from __future__ import annotations

import argparse
import os

from .train import make_model_config

_IGNORED = "a TPU layout flag, accepted and ignored by the port"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict depth, filter, and fuse")
    p.add_argument("--model", default="mvsnet", help="parity; unused")
    p.add_argument("--dataset", default="dataloader_eval")
    p.add_argument("--dataset_name", default="blender",
                   choices=["dtu", "blender", "bin"])
    p.add_argument("--datapath")
    p.add_argument("--data_resolution", type=str, default="_512x640")
    p.add_argument("--testlist")
    p.add_argument("--loadckpt", default=None)
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--pair_fname", default="pair.txt")
    p.add_argument("--lighting", type=int, default=3)

    p.add_argument("--ndepths", type=str, default="8,8,4,4")
    p.add_argument("--depth_inter_r", type=str, default="0.5,0.5,0.5,1")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--interval_scale", type=float, required=True)
    p.add_argument("--max_h", type=int, default=512)
    p.add_argument("--max_w", type=int, default=640)
    p.add_argument("--fix_res", action="store_true")
    p.add_argument("--num_worker", type=int, default=1)
    p.add_argument("--eval_shape_bucket", type=str, default="max",
                   help="'max' pads every sample to (max_h, max_w), an int N "
                        "rounds shapes up to N-multiples, 'none'/0 keeps each "
                        "sample's shape")
    p.add_argument("--save_freq", type=int, default=20)
    p.add_argument("--filter_method", type=str, default="normal",
                   choices=["gipuma", "normal"])
    p.add_argument("--save_ply", action="store_true")

    p.add_argument("--run_gendepth", action="store_true")
    p.add_argument("--NviewGen", type=int, default=5)
    p.add_argument("--depthgen_thres", type=float, default=0.8)

    p.add_argument("--run_filter", action="store_true")
    p.add_argument("--NviewFilter", type=int, default=10)
    p.add_argument("--photomask", type=float, default=0.8)
    p.add_argument("--geomask", type=int, default=3)
    p.add_argument("--condmask_pixel", type=float, default=1.0)
    p.add_argument("--condmask_depth", type=float, default=0.01)

    p.add_argument("--share_cr", action="store_true")
    p.add_argument("--fpn_base_channel", type=int, default=8)
    p.add_argument("--reg_channel", type=int, default=8)
    p.add_argument("--reg_mode", type=str, default="reg2d")
    p.add_argument("--dlossw", type=str, default="1,1,1,1")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--group_cor", action="store_true")
    p.add_argument("--group_cor_dim", type=str, default="8,8,4,4")
    p.add_argument("--inverse_depth", action="store_true")
    p.add_argument("--agg_type", type=str, default="ConvBnReLU3D")
    p.add_argument("--dcn", action="store_true")
    p.add_argument("--arch_mode", type=str, default="fpn")
    p.add_argument("--ot_continous", action="store_true")
    p.add_argument("--ot_eps", type=float, default=1)
    p.add_argument("--ot_iter", type=int, default=0)
    p.add_argument("--rt", action="store_true")
    p.add_argument("--use_raw_train", action="store_true")
    p.add_argument("--mono", action="store_true")
    p.add_argument("--mono_stg_itrpl", type=str, default="nearest",
                   choices=["nearest", "bilinear"])
    p.add_argument("--pos_enc", type=int, default=0)
    p.add_argument("--split", type=str, default="intermediate")
    p.add_argument("--save_jpg", action="store_true")
    p.add_argument("--ASFF", action="store_true")
    p.add_argument("--vis_ETA", action="store_true")
    p.add_argument("--vis_stg_features", type=int, default=0)
    p.add_argument("--attn_temp", type=float, default=2)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 eval compute (default float32, as the reference)")
    p.add_argument("--warp_impl", type=str, default=None,
                   choices=["mxu", "mxu_pallas", "mxu_hybrid", "mxu_v3", "gather"],
                   help=_IGNORED + ": the port's warps are "
                        "exact gathers, so the JAX package's banded-warp "
                        "coverage warning does not apply")
    p.add_argument("--warp_band", type=str, default="16", help=_IGNORED)
    p.add_argument("--warp_tile_rows", type=int, default=8, help=_IGNORED)
    p.add_argument("--warp_xband", type=int, default=192, help=_IGNORED)
    p.add_argument("--warp_tile_cols", type=int, default=128, help=_IGNORED)
    p.add_argument("--pack_conv", action=argparse.BooleanOptionalAction, default=None,
                   help=_IGNORED)
    p.add_argument("--fused_topdown", action=argparse.BooleanOptionalAction, default=None,
                   help=_IGNORED + ": the port runs the top-down level in "
                        "its kernel K2 on the card")
    p.add_argument("--kernel_coords", action=argparse.BooleanOptionalAction, default=True,
                   help=_IGNORED)
    p.add_argument("--fuse_attn", action=argparse.BooleanOptionalAction, default=False,
                   help=_IGNORED + ": the port runs the attention "
                        "accumulation in its kernel K5 on the card either way")
    p.add_argument("--d_pack_mids", action=argparse.BooleanOptionalAction, default=False,
                   help=_IGNORED)
    p.add_argument("--debug_model", type=int, default=0)
    p.add_argument("--debug_depth_gen", type=int, default=0)
    p.add_argument("--debug_depth_filter", type=int, default=0)
    p.add_argument("--space", type=int, default=1,
                   help="row-shard the eval over this many devices (not ported "
                        "yet: only 1)")
    p.add_argument("--space_halo", type=int, default=48)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card, 'cpu' runs the kernels' "
                        "plain PyTorch versions")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.batch_size != 1:
        raise ValueError("eval expects batch_size 1 (test_mvs4.py:947)")
    if args.space > 1:
        raise NotImplementedError(
            "--space > 1 (row-sharded eval) is not ported yet (ROADMAP Queue 1 item 13)")
    if args.debug_model or args.debug_depth_gen or args.vis_ETA or args.vis_stg_features:
        raise NotImplementedError(
            "the numeric debug dumps are not ported yet (ROADMAP Queue 1 item 14)")

    from ..config import setup_device
    from ..data import find_dataset_def
    from ..data.io import read_scan_list
    from ..train.checkpoint import load_weights

    device = setup_device(args.device)
    testlist = read_scan_list(args.testlist) if args.testlist else [""]

    if args.run_gendepth:
        import torch

        from ..eval.depthgen import device_peak_memory_gb, generate_depth_maps
        from ..models import MVS4Net

        model = MVS4Net(make_model_config(args, mode="eval"), device=device)
        if args.loadckpt:
            print(f"=> loading model {args.loadckpt}")
            load_weights(model, args.loadckpt)
        bucket = args.eval_shape_bucket
        if bucket in ("none", "0", ""):
            bucket = 0
        elif bucket != "max":
            bucket = int(bucket)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        DS = find_dataset_def(args.dataset)
        total_time, total_views, shapes = 0.0, 0, set()
        for scene in testlist:
            ds = DS(
                datapath=args.datapath, resolution=args.data_resolution,
                listfile=[scene], mode="test", nviews=args.NviewGen,
                interval_scale=args.interval_scale, max_h=args.max_h,
                max_w=args.max_w, pair_fname=args.pair_fname,
                lighting=args.lighting, dsname=args.dataset_name,
            )
            stats = generate_depth_maps(
                model, ds, args.outdir,
                batch_size=args.batch_size,
                depthgen_thres=args.depthgen_thres,
                save_ply=args.save_ply, save_jpg=args.save_jpg,
                num_workers=args.num_worker,
                shape_bucket=bucket, max_hw=(args.max_h, args.max_w),
            )
            total_time += stats["total_time_s"]
            total_views += int(stats["views"])
            shapes.update(map(tuple, stats["shapes"]))
        print(f"total time: {total_time}")
        if total_views:
            print(f"avg time: {total_time / total_views}")
        print(f"forward shapes: {len(shapes)}")
        peak = device_peak_memory_gb() if device.type == "cuda" else None
        print(f"max device mem: {peak:.3f} GiB" if peak is not None
              else "max device mem: not measured (no card)")

    if args.run_filter:
        from ..eval import FusionConfig, filter_scene

        if args.run_gendepth and args.NviewFilter > args.NviewGen:
            raise ValueError("--NviewFilter must not exceed --NviewGen")
        cfg = FusionConfig(
            photomask=args.photomask, geomask=args.geomask,
            condmask_pixel=args.condmask_pixel,
            condmask_depth=args.condmask_depth,
        )
        if args.dataset_name == "bin":
            pair_file = os.path.join(args.datapath, "../..", args.pair_fname)
        else:
            pair_file = os.path.join(args.datapath, args.pair_fname)
        for scene in testlist:
            filter_scene(
                os.path.join(args.outdir, scene), pair_file,
                nview_filter=args.NviewFilter, cfg=cfg,
                save_ply=True, debug_bits=args.debug_depth_filter, device=device,
            )


if __name__ == "__main__":
    main()
