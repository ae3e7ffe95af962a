"""Training CLI of the PyTorch port, flag-compatible with the JAX package's
``cli/train.py`` (and the reference ``train_mvs4.py:18-100``):

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.train \\
        --dataset=dtu_yao4 --trainpath DTU/mvs_training --trainlist lists/dtu/train.txt \\
        --testlist lists/dtu/val.txt --logdir out --batch_size 6 --bf16 --mono ...

``--mode train`` runs ``train/loop.fit`` (checkpoints, ``--resume``,
``metrics.jsonl``), ``--mode test`` one validation sweep, ``--mode profile``
a timing of the train step and a ``torch.profiler`` trace in the logdir.
``--dataset synthetic --trainpath synthetic://HxW/N`` trains on analytic
plane scenes, with no data files.

Everything runs on ``--device`` (default: the card; ``--device cpu`` runs
the plain PyTorch versions of the kernels), set up by
``config.setup_device``. Weights are drawn from ``--seed``.

On N cards, one process a card under ``torchrun``:

    torchrun --nproc_per_node N -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.train ...

``parallel.init_distributed`` joins the process group (``nccl``; ``gloo``
with ``--device cpu``) and each rank runs on ``cuda:LOCAL_RANK``.
``--batch_size`` is, as in the JAX package, the samples of a host's batch:
the host's ranks split it in contiguous equal shares (a batch size that
they do not divide raises). ``--dp_impl`` chooses the data-parallel form
(``parallel/mesh.py``): ``gspmd`` (default) trains on the global batch
(BatchNorm statistics and masked means over every rank's samples),
``shard_map`` keeps them per rank and averages the BatchNorm running
statistics after each step. ``--debug_model BITS`` writes the numeric
debug dumps of one train-mode forward of the first sample under
``<logdir>/debug/`` (``utils/debug.py``).

The TPU layout flags (``--warp_impl``, ``--warp_band``, ``--warp_bwd``,
``--warp_tile_rows``, ``--warp_xband``, ``--warp_tile_cols``,
``--pack_conv``, ``--fused_topdown``, ``--kernel_coords``, ``--fuse_attn``,
``--d_pack_mids``, ``--no_remat``) are accepted and ignored, as
``config.py`` documents; ``--local_rank`` and ``--pin_m`` are accepted for
the reference's sake (torchrun passes the rank in the environment).
"""

from __future__ import annotations

import argparse

_IGNORED = "a TPU layout flag, accepted and ignored by the port"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MVSTER training (PyTorch port)")
    p.add_argument("--mode", default="train", choices=["train", "test", "profile"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card, 'cpu' runs the kernels' "
                        "plain PyTorch versions")

    p.add_argument("--dataset", default="dtu_yao4")
    p.add_argument("--trainpath")
    p.add_argument("--testpath")
    p.add_argument("--trainlist")
    p.add_argument("--testlist")
    p.add_argument("--pair_fname", default="pair.txt")
    p.add_argument("--train_nviews", type=int, default=5)
    p.add_argument("--test_nviews", type=int, default=5)
    p.add_argument("--Nlights", type=str, default="1:1")

    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lrepochs", type=str, default="6,8,9:2")
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--interval_scale", type=float, default=1.06)

    p.add_argument("--loadckpt", default=None)
    p.add_argument("--logdir", default="./outputs/debug")
    p.add_argument("--resume", action="store_true")

    p.add_argument("--summary_freq", type=int, default=50)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--pin_m", action="store_true", help="parity; unused")
    p.add_argument("--dataloader_workers", type=int, default=4)
    p.add_argument("--local_rank", type=int, default=0, help="parity; unused")

    p.add_argument("--ndepths", type=str, default="8,8,4,4")
    p.add_argument("--depth_inter_r", type=str, default="0.5,0.5,0.5,1")
    p.add_argument("--dlossw", type=str, default="1,1,1,1")
    p.add_argument("--l1ce_lw", type=str, default="0,1")
    p.add_argument("--fpn_base_channel", type=int, default=8)
    p.add_argument("--reg_channel", type=int, default=8)
    p.add_argument("--reg_mode", type=str, default="reg2d")
    p.add_argument("--group_cor", action="store_true")
    p.add_argument("--group_cor_dim", type=str, default="8,8,4,4")
    p.add_argument("--inverse_depth", action="store_true")
    p.add_argument("--agg_type", type=str, default="ConvBnReLU3D")
    p.add_argument("--dcn", action="store_true")
    p.add_argument("--pos_enc", type=int, default=0)
    p.add_argument("--arch_mode", type=str, default="fpn")
    p.add_argument("--ot_continous", action="store_true")
    p.add_argument("--ot_iter", type=int, default=10)
    p.add_argument("--ot_eps", type=float, default=1)
    p.add_argument("--rt", action="store_true")
    p.add_argument("--max_h", type=int, default=864)
    p.add_argument("--max_w", type=int, default=1152)
    p.add_argument("--use_raw_train", action="store_true")
    p.add_argument("--mono", action="store_true")
    p.add_argument("--mono_stg_itrpl", type=str, default="nearest",
                   choices=["nearest", "bilinear"])
    p.add_argument("--lr_scheduler", type=str, default="MS")
    p.add_argument("--ASFF", action="store_true")
    p.add_argument("--attn_temp", type=float, default=2)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype for the conv path")
    p.add_argument("--warp_impl", type=str, default=None,
                   choices=["mxu", "mxu_pallas", "mxu_hybrid", "mxu_v3", "gather"],
                   help=_IGNORED + ": the port's warps are exact gathers")
    p.add_argument("--warp_band", type=str, default="16", help=_IGNORED)
    p.add_argument("--warp_bwd", default="auto",
                   choices=["auto", "v1", "v2", "v3", "v4", "v4_ik"],
                   help=_IGNORED + ": the port's warp backward is its kernel K3")
    p.add_argument("--warp_tile_rows", type=int, default=8, help=_IGNORED)
    p.add_argument("--warp_xband", type=int, default=192, help=_IGNORED)
    p.add_argument("--warp_tile_cols", type=int, default=128, help=_IGNORED)
    p.add_argument("--pack_conv", action=argparse.BooleanOptionalAction, default=None,
                   help=_IGNORED + ": in eval the small-channel 3x3 convs run as "
                        "the port's kernel K6 on the card")
    p.add_argument("--kernel_coords", action=argparse.BooleanOptionalAction, default=True,
                   help=_IGNORED)
    p.add_argument("--fuse_attn", action=argparse.BooleanOptionalAction, default=False,
                   help=_IGNORED)
    p.add_argument("--d_pack_mids", action=argparse.BooleanOptionalAction, default=False,
                   help=_IGNORED)
    p.add_argument("--fused_topdown", action=argparse.BooleanOptionalAction, default=None,
                   help=_IGNORED + ": the port runs the top-down levels in its "
                        "kernel K2 on the card")
    p.add_argument("--debug_model", type=int, default=0,
                   help="bitmask of numeric debug dumps (utils/debug.py) of one "
                        "train-mode forward, under <logdir>/debug")
    p.add_argument("--dp_impl", type=str, default="gspmd", choices=["gspmd", "shard_map"],
                   help="data-parallel form on more than one rank: gspmd (global-batch "
                        "BatchNorm and masked means) or shard_map (per-rank, the "
                        "reference's DDP; running statistics averaged each step)")
    p.add_argument("--no_remat", action="store_true",
                   help=_IGNORED + ": the port keeps every activation")
    return p


def make_model_config(args, mode: str = "train"):
    """The port's ``ModelConfig`` from the flags, field for field as the
    JAX package's ``cli/train.make_model_config(args, mode)``; the layout
    fields, which the port ignores, take the flags' values or the JAX
    package's CPU defaults. Per-stage lists must have one entry per stage."""
    from ..config import ModelConfig, parse_float_list, parse_int_list

    band = parse_int_list(args.warp_band)
    cfg = ModelConfig(
        arch_mode=args.arch_mode,
        reg_mode=args.reg_mode,
        fpn_base_channel=args.fpn_base_channel,
        reg_channel=args.reg_channel,
        ndepths=parse_int_list(args.ndepths),
        depth_inter_r=parse_float_list(args.depth_inter_r),
        group_cor=args.group_cor,
        group_cor_dim=parse_int_list(args.group_cor_dim),
        inverse_depth=args.inverse_depth,
        agg_type=args.agg_type,
        dcn=args.dcn,
        pos_enc=args.pos_enc,
        mono=args.mono,
        mono_stg_itrpl=args.mono_stg_itrpl,
        asff=args.ASFF,
        attn_temp=args.attn_temp,
        dtype="bfloat16" if args.bf16 else "float32",
        remat=not getattr(args, "no_remat", False),
        warp_impl=args.warp_impl or ("mxu_v3" if mode == "eval" else "mxu_hybrid"),
        warp_band=band[0] if len(band) == 1 else band,
        warp_tile_rows=args.warp_tile_rows,
        warp_xband=args.warp_xband,
        warp_tile_cols=args.warp_tile_cols,
        pack_conv=bool(args.pack_conv),
        fused_topdown=bool(args.fused_topdown),
        kernel_coords=args.kernel_coords,
        fuse_attn=args.fuse_attn,
        d_pack_mids=args.d_pack_mids,
    )
    for name in ("ndepths", "depth_inter_r", "group_cor_dim"):
        if len(getattr(cfg, name)) != cfg.num_stages:
            raise ValueError(f"--{name} {getattr(args, name)!r}: one entry per stage "
                             f"({cfg.num_stages}) expected")
    if len(band) not in (1, cfg.num_stages):
        raise ValueError(f"--warp_band {args.warp_band!r}: one value or one per stage")
    return cfg


def make_loss_config(args):
    from ..config import LossConfig, parse_float_list

    l1_lw, ot_lw = parse_float_list(args.l1ce_lw)
    return LossConfig(
        stage_lw=parse_float_list(args.dlossw),
        l1_lw=l1_lw,
        ot_lw=ot_lw,
        ot_iter=args.ot_iter,
        ot_eps=args.ot_eps,
        ot_continuous=args.ot_continous,
        inverse_depth=args.inverse_depth,
        mono=args.mono,
    )


def make_train_config(args):
    from ..config import TrainConfig, parse_lrepochs

    milestones, divisor = parse_lrepochs(args.lrepochs)
    return TrainConfig(
        lr=args.lr, weight_decay=args.wd, epochs=args.epochs,
        batch_size=args.batch_size, lr_scheduler=args.lr_scheduler,
        lr_milestones=milestones, lr_gamma_divisor=divisor, seed=args.seed,
        summary_freq=args.summary_freq, save_freq=args.save_freq,
        eval_freq=args.eval_freq,
    )


def main(argv=None):
    """Run the CLI; returns what the mode produced: the ``TrainStep`` of
    ``fit`` (train), the mean validation scalars (test), or the step
    timings, memory and trace path (profile)."""
    args = build_parser().parse_args(argv)
    if args.resume and (args.mode != "train" or args.loadckpt is not None):
        raise ValueError("--resume needs --mode train and no --loadckpt")
    if args.testpath is None:
        args.testpath = args.trainpath

    import torch
    import torch.distributed as dist

    from ..config import setup_device
    from ..data import DataLoader, find_dataset_def
    from ..data.synthetic import batch_to_torch
    from ..models import MVS4Net
    from ..parallel import init_distributed, is_host0
    from ..train.checkpoint import load_weights

    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    mesh = init_distributed("cpu" if on_cpu else "cuda")
    if mesh.world > 1 and args.mode != "train":
        raise ValueError(f"--mode {args.mode} runs in one process, not {mesh.world}")
    if args.batch_size % mesh.local_world:
        raise ValueError(f"--batch_size {args.batch_size} (samples a host) does not split "
                         f"over the host's {mesh.local_world} ranks")
    device = setup_device(args.device if on_cpu or not dist.is_initialized()
                          else mesh.device("cuda"))
    tcfg = make_train_config(args)
    mcfg = make_model_config(args)
    lcfg = make_loss_config(args)

    DS = find_dataset_def(args.dataset)
    if args.dataset.startswith("blendedmvs"):
        train_ds = DS(args.trainpath, args.trainlist, "train", args.train_nviews,
                      robust_train=args.rt, seed=args.seed)
        val_ds = DS(args.testpath, args.testlist, "val", args.test_nviews,
                    robust_train=False, seed=args.seed)
    else:
        train_ds = DS(args.trainpath, args.trainlist, "train", args.train_nviews,
                      args.interval_scale, rt=args.rt, use_raw_train=args.use_raw_train,
                      pair_fname=args.pair_fname, Nlights=args.Nlights, seed=args.seed)
        val_ds = DS(args.testpath, args.testlist, "val", args.test_nviews,
                    args.interval_scale, pair_fname=args.pair_fname,
                    Nlights=args.Nlights, seed=args.seed)
    hosts = dict(num_hosts=mesh.hosts, host_id=mesh.host)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              num_workers=args.dataloader_workers, seed=args.seed,
                              rank_in_host=mesh.local_rank, ranks_in_host=mesh.local_world,
                              **hosts)
    val_loader = DataLoader(val_ds, args.batch_size, num_workers=args.dataloader_workers,
                            rank_in_host=mesh.local_rank, ranks_in_host=mesh.local_world,
                            **hosts)

    host0 = is_host0()
    model = MVS4Net(mcfg, device=device, generator=torch.Generator().manual_seed(args.seed))
    if args.loadckpt:
        if host0:
            print(f"warm-starting from {args.loadckpt}")
        load_weights(model, args.loadckpt)
    if host0:
        print(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")

    if args.debug_model and host0:
        # the reference's cv2 debug windows (MVS4Net.py:85-191) as .npy
        # dumps of one train-mode forward of the first sample
        from ..data.loader import collate
        from ..utils.debug import debug_dump_forward

        sample = batch_to_torch(collate([train_ds[0]]), device)
        written = debug_dump_forward(
            model, sample["imgs"], sample["proj_matrices"], sample["depth_values"],
            bits=args.debug_model, outdir=args.logdir, train=True, tag="train_sample0")
        print(f"debug_model={args.debug_model}: wrote {len(written)} arrays "
              f"under {args.logdir}/debug")

    if args.mode == "train":
        from ..train.loop import fit

        return fit(model, train_loader, val_loader, tcfg, lcfg, logdir=args.logdir,
                   device=device, resume=args.resume, dp_impl=args.dp_impl)
    if args.mode == "test":
        # the reference's --mode test crashes on an out-of-scope optimizer
        # (train_mvs4.py:271); a working validation sweep, as in JAX, its
        # eval step captured on the card as JAX jits it (JAX cli/train.py:361)
        from ..train.metrics import DictAverageMeter
        from ..train.step import make_eval_step

        eval_step = make_eval_step(model, lcfg)
        meter = DictAverageMeter()
        for i, batch in enumerate(val_loader):
            scalars = {k: float(v) for k, v in eval_step(batch_to_torch(batch, device)).items()}
            meter.update(scalars)
            if i % args.summary_freq == 0:
                print(f"Eval iter {i}/{len(val_loader)} loss={scalars['loss']:.3f}", flush=True)
        print("final", meter.mean())
        return meter.mean()
    # profile (unimplemented upstream, train_mvs4.py:605-606): the train
    # step's first call (on the card its capture, JAX cli/train.py:382's
    # jit) against its steady state (replays), then one traced step
    from ..train.profiler import device_memory_stats, profile_step_fn, profile_trace
    from ..train.schedule import warmup_multistep
    from ..train.step import make_optimizer, make_train_step

    step = make_train_step(model, lcfg, make_optimizer(model, tcfg.weight_decay),
                           warmup_multistep(tcfg.lr, [10_000], 0.5))
    batch = batch_to_torch(next(iter(train_loader)), device)
    stats = profile_step_fn(lambda: step(batch), device, iters=5)
    with profile_trace(args.logdir, device) as trace:
        step(batch)
    memory = device_memory_stats()
    print("step stats:", stats)
    print("memory:", memory)
    print(f"trace written to {trace} (chrome://tracing, Perfetto)")
    return {"stats": stats, "memory": memory, "trace": trace}


if __name__ == "__main__":
    main()
