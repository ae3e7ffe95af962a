"""Analytic FLOP and byte bound of the port's eval forward on one H100.

Counterpart of the JAX repo's ``_roofline.py``, which bounds the TPU
formulation on a v5e (banded warps, packed convs, hard-coded stage table).
Here every number comes from a ``ModelConfig`` and ``(B, V, H, W)``, for
the pieces the port runs (FPN4 with Reg2D and the ``ConvBnReLU3D`` mid
blocks, the flagship family; other variants raise):

- the FPN stem convs (K6 on its route, the convolution library otherwise)
  and ``out1``, the top-down's 1x1 head;
- the three top-down levels (K2: ``up2(intra) + 1x1(skip) + b``, then the
  3x3 ``out`` conv);
- per stage, the direct-gather warp + group correlation of each source
  view (K1: an exact bilinear gather, no band or pack inflation, so the
  executed FLOPs are the logical ones);
- per stage, the attention accumulation over the source views (K5);
- per stage, Reg2D (``conv0`` on K6, the rest the library's; a stride-2
  transposed conv counts its input pixels x 9 taps, as
  ``torch.utils.flop_counter`` does);
- per stage, the readout: argmax, softmax and confidence over D in float32,
  and the stage's hypotheses.

A piece's FLOPs are split into convolution FLOPs (the tensor cores', at the
dtype's dense peak) and the rest (elementwise and gather arithmetic on the
float32 CUDA cores, at their peak). Its bytes are its inputs read once and
its outputs written once, in the config's dtype (float32 for hypotheses and
scores); the stem, top-down head and Reg2D count this per layer, as the
port runs them one layer at a time. A piece's bound is the larger of its
bytes over the memory rate and its FLOPs over the peaks; the forward's bound
is the sum of its pieces' bounds.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them, 3.35
TB/s HBM3.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.roofline [B V H W]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..config import ModelConfig

HBM_BYTES_PER_S = 3.35e12
DENSE_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FP32_FLOPS = 67e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

Piece = Dict[str, float]


def stage_table(cfg: ModelConfig, H: int, W: int) -> List[Tuple[int, int, int, int, int]]:
    """``(h, w, D, C, G)`` of each stage: resolution (1/8 .. 1/1),
    hypotheses, feature channels and correlation groups (the JAX script's
    ``STAGES``)."""
    n = cfg.num_stages
    return [(H >> (n - 1 - s), W >> (n - 1 - s), cfg.ndepths[s], cfg.fpn_out_channels[s],
             cfg.group_cor_dim[s] if cfg.group_cor else cfg.fpn_out_channels[s])
            for s in range(n)]


def _check(cfg: ModelConfig) -> None:
    covered = (cfg.arch_mode == "fpn" and cfg.reg_mode == "reg2d" and cfg.num_stages == 4
               and cfg.agg_type == "ConvBnReLU3D" and cfg.group_cor and cfg.attn_fuse_d
               and not (cfg.dcn or cfg.asff or cfg.gn or cfg.pos_enc))
    if not covered:
        raise ValueError("the roofline covers FPN4 + Reg2D with group correlation and the "
                         "ConvBnReLU3D mid blocks, no DCN, ASFF, GroupNorm or pos-enc")


def _conv(n: int, h: int, w: int, k: int, ci: int, co: int, esz: int, stride: int = 1,
          transposed: bool = False, kd: int = 1, d: int = 1) -> Tuple[float, float]:
    """(FLOPs, bytes) of one conv layer on ``n`` images of ``h x w`` input:
    2 MACs per output pixel (per input pixel for a transposed conv) per tap
    and channel pair; input, output and weights moved once."""
    ho, wo = (h * stride, w * stride) if transposed else (-(-h // stride), -(-w // stride))
    px = n * d * (h * w if transposed else ho * wo)
    flops = 2.0 * px * kd * k * k * ci * co
    nbytes = esz * (n * d * (h * w * ci + ho * wo * co) + kd * k * k * ci * co)
    return flops, nbytes


def _piece(name: str, layers, cc_flops: float = 0.0, nbytes: float = 0.0) -> Piece:
    return {"name": name, "conv_flops": sum(f for f, _ in layers), "other_flops": cc_flops,
            "bytes": nbytes + sum(b for _, b in layers)}


def pieces(cfg: ModelConfig, B: int, V: int, H: int, W: int) -> List[Piece]:
    """The forward's pieces (module docstring), each with ``conv_flops``,
    ``other_flops``, ``bytes`` and ``bound_ms``."""
    _check(cfg)
    esz = DTYPE_BYTES[cfg.dtype]
    b, r = cfg.fpn_base_channel, cfg.reg_channel
    N = B * V
    out: List[Piece] = []

    stem = [_conv(N, H, W, 3, 3, b, esz), _conv(N, H, W, 3, b, b, esz)]
    for lvl in (1, 2, 3):
        h, w, ci, co = H >> (lvl - 1), W >> (lvl - 1), b << (lvl - 1), b << lvl
        stem += [_conv(N, h, w, 5, ci, co, esz, stride=2)]
        stem += [_conv(N, h >> 1, w >> 1, 3, co, co, esz)] * 2
    out.append(_piece("FPN stem", stem))
    final = 8 * b
    out.append(_piece("FPN out1 (1x1)", [_conv(N, H >> 3, W >> 3, 1, final, final, esz)]))
    for lvl in (1, 2, 3):
        h, w = H >> (3 - lvl), W >> (3 - lvl)
        cs = co = b << (3 - lvl)
        px = N * h * w
        out.append(_piece(
            f"K2 top-down L{lvl + 1}",
            [(2.0 * px * final * cs, 0.0), (2.0 * px * 9 * final * co, 0.0)],
            cc_flops=7.0 * px * final,
            nbytes=esz * (N * (h // 2) * (w // 2) * final + px * (cs + co)
                          + final * cs + final + 9 * final * co)))

    for s, (h, w, D, C, G) in enumerate(stage_table(cfg, H, W)):
        vol, px = B * D * h * w, B * h * w
        S = V - 1
        out.append(_piece(
            f"K1 warp + group cor s{s + 1}", [], cc_flops=S * vol * (28 + 9 * C + G),
            nbytes=S * (esz * (2 * px * C + vol * G) + 4 * (vol + 16 * B))))
        out.append(_piece(
            f"K5 attention s{s + 1}", [], cc_flops=S * vol * (3 * G + 8) + vol * G,
            nbytes=esz * (S + 1) * vol * G))
        n = B * D
        reg = [_conv(n, h, w, 3, G, r, esz)]                       # conv0 (K6)
        for lvl in range(3):
            ci, co = r << lvl, r << (lvl + 1)
            hh, ww = h >> (lvl + 1), w >> (lvl + 1)
            reg += [_conv(n, h >> lvl, w >> lvl, 3, ci, co, esz, stride=2),
                    _conv(B, hh, ww, 3, co, co, esz, kd=3, d=D)]
        for lvl in (3, 2, 1):                                      # conv7, conv9, conv11
            reg += [_conv(n, h >> lvl, w >> lvl, 3, r << lvl, r << (lvl - 1), esz,
                          stride=2, transposed=True)]
        reg += [_conv(n, h, w, 1, r, 1, esz)]                      # prob
        out.append(_piece(f"Reg2D s{s + 1}", reg))
        out.append(_piece(f"readout s{s + 1}", [], cc_flops=8.0 * vol,
                          nbytes=4.0 * px * (4 * D + 4)))

    peak = DENSE_FLOPS[cfg.dtype]
    for p in out:
        p["bytes_ms"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
        p["ops_ms"] = (p["conv_flops"] / peak + p["other_flops"] / FP32_FLOPS) * 1e3
        p["bound_ms"] = max(p["bytes_ms"], p["ops_ms"])
        p["bound_by"] = "operations" if p["ops_ms"] > p["bytes_ms"] else "bytes"
    return out


def roofline(cfg: ModelConfig, B: int, V: int, H: int, W: int) -> Dict[str, object]:
    """The forward's pieces and their sums: logical FLOPs (convolution and
    other), bytes, and the bound (the sum of the pieces' bounds)."""
    ps = pieces(cfg, B, V, H, W)
    total = {k: sum(p[k] for p in ps) for k in ("conv_flops", "other_flops", "bytes",
                                                 "bytes_ms", "ops_ms", "bound_ms")}
    total["flops"] = total["conv_flops"] + total["other_flops"]
    return {"B": B, "V": V, "H": H, "W": W, "dtype": cfg.dtype, "pieces": ps, **total}


def mfu(roof: Dict[str, object], seconds_per_forward: float) -> float:
    """Logical FLOPs over (seconds per forward x the dtype's dense peak)."""
    return roof["flops"] / (seconds_per_forward * DENSE_FLOPS[roof["dtype"]])


def main(argv=None) -> None:
    from ..graft_entry import dtu_model_config

    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [4, 4, 512, 640]
    roof = roofline(dtu_model_config(), *args)
    print(f"H100 bound of the eval forward, B{args[0]} V{args[1]} {args[2]}x{args[3]} "
          f"{roof['dtype']} (data-sheet peaks)")
    print(f"{'piece':28s} {'conv GFLOP':>10s} {'other GFLOP':>11s} {'MB':>8s} "
          f"{'bytes ms':>8s} {'ops ms':>7s} {'bound ms':>8s}")
    for p in roof["pieces"] + [{"name": "forward", **roof}]:
        print(f"{p['name']:28s} {p['conv_flops'] / 1e9:10.2f} {p['other_flops'] / 1e9:11.2f} "
              f"{p['bytes'] / 1e6:8.1f} {p['bytes_ms']:8.4f} {p['ops_ms']:7.4f} "
              f"{p['bound_ms']:8.4f}")
    print(f"bound {roof['bound_ms']:.3f} ms a forward -> "
          f"{args[0] / roof['bound_ms'] * 1e3:.0f} maps/s at most")


if __name__ == "__main__":
    main()
