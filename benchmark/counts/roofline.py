"""The frozen yardstick: analytic FLOPs and bytes of MVSTER's eval forward
and train step at a configuration and a shape, and the H100's peaks.

A copy of the program's ``tools/roofline.py`` (FPN4 + Reg2D with group
correlation, the ``ConvBnReLU3D`` mid blocks), taking the benchmark's
configuration dict, extended to the train step (``train_pieces``), with
the per-kernel counts of the program's ``chip_smoke.py`` rows
(``kernel_pieces``). Every count is of the work the algorithm needs at its
shapes: each input byte read once, each output byte written once.

- A piece's FLOPs split into convolution FLOPs (tensor cores, at the
  dtype's dense peak) and the rest (float32 CUDA cores). A transposed conv
  counts its input pixels x 9 taps, as ``torch.utils.flop_counter`` does.
- The train step is the train-route forward (cuDNN for every convolution,
  the warp forward K4, group correlation and attention in PyTorch, the
  mono decoder, the Sinkhorn loss), and a backward counted as twice the
  forward's convolution FLOPs (input and weight gradients) plus twice the
  elementwise aggregation's FLOPs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
DENSE_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FP32_FLOPS = 67e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
# widest 3x3 stride-1 conv + BN + ReLU the program runs as K6 in eval, by dtype
K6_MAX_CHANNELS = {"bfloat16": 64, "float32": 32}

Piece = Dict[str, float]


def stage_table(cfg: Dict, H: int, W: int) -> List[Tuple[int, int, int, int, int]]:
    """``(h, w, D, C, G)`` of each stage."""
    b = cfg["fpn_base_channel"]
    chans = (8 * b, 4 * b, 2 * b, b)
    return [(H >> (3 - s), W >> (3 - s), cfg["ndepths"][s], chans[s], cfg["group_cor_dim"][s])
            for s in range(4)]


def _conv(n, h, w, k, ci, co, esz, stride=1, transposed=False, kd=1, d=1):
    """(FLOPs, bytes) of one conv layer on ``n`` images of ``h x w`` input."""
    ho, wo = (h * stride, w * stride) if transposed else (-(-h // stride), -(-w // stride))
    px = n * d * (h * w if transposed else ho * wo)
    flops = 2.0 * px * kd * k * k * ci * co
    nbytes = esz * (n * d * (h * w * ci + ho * wo * co) + kd * k * k * ci * co)
    return flops, nbytes


def _piece(name, layers, cc_flops=0.0, nbytes=0.0) -> Piece:
    return {"name": name, "conv_flops": sum(f for f, _ in layers), "other_flops": cc_flops,
            "bytes": nbytes + sum(b for _, b in layers)}


def _bound(pieces: List[Piece], dtype: str) -> List[Piece]:
    for p in pieces:
        peak = p.pop("peak", DENSE_FLOPS[dtype])
        p["bytes_ms"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
        p["ops_ms"] = (p["conv_flops"] / peak + p["other_flops"] / FP32_FLOPS) * 1e3
        p["bound_ms"] = max(p["bytes_ms"], p["ops_ms"])
    return pieces


def _stem(cfg, N, H, W, esz):
    b = cfg["fpn_base_channel"]
    stem = [_conv(N, H, W, 3, 3, b, esz), _conv(N, H, W, 3, b, b, esz)]
    for lvl in (1, 2, 3):
        h, w, ci, co = H >> (lvl - 1), W >> (lvl - 1), b << (lvl - 1), b << lvl
        stem += [_conv(N, h, w, 5, ci, co, esz, stride=2)]
        stem += [_conv(N, h >> 1, w >> 1, 3, co, co, esz)] * 2
    return stem


def _reg2d(cfg, B, h, w, D, G, esz):
    r = cfg["reg_channel"]
    n = B * D
    reg = [_conv(n, h, w, 3, G, r, esz)]
    for lvl in range(3):
        ci, co = r << lvl, r << (lvl + 1)
        reg += [_conv(n, h >> lvl, w >> lvl, 3, ci, co, esz, stride=2),
                _conv(B, h >> (lvl + 1), w >> (lvl + 1), 3, co, co, esz, kd=3, d=D)]
    for lvl in (3, 2, 1):
        reg += [_conv(n, h >> lvl, w >> lvl, 3, r << lvl, r << (lvl - 1), esz, stride=2,
                      transposed=True)]
    reg += [_conv(n, h, w, 1, r, 1, esz)]
    return reg


def _topdown(cfg, N, H, W, esz, with_u: bool):
    """The three top-down levels (K2): their two convolutions and the
    upsample-add; with ``with_u`` the mid levels also write ``u``."""
    b = cfg["fpn_base_channel"]
    final = 8 * b
    out = []
    for lvl in (1, 2, 3):
        h, w = H >> (3 - lvl), W >> (3 - lvl)
        cs = co = b << (3 - lvl)
        px = N * h * w
        written = co + (final if with_u and lvl < 3 else 0)
        out.append(_piece(f"K2 top-down L{lvl + 1}",
                          [(2.0 * px * final * cs, 0.0), (2.0 * px * 9 * final * co, 0.0)],
                          cc_flops=7.0 * px * final,
                          nbytes=esz * (N * (h // 2) * (w // 2) * final + px * (cs + written)
                                        + final * cs + final + 9 * final * co)))
    return out


def pieces(cfg: Dict, B: int, V: int, H: int, W: int) -> List[Piece]:
    """The eval forward's pieces, each with ``conv_flops``, ``other_flops``,
    ``bytes`` and ``bound_ms`` (the program's ``tools/roofline.py``)."""
    dtype = cfg["dtype"]
    esz = DTYPE_BYTES[dtype]
    N = B * V
    final = 8 * cfg["fpn_base_channel"]
    out = [_piece("FPN stem", _stem(cfg, N, H, W, esz)),
           _piece("FPN out1 (1x1)", [_conv(N, H >> 3, W >> 3, 1, final, final, esz)])]
    out += _topdown(cfg, N, H, W, esz, with_u=False)
    for s, (h, w, D, C, G) in enumerate(stage_table(cfg, H, W)):
        vol, px, S = B * D * h * w, B * h * w, V - 1
        out.append(_piece(f"K1 warp + group cor s{s + 1}", [], cc_flops=S * vol * (28 + 9 * C + G),
                          nbytes=S * (esz * (2 * px * C + vol * G) + 4 * (vol + 16 * B))))
        out.append(_piece(f"K5 attention s{s + 1}", [], cc_flops=S * vol * (3 * G + 8) + vol * G,
                          nbytes=esz * (S + 1) * vol * G))
        out.append(_piece(f"Reg2D s{s + 1}", _reg2d(cfg, B, h, w, D, G, esz)))
        out.append(_piece(f"readout s{s + 1}", [], cc_flops=8.0 * vol,
                          nbytes=4.0 * px * (4 * D + 4)))
    return _bound(out, dtype)


def train_pieces(cfg: Dict, B: int, V: int, H: int, W: int) -> List[Piece]:
    """The train step's pieces: the train-route forward, the loss and the
    backward (module docstring)."""
    dtype = cfg["dtype"]
    esz = DTYPE_BYTES[dtype]
    N = B * V
    b = cfg["fpn_base_channel"]
    final = 8 * b
    chans = (8 * b, 4 * b, 2 * b, b)
    fwd = [_piece("FPN stem", _stem(cfg, N, H, W, esz)),
           _piece("FPN out1 (1x1)", [_conv(N, H >> 3, W >> 3, 1, final, final, esz)])]
    fwd += _topdown(cfg, N, H, W, esz, with_u=True)
    for s, (h, w, D, C, G) in enumerate(stage_table(cfg, H, W)):
        vol, px, S = B * D * h * w, B * h * w, V - 1
        fwd.append(_piece(f"K4 warp forward s{s + 1}", [], cc_flops=S * vol * (28 + 7 * C),
                          nbytes=S * (esz * (px * C + vol * C) + 4 * (vol + 16 * B))))
        fwd.append(_piece(f"aggregation s{s + 1}", [],
                          cc_flops=S * vol * (2 * C + 3 * G + 8) + vol * G,
                          nbytes=S * (esz * vol * C + 4 * vol * G) + esz * (px * C + vol * G)))
        fwd.append(_piece(f"Reg2D s{s + 1}", _reg2d(cfg, B, h, w, D, G, esz)))
        fwd.append(_piece(f"readout s{s + 1}", [], cc_flops=8.0 * vol,
                          nbytes=4.0 * px * (4 * D + 4)))
        fwd.append(_piece(f"Sinkhorn loss s{s + 1}", [],
                          cc_flops=px * D * D * (8.0 * cfg["loss"]["ot_iter"] + 6.0),
                          nbytes=4.0 * px * (2 * D + 2)))
    if cfg["mono"]:
        mono = []
        for i in range(3):
            h, w = H >> (3 - i), W >> (3 - i)
            mono += [_conv(B, h, w, 3, chans[i], chans[i + 1], esz),
                     _conv(B, 2 * h, 2 * w, 3, 2 * chans[i + 1], 1, esz)]
        fwd.append(_piece("mono decoder", mono))
    conv = sum(p["conv_flops"] for p in fwd)
    agg = sum(p["other_flops"] for p in fwd if p["name"].startswith("aggregation"))
    bwd = [_piece("backward (convolutions, 2x)", [(2.0 * conv, 0.0)]),
           _piece("backward (aggregation, 2x)", [], cc_flops=2.0 * agg)]
    return _bound(fwd + bwd, dtype)


def totals(ps: List[Piece]) -> Dict[str, float]:
    t = {k: sum(p[k] for p in ps) for k in ("conv_flops", "other_flops", "bytes", "bound_ms")}
    t["flops"] = t["conv_flops"] + t["other_flops"]
    return t


def kernel_pieces(cfg: Dict, B: int, V: int, H: int, W: int, train: bool) -> List[Piece]:
    """The work the program's own kernels do in one eval forward (K1, K2,
    K5, K6) or one train step (K2 forward and its backward's re-derivation
    of ``u``, K3, K4), counted as the program's ``chip_smoke.py`` rows count
    each launch; each piece named after its kernel, with its bound."""
    dtype = cfg["dtype"]
    esz = DTYPE_BYTES[dtype]
    b = cfg["fpn_base_channel"]
    final = 8 * b
    N = B * V
    bf16 = dtype == "bfloat16"
    out: List[Piece] = []
    for lvl in (1, 2, 3):
        h, w = H >> (3 - lvl), W >> (3 - lvl)
        cs = co = b << (3 - lvl)
        npix = N * h * w
        modes = (["with_u" if lvl < 3 else "o"] + ["u_only"]) if train else ["o"]
        for mode in modes:
            written = (0 if mode == "u_only" else co) + (0 if mode == "o" else final)
            nbytes = (N * (h // 2) * (w // 2) * final + npix * cs + npix * written) * esz \
                + (final * cs + final + (0 if mode == "u_only" else 9 * final * co)) * 4
            ops = npix * (final * (2 * cs + 7) + (0 if mode == "u_only" else 18 * final * co))
            mma = bf16 and final == 64 and cs in (8, 16, 32)
            out.append({"name": f"K2 top-down L{lvl + 1} {mode}", "conv_flops": 0.0,
                        "other_flops": 0.0, "ops": ops, "bytes": nbytes,
                        "peak": DENSE_FLOPS["bfloat16"] if mma else FP32_FLOPS})
    for s, (h, w, D, C, G) in enumerate(stage_table(cfg, H, W)):
        vol, px, S = B * D * h * w, B * h * w, V - 1
        hyp = 4 * (vol + 16 * B)
        if train:
            out.append({"name": f"K4 warp forward s{s + 1}", "ops": S * vol * (28 + 7 * C),
                        "bytes": S * (esz * (px * C + vol * C) + hyp), "peak": FP32_FLOPS})
            out.append({"name": f"K3 warp backward s{s + 1}", "ops": S * vol * (28 + 8 * C),
                        "bytes": S * (esz * vol * C + hyp + 4 * px * C), "peak": FP32_FLOPS})
            continue
        out.append({"name": f"K1 warp + group cor s{s + 1}", "ops": S * vol * (28 + 9 * C + G),
                    "bytes": S * (esz * (2 * px * C + vol * G) + hyp), "peak": FP32_FLOPS})
        out.append({"name": f"K5 attention s{s + 1}", "ops": S * vol * (3 * G + 8) + vol * G,
                    "bytes": esz * (S + 1) * vol * G, "peak": FP32_FLOPS})
    if not train:
        limit = K6_MAX_CHANNELS[dtype]
        layers = [("conv0.0", N, H, W, 3, b), ("conv0.1", N, H, W, b, b)]
        for lvl in (1, 2, 3):
            c = b << lvl
            layers += [(f"conv{lvl}.{i}", N, H >> lvl, W >> lvl, c, c) for i in (1, 2)]
        for s, (h, w, D, C, G) in enumerate(stage_table(cfg, H, W)):
            layers.append((f"reg{s + 1}.conv0", B * D, h, w, G, cfg["reg_channel"]))
        for name, n, h, w, ci, co in layers:
            if max(ci, co) > limit:
                continue
            out.append({"name": f"K6 band conv {name}", "ops": 2.0 * n * h * w * co * 9 * ci,
                        "bytes": n * h * w * (ci + co) * esz + (co * ci * 9 + 2 * co) * 4,
                        "peak": DENSE_FLOPS[dtype]})
    for p in out:
        p["bound_ms"] = max(p["bytes"] / HBM_BYTES_PER_S, p["ops"] / p["peak"]) * 1e3
    return out
