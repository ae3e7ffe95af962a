"""The comparisons that decide ``correct``: the numbers each cell holds
the program's answers to, against the plain reference's, and the
reference runs that produce them.

Every number is a gap, so a reading passes when it is at most its limit.
The limits live in each cell's ``workloads/<cell>.json`` with the readings
they were set from (``PERF.md``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from .reference.mvster import Net

# a depth counts as another answer where it differs by more than this share
DEPTH_REL_TOL = 0.01


@contextlib.contextmanager
def precision(name: str):
    """``float32`` with TF32 off (as the configurations state), or the
    ``tf32`` control: TF32 on for cuDNN convolutions and matmuls."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def reference_depths(weights, config: Dict, batch: Dict, mode: str = "float32") -> Dict:
    """The reference's eval forward of ``batch``: stage-4 ``depth`` and
    ``confidence``, and every stage's depths and scores. ``mode``:
    ``float32``, or the controls ``tf32`` and ``fp8``."""
    net = Net(weights, config, train=False, precision="fp8" if mode == "fp8" else "float32")
    with torch.no_grad(), precision(mode):
        out = net.forward(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    s4 = out["stage4"]
    stages = [out[f"stage{s}"] for s in (1, 2, 3, 4)]
    return {"depth": s4["depth"], "confidence": s4["photometric_confidence"],
            "stage_depths": [o["depth"] for o in stages],
            "stage_scores": [o["score"] for o in stages]}


def _agree(d, ref):
    return (d - ref).abs() <= DEPTH_REL_TOL * ref


class DepthGap:
    """Accumulates over maps the program's winner-take-all depths against
    the reference's, where both chose among the same hypotheses: every
    pixel of stage 1, and the pixels of a later stage whose 3x3
    neighbourhood of parents in the stage before was counted and agrees on
    both sides (its hypothesis window, interpolated from those parents, is
    then the same). A flip of the cascade's first stage moves every later
    window around it; counting a stage only where its window agrees keeps
    the numbers about each choice.

    - ``flip_share``: how often the program's depth is another hypothesis
      than the reference's;
    - ``sure_flip_share``: the same among the pixels where the reference's
      best score leads its second by more than ``margin`` of the mean
      spread of its scores across the hypotheses and ``level`` of their
      mean magnitude (of that stage and map): the cell's ``sure``, set to
      what the configuration's precision resolves (scores share an offset
      across the hypotheses, so a score resolves its margin only to its
      own magnitude's precision). With seeded random weights many pixels
      are near-ties, which rounding decides either way; a pixel the
      reference decides clearly is decided the same way by a sound
      program;
    - ``conf_gap``: the median, over the counted stage-4 pixels whose depth
      agrees, of the relative gap of the program's photometric confidence
      (given to ``add``) to the reference's; a non-finite confidence of the
      program reads as an infinite gap. The confidence is the best score
      over the sum of the scores, and with random weights the scores take
      both signs: where their sum crosses zero the readout runs far out on
      both sides, or is not finite in the reference (such pixels are left
      out). So the median, and not a mean or a widest gap.

    Maps with a non-finite depth are counted in ``bad_maps``."""

    def __init__(self, margin: float, level: float):
        self.margin, self.level = margin, level
        self.counted = [0, 0]
        self.flips = [0, 0]
        self.bad_maps = 0
        self.conf = []

    def add(self, stage_depths, confidence, ref: Dict) -> None:
        ds = [d.float().to(r.device) for d, r in zip(stage_depths, ref["stage_depths"])]
        finite = torch.stack([torch.isfinite(d).flatten(1).all(dim=1) for d in ds]).all(dim=0)
        self.bad_maps += int((~finite).sum())
        keep = None
        last = len(ds) - 1
        for s, (d, r, sc) in enumerate(zip(ds, ref["stage_depths"], ref["stage_scores"])):
            flip = ~_agree(d, r)
            if keep is None:
                keep = torch.ones_like(flip)
            top2 = sc.topk(2, dim=1).values
            spread = (top2[:, 0] - sc.amin(dim=1)).flatten(1).mean(dim=1)[:, None, None]
            level = sc.abs().flatten(1).mean(dim=1)[:, None, None]
            margin = top2[:, 0] - top2[:, 1]
            sure = keep & (margin > self.margin * spread) & (margin > self.level * level)
            for i, m in enumerate((keep, sure)):
                self.flips[i] += int((flip & m).sum())
                self.counted[i] += int(m.sum())
            if s == last:
                want = ref["confidence"]
                got = torch.as_tensor(confidence, device=want.device).float().reshape(want.shape)
                gap = torch.nan_to_num((got - want).abs() / want.abs(), nan=float("inf"))
                held = torch.isfinite(want) & (want != 0)
                self.conf.append(gap[keep & ~flip & held])
            same = (~flip & keep).float()[:, None]
            same = -F.max_pool2d(-same, 3, 1, 1)          # all of the 3x3 parents agree
            keep = F.interpolate(same, scale_factor=2, mode="nearest")[:, 0] > 0.5

    def numbers(self) -> Dict[str, float]:
        conf = torch.cat(self.conf) if self.conf else torch.zeros(0)
        return {"flip_share": self.flips[0] / max(self.counted[0], 1),
                "sure_flip_share": self.flips[1] / max(self.counted[1], 1),
                "conf_gap": float(conf.median()) if conf.numel() else float("inf")}


class FusionGap:
    """Accumulates, over reference views, the program's filter and fusion
    against the reference's on the same depth and confidence maps: the
    share of pixels whose photometric, geometric or final mask differs
    (``mask_mismatch``, over the three) and the mean relative gap of the
    fused depth over every pixel (``fused_gap``)."""

    def __init__(self):
        self.px = 0
        self.off = 0
        self.fused = 0.0

    def add(self, got: Dict, want: Dict) -> None:
        dev = want["final_mask"].device
        for k in ("photo_mask", "geo_mask", "final_mask"):
            self.off += int((torch.as_tensor(got[k], device=dev) != want[k]).sum())
        self.px += want["final_mask"].numel()
        fused = torch.as_tensor(got["fused_depth"], device=dev)
        ref = want["fused_depth"]
        self.fused += float(((fused - ref).abs() / ref.abs()).sum())

    def numbers(self) -> Dict[str, float]:
        return {"mask_mismatch": self.off / max(3 * self.px, 1),
                "fused_gap": self.fused / max(self.px, 1)}


def head_weight(name: str) -> bool:
    """The weights of the output convolutions of the loss heads that no
    depth choice reaches: stage 1's probability convolution (stage 1's
    hypotheses are fixed, and its loss reads no later stage) and the mono
    decoder's three depth convolutions (an L1 of the mono depth, made from
    the reference view's features). Their gradient is the loss's own
    gradient against a forward activation, with no train-mode BatchNorm
    backward in between, whose subtraction of batch means amplifies the
    rounding of any precision alike."""
    return name == "reg.0.prob.weight" or (name.startswith("mono_depth_decoder.conv3x3.")
                                            and name.endswith(".weight"))


class TrainGap:
    """The program's first steps against the reference's: the widest
    relative gap of a step's loss (``loss_gap``) and of its mono L1 terms
    (``mono_loss_gap``); by leaf, the gap between the norms of the first
    gradient as Adam takes it and of each parameter's change over the
    steps, over the larger of the reference's norm of that leaf and of the
    median leaf, at the median leaf (``grad_gap_median``,
    ``update_gap_median``); and the norm of the first gradient's
    difference over the same denominator, the median leaf among the
    mono decoder's (``mono_grad_diff``) and among the loss heads' output
    weights (``head_grad_diff``, ``head_weight``). Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change (``excluded``).

    A difference of norms, or of means such as a loss, moves only at
    second order under unbiased rounding; the norm of a difference moves
    at first order. On the heads' output weights it is swamped neither by
    the near-tie depth choices that any rounding flips nor by BatchNorm's
    backward, so it tells bf16 from fp8 (``PERF.md``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], want: Dict):
        self.w0 = weights
        self.want = want
        g = {k: float(v.norm()) for k, v in want["first_grad"].items()}
        med = float(torch.tensor(list(g.values())).median())
        self.excluded = sorted(k for k, v in g.items() if v < 1e-3 * med)

    @staticmethod
    def _ratios(num: Dict[str, float], want: Dict[str, torch.Tensor]) -> List[float]:
        """``num[k]`` over the larger of ``want[k]``'s norm and the median leaf's."""
        b = {k: float(want[k].float().norm()) for k in num}
        med = float(torch.tensor(list(b.values())).median())
        return [num[k] / max(b[k], med, 1e-30) for k in num]

    def _gaps(self, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keys) -> List[float]:
        return self._ratios({k: abs((float(got[k].float().norm()) if k in got else 0.0)
                                    - float(want[k].float().norm())) for k in keys},
                            {k: want[k] for k in keys})

    def _diff(self, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keys) -> float:
        """The median over ``keys`` of the norm of ``got - want`` by leaf,
        over the larger of the leaf's and the median leaf's norm in ``want``."""
        if not keys:
            return 0.0
        dev = next(iter(want.values())).device
        diff = {k: float(((got[k].to(dev).float() if k in got else 0) - want[k]).norm())
                for k in keys}
        return float(torch.tensor(self._ratios(diff, {k: want[k] for k in keys})).median())

    def numbers(self, got: Dict) -> Dict[str, float]:
        want = self.want

        def rel(key):
            return max(abs(a[key] - b[key]) / abs(b[key])
                       for a, b in zip(got["losses"], want["losses"]))

        g_want = want["first_grad"]
        dev = next(iter(g_want.values())).device
        grads = self._gaps(got["first_grad"], g_want, list(g_want))
        keys = [k for k in want["after"] if k not in self.excluded]
        d_got = {k: got["after"][k].to(dev).float() - self.w0[k].to(dev).float() for k in keys}
        d_want = {k: want["after"][k] - self.w0[k].to(dev).float() for k in keys}
        upd = self._gaps(d_got, d_want, keys)
        mono = [k for k in g_want if k.startswith("mono_depth_decoder.")]
        return {"loss_gap": rel("loss"), "mono_loss_gap": rel("mono"),
                "grad_gap_median": float(torch.tensor(grads).median()),
                "update_gap_median": float(torch.tensor(upd).median()),
                "mono_grad_diff": self._diff(got["first_grad"], g_want, mono),
                "head_grad_diff": self._diff(got["first_grad"], g_want,
                                             [k for k in g_want if head_weight(k)])}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """Each number beside its limit."""
    return [{"name": k, "value": numbers[k], "limit": limits[k]} for k in limits]
