"""The PyTorch port's train path against the JAX package on the CPU.

Kernel K3's plain version (the warp backward) against ``jax.vjp`` of the
exact gather warp and against the TPU kernel's entry point; the top-down
chain's ``autograd.Function`` against ``jax.grad`` of the fused chain;
train-mode BatchNorm, the Sinkhorn and MVS4Net losses, the metrics, the
schedules and Adam against their JAX counterparts; and one whole train step
(loss, every aux scalar, every parameter's gradient, the updated BatchNorm
statistics) against ``make_train_step`` of the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks. Every
test states its tolerance. JAX runs on the CPU; Pallas kernels run in
interpret mode, as the JAX package's own tests run them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    LossConfig as JaxLossConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core import geometry as jg
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.sinkhorn import (
    sinkhorn_loss as jax_sinkhorn_loss,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import layers as jl
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models.losses import (
    mvs4net_loss as jax_mvs4net_loss,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops import warp_mxu
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.pallas.topdown_fused import (
    topdown_fused_chain,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.warp_cor import (
    correlate_view as jax_correlate_view,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train import metrics as jax_metrics
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train import schedule as jax_schedule
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train import step as jax_step
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
    LossConfig,
    ModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.sinkhorn import sinkhorn_loss
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.losses import mvs4net_loss
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_bwd as k3,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.topdown_chain import (
    topdown_chain,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.warp_cor import correlate_view
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import metrics as tmetrics
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import schedule as tschedule
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
    make_optimizer,
    make_train_step,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_grads_to_port,
    jax_variables_to_state_dict,
)

# the recipe's loss weights (scripts/train_dtu.sh: --l1ce_lw 0.003,1, mono,
# inverse depth, 3 Sinkhorn iterations)
RECIPE_LOSS = dict(stage_lw=(1.0, 1.0, 1.0, 1.0), l1_lw=0.003, ot_lw=1.0, ot_iter=3,
                   inverse_depth=True, mono=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel, what=""):
    """max|got - want| <= rel * max(1, max|want|)."""
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


# ------------------------------------------------------- K3: warp backward --


def _warp_inputs(B, H, W, D, C, seed, hs=None, ws=None):
    """Plane-scene geometry (view 1 against view 0), random features, a
    per-pixel jittered inverse-depth sweep and a random cotangent."""
    rng = np.random.default_rng(seed)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=seed + i) for i in range(B)])
    pr = batch["proj_matrices"]["stage4"]
    rel = np.asarray(jg.relative_projection(jnp.asarray(pr[:, 1]), jnp.asarray(pr[:, 0])))
    hs, ws = hs or H, ws or W
    src = rng.standard_normal((B, hs, ws, C)).astype(np.float32)
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    g = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    return src, ref, rel.astype(np.float32), (1.0 / inv).astype(np.float32), g


# (C, G) of the four flagship stages, plus a source smaller than the
# reference, so that the sweep leaves the source image
WARP_CASES = [(8, 4, None), (16, 4, None), (32, 8, None), (64, 8, None), (8, 2, (20, 28))]


@pytest.mark.parametrize("C,G,src_hw", WARP_CASES)
def test_warp_bwd_ref_and_train_correlation_match_jax_vjp(C, G, src_hw):
    """``warp_bwd_ref`` against ``jax.vjp`` of the exact gather warp
    (``grid_sample_2d`` at ``warp_coords``), and the gradients of the train
    path's correlation (``WarpIK`` + group correlation, autograd) for src and
    ref against ``jax.vjp`` of ``correlate_view(impl="gather")``. float32,
    tolerance 1e-5 of max(1, max|grad|) (measured <= 2.5e-7): the
    coordinates may differ by an ulp (explicit products here, an einsum in
    JAX), which moves a bilinear weight by up to ~4e-6 at |x| ~ 100."""
    B, H, W, D = 2, 24, 32, 4
    hs, ws = src_hw or (None, None)
    src, ref, rel, hypo, g = _warp_inputs(B, H, W, D, C, seed=C + G, hs=hs, ws=ws)

    def jwarp(s):
        return jg.grid_sample_2d(s, jg.warp_coords(jnp.asarray(rel), jnp.asarray(hypo)))

    _, vjp = jax.vjp(jwarp, jnp.asarray(src))
    want = vjp(jnp.asarray(g))[0]
    got = k3.warp_bwd_ref(_t(g), _t(rel), _t(hypo), src.shape)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, "warp_bwd_ref")

    gc = np.random.default_rng(C).standard_normal((B, D, H, W, G)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda s, r: jax_correlate_view(s, r, jnp.asarray(rel), jnp.asarray(hypo),
                                        group_cor=True, group_dim=G, impl="gather"),
        jnp.asarray(src), jnp.asarray(ref))
    want_src, want_ref = vjp(jnp.asarray(gc))
    ts, tr = _t(src).requires_grad_(), _t(ref).requires_grad_()
    out = correlate_view(ts, tr, _t(rel), _t(hypo), group_cor=True, group_dim=G, train=True)
    assert type(out.grad_fn).__name__ != "WarpIKBackward"      # correlation after the warp
    out.backward(_t(gc))
    _close(ts.grad, want_src, 1e-5, "dsrc")
    _close(tr.grad, want_ref, 1e-5, "dref")


def _tilted_setup(B=2, D=4, H=32, W=64, baseline=6.0, tilt=0.02):
    """The geometry of tests/test_warp_mxu.py's hybrid-backward test:
    a mostly horizontal baseline with a slight rotation and smooth
    per-pixel hypotheses, which the TPU kernel's bands cover."""
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)
    c, s = np.cos(tilt), np.sin(tilt)
    E_src = np.eye(4, dtype=np.float32)
    E_src[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    E_src[0, 3] = baseline
    E_src[1, 3] = 0.3 * baseline

    def stack(E):
        st = np.zeros((2, 4, 4), dtype=np.float32)
        st[0] = E
        st[1, :3, :3] = K
        return np.broadcast_to(st, (B, 2, 4, 4)).copy()

    rel = np.asarray(jg.relative_projection(jnp.asarray(stack(E_src)),
                                            jnp.asarray(stack(np.eye(4, dtype=np.float32)))))
    planes = np.linspace(40.0, 90.0, D, dtype=np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ramp = (0.02 * xx + 0.01 * yy).astype(np.float32)
    depth = np.broadcast_to(planes[None, :, None, None] + ramp[None, None], (B, D, H, W))
    return rel.astype(np.float32), np.ascontiguousarray(depth, np.float32)


def test_warp_bwd_ref_matches_pallas_ik_backward():
    """``warp_bwd_ref`` against the TPU kernel's entry point: the gradient
    of ``homo_warp_mxu(..., hybrid=True)`` with the in-kernel-coordinates v4
    backward (``warp_tiles_pallas_xband_bwd_ik``, interpret mode). The
    banded kernel drops taps outside its bands, so the geometry has zero
    band coverage first; atol 2e-3 covers its in-kernel coordinate rounding
    and factor products, as tests/test_warp_mxu.py states."""
    B, D, H, W, C = 2, 4, 32, 64, 8
    band, tile_rows, xband, tc = 16, 8, 96, 32
    rel, depth = _tilted_setup(B, D, H, W)
    rng = np.random.default_rng(5)
    src = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    cov = warp_mxu.band_coverage(jnp.asarray(rel), jnp.asarray(depth), H, band=band,
                                 tile_rows=tile_rows, src_w=W, xband=xband, tile_cols=tc)
    assert float(cov) == 0.0
    warp_mxu.set_bwd_kernel("v4", ik=True)
    try:
        _, vjp = jax.vjp(
            lambda s: warp_mxu.homo_warp_mxu(
                s, jnp.asarray(rel), jnp.asarray(depth), band=band, tile_rows=tile_rows,
                xband=xband, tile_cols=tc, hybrid=True),
            jnp.asarray(src))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    finally:
        warp_mxu.set_bwd_kernel("auto", ik=True)  # the module default
    got = k3.warp_bwd_ref(_t(g), _t(rel), _t(depth), src.shape)
    np.testing.assert_allclose(_np(got), want, atol=2e-3, rtol=0)


def test_warp_bwd_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors ``warp_bwd`` computes the plain version and launches
    nothing."""
    _, _, rel, hypo, g = _warp_inputs(1, 16, 16, 4, 8, seed=3)
    before = k3.launches
    got = k3.warp_bwd(_t(g), _t(rel), _t(hypo), (1, 16, 16, 8))
    assert torch.equal(got, k3.warp_bwd_ref(_t(g), _t(rel), _t(hypo), (1, 16, 16, 8)))
    assert k3.launches == before


# ------------------------------------------------- K2: the chain backward --


def _chain_inputs(seed=11):
    """The chain shape of tests/test_topdown_fused.py (N=1, L2 half-res
    8x12 doubling to 64x96, Ci=64, (Cs, Co) = (32,32), (16,16), (8,8)),
    weights in the JAX HWIO layout, and random output cotangents."""
    rng = np.random.default_rng(seed)
    N, Ci, Hh, Wh = 1, 64, 8, 12
    intra = rng.standard_normal((N, Hh, Wh, Ci)).astype(np.float32)
    skips, weights, gs = [], [], []
    for lvl, (cs, co) in enumerate([(32, 32), (16, 16), (8, 8)]):
        H, W = 2 ** (lvl + 1) * Hh, 2 ** (lvl + 1) * Wh
        skips.append(rng.standard_normal((N, H, W, cs)).astype(np.float32))
        weights.append((
            (rng.standard_normal((1, 1, cs, Ci)) * 0.1).astype(np.float32),
            (rng.standard_normal((Ci,)) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, Ci, co)) * 0.05).astype(np.float32),
        ))
        gs.append(rng.standard_normal((N, H, W, co)).astype(np.float32))
    return intra, skips, weights, gs


def test_topdown_chain_grads_match_jax_fused_chain():
    """Gradients of the chain ``autograd.Function`` (K2's plain version on
    the CPU, ``u`` re-derived in the backward) for intra, the skips, wi, bi
    and wo against ``jax.vjp`` of ``topdown_fused_chain`` (its custom VJP
    re-derives ``u`` with the Pallas kernel, interpret mode). float32,
    tolerance 2e-5 of max(1, max|grad|): convolution-gradient sums of up to
    6144 products in another order."""
    intra, skips, weights, gs = _chain_inputs()
    _, vjp = jax.vjp(
        lambda i, s, w: topdown_fused_chain(i, s, w, interpret=True),
        jnp.asarray(intra), tuple(jnp.asarray(s) for s in skips),
        tuple(tuple(jnp.asarray(x) for x in lw) for lw in weights))
    d_intra, d_skips, d_weights = vjp(tuple(jnp.asarray(g) for g in gs))

    t_intra = _t(intra).requires_grad_()
    t_skips = [_t(s).requires_grad_() for s in skips]
    t_weights = [(_t(wi.transpose(3, 2, 0, 1)).requires_grad_(), _t(bi).requires_grad_(),
                  _t(wo.transpose(3, 2, 0, 1)).requires_grad_()) for wi, bi, wo in weights]
    outs = topdown_chain(t_intra, t_skips, t_weights, train=True)
    assert type(outs[0].grad_fn).__name__ == "TopDownChainBackward"
    torch.autograd.backward(outs, [_t(g) for g in gs])

    _close(t_intra.grad, d_intra, 2e-5, "intra")
    for lvl in range(3):
        _close(t_skips[lvl].grad, d_skips[lvl], 2e-5, f"skip{lvl}")
        dwi, dbi, dwo = d_weights[lvl]
        twi, tbi, two = t_weights[lvl]
        _close(twi.grad, np.asarray(dwi).transpose(3, 2, 0, 1), 2e-5, f"wi{lvl}")
        _close(tbi.grad, dbi, 2e-5, f"bi{lvl}")
        _close(two.grad, np.asarray(dwo).transpose(3, 2, 0, 1), 2e-5, f"wo{lvl}")


# ------------------------------------------------------ train BatchNorm --


@pytest.mark.parametrize("groups", [1, 3])
def test_batchnorm_train_matches_flax(groups):
    """Train-mode ``TorchBatchNorm`` against the JAX package's, B=2 and V=3
    views folded ``b*V + v`` whose statistics differ visibly (view v is
    scaled by 1+v and shifted by 2v), so that a wrong group axis fails:
    the output (atol 1e-5) and the running statistics after one call
    (rtol 1e-5), the second call starting from the first's."""
    B, V, H, W, C = 2, 3, 5, 7, 4
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, V, H, W, C)).astype(np.float32)
    x = (x * (1 + np.arange(V))[None, :, None, None, None]
         + 2.0 * np.arange(V)[None, :, None, None, None]).reshape(B * V, H, W, C)
    jbn = jl.TorchBatchNorm()
    variables = {
        "params": {"scale": rng.uniform(0.5, 2, C).astype(np.float32),
                   "bias": rng.normal(0, 0.2, C).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.2, C).astype(np.float32),
                        "var": rng.uniform(0.5, 2, C).astype(np.float32)},
    }
    tbn = tl.TorchBatchNorm(C).train()
    tbn.load_state_dict({
        "weight": _t(variables["params"]["scale"]), "bias": _t(variables["params"]["bias"]),
        "running_mean": _t(variables["batch_stats"]["mean"]),
        "running_var": _t(variables["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    for call in range(2):
        want, mutated = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                                  groups=groups, mutable=["batch_stats"])
        got = tbn(_t(x), groups)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, err_msg=f"call {call}")
        stats = mutated["batch_stats"]
        np.testing.assert_allclose(_np(tbn.running_mean), np.asarray(stats["mean"]), rtol=1e-5)
        np.testing.assert_allclose(_np(tbn.running_var), np.asarray(stats["var"]), rtol=1e-5)
        variables = {"params": variables["params"], "batch_stats": stats}


# ---------------------------------------------------------------- losses --


def _loss_inputs(B=2, D=4, H=6, W=8, seed=13):
    """Inverse-depth hypotheses with per-pixel jitter, a GT depth inside and
    outside their span, a partial mask and a softmax distribution."""
    rng = np.random.default_rng(seed)
    inv = np.linspace(1 / 900.0, 1 / 450.0, D)[None, :, None, None]
    hypo = (1.0 / (inv * (1 + 0.02 * rng.standard_normal((B, D, H, W))))).astype(np.float32)
    gt = rng.uniform(400, 950, (B, H, W)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.3
    logits = rng.standard_normal((B, D, H, W)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return hypo, gt, mask, attn.astype(np.float32)


@pytest.mark.parametrize("continuous", [False, True])
def test_sinkhorn_loss_and_grad_match_jax(continuous):
    """Sinkhorn OT loss (discrete one-hot GT bin and the continuous virtual
    bin), value and gradient with respect to the attention, against JAX:
    rtol 1e-5 on the value, 1e-5 of max|grad| on the gradient (float32
    logsumexp in another order)."""
    hypo, gt, mask, attn = _loss_inputs()
    kw = dict(iters=3, eps=1.0, continuous=continuous)
    want, jgrad = jax.value_and_grad(
        lambda a: jax_sinkhorn_loss(jnp.asarray(gt), jnp.asarray(hypo), a,
                                    jnp.asarray(mask), **kw))(jnp.asarray(attn))
    ta = _t(attn).requires_grad_()
    got = sinkhorn_loss(_t(gt), _t(hypo), ta, _t(mask), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close(ta.grad, jgrad, 1e-5, "d attn")


def test_mvs4net_loss_matches_jax():
    """``mvs4net_loss`` with the recipe's weights (mono L1 on stages 2-4,
    OT, range diagnostic), total and every aux scalar against JAX: rtol
    1e-5."""
    rng = np.random.default_rng(14)
    outputs, depth, mask = {}, {}, {}
    for s in range(4):
        D, H, W = (8, 8, 4, 4)[s], 4 << s, 6 << s
        hypo, gt, m, attn = _loss_inputs(D=D, H=H, W=W, seed=20 + s)
        stage = {"hypo_depth": hypo, "attn_weight": attn}
        if s:
            stage["mono_depth"] = rng.uniform(400, 950, (2, H, W)).astype(np.float32)
        outputs[f"stage{s + 1}"], depth[f"stage{s + 1}"] = stage, gt
        mask[f"stage{s + 1}"] = m.astype(np.float32)
    jt, jaux = jax_mvs4net_loss(
        jax.tree_util.tree_map(jnp.asarray, outputs), jax.tree_util.tree_map(jnp.asarray, depth),
        jax.tree_util.tree_map(jnp.asarray, mask), JaxLossConfig(**RECIPE_LOSS))
    tt, taux = mvs4net_loss(
        {k: {n: _t(a) for n, a in v.items()} for k, v in outputs.items()},
        {k: _t(v) for k, v in depth.items()}, {k: _t(v) for k, v in mask.items()},
        LossConfig(**RECIPE_LOSS))
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
    assert taux.keys() == jaux.keys()
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)


def test_depth_metrics_match_jax():
    """``depth_metrics`` with and without the ``valid`` weights: rtol 1e-6."""
    rng = np.random.default_rng(15)
    gt = rng.uniform(400, 950, (2, 16, 20)).astype(np.float32)
    est = gt + rng.normal(0, 4, gt.shape).astype(np.float32)
    mask = rng.uniform(size=gt.shape) > 0.4
    for valid in (None, np.array([1.0, 0.0], np.float32)):
        want = jax_metrics.depth_metrics(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask),
                                         None if valid is None else jnp.asarray(valid))
        got = tmetrics.depth_metrics(_t(est), _t(gt), _t(mask),
                                     None if valid is None else _t(valid))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["MS", "cos", "onecycle", "CyclicLR_tri2", "exponent"])
def test_schedules_match_jax(name):
    """Every scheduler of ``make_schedule`` at steps across warmup,
    milestones, cycles and past the end: rtol 1e-5, atol 1e-9 (1e-6 of the
    base rate): JAX evaluates in float32, the port in float64, and near the
    end of a cosine ``1 + cos`` cancels in float32."""
    kw = dict(milestones_iters=(30, 60), gamma=0.5, total_steps=100, warmup_iters=20,
              steps_per_epoch=25)
    jsched = jax_schedule.make_schedule(name, 1e-3, **kw)
    tsched = tschedule.make_schedule(name, 1e-3, **kw)
    for step in (0, 1, 7, 19, 20, 29, 30, 31, 45, 59, 60, 99, 100, 140):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-5,
                                   atol=1e-9, err_msg=f"{name} step {step}")


def test_adam_update_matches_optax():
    """The port's optimizer (``torch.optim.Adam``, L2 weight decay in the
    gradient) against the JAX package's ``make_optimizer`` (``optax``
    ``add_decayed_weights`` + ``adam``), fed the same gradients for three
    steps of a warmup schedule, some gradients near zero: rtol 1e-5,
    atol 1e-8 on the parameters."""
    rng = np.random.default_rng(16)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jsched = jax_schedule.warmup_multistep(1e-3, [2], 0.5, warmup_iters=2)
    tx = jax_step.make_optimizer(jsched, weight_decay=1e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(_t(v)))
    opt = make_optimizer(module, weight_decay=1e-4)
    tsched = tschedule.warmup_multistep(1e-3, [2], 0.5, warmup_iters=2)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        for group in opt.param_groups:
            group["lr"] = tsched(i)
        for k, p in module.named_parameters():
            p.grad = _t(g[k])
        opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(_np(p), np.asarray(jparams[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)


# ------------------------------------------------------ the whole step --

# 64 x 128: the smallest non-square input whose 1/8 stage still halves
# three times in reg2d (stage 1 is 8 x 16)
STEP_B, STEP_V, STEP_H, STEP_W = 2, 3, 64, 128


def _step_cfg():
    return JaxModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
        mono=True, attn_temp=2.0, dtype="float32", remat=False,
        warp_impl="gather", fused_topdown=False, pack_conv=False,
    )


def _grad_capture():
    """An optax transformation whose state after one update is that
    update's gradient tree, and whose update is zero: it reads the
    gradients out of the JAX package's own ``make_train_step``."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


@pytest.fixture(scope="module")
def one_step():
    """One train step of each framework from the same seeded weights and
    BatchNorm statistics (the flax tree of a train-mode init, so with the
    mono decoder) on the same plane scenes: the JAX step compiled once."""
    batch = batch_samples([make_plane_scene(V=STEP_V, H=STEP_H, W=STEP_W, seed=i)
                           for i in range(STEP_B)])
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jcfg = _step_cfg()
    jnet = JaxMVS4Net(jcfg)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jbatch["imgs"], jbatch["proj_matrices"],
        jbatch["depth_values"], train=True))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    vs = jax.tree_util.tree_map_with_path(fill, shapes)
    tx = _grad_capture()
    state = jax_step.TrainState.create(jax.tree_util.tree_map(jnp.asarray, vs), tx)
    jstep = jax.jit(jax_step.make_train_step(jnet, JaxLossConfig(**RECIPE_LOSS), tx))
    new_state, jscalars = jstep(state, jbatch)

    port = MVS4Net(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs))
    opt = make_optimizer(port, weight_decay=1e-4)
    step = make_train_step(port, LossConfig(**RECIPE_LOSS), opt, lambda s: 1e-3)
    tbatch = batch_to_torch(batch, "cpu")
    grads = {}
    hook = opt.register_step_pre_hook(
        lambda o, a, k: grads.update({n: p.grad.clone() for n, p in port.named_parameters()}))
    tscalars = step(tbatch)
    hook.remove()
    return {
        "jscalars": {k: float(v) for k, v in jscalars.items()},
        "tscalars": {k: v.item() for k, v in tscalars.items()},
        "jgrads": jax_grads_to_port(jax.tree_util.tree_map(np.asarray, new_state.opt_state)),
        "tgrads": grads,
        "jstats": jax_variables_to_state_dict(
            {"params": vs["params"],
             "batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)}),
        "port": port,
        "tbatch": tbatch,
    }


def test_train_step_loss_and_scalars_match_jax(one_step):
    """The loss and every scalar of the step (aux: mono L1, OT, range
    ratio per stage; depth metrics), float32, against the JAX package's
    ``make_train_step`` (``warp_impl="gather"``, fused top-down and packed
    convs off): the loss within 1e-4 relative, each scalar within 1e-4 of
    max(1, |value|) (a depth argmax near-tie that flips moves a metric by
    one pixel's share, ~1e-4 at stage 4)."""
    j, t = one_step["jscalars"], one_step["tscalars"]
    assert t.keys() == j.keys()
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    for k in j:
        assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), (k, t[k], j[k])


def test_train_step_grads_match_jax(one_step):
    """Every parameter's gradient, carried from the flax tree by
    ``jax_grads_to_port``, against the port's. float32 gradients of this
    network are ill-conditioned: perturbing the weights by 1e-6 relative
    moves some tensors' gradients by 5% of their max|grad| (train-mode
    BatchNorm over softmax scores whose gradient sums to ~0 over D), and
    the two frameworks' forwards differ by ~1e-5 in the attention. So:

    - each tensor within 3e-2 of its max|grad| (measured worst 1.0e-2);
    - the median tensor within 1e-4 of its max|grad| (measured 1.3e-5);
    - the reg nets' ``prob.bias``, whose gradient is analytically zero (a
      constant added to every hypothesis' score leaves the softmax as it
      is), below 1e-6 of the largest gradient in both frameworks."""
    jg_, tg_ = one_step["jgrads"], one_step["tgrads"]
    assert jg_.keys() == tg_.keys()
    top = max(float(g.abs().max()) for g in jg_.values())
    rel = []
    for k, want in jg_.items():
        got = tg_[k]
        if k.endswith("prob.bias"):
            assert max(float(want.abs().max()), float(got.abs().max())) <= 1e-6 * top, k
            continue
        scale = float(want.abs().max())
        assert scale > 0, k
        rel.append(float((got - want).abs().max()) / scale)
        assert rel[-1] <= 3e-2, (k, rel[-1])
    assert float(np.median(rel)) <= 1e-4, np.median(rel)


def test_train_step_batchnorm_stats_match_jax(one_step):
    """The running statistics every BatchNorm holds after the step (per
    view in the FPN stem, G momentum updates there) against the JAX step's
    updated ``batch_stats``: rtol 1e-4, atol 1e-5."""
    sd = one_step["port"].state_dict()
    n = 0
    for k, want in one_step["jstats"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_np(sd[k]), _np(want), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            n += 1
    assert n == 2 * (11 + 4 * 10 + 3)      # stem, 4 x reg2d, mono decoder


def _graph_names(root):
    seen, names, stack = set(), [], [root.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def test_train_forward_routes_kernels_through_their_functions(one_step):
    """A train-mode forward records the top-down chain once through
    ``TopDownChain`` and every source view's warp through ``WarpIK`` (4
    stages x 2 source views): the kernels' wrappers never meet autograd.
    The route follows ``train()``/``eval()``, not grad mode, as the JAX
    package's follows its ``train`` flag: an eval forward with grad enabled
    takes neither Function (on the card its kernels then refuse autograd),
    and under ``no_grad`` records nothing."""
    port, b = one_step["port"], one_step["tbatch"]
    port.train()
    out = port(b["imgs"], b["proj_matrices"], b["depth_values"])
    loss, _ = mvs4net_loss(out, b["depth"], b["mask"], LossConfig(**RECIPE_LOSS))
    names = _graph_names(loss)
    assert names.count("TopDownChainBackward") == 1
    assert names.count("WarpIKBackward") == 4 * (STEP_V - 1)
    port.eval()
    out = port(b["imgs"], b["proj_matrices"], b["depth_values"])
    names = _graph_names(out["stage4"]["attn_weight"])
    assert "TopDownChainBackward" not in names and "WarpIKBackward" not in names
    with torch.no_grad():
        out = port(b["imgs"], b["proj_matrices"], b["depth_values"])
    assert out["stage4"]["depth"].grad_fn is None
