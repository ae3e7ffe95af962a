"""The modules of the model variants, one by one: the PyTorch port's against
the JAX package's, on the CPU, at small sizes.

Each case fills the JAX module's variables (the shapes of a train-mode
init, from ``jax.eval_shape``) with seeded numpy values, carries them to the
port's module through the port's key tables (``utils/jax_params.py``), and
runs both on the same seeded inputs in eval or train mode: the outputs
within 1e-5 of max|JAX|; one vector-Jacobian product (a seeded cotangent)
through each, its gradients at every input and every parameter within 1e-4
of max|JAX| per tensor; in train mode the BatchNorm running statistics
within 1e-5. The JAX side runs in float32 under ``jax.jit``.

Cases: the positional encodings, Reg3D (down 3 at D 8, down 2 at D 4), the
four attention mid blocks, the GroupNorm ConvBnReLU, ASFF at each level
(the views folded into the batch on the port's side, one call per view on
the JAX side, as its ``MVS4Net`` makes them), the two ConvNeXt blocks and
pyramids (training through the top-down chain's ``autograd.Function``),
the deformable conv with an offset conv that moves every tap off the pixel
grid, and the DCN head with BatchNorm (per view) or GroupNorm. Then K6's
route rule for the new blocks, and the configurations ``MVS4Net`` refuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import fpn as jfpn
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import layers as jlayers
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import posenc as jposenc
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import reg as jreg
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import fpn as pfpn
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as players
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import posenc as pposenc
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import reg as preg
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import jax_params as jp

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _fill(shapes, seed):
    """Seeded values in the shapes of a flax variables tree: kernels ~
    N(0, 1/fan_in), scales and running variances in [0.5, 2], everything
    else (biases, means, layer scales, embeddings) ~ N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _run(jmod, pmod, xs, entries, *, train, has_train=True, views=1, per_view=False,
         strip="m.", seed=0):
    """Both modules on ``xs`` (numpy); every check is an assertion.
    ``entries(table)`` fills the key table of the JAX tree under flax name
    ``m`` (torch prefix ``strip``). ``views`` > 1 hands the port's module
    ``view_groups=views``; with ``per_view`` the JAX module is called once
    per view (fold index ``b*views + v``), threading its BatchNorm
    statistics, else once on the folded batch."""
    rng = np.random.default_rng(seed + 100)
    kw = {"train": True} if has_train else {}
    calls = ([[x[v::views] for x in xs] for v in range(views)] if per_view else [xs])
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *calls[0], **kw))
    vs = _fill(shapes, seed)
    params, stats = vs.get("params", {}), vs.get("batch_stats", {})
    n = len(xs)

    def forward(p, bs, *flat):
        outs = []
        for c in range(len(calls)):
            xc = flat[c * n:(c + 1) * n]
            if has_train:
                o, upd = jmod.apply({"params": p, "batch_stats": bs}, *xc, train=train,
                                    mutable=["batch_stats"])
                bs = upd.get("batch_stats", bs)
            else:
                o = jmod.apply({"params": p}, *xc)
            outs.append(o)
        return outs, bs

    @jax.jit
    def run(p, bs, flat, cot):
        outs, vjp, new_bs = jax.vjp(lambda p_, *f: forward(p_, bs, *f), p, *flat, has_aux=True)
        return outs, new_bs, vjp(cot)

    flat = [jnp.asarray(x) for xc in calls for x in xc]
    out_shapes = jax.eval_shape(lambda: forward(params, stats, *flat)[0])
    cot = [rng.standard_normal(s.shape).astype(np.float32) for s in out_shapes]
    outs, new_stats, grads = run(params, stats, flat, cot)

    def folded(arrs):
        """Per-call arrays -> the port's folded layout."""
        a = np.stack([np.asarray(x) for x in arrs], 1)
        return a.reshape(-1, *a.shape[2:])

    table = []
    entries(table)
    sd = jp.entries_to_state_dict(table, {"params": {"m": params}, "batch_stats": {"m": stats}})
    pmod.load_state_dict({k[len(strip):]: v for k, v in sd.items()})
    pmod.train(train)
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    got = pmod(*txs, view_groups=views) if views > 1 else pmod(*txs)
    _close(got, folded(outs), OUT_RTOL, "output")
    got.backward(torch.from_numpy(folded(cot)))

    dparams, dxs = grads[0], grads[1:]
    for i, x in enumerate(txs):
        # an input the module detaches (the pos-enc hypotheses) has none
        got_dx = torch.zeros_like(x) if x.grad is None else x.grad
        _close(got_dx, folded(dxs[i::n]), GRAD_RTOL, f"input {i} gradient")
    gsd = jp.entries_to_state_dict([e for e in table if e[0] == "params"],
                                   {"params": {"m": dparams}})
    named = dict(pmod.named_parameters())
    assert {k[len(strip):] for k in gsd} == set(named)
    for k, g in gsd.items():
        _close(named[k[len(strip):]].grad, g, GRAD_RTOL, f"gradient {k}")
    if train and stats:
        ssd = jp.entries_to_state_dict([e for e in table if e[0] == "batch_stats"],
                                       {"batch_stats": {"m": new_stats}})
        buffers = dict(pmod.named_buffers())
        for k, want in ssd.items():
            if not k.endswith("num_batches_tracked"):
                _close(buffers[k[len(strip):]], want, OUT_RTOL, f"running stat {k}")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- pos-enc --


def test_posenc_sine_matches_jax():
    x = _rand(1, 2, 4, 3, 5, 8)
    depth = np.random.default_rng(2).uniform(425, 935, (2, 4, 3, 5)).astype(np.float32)
    _run(jposenc.PosEncSine(), pposenc.PosEncSine(), [x, depth], lambda t: None,
         train=False, has_train=False)


def test_posenc_learned_matches_jax():
    def entries(t):
        t.append(("params", "m/depth_embed", "m.depth_embed", jp._vec))

    _run(jposenc.PosEncLearned(4, 8), pposenc.PosEncLearned(4, 8), [_rand(1, 2, 4, 3, 5, 8)],
         entries, train=False, has_train=False)


# ------------------------------------------------------------------ reg3d --


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("down,D,hw", [(3, 8, (8, 8)), (2, 4, (8, 12))])
def test_reg3d_matches_jax(down, D, hw, train):
    x = _rand(3, 2 * D, *hw, 4)
    _run(jreg.Reg3D(base_channels=8, down_size=down, depth=D), preg.Reg3D(4, 8, down, D), [x],
         lambda t: jp._reg3d_entries(t, "m", "m", down), train=train)


# ------------------------------------------------------------ agg blocks --


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("agg", ["ConvBnReLU3D_CAM", "ConvBnReLU3D_DCAM", "ConvBnReLU3D_PAM",
                                 "ConvBnReLU3D_PDAM"])
def test_attention_mid_block_matches_jax(agg, train):
    D = 4
    x = _rand(4, 2 * D, 6, 8, 16)
    _run(jlayers.AGG_BLOCKS[agg](16, depth=D), players.AGG_BLOCKS[agg](16, 16, depth=D), [x],
         lambda t: jp._agg_block(t, "m", "m", agg), train=train)


# ------------------------------------------------------------- GroupNorm --


def test_groupnorm_conv_block_matches_jax():
    x = _rand(5, 2, 10, 12, 8)
    _run(jlayers.ConvBnReLU(16, 3, gn=True), players.ConvBnReLU(8, 16, 3, gn=True), [x],
         lambda t: jp._conv_bn_relu(t, "m", "m", gn=True), train=False)


# ------------------------------------------------------------------ ASFF --


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_asff_matches_jax_per_view(level, train):
    """Base 4, two views of two images: the port folds the views into the
    batch (per-view train statistics by ``view_groups``), the JAX package
    calls the module once per view."""
    b, n = 4, 4
    xs = [_rand(10 + k, n, 2 << k, 3 << k, (8 * b) >> k) for k in range(4)]

    class Folded(pfpn.ASFF):
        def forward(self, *feats, view_groups=1):
            return super().forward(feats, view_groups)

    _run(jfpn.ASFF(level, b), Folded(level, b), xs,
         lambda t: jp._asff_level_entries(t, "m", "m", level), train=train, views=2,
         per_view=True)


# -------------------------------------------------------------- ConvNeXt --


@pytest.mark.parametrize("patchify", [False, True])
def test_convnext_block_matches_jax(patchify):
    jcls, pcls = ((jfpn.ConvNeXt4Block, pfpn.ConvNeXt4Block) if patchify
                  else (jfpn.ConvNeXtBlock, pfpn.ConvNeXtBlock))
    _run(jcls(8), pcls(8), [_rand(6, 2, 12, 16, 8)],
         lambda t: jp._convnext_block_entries(t, "m", "m", patchify), train=False,
         has_train=False)


@pytest.mark.parametrize("patchify", [False, True])
def test_convnext_pyramid_trains_like_jax(patchify):
    """The whole ConvNeXt pyramid at base 4 in train mode, two views of two
    images: per-view stem statistics, and the top-down levels through the
    chain's ``autograd.Function`` (K2's plain version here) against the JAX
    package's unfused top-down."""
    class Pyramid(pfpn.FPN4ConvNeXt):
        def forward(self, x, view_groups=1):
            return torch.cat([o.reshape(o.shape[0], -1)
                              for o in super().forward(x, view_groups)], 1)

    class JPyramid(jfpn.FPN4ConvNeXt):
        def __call__(self, x, train):
            return jnp.concatenate([o.reshape(o.shape[0], -1) for o in super().__call__(x, train)],
                                   1)

    _run(JPyramid(4, patchify=patchify, view_groups=2), Pyramid(4, patchify=patchify),
         [_rand(7, 4, 32, 48, 3)],
         lambda t: jp._fpn4_convnext_entries(t, "m", patchify), train=True, views=2,
         strip="feature.")


# ------------------------------------------------------------------- DCN --


def test_deform_conv_matches_jax_off_the_pixel_grid():
    """The offset conv's weights are drawn (not its zero init): every tap
    lands between pixels, some outside the image, and the coordinate
    gradient reaches the offset conv."""
    _run(jfpn.DeformConv2d(6), pfpn.DeformConv2d(6, 6), [_rand(8, 2, 10, 12, 6)],
         lambda t: jp._dcn_entries(t, "m", "m"), train=False, has_train=False)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("gn", [False, True])
def test_dcn_head_matches_jax(gn, train):
    _run(jfpn.NADCN(8, gn=gn, view_groups=2), pfpn.NADCN(8, gn), [_rand(9, 4, 10, 12, 8)],
         lambda t: jp._nadcn_entries(t, "m", "m", gn), train=train, views=2)


# ------------------------------------------------------ routes and errors --


def test_band_conv_route_takes_batchnorm_relu_blocks_only():
    """K6 folds a BatchNorm and fuses the ReLU: in eval a 3x3 stride-1
    block with both takes it, a GroupNorm block or one without ReLU (ASFF's
    weight heads are 1x1, but the rule holds for any) does not."""
    bn = players.ConvBnReLU(8, 8, 3).eval()
    gn = players.ConvBnReLU(8, 8, 3, gn=True).eval()
    no_relu = players.ConvBnReLU(8, 8, 3, relu=False).eval()
    route = players._band_conv_route
    assert route(bn, bn.conv.weight, torch.bfloat16)
    assert not route(gn, gn.conv.weight, torch.bfloat16)
    assert not route(no_relu, no_relu.conv.weight, torch.bfloat16)
    assert not route(bn.train(), bn.conv.weight, torch.bfloat16)


def test_unknown_variant_fields_raise():
    with pytest.raises(ValueError, match="arch_mode"):
        MVS4Net(ModelConfig(arch_mode="fpn_vit"), device="cpu")
    with pytest.raises(KeyError):
        MVS4Net(ModelConfig(agg_type="ConvBnReLU3D_XAM"), device="cpu")
