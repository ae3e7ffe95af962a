"""The shared checks of the train path and the eval pipeline (``checks.py``)
on the CPU.

On the CPU every kernel wrapper takes its plain version, so these tests
hold the checks themselves: the chain ``autograd.Function``'s hand-written
backward passes its check against autograd of the plain chain; the
train-step comparison passes the CPU's own rounding noise with a wide
margin; and it fails when the warp's backward or the chain's backward is
wrong by 1%, or when gradients stop at either; the pipeline comparison
passes the CPU against itself and fails when the attention accumulation
or the warp + correlation is wrong. The card runs the same
checks against its kernels (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import topdown_chain as op_chain
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import warp as op_warp
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import warp_cor as op_warp_cor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_backward_check_passes_on_cpu(dtype):
    """``TopDownChain`` (K2's plain version on the CPU, ``u`` re-derived in
    the backward) against autograd through the plain chain, within
    ``checks.CHAIN_TOLERANCE`` (2 images, intra 4x6 -> 32x48)."""
    leaves, grads = checks.chain_inputs(2, 4, 6, dtype, "cpu", torch.Generator().manual_seed(1))
    out = checks.check_chain_backward(leaves, grads)
    assert out["max_rel_diff"] <= checks.CHAIN_TOLERANCE[dtype]


@pytest.fixture(scope="module")
def reference_step():
    return checks.train_step_grads(checks.small_step_model(3), checks.small_step_batch("cpu"))


def _pinned_step(reference, **model_kw):
    return checks.train_step_grads(checks.small_step_model(3, **model_kw),
                                   checks.small_step_batch("cpu"), pin=reference["seen"])


@pytest.mark.parametrize("perturb,draw", [(1e-7, 1), (1e-6, 1), (1e-6, 2)])
def test_train_step_check_passes_rounding_noise(reference_step, perturb, draw):
    """The step with every weight moved by ``perturb`` (relative), pinned
    to the reference step, passes the comparison, and the tightly held
    gradients stay 10x inside ``checks.TRAIN_GRAD_EACH``."""
    moved = _pinned_step(reference_step, perturb=perturb, perturb_seed=draw)
    out = checks.compare_train_step(reference_step, moved, "cpu")
    assert out["acts"]["max"] <= checks.TRAIN_GRAD_EACH / 10
    assert out["kernel_fed"]["max"] <= checks.TRAIN_GRAD_EACH / 10


def _scaled(factor):
    return lambda fn: (lambda *a, **k: fn(*a, **k) * factor)


def _lost(ctx, *grads):
    return (None,) * 13            # intra, 3 skips, 3 x (wi, bi, wo)


WRONG = {
    "warp backward 1% high": (op_warp, "warp_bwd", _scaled(1.01)),
    "warp backward lost": (op_warp, "warp_bwd", _scaled(0.0)),
    "chain dwo 1% high": (op_chain, "conv2d_weight", _scaled(1.01)),
    "chain backward lost": (op_chain.TopDownChain, "backward",
                            lambda fn: staticmethod(_lost)),
}


@pytest.mark.parametrize("name", list(WRONG))
def test_train_step_check_catches_a_wrong_backward(reference_step, name):
    """A warp backward (K3's place) or a chain backward (K2's role) that is
    1% off, or that drops its gradients, fails the comparison."""
    owner, attr, wrap = WRONG[name]
    with mock.patch.object(owner, attr, wrap(getattr(owner, attr))):
        wrong = _pinned_step(reference_step)
    with pytest.raises(AssertionError):
        checks.compare_train_step(reference_step, wrong, "cpu")


@pytest.fixture(scope="module")
def reference_pipeline():
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        SyntheticEvalDataset,
    )

    ds = SyntheticEvalDataset(V=4, H=64, W=128)
    return ds, checks.run_pipeline(checks.seeded_model(checks.eval_dtu_config(), 7, "cpu"), ds,
                                   "cpu")


def test_pipeline_check_passes_on_cpu(reference_pipeline):
    """``check_pipeline`` on the CPU against itself: every depth and mask
    equal, the same non-empty cloud."""
    out = checks.check_pipeline("cpu")
    assert out["depth_agreement_min"] == 1.0 and out["final_mask_agreement_min"] == 1.0
    assert out["points_cpu"] == out["points_device"] == len(reference_pipeline[1]["points"]) > 0


def _first_view_only(fn):
    return lambda cors, temp, channels: fn(cors[:1], temp, channels)


def _zero_warp(fn):
    return lambda *a, **k: fn(*a, **k).zero_()


WRONG_EVAL = {
    "attention over the first source view only": (op_warp_cor, "attn_fuse", _first_view_only),
    "group correlation lost": (op_warp_cor, "warp_cor", _zero_warp),
}


@pytest.mark.parametrize("name", list(WRONG_EVAL))
def test_pipeline_check_catches_a_wrong_kernel(reference_pipeline, name):
    """An attention accumulation (K5's place) that reads one source view, or
    a warp + correlation (K1's place) that returns zeros, fails the
    pipeline comparison."""
    ds, reference = reference_pipeline
    owner, attr, wrap = WRONG_EVAL[name]
    with mock.patch.object(owner, attr, wrap(getattr(owner, attr))):
        wrong = checks.run_pipeline(checks.seeded_model(checks.eval_dtu_config(), 7, "cpu"), ds,
                                    "cpu")
    with pytest.raises(AssertionError):
        checks.compare_pipelines(reference, wrong, "cpu")
