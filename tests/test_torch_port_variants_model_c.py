"""The whole eval forward and the parameter round trip of the last four
variants of ``checks.VARIANTS`` (the ConvNeXt pyramids, the DCN heads with
BatchNorm and with GroupNorm): the port against the JAX package on the CPU,
by the checks of ``test_torch_port_variants_model_a.py``."""

from __future__ import annotations

import pytest

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.checks import VARIANTS
from test_torch_port_variants_model_a import check_eval_forward, check_round_trip

NAMES = [name for name, _ in VARIANTS[9:]]


@pytest.mark.parametrize("name", NAMES)
def test_variant_eval_forward_matches_jax(name):
    check_eval_forward(name)


@pytest.mark.parametrize("name", NAMES)
def test_variant_state_dict_round_trip(name):
    check_round_trip(name)
