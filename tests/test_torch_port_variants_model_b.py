"""The whole eval forward and the parameter round trip of the next four
variants of ``checks.VARIANTS`` (the PAM and PDAM mid blocks, GroupNorm,
ASFF) and of two combinations of variants: the port against the JAX
package on the CPU, by the checks of ``test_torch_port_variants_model_a.py``."""

from __future__ import annotations

import pytest

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.checks import VARIANTS
from test_torch_port_variants_model_a import check_eval_forward, check_round_trip

NAMES = [name for name, _ in VARIANTS[5:9]] + ["combined_reg2d", "combined_reg3d"]


@pytest.mark.parametrize("name", NAMES)
def test_variant_eval_forward_matches_jax(name):
    check_eval_forward(name)


@pytest.mark.filterwarnings("ignore:pos_enc=2")
@pytest.mark.parametrize("name", NAMES)
def test_variant_state_dict_round_trip(name):
    check_round_trip(name)
