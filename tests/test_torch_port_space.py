"""The port's row-sharded eval forward (``--space``) and the data-sharded
eval forward, against its own unsharded forward and against the JAX
package's ``shard_eval_forward_space`` on the conftest's virtual CPU
devices, in float32.

The port runs the space ranks as threads over ``devices=[cpu] * S``
(``parallel.mesh.sharded_eval_forward``); the JAX package runs them as a
``shard_map`` over a (1, S) mesh. Weights are seeded flax variables carried
to the port by ``utils/jax_params.py``; inputs are plane scenes from numpy
seeds. Every tolerance is stated.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.parallel import (
    make_mesh,
    replicate,
    shard_eval_forward_space,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as port_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
    make_eval_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.mvs4net import _row_window
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)

V = 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads, as tests/test_torch_port_train_stack.py sets them:
    with a thread per core, the small model's thousands of operators wait
    at OpenMP barriers for threads that other test workers keep off the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfg():
    return JaxModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
        attn_temp=2.0, dtype="float32", remat=False,
        warp_impl="gather", fused_topdown=False, pack_conv=False,
    )


def _scene(B, H, W):
    return batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)])


def _models(scene, seed=0):
    """The JAX network with seeded numpy variables (the shapes of an
    eval-mode init), and the port with the same weights."""
    jcfg = _cfg()
    jnet = JaxMVS4Net(jcfg)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(scene["imgs"]),
        {k: jnp.asarray(v) for k, v in scene["proj_matrices"].items()},
        jnp.asarray(scene["depth_values"]), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    vs = jax.tree_util.tree_map_with_path(fill, shapes)
    port = MVS4Net(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs))
    return jnet, vs, port


def _port_forward(port, scene, devices=None, space=1, halo=48):
    t = batch_to_torch(scene, "cpu")
    out = make_eval_forward(port, devices, space=space, space_halo=halo)(
        t["imgs"], t["proj_matrices"], t["depth_values"])
    return {k: ([x.numpy() for x in v] if isinstance(v, list) else v.numpy())
            for k, v in out.items()}


@pytest.mark.parametrize("S", [2, 4])
def test_windowed_forward_matches_unsharded(S):
    """256x64, halo 48 (the default, which covers Reg2D's receptive field):
    stage 4 runs on S windows (224 rows at S 2, 160 at S 4), the coarser
    stages whole. Every stage's depth and the stage-4 confidence against
    the unsharded forward at the JAX package's own limits
    (tests/test_spatial_sharding.py): isclose(rtol 1e-4, atol 1e-2) on at
    least 99.5% of the depths, (rtol 1e-3, atol 1e-3) on 99.5% of the
    confidences (measured: every depth equal, the confidences within
    5.6e-4 relative: the windows' convolutions may sum in another order)."""
    scene = _scene(1, 256, 64)
    _, _, port = _models(scene)
    assert _row_window(256, 0, S, 48) is not None and _row_window(128, 0, S, 48) is None
    whole = _port_forward(port, scene)
    rows = _port_forward(port, scene, [torch.device("cpu")] * S, space=S)
    for a, b in zip(rows["stage_depths"], whole["stage_depths"]):
        assert a.shape == b.shape
        assert np.isclose(a, b, rtol=1e-4, atol=1e-2).mean() >= 0.995
    assert np.isclose(rows["confidence"], whole["confidence"], rtol=1e-3, atol=1e-3).mean() \
        >= 0.995


@pytest.mark.parametrize("S", [2, 4])
def test_windowed_forward_matches_jax_shard_eval_forward_space(S):
    """128x64 with ``space_halo=16``: stage 4 windowed at S 2 (96-row
    windows), stages 4 and 3 at S 4 (64 and 48 rows), in both frameworks,
    which then compute the same windows (a halo that short does not cover
    the receptive field, so neither equals its unsharded forward there).
    The port's stage-4 depth and confidence against JAX
    ``shard_eval_forward_space`` on a (1, S) mesh: the depth within 1e-5
    relative at >= 99% of the pixels (an argmax near-tie may flip between
    the frameworks, as in tests/test_torch_port_model.py), the confidence
    within 1e-5 absolute where both depths agree."""
    scene = _scene(1, 128, 64)
    jnet, vs, port = _models(scene, seed=1)
    mesh = make_mesh(jax.devices()[:S], space=S)
    fwd = shard_eval_forward_space(jnet, mesh, space_halo=16)
    with mesh:
        jd, jc = fwd(replicate(jax.tree_util.tree_map(jnp.asarray, vs), mesh),
                     jnp.asarray(scene["imgs"]),
                     {k: jnp.asarray(v) for k, v in scene["proj_matrices"].items()},
                     jnp.asarray(scene["depth_values"]))
    jd, jc = np.asarray(jd), np.asarray(jc)
    got = _port_forward(port, scene, ["cpu"] * S, space=S, halo=16)
    assert got["depth"].shape == jd.shape == (1, 128, 64)
    same = np.isclose(got["depth"], jd, rtol=1e-5, atol=0)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(got["confidence"][same], jc[same], atol=1e-5)


def test_data_sharded_forward_and_refusals():
    """``devices=[cpu, cpu]`` with ``space=1`` splits a B2 batch over two
    data shards, which agree with the one-device forward at the limits of
    ``test_windowed_forward_matches_unsharded`` (measured: every depth
    equal, the confidences within 1.6e-3 relative: a batch of one sums its
    convolutions in another order than a batch of two); a batch
    the shards do not divide, a device list that is no (data, space)
    layout, a row-sharded train forward and ``--space`` above the device
    count (the CLI on the CPU, one device) raise."""
    scene = _scene(2, 64, 64)
    _, _, port = _models(scene, seed=2)
    whole = _port_forward(port, scene)
    shards = _port_forward(port, scene, ["cpu", "cpu"])
    assert np.isclose(shards["depth"], whole["depth"], rtol=1e-4, atol=1e-2).mean() >= 0.995
    assert np.isclose(shards["confidence"], whole["confidence"], rtol=1e-3,
                      atol=1e-3).mean() >= 0.995
    t = batch_to_torch(_scene(1, 64, 64), "cpu")
    with pytest.raises(ValueError, match="split"):
        make_eval_forward(port, ["cpu", "cpu"])(t["imgs"], t["proj_matrices"],
                                                t["depth_values"])
    with pytest.raises(ValueError, match="lay out"):
        make_eval_forward(port, ["cpu"] * 3, space=2)
    port.train()
    with pytest.raises(ValueError, match="eval"):
        next(port.forward_steps(t["imgs"], t["proj_matrices"], t["depth_values"],
                                space_shards=2))
    port.eval()
    with pytest.raises(ValueError, match="cards"):
        port_cli.main(["--interval_scale", "1", "--device", "cpu", "--space", "2"])
