"""PWCLite (``models/pwclite.py``) against the JAX package on the same
numpy inputs and the same weights.

- ``weights.load_jax_params`` maps the JAX tree one to one (every leaf
  fills one parameter, none left), at output level 4 and 2 (flax makes a
  1x1 conv only for the levels it reaches).
- ``flow_warp`` and ``grid_sample_pixel`` against JAX: 1e-6 (the same
  index and weight formulas).
- The forward at the default output level 4, 64x64, ``with_bk``: every
  ``flows_fw`` and ``flows_bw`` level within 1e-4 max|JAX| (f32 convs
  summed in another order through 30 layers).
- A 3-frame input takes the pairwise form (the reference seam pinned in
  ROADMAP.md queue 3): its flows are the 2-frame flows of the last two
  frames.
The JAX tree's shapes come from ``jax.eval_shape`` and its values from a
seed; the JAX forward runs once under ``jax.jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.models import pwclite as jp
from depthestimation_tpu.ops.resample import grid_sample_pixel as j_gsp
from depthestimation_tpu_torch.models import pwclite as tp
from depthestimation_tpu_torch.ops.resample import grid_sample_pixel
from depthestimation_tpu_torch.weights import from_jax_params, load_jax_params

HW = 64


def _images(b=1, frames=2, seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(0, 1, (b, 3 * frames, HW, HW)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(output_level=4):
    """The JAX model's parameter tree (shapes from ``jax.eval_shape``, no
    compile), filled from a seed: kernels N(0, 1 / fan_in), biases
    N(0, 0.01)."""
    model = jp.PWCLite(output_level=output_level)
    shapes = jax.eval_shape(
        lambda k, v: model.init(k, v, with_bk=True)["params"],
        jax.random.PRNGKey(0), jnp.asarray(_images()))
    rs = np.random.RandomState(output_level)

    def fill(s):
        if len(s.shape) == 4:
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rs.randn(*s.shape) * 0.01).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


@functools.lru_cache(maxsize=None)
def _jax_model(output_level=4):
    model = jp.PWCLite(output_level=output_level)
    params = _jax_params(output_level)
    out = jax.jit(lambda p, v: model.apply({"params": p}, v, with_bk=True))(
        params, jnp.asarray(_images()))
    return params, _np_tree(out)


def _torch_model(params, **kw):
    model = tp.PWCLite(**kw)
    load_jax_params(model, {"params": params})
    return model


@pytest.mark.parametrize("level", [4, 2])
def test_jax_tree_maps_one_to_one(level):
    params = _jax_params(level)
    sd = from_jax_params({"params": params})
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    model = _torch_model(params, output_level=level)
    assert set(model.state_dict()) == set(sd)
    assert "conv1x1_2.weight" in sd
    assert ("conv1x1_3.weight" in sd) == (level > 2)


def test_flow_warp_and_grid_sample_pixel_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 9, 11).astype(np.float32)
    flow = (rs.randn(2, 2, 9, 11) * 3).astype(np.float32)
    want = jp.flow_warp(jnp.asarray(x), jnp.asarray(flow))
    got = tp.flow_warp(torch.from_numpy(x), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    pix = (rs.rand(2, 5, 7, 2) * 14 - 2).astype(np.float32)
    for mode in ("bilinear", "nearest"):
        want = jax.vmap(lambda im, p: j_gsp(im, p, mode))(jnp.asarray(x),
                                                          jnp.asarray(pix))
        got = grid_sample_pixel(torch.from_numpy(x), torch.from_numpy(pix),
                                mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_forward_with_bk_matches_jax():
    params, want = _jax_model(4)
    model = _torch_model(params)
    with torch.no_grad():
        got = model(torch.from_numpy(_images()), with_bk=True)
    for key in ("flows_fw", "flows_bw"):
        assert len(got[key]) == len(want[key]) == 5
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape
            scale = np.abs(w).max()
            assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, key
    assert got["flows_fw"][0].shape == (1, 2, HW, HW)
    # on the CPU both correlation routes run the plain version
    model.use_kernels = False
    with torch.no_grad():
        plain = model(torch.from_numpy(_images()))
    np.testing.assert_array_equal(plain["flows_fw"][0].numpy(),
                                  got["flows_fw"][0].numpy())


def test_three_frames_take_the_pairwise_form():
    params = _jax_params(4)
    model = _torch_model(params, n_frames=3)
    x = torch.from_numpy(_images(frames=3, seed=2))
    with torch.no_grad():
        three = model(x, with_bk=True)
        two = model(x[:, 3:], with_bk=True)
    for key in ("flows_fw", "flows_bw"):
        for a, b in zip(three[key], two[key]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_output_level_past_the_1x1_convs_raises():
    with pytest.raises(ValueError):
        tp.PWCLite(output_level=5)
