"""The port's bf16 train step against the JAX bf16 train step, by
tests/TOLERANCES.md rule 4.

The port's bf16 step (its kernel wrappers on CPU tensors, so the plain
versions with the kernels' rounding points) and the JAX bf16 step (both
Pallas kernels in interpret mode, the eager encoder: ``convbn2d=False``)
start from the same weights on the same batch, both on the eager encoder
and decoder (``convbn2d`` False; the fused route is held in
tests/test_torch_train_step_fused.py). Each is measured against
the f32 oracle, the port's f32 step (which tests/test_torch_train_step.py
holds to JAX's): the loss (relative difference) and the gradient of each
of the encoder, BV head, Base3D and decoder (rel-L2). The port's distance
must be within 3x the JAX distance plus 0.4%."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from depthestimation_tpu.models.base_model import BaseModelNet as JModel
from test_torch_train_step import (D, FD, cfgs, jax_value_and_grad,
                                   jax_variables, jnp_dict, make_batch,
                                   port_grads, port_step, rel)

GROUPS = ("base_encoder.", "conv0", "based_3d.", "base_decoder.")


def _group_rel(grads, oracle, prefix):
    keys = [k for k in oracle if k.startswith(prefix)]
    return rel(torch.cat([grads[k].flatten() for k in keys]),
               torch.cat([oracle[k].flatten() for k in keys]))


def test_bf16_step_rule4_against_jax_bf16():
    batch = make_batch()
    variables = jax_variables(batch[0])
    jc, _ = cfgs()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    mi, gt = jnp_dict(batch[0]), jnp_dict(batch[1])
    jbf = JModel(feature_dim=FD, d=D, nmode="exp7_lc", dtype=jnp.bfloat16,
                 sweep_pallas="interpret", convcomb_pallas="interpret",
                 convbn2d=False)
    lbf, gbf = jax_value_and_grad(jbf, jc)(params, mi, gt)
    grads_j = port_grads(gbf)
    (l32,), oracle, _, _ = port_step(batch, variables, None)

    losses, grads, _, _ = port_step(batch, variables, torch.bfloat16,
                                    convbn2d=False)
    assert np.isfinite(losses[0])
    assert all(torch.isfinite(g).all() for g in grads.values())
    floor = 4e-3
    d_port = abs(losses[0] - l32) / abs(l32)
    d_jax = abs(float(lbf) - l32) / abs(l32)
    assert d_port <= 3 * d_jax + floor, (d_port, d_jax)
    for prefix in GROUPS:
        dp = _group_rel(grads, oracle, prefix)
        dj = _group_rel(grads_j, oracle, prefix)
        assert dp <= 3 * dj + floor, (prefix, dp, dj)
