#!/usr/bin/env python3
"""Where the port's f32 train step and the JAX package's part: both
against the same step in float64, on the CPU.

    JAX_PLATFORMS=cpu python3 step_precision.py [--batch 4] [--work DIR]

The step is tests/test_torch_train_step.py's tiny exp7_lc step (its batch
drawn at ``--batch`` items, its numpy weights), the batch of
tests/test_torch_mesh_step.py at the default 4. A child process per
precision computes the first step's gradient of:

- f32: JAX's step, JAX's step with its batch-statistics BatchNorm
  replaced by the two-pass closed form (``_two_pass_bn`` of
  tests/test_torch_mesh_step.py: the same function), and the port's step
  on the unchanged images and on three copies moved by one part in 10^6
  (the sensitivity rule of tests/test_torch_train_step.py: 3x the largest
  rel-L2 motion plus 1e-3);
- f64: JAX's step and the port's, each forced to float64 throughout by
  rebinding the float32 names (numpy's, ``jnp``'s, torch's and
  ``Tensor.float``) before either package is imported, on the f32 run's
  inputs widened.

It prints the largest rel-L2 distances between them over all parameters
and each parameter where the port's f32 gradient is outside the rule
against JAX's, with both sides' distance to float64 there.
"""

import argparse
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FD = D = 16


def _child(mode: str, batch: int, work: str) -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(2)
    if mode == "f64":
        jax.config.update("jax_enable_x64", True)
        np.float32 = np.float64
        jnp.float32 = jnp.float64
        torch.float32 = torch.float64
        torch.set_default_dtype(torch.float64)
        torch.Tensor.float = lambda self, *a, **k: self.double()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from depthestimation_tpu.models import layers as jlayers
    from depthestimation_tpu_torch import config as tcfg
    from depthestimation_tpu_torch.data import synthetic as tsyn
    from depthestimation_tpu_torch.losses import get_loss
    from depthestimation_tpu_torch.models.base_model import BaseModelNet
    from depthestimation_tpu_torch.parallel import train_step as ts
    from depthestimation_tpu_torch.weights import load_jax_params
    from test_torch_mesh_step import _two_pass_bn
    from test_torch_train_step import (_CFG, H, W, JModel, cfgs,
                                       jax_value_and_grad, jax_variables,
                                       jnp_dict, port_grads)

    inputs = os.path.join(work, "inputs.pkl")
    if mode == "f32":
        mi, gt = tsyn.make_batch(batch=batch, t_win=1, h=H, w=W, d_min=3.0,
                                 d_max=30.0, ndepth=D, seed=4)
        gt["T_left2right"] = gt["T_left2right"].copy()
        gt["T_left2right"][1, 3] = 0.01
        variables = jax_variables(mi)
        with open(inputs, "wb") as f:
            pickle.dump((mi, gt, variables), f)
        as_tensors = lambda d: tsyn.to_device(d, "cpu")
    else:
        with open(inputs, "rb") as f:
            mi, gt, variables = pickle.load(f)
        wide = lambda d: {k: (v.astype(np.float64) if isinstance(
            v, np.ndarray) and v.dtype.kind == "f" else v)
            for k, v in d.items()}
        mi, gt = wide(mi), wide(gt)
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                           variables)
        as_tensors = lambda d: {k: (torch.as_tensor(v) if isinstance(
            v, np.ndarray) else v) for k, v in d.items()}

    jc, _ = cfgs()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    model_j = JModel(feature_dim=FD, d=D, nmode="exp7_lc")

    def jax_grad(images, bn=None):
        with_bn = jlayers.bn_train_apply
        if bn is not None:
            jlayers.bn_train_apply = bn
        try:
            g = jax_value_and_grad(model_j, jc)(
                params, jnp_dict(images), jnp_dict(gt))[1]
        finally:
            jlayers.bn_train_apply = with_bn
        return {k: torch.as_tensor(np.asarray(v))
                for k, v in port_grads(g).items()}

    cfg = tcfg.config_from_dict(dict(_CFG, train=dict(_CFG["train"],
                                                      batch_size=batch)))

    def port_grad(images):
        model = BaseModelNet(FD, D, "exp7_lc")
        load_jax_params(model, variables)
        if mode == "f64":
            model = model.double()
        state = ts.init_state(model, cfg)
        mi_t, gt_t = as_tensors(images), as_tensors(gt)
        ts.make_train_step(get_loss(cfg))(state, mi_t, mi_t, gt_t, gt_t)
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    out = {"jax": jax_grad(mi), "port": port_grad(mi)}
    if mode == "f32":
        out["jax_two_pass"] = jax_grad(mi, _two_pass_bn)
        out["port_moved"] = [port_grad(dict(mi, rgb=(mi["rgb"] * (
            1 + 1e-6 * np.random.RandomState(s).randn(*mi["rgb"].shape)))
            .astype(np.float32))) for s in range(3)]
    torch.save(out, os.path.join(work, f"{mode}.pt"))


def _report(work: str) -> None:
    import torch

    a = torch.load(os.path.join(work, "f32.pt"))
    b = torch.load(os.path.join(work, "f64.pt"))

    def rel(x, y):
        x, y = x.double(), y.double()
        return (torch.linalg.vector_norm(x - y)
                / torch.linalg.vector_norm(y).clamp_min(1e-300)).item()

    keys = sorted(b["jax"])
    pairs = {"port f64 - JAX f64": (b["port"], b["jax"]),
             "port f32 - f64": (a["port"], b["jax"]),
             "JAX f32 - f64": (a["jax"], b["jax"]),
             "JAX f32 two-pass BN - f64": (a["jax_two_pass"], b["jax"]),
             "port f32 - JAX f32": (a["port"], a["jax"])}
    for name, (x, y) in pairs.items():
        worst = max(keys, key=lambda k: rel(x[k], y[k]))
        print(f"{name}: max rel-L2 {rel(x[worst], y[worst]):.3e} "
              f"({worst})")
    print("outside the rule (port f32 - JAX f32 > 3 x motion + 1e-3):")
    n = 0
    for k in keys:
        bound = 3 * max(rel(m[k], a["port"][k]) for m in a["port_moved"]) \
            + 1e-3
        gap = rel(a["port"][k], a["jax"][k])
        if gap > bound:
            n += 1
            print(f"  {k}: gap {gap:.3e} bound {bound:.3e}; to f64: port "
                  f"{rel(a['port'][k], b['jax'][k]):.3e}, JAX "
                  f"{rel(a['jax'][k], b['jax'][k]):.3e}, JAX two-pass BN "
                  f"{rel(a['jax_two_pass'][k], b['jax'][k]):.3e}")
    print(f"{n} of {len(keys)} parameters outside the rule")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "step_precision"))
    ap.add_argument("--mode", choices=("f32", "f64"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode:
        _child(args.mode, args.batch, args.work)
        return 0
    os.makedirs(args.work, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for mode in ("f32", "f64"):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--mode",
                        mode, "--batch", str(args.batch), "--work",
                        args.work], env=env, check=True)
    _report(args.work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
