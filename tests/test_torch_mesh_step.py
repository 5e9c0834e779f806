"""Data-parallel training of the port (``parallel/mesh.py``) over two gloo
ranks on the CPU against the JAX package's step on the whole batch.

One spawn of two ranks (``torch.multiprocessing``, a ``FileStore`` in the
test's directory, one torch thread each) runs, from the same weights
(``weights.load_jax_params``):

- the tiny exp7_lc step of tests/test_torch_train_step.py at B=2 per rank,
  f32 and bf16 (the eager encoder, the fused Base3D blocks), the two
  halves of one B=4 batch;
- the CLI (``train.main``) on a tiny synthetic config of 7 training
  trajectories (rank 0 loads 4, rank 1 loads 3: 2 batches against 1 at
  B=2) whose rank-1 trajectories have an invalid second frame, for one
  epoch and its validation, then ``--resume`` for a second epoch.

Held here: the losses of 3 two-rank f32 Adam steps against JAX's B=4
steps at rtol 1e-5 (tests/test_torch_train_step.py's rule); the averaged
gradient of the first step, for every parameter, against the single
process's B=4 gradient within 3x plus 1e-3 of the largest rel-L2 by
which that gradient moves under a 1e-6 change of the images (the same
file's rule), and against JAX's B=4 gradient within that bound plus
JAX's own f32 rounding: the distance from JAX's gradient to JAX's with
its BatchNorm computed by the two-pass closed form (``_two_pass_bn``,
the same function). At this batch JAX's f32 BatchNorm puts nine
gradients outside the rule: six of Base3D's last three layers, 0.33-0.70%
from their float64 value against bounds of 0.16-0.29%, and three of the
decoder, 0.81-1.14% against 0.70-0.86%; there the port is within 5.4e-6
of float64 and the two-pass JAX step within 1.2e-5 (step_precision.py,
which also shows the two packages' float64 steps 1.8e-13 apart). The
bf16 step by rule 4 against JAX's bf16 step at B=4
(tests/test_torch_train_step_bf16.py); the two ranks' losses, gradients
and parameters bit-equal; a group of one bit-equal to no group; and in
the CLI equal step counts (the fewest rank's, less the skipped frame, on
both ranks), one checkpoint written by
rank 0, the resume at epoch 1, bit-equal parameters at the end, the
same five validation metrics on both ranks, and the generators seeded
from the config's seed on rank 0 and another on rank 1.

JAX is imported inside the fixtures: the spawned ranks import this module
for their entry point and load only the port.
"""

import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from depthestimation_tpu_torch import config as tcfg
from depthestimation_tpu_torch.data import synthetic as tsyn
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models.base_model import BaseModelNet
from depthestimation_tpu_torch.parallel import mesh
from depthestimation_tpu_torch.parallel import train_step as ts
from depthestimation_tpu_torch.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
#: the spawned ranks' time limit (they take a few seconds alone)
JOIN_SECONDS = 600
FD = D = 16
B = 4                       # the global batch: B // WORLD per rank
# the batch's arrays shared by its items (no leading batch axis)
_SHARED = ("d_candi", "d_candi_up", "T_left2right")
# the CLI run: 7 training trajectories at B=2 per rank
CLI_TRAJ, CLI_B = 7, 2


def _init_group(root: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


def _half(d: dict, rank: int) -> dict:
    n = B // WORLD
    return {k: (v[rank * n:(rank + 1) * n] if isinstance(v, np.ndarray)
                and k not in _SHARED else v) for k, v in d.items()}


def port_step(inp: dict, dtype, rank=None, steps=1):
    """([loss of each step], {name: grad of the first step}, {name: param
    after the last}) of ``steps`` port steps on the whole batch (``rank``
    None) or on this rank's half."""
    cfg = tcfg.config_from_dict(inp["cfg"])
    mi_np, gt_np = inp["batch"]
    if rank is not None:
        mi_np, gt_np = _half(mi_np, rank), _half(gt_np, rank)
    model = BaseModelNet(FD, D, "exp7_lc", dtype=dtype, convbn2d=False)
    load_jax_params(model, inp["variables"])
    state = ts.init_state(model, cfg)
    mi = tsyn.to_device(mi_np, "cpu")
    gt = tsyn.to_device(gt_np, "cpu")
    step = ts.make_train_step(get_loss(cfg))
    losses, grads = [], None
    for _ in range(steps):
        state, loss, _ = step(state, mi, mi, gt, gt)
        losses.append(loss.item())
        grads = grads or {k: p.grad.clone()
                          for k, p in model.named_parameters()}
    return (losses, grads,
            {k: p.detach().clone() for k, p in model.named_parameters()})


def _cli(root: str, rank: int) -> dict:
    """Two CLI runs (one epoch, then ``--resume`` for a second) on a tiny
    synthetic config with an odd trajectory count and an invalid frame in
    rank 1's trajectories; what each rank saw."""
    from depthestimation_tpu_torch import train as ttrain
    from depthestimation_tpu_torch.data import video_synthetic as vs
    from depthestimation_tpu_torch.trainer import checkpoint as ckpt
    from depthestimation_tpu_torch.trainer import default as tdefault

    base = vs.SyntheticStereoVideoDataset

    class Uneven(base):
        """CLI_TRAJ training trajectories; frame 1 of the odd ones (rank
        1's) comes back broken."""

        def __init__(self, n_traj, seed=0, **kw):
            self._train = seed == 1
            super().__init__(n_traj=CLI_TRAJ if self._train else n_traj,
                             seed=seed, **kw)

        def frame(self, i, t):
            if self._train and i % 2 == 1 and t == 1:
                return {"success": False}
            return super().frame(i, t)

    saves = []
    real_save = ckpt.save_checkpoint

    def save(*a, **k):
        saves.append(rank)
        return real_save(*a, **k)

    vs.SyntheticStereoVideoDataset = Uneven
    tdefault.ckpt.save_checkpoint = save
    cwd = os.getcwd()
    os.chdir(root)
    try:
        path = os.path.join(root, "cli.json")
        out = {}
        for run, extra in (("first", []), ("second", ["--resume"])):
            if rank == 0:
                with open(os.path.join(ROOT, "configs",
                                       "test_tiny.json")) as f:
                    raw = json.load(f)
                raw["data"]["exp_name"] = "mesh_cli"
                raw["train"]["epoch_num"] = 1 if run == "first" else 2
                with open(path, "w") as f:
                    json.dump(raw, f)
            mesh.barrier("config")
            tr = ttrain.main(["--config", path, "--synthetic", "-b",
                              str(CLI_B)] + extra, device="cpu")
            out[run] = {
                "steps": len(tr._last_epoch_losses),
                "epoch_length": tr.train_loader.epoch_length(),
                "i_epoch": tr.i_epoch, "metrics": tr.last_metrics,
                "seed": tr.generator.initial_seed(),
                "losses": tr._last_epoch_losses,
                "params": {k: v.clone() for k, v in
                           tr.model.state_dict().items()}}
        out["saves"] = saves
        return out
    finally:
        os.chdir(cwd)
        vs.SyntheticStereoVideoDataset = base
        tdefault.ckpt.save_checkpoint = real_save


def _worker(rank: int, root: str) -> None:
    _init_group(root, rank, WORLD)
    try:
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = {"f32": port_step(inp, None, rank, steps=3),
               "bf16": port_step(inp, torch.bfloat16, rank),
               "cli": _cli(root, rank)}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are too small for more threads, and the suite's other
    workers, JAX's own and the spawned ranks share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs (a B=4 batch and a JAX parameter tree drawn with numpy,
    both from tests/test_torch_train_step.py) and the two ranks, started;
    ``results`` joins them."""
    from test_torch_train_step import _CFG, H, W, jax_variables

    root = str(tmp_path_factory.mktemp("mesh_step"))
    cfg = dict(_CFG, train=dict(_CFG["train"], batch_size=B // WORLD))
    # tests/test_torch_train_step.py's batch (make_batch) at B items
    mi, gt = tsyn.make_batch(batch=B, t_win=1, h=H, w=W, d_min=3.0,
                             d_max=30.0, ndepth=D, seed=4)
    gt["T_left2right"] = gt["T_left2right"].copy()
    gt["T_left2right"][1, 3] = 0.01
    variables = jax_variables(mi)
    inp = {"cfg": cfg, "batch": (mi, gt), "variables": variables}
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    ctx = tmp.start_processes(_worker, args=(root,), nprocs=WORLD,
                              join=False, start_method="spawn")
    yield {"root": root, "ctx": ctx, "inp": inp}
    for proc in ctx.processes:           # a rank left behind by a failure
        if proc.is_alive():
            proc.terminate()
            proc.join(10)


def _two_pass_bn(x, scale, bias, eps):
    """JAX's batch-statistics BatchNorm (``layers.bn_train_apply``) as
    autodiff of the two-pass closed form: the same function, without the
    single-pass variance E[x^2] - E[x]^2 and the folded VJP."""
    import jax
    import jax.numpy as jnp

    axes = tuple(range(x.ndim - 1))
    xf = x.astype(jnp.float32)
    mean = xf.mean(axes)
    var = jnp.square(xf - mean).mean(axes)
    y = (xf - mean) * jax.lax.rsqrt(var + eps) * scale + bias
    return y.astype(x.dtype)


@pytest.fixture(scope="module")
def jax_f32(spawned):
    """JAX's f32 losses of 3 Adam steps and first gradient on the whole
    batch, and that gradient with ``_two_pass_bn``, while the ranks run."""
    import jax
    import jax.numpy as jnp
    import optax
    from depthestimation_tpu.models import layers as jlayers
    from test_torch_train_step import (JModel, cfgs, jax_value_and_grad,
                                       jnp_dict, jts, port_grads)

    jc, _ = cfgs()
    mi, gt = jnp_dict(spawned["inp"]["batch"][0]), jnp_dict(
        spawned["inp"]["batch"][1])
    params = jax.tree_util.tree_map(jnp.asarray,
                                    spawned["inp"]["variables"]["params"])
    model = JModel(feature_dim=FD, d=D, nmode="exp7_lc")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "bn_train_apply", _two_pass_bn)
        two_pass = port_grads(jax_value_and_grad(model, jc)(params, mi,
                                                            gt)[1])
    vg = jax_value_and_grad(model, jc)
    tx = jts.make_optimizer(jc, params)
    opt = tx.init(params)
    losses, grads = [], None
    for _ in range(3):
        loss, g = vg(params, mi, gt)
        grads = grads or port_grads(g)
        losses.append(float(loss))
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return losses, grads, two_pass


@pytest.fixture(scope="module")
def jax_bf16(spawned):
    """JAX's bf16 loss and gradient on the whole batch (both Pallas
    kernels in interpret mode, the eager encoder)."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import (JModel, cfgs, jax_value_and_grad,
                                       jnp_dict, port_grads)

    jc, _ = cfgs()
    mi, gt = spawned["inp"]["batch"]
    params = jax.tree_util.tree_map(jnp.asarray,
                                    spawned["inp"]["variables"]["params"])
    jbf = JModel(feature_dim=FD, d=D, nmode="exp7_lc", dtype=jnp.bfloat16,
                 sweep_pallas="interpret", convcomb_pallas="interpret",
                 convbn2d=False)
    loss, g = jax_value_and_grad(jbf, jc)(params, jnp_dict(mi), jnp_dict(gt))
    return float(loss), port_grads(g)


@pytest.fixture(scope="module")
def results(spawned, jax_f32, jax_bf16):
    """The ranks' results, joined after JAX's steps (which run while the
    ranks do)."""
    ctx = spawned["ctx"]
    deadline = time.monotonic() + JOIN_SECONDS
    while not ctx.join(timeout=5):      # raises if a rank failed
        if time.monotonic() > deadline:
            pytest.fail(f"the ranks did not finish in {JOIN_SECONDS} s")
    return [torch.load(os.path.join(spawned["root"], f"rank{r}.pt"))
            for r in range(WORLD)]


def rel(a, b):
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float()).clamp_min(1e-30)).item()


def _ranks_equal(results, key):
    a, b = (r[key] for r in results)
    assert a[0] == b[0]                                  # the global losses
    for part in (1, 2):                                  # grads, params
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), k


def test_f32_step_over_two_ranks_matches_jax(jax_f32, results, spawned):
    """The global losses of 3 Adam steps against JAX's at rtol 1e-5; the
    first step's averaged gradient against the single process's B=4
    gradient by the sensitivity rule (3x the largest rel-L2 by which the
    port's own B=4 gradient moves under a 1e-6 change of the images, plus
    1e-3), and against JAX's within that bound plus JAX's distance to its
    own two-pass-BatchNorm gradient."""
    losses_j, grads_j, two_pass_j = jax_f32
    _ranks_equal(results, "f32")
    losses, grads, _ = results[0]["f32"]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
    inp = spawned["inp"]
    single = port_step(inp, None)[1]
    mi_np, gt_np = inp["batch"]
    moved = []
    for seed in range(3):
        rgb = mi_np["rgb"] * (1 + 1e-6 * np.random.RandomState(seed).randn(
            *mi_np["rgb"].shape))
        moved.append(port_step(dict(inp, batch=(
            dict(mi_np, rgb=rgb.astype(np.float32)), gt_np)), None)[1])
    assert set(grads) == set(grads_j) == set(single) == set(two_pass_j)
    for k in grads:
        bound = 3 * max(rel(g[k], single[k]) for g in moved) + 1e-3
        assert rel(grads[k], single[k]) <= bound, k
        assert rel(grads[k], grads_j[k]) <= bound + rel(two_pass_j[k],
                                                         grads_j[k]), k


GROUPS = ("base_encoder.", "conv0", "based_3d.", "base_decoder.")


def _group_rel(grads, oracle, prefix):
    keys = [k for k in oracle if k.startswith(prefix)]
    return rel(torch.cat([grads[k].flatten() for k in keys]),
               torch.cat([oracle[k].flatten() for k in keys]))


def test_bf16_step_over_two_ranks_rule4(jax_bf16, results):
    """Rule 4 against the f32 oracle, the 2-rank f32 step (held to JAX
    above): the 2-rank bf16 step within 3x JAX's bf16 distance plus
    0.4%, in the loss and each group's gradient."""
    lbf, grads_j = jax_bf16
    _ranks_equal(results, "bf16")
    l32, oracle = results[0]["f32"][0][0], results[0]["f32"][1]
    loss, grads = results[0]["bf16"][0][0], results[0]["bf16"][1]
    assert np.isfinite(loss)
    floor = 4e-3
    d_port = abs(loss - l32) / abs(l32)
    d_jax = abs(lbf - l32) / abs(l32)
    assert d_port <= 3 * d_jax + floor, (d_port, d_jax)
    for prefix in GROUPS:
        dp = _group_rel(grads, oracle, prefix)
        dj = _group_rel(grads_j, oracle, prefix)
        assert dp <= 3 * dj + floor, (prefix, dp, dj)


def test_group_of_one_is_bit_equal_to_no_group(spawned, tmp_path):
    """World size 1: no collective runs, so the step is the single
    process's bit for bit."""
    inp = spawned["inp"]
    alone = port_step(inp, torch.bfloat16)
    _init_group(str(tmp_path), 0, 1)
    try:
        assert mesh.world() == 1
        grouped = port_step(inp, torch.bfloat16)
    finally:
        dist.destroy_process_group()
    assert grouped[0] == alone[0]
    for part in (1, 2):
        for k in alone[part]:
            assert torch.equal(grouped[part][k], alone[part][k]), k


def test_cli_over_two_ranks(results, spawned):
    """Both ranks run the fewest rank's steps less the frame rank 1 could
    not load (rank 0: 2 batches, 8 steps; rank 1: 1 batch, 4; the skip at
    frame 1), one checkpoint per validation from rank 0, the resume at
    epoch 1, equal parameters and metrics."""
    cli = [r["cli"] for r in results]
    lengths = [c["first"]["epoch_length"] for c in cli]
    assert sorted(lengths) == [4, 8]
    for run in ("first", "second"):
        a, b = (c[run] for c in cli)
        assert a["steps"] == b["steps"] == min(lengths) - 1, run
        assert a["losses"] == b["losses"]
        assert all(np.isfinite(a["losses"]))
        assert a["metrics"] == b["metrics"] and len(a["metrics"]) == 5
        assert all(np.isfinite(a["metrics"]))
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), (run, k)
    assert [c["second"]["i_epoch"] for c in cli] == [2, 2]
    # the draws: rank 0 keeps the config's seed, rank 1 another stream
    seeds = [c["first"]["seed"] for c in cli]
    assert seeds[0] == 0 and seeds[1] != 0
    assert cli[0]["saves"] == [0, 0] and cli[1]["saves"] == []
    saved = os.listdir(os.path.join(spawned["root"], "outputs",
                                    "checkpoints", "mesh_cli"))
    assert sorted(f for f in saved if "_ckpt" in f) == ["mesh_cli_ckpt"]
