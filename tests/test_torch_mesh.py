"""``parallel/mesh.py`` over two gloo ranks on the CPU against the JAX
package on the whole batch.

One spawn of two ranks (``torch.multiprocessing``, a ``FileStore`` in the
test's directory, one torch thread each) computes:

- the step-count vote and the skip vote over the real schedulers
  (``BatchScheduler(host_id=rank, n_hosts=2)`` on 5 trajectories: 3 and 2
  of them), against JAX's ``global_min_steps`` / ``global_any`` with the
  injected allgather of tests/test_data.py, and the epochs they cut;
- the fused layers' blocks on CPU tensors (their plain versions) with
  half the items per rank and the statistics summed over the ranks the
  way ``models/layers.py`` sums them (``_global_sums``): ``convbn_block``
  (Base3D) and ``convbn2d_block`` (the encoder) in bf16 against the JAX
  Pallas kernels in interpret mode over the whole batch, forward and
  ``jax.vjp`` (y, the statistics and dx on the rank's items; dW and
  d(a,b) summed over the ranks) within tests/test_torch_convbn2d.py's
  bounds (one block: tests/TOLERANCES.md rule 3); the same in f32 against
  the port's own plain block over the whole batch at f32 round-off;
- ``BatchNorm`` (batch statistics, and with running statistics) in f32
  and bf16 against JAX's ``BatchNorm`` over the whole batch: the output,
  dx, the scale's and the bias's gradients (summed), the running
  statistics;
- ``rank0_first``, the kernel builds' order: rank 0 first, the others
  after it, and an error on every rank when rank 0's call raises;
- exp7_lc's ``prev_lc`` drop at ``use_lc_prob`` 0.5, each rank with the
  trainer's generator for its rank: one keep flag for the global batch,
  rank 0's, on both ranks (JAX draws it once per forward).

JAX is imported inside the fixtures and tests: the spawned ranks import
this module for their entry point and load only the port.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from depthestimation_tpu_torch.data.scheduler import BatchScheduler
from depthestimation_tpu_torch.data.video_synthetic import (
    SyntheticStereoVideoDataset)
from depthestimation_tpu_torch.models import layers as tl
from depthestimation_tpu_torch.ops import convbn2d_kernel as c2
from depthestimation_tpu_torch.ops import convcomb_kernel as ck
from depthestimation_tpu_torch.parallel import mesh

WORLD = 2
#: the spawned ranks' time limit (they take a few seconds alone)
JOIN_SECONDS = 600
ITEMS = 4                  # Base3D items (depth D each) or encoder images
D, H, W, C = 8, 8, 16, 8
BF = torch.bfloat16


def _schedulers():
    """tests/test_data.py's uneven shards: 5 trajectories over 2 ranks."""
    ds = SyntheticStereoVideoDataset(n_traj=5, traj_len=3, h=16, w=24,
                                     ndepth=8)
    return [BatchScheduler(ds, 1, shuffle=True, seed=7, prefetch=False,
                           host_id=i, n_hosts=WORLD) for i in range(WORLD)]


def _data(seed, shape_x, shape_k):
    """x and k (bf16-representable), a, b as f32 numpy, and the
    generator for the cotangents."""
    rs = np.random.RandomState(seed)
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(BF).float() \
        .numpy()
    x = bf(rs.randn(*shape_x))
    k = bf(rs.randn(*shape_k) * 0.2)
    a = (rs.rand(C) * 0.5 + 0.75).astype(np.float32)
    b = (rs.randn(C) * 0.1).astype(np.float32)
    return x, k, a, b, rs


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def block_case(kind: str, inp: dict, lo: int, hi: int, dtype):
    """One fused block on items [lo, hi) with the statistics summed over
    the group (none without one): y [n, F, ...], the global sums and
    count, and the gradients of sum(y gy) + sum(sums gs) / world."""
    x4, k, a, b, gy, gs = (inp[kind][n] for n in
                           ("x", "k", "a", "b", "gy", "gs"))
    if kind == "convcomb":
        # x4 [items*D, H, W, C], k [3, 3, 3, C, F]
        x = _t(x4[lo * D:hi * D], dtype).permute(0, 3, 1, 2).reshape(
            -1, C, H * W).contiguous().requires_grad_()
        wt = _t(k).permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
        av, bv = _t(a).requires_grad_(), _t(b).requires_grad_()
        y, st = ck.convbn_block(x, ck.pack_wm(wt).to(dtype), av, bv, D, H,
                                W, True)
        g = _t(gy[lo * D:hi * D], dtype)
        count = float(y.shape[0] * H * W)
    else:
        # x4 [items, H, W, C], k [3, 3, C, F]
        x = _t(x4[lo:hi], dtype).permute(0, 3, 1, 2).contiguous() \
            .requires_grad_()
        wt = _t(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
        av, bv = _t(a).requires_grad_(), _t(b).requires_grad_()
        y, st = c2.convbn2d_block(x, wt.to(dtype), av, bv, "relu")
        g = _t(gy[lo:hi], dtype)
        count = float(y.shape[0] * H * W)
    sums, gcount = tl._global_sums(st, count)
    loss = (y.float() * g.float()).sum() + (sums * _t(gs)).sum() / \
        mesh.world()
    loss.backward()
    return {"y": y.detach().float(), "sums": sums.detach(),
            "count": float(gcount), "dx": x.grad.float(),
            "dw": wt.grad, "da": av.grad, "db": bv.grad}


def bn_case(inp: dict, lo: int, hi: int, dtype, running: bool):
    """BatchNorm on items [lo, hi) (NCHW), trained: y, dx, the scale's
    and bias's gradients of sum(y gy), the running statistics."""
    x4, gy, scale, bias = (inp["bn"][n] for n in ("x", "gy", "scale",
                                                  "bias"))
    bn = tl.BatchNorm(C, track_running_stats=running).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    x = _t(x4[lo:hi], dtype).permute(0, 3, 1, 2).contiguous() \
        .requires_grad_()
    y = bn(x)
    (y.float() * _t(gy[lo:hi]).permute(0, 3, 1, 2)).sum().backward()
    out = {"y": y.detach().float(), "dx": x.grad.float(),
           "dscale": bn.weight.grad, "dbias": bn.bias.grad}
    if running:
        out.update(mean=bn.running_mean.clone(), var=bn.running_var.clone())
    return out


def _rank0_first(root: str, rank: int) -> dict:
    """``mesh.rank0_first`` as the kernel builds use it: rank 1's call
    finds what rank 0's left on disk; a call that raises on rank 0 raises
    on every rank instead of leaving the others at the barrier."""
    marker = os.path.join(root, "built")

    def build():
        if rank == 0:
            time.sleep(0.2)
            with open(marker, "w") as f:
                f.write("rank 0")
        return os.path.exists(marker)

    def broken():
        raise RuntimeError("no compiler")

    out = {"found": mesh.rank0_first(build)}
    try:
        mesh.rank0_first(broken)
        out["raised"] = False
    except RuntimeError:
        out["raised"] = True
    return out


def _drop_case(rank: int) -> dict:
    """The keep flags of 20 train-mode ``prev_lc`` drops from this rank's
    trainer generator (``rank_seed``), and the flags this rank's stream
    alone would give."""
    from depthestimation_tpu_torch.models.base_model import BaseModelNet
    from depthestimation_tpu_torch.trainer.default import rank_seed

    model = BaseModelNet(16, 16, "exp7_lc", use_lc_prob=0.5).train()
    prev = torch.randn(1, 16, 2, 3)
    like = torch.zeros_like(prev)
    seed = rank_seed(0, rank)
    gen = torch.Generator().manual_seed(seed)
    kept = [model._drop_prev_lc(prev, like, gen) is prev for _ in range(20)]
    own = torch.Generator().manual_seed(seed)
    alone = [torch.rand((), generator=own).item() < 0.5 for _ in range(20)]
    return {"kept": kept, "alone": alone}


CASES = [("convcomb", BF), ("convbn2d", BF), ("convcomb", torch.float32),
         ("convbn2d", torch.float32)]
BN_CASES = [(dt, run) for dt in (torch.float32, BF) for run in (False,
                                                                 True)]


def _worker(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        sched = _schedulers()[rank]
        gmin = mesh.global_min_steps(sched.epoch_length())
        out = {"votes": {
            "length": sched.epoch_length(), "gmin": gmin,
            "steps": sum(1 for _ in sched.enumerate(max_steps=gmin)),
            "any_one": mesh.global_any(rank == 1),
            "any_none": mesh.global_any(False)}}
        out["rank0_first"] = _rank0_first(root, rank)
        out["drop"] = _drop_case(rank)
        lo, hi = rank * ITEMS // WORLD, (rank + 1) * ITEMS // WORLD
        for kind, dt in CASES:
            out[(kind, str(dt))] = block_case(kind, inp, lo, hi, dt)
        for dt, run in BN_CASES:
            out[("bn", str(dt), run)] = bn_case(inp, lo, hi, dt, run)
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
    root = str(tmp_path_factory.mktemp("mesh"))
    inp = {}
    x, k, a, b, rs = _data(1, (ITEMS * D, H, W, C), (3, 3, 3, C, C))
    inp["convcomb"] = dict(x=x, k=k, a=a, b=b,
                           gy=_t(rs.randn(ITEMS * D, C, H * W) * 0.1, BF)
                           .float().numpy(),
                           gs=(rs.randn(C, 2) * 1e-3).astype(np.float32))
    x, k, a, b, rs = _data(2, (ITEMS, H, W, C), (3, 3, C, C))
    inp["convbn2d"] = dict(x=x, k=k, a=a, b=b,
                           gy=_t(rs.randn(ITEMS, C, H, W) * 0.1, BF)
                           .float().numpy(),
                           gs=(rs.randn(C, 2) * 1e-3).astype(np.float32))
    rs = np.random.RandomState(3)
    inp["bn"] = dict(x=(rs.randn(ITEMS, H, W, C) * 2 + 1).astype(np.float32),
                     gy=rs.randn(ITEMS, H, W, C).astype(np.float32),
                     scale=(rs.rand(C) + 0.5).astype(np.float32),
                     bias=rs.randn(C).astype(np.float32))
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    ctx = tmp.start_processes(_worker, args=(root,), nprocs=WORLD,
                              join=False, start_method="spawn")
    yield {"root": root, "ctx": ctx, "inp": inp}
    for proc in ctx.processes:           # a rank left behind by a failure
        if proc.is_alive():
            proc.terminate()
            proc.join(10)


@pytest.fixture(scope="module")
def jax_blocks(spawned):
    """The JAX kernels (interpret mode) over the whole batch: y, stats and
    the vjp of each, while the ranks run."""
    import jax
    import jax.numpy as jnp
    from depthestimation_tpu.ops import convbn2d_pallas as j2
    from depthestimation_tpu.ops import convcomb_pallas as jc

    inp = spawned["inp"]
    out = {}

    def comb(x4, k3, a, b):
        return jc.convbn_block(jc.to_transposed(x4.astype(jnp.bfloat16)),
                               jc.pack_wm(k3).astype(jnp.bfloat16), a, b,
                               D, H, W, True, True)

    def conv2d(x4, k, a, b):
        rows = H // 2                        # two strips per image
        y, st = j2.convbn2d_block(
            j2.to_strips(x4.astype(jnp.bfloat16), rows),
            j2.pack_wm2d(k).astype(jnp.bfloat16), a, b, H // rows, rows, W,
            "relu", True)
        return j2.from_strips(y, rows, H), st

    for kind, fn in (("convcomb", comb), ("convbn2d", conv2d)):
        d = inp[kind]
        args = [jnp.asarray(d[n]) for n in ("x", "k", "a", "b")]
        (y, st), vjp = jax.vjp(jax.jit(fn), *args)
        gy = d["gy"]
        if kind == "convbn2d":                 # NCHW -> the strips' NHWC
            gy = np.moveaxis(gy, 1, -1)
        dx, dk, da, db = vjp((jnp.asarray(gy, jnp.bfloat16),
                              jnp.asarray(d["gs"])))
        y = np.asarray(y, np.float32)
        dx = np.asarray(dx, np.float32)
        dk = np.asarray(dk, np.float32)
        if kind == "convcomb":       # x4 layout -> [N, C, HW]; k -> FC333
            dx = np.moveaxis(dx, -1, 1).reshape(-1, C, H * W)
            dk = np.transpose(dk, (4, 3, 0, 1, 2))
        else:                        # NHWC -> NCHW; HWIO -> OIHW
            y = np.moveaxis(y, -1, 1)
            dx = np.moveaxis(dx, -1, 1)
            dk = np.transpose(dk, (3, 2, 0, 1))
        out[kind] = {"y": y, "sums": np.asarray(st), "dx": dx, "dw": dk,
                     "da": np.asarray(da), "db": np.asarray(db)}
    return out


@pytest.fixture(scope="module")
def results(spawned, jax_blocks):
    ctx = spawned["ctx"]
    deadline = time.monotonic() + JOIN_SECONDS
    while not ctx.join(timeout=5):      # raises if a rank failed
        if time.monotonic() > deadline:
            pytest.fail(f"the ranks did not finish in {JOIN_SECONDS} s")
    return [torch.load(os.path.join(spawned["root"], f"rank{r}.pt"))
            for r in range(WORLD)]


def test_votes_match_jax(results):
    """The ranks agree on the fewest steps and cut their epochs to it;
    one rank's flag is every rank's; JAX's votes on the same lengths and
    flags say the same. Without a group both return their input."""
    from depthestimation_tpu.parallel import mesh as jmesh

    lengths = [s.epoch_length() for s in _schedulers()]
    assert lengths[0] != lengths[1]
    votes = [r["votes"] for r in results]
    assert [v["length"] for v in votes] == lengths
    for rank, v in enumerate(votes):
        want = jmesh.global_min_steps(
            lengths[rank], allgather=lambda x: np.array(lengths))
        assert v["gmin"] == want == min(lengths)
        assert v["steps"] == want
        assert v["any_one"] is jmesh.global_any(
            rank == 1, allgather=lambda x: np.array([0, 1])) is True
        assert v["any_none"] is jmesh.global_any(
            False, allgather=lambda x: np.array([0, 0])) is False
    assert mesh.world() == 1
    assert mesh.global_min_steps(17) == 17
    assert mesh.global_any(True) is True and mesh.global_any(False) is False


def test_rank0_first(results):
    """Rank 1 waits for rank 0's build and finds it; a failing build
    raises on both ranks."""
    assert [r["rank0_first"] for r in results] == [
        {"found": True, "raised": True}] * 2


def test_prev_lc_drop_is_rank0s_on_every_rank(results):
    """Both ranks keep or drop ``prev_lc`` together, as rank 0's stream
    says, at a probability strictly between 0 and 1; rank 1's own stream
    would have said otherwise."""
    a, b = (r["drop"] for r in results)
    assert a["kept"] == b["kept"] == a["alone"]
    assert 0 < sum(a["kept"]) < len(a["kept"])
    assert b["alone"] != a["alone"]


def _gathered(results, key):
    """(rank-concatenated y and dx, summed dW / d(a,b), the sums, the
    count), the ranks' sums and counts equal."""
    a, b = (r[key] for r in results)
    assert torch.equal(a["sums"], b["sums"]) and a["count"] == b["count"]
    return {"y": torch.cat([a["y"], b["y"]]).numpy(),
            "dx": torch.cat([a["dx"], b["dx"]]).numpy(),
            "dw": (a["dw"] + b["dw"]).numpy(),
            "da": (a["da"] + b["da"]).numpy(),
            "db": (a["db"] + b["db"]).numpy(),
            "sums": a["sums"].numpy(), "count": a["count"]}


@pytest.mark.parametrize("kind", ["convcomb", "convbn2d"])
def test_bf16_blocks_with_summed_stats_match_jax(results, jax_blocks,
                                                 spawned, kind):
    got = _gathered(results, (kind, str(BF)))
    want = jax_blocks[kind]
    d = spawned["inp"][kind]
    n = ITEMS * (D if kind == "convcomb" else 1)
    assert got["count"] == n * H * W
    scale = np.abs(want["y"]).max() + 1e-6
    np.testing.assert_allclose(got["y"].reshape(want["y"].shape), want["y"],
                               rtol=0, atol=0.03 * scale)
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=3e-2,
                               atol=1e-2 * n * H * W)
    # dx away from the ReLU's kink (the f32 pre-activation v = x a + b)
    v = d["x"] * d["a"] + d["b"]
    inner = np.abs(v) > 0.02
    inner = (np.moveaxis(inner, -1, 1).reshape(got["dx"].shape))
    assert inner.mean() > 0.97
    for name, g, w_, tol in (("dx", got["dx"][inner],
                              want["dx"].reshape(got["dx"].shape)[inner],
                              0.03),
                             ("dW", got["dw"], want["dw"], 0.03),
                             ("da", got["da"], want["da"], 0.10),
                             ("db", got["db"], want["db"], 0.10)):
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=tol * np.abs(w_).max() + 1e-6,
                                   err_msg=f"{kind} {name}")


@pytest.mark.parametrize("kind", ["convcomb", "convbn2d"])
def test_f32_blocks_with_summed_stats_match_the_whole_batch(results, spawned,
                                                            kind):
    """f32: the two ranks' blocks equal the plain block over the whole
    batch at f32 round-off."""
    got = _gathered(results, (kind, str(torch.float32)))
    want = block_case(kind, spawned["inp"], 0, ITEMS, torch.float32)
    assert got["count"] == want["count"]
    for name in ("y", "sums", "dx", "dw", "da", "db"):
        w_ = want[name].numpy()
        np.testing.assert_allclose(got[name].reshape(w_.shape), w_,
                                   rtol=1e-5, atol=1e-5 * np.abs(w_).max(),
                                   err_msg=f"{kind} {name}")


@pytest.mark.parametrize("dtype,running", BN_CASES)
def test_batchnorm_over_two_ranks_matches_jax(results, spawned, dtype,
                                              running):
    import jax
    import jax.numpy as jnp
    from depthestimation_tpu.models import layers as jl

    d = spawned["inp"]["bn"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = jl.BatchNorm(track_running_stats=running)
    variables = {"params": {"scale": jnp.asarray(d["scale"]),
                            "bias": jnp.asarray(d["bias"])}}
    if running:
        variables["batch_stats"] = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def f(x, scale, bias):
        v = dict(variables, params={"scale": scale, "bias": bias})
        return jm.apply(v, x.astype(jdt), True, mutable=["batch_stats"])

    (y, upd), vjp = jax.vjp(f, jnp.asarray(d["x"]), jnp.asarray(d["scale"]),
                            jnp.asarray(d["bias"]))
    dx, dscale, dbias = vjp((jnp.asarray(d["gy"], jdt),
                             jax.tree_util.tree_map(jnp.zeros_like, upd)))
    a, b = (r[("bn", str(dtype), running)] for r in results)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, got, want in (
            ("y", torch.cat([a["y"], b["y"]]).permute(0, 2, 3, 1), y),
            ("dx", torch.cat([a["dx"], b["dx"]]).permute(0, 2, 3, 1), dx),
            ("dscale", a["dscale"] + b["dscale"], dscale),
            ("dbias", a["dbias"] + b["dbias"], dbias)):
        w_ = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), w_, rtol=tol,
                                   atol=tol * np.abs(w_).max(),
                                   err_msg=name)
    if running:
        for name in ("mean", "var"):
            assert torch.equal(a[name], b[name])
            np.testing.assert_allclose(a[name].numpy(),
                                       np.asarray(upd["batch_stats"][name]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_init_distributed(monkeypatch):
    """Without torchrun's variables: no group, the device as given. With
    them and a CPU device: a gloo group (here of one, on a free localhost
    port), the device as given; a group that exists is used as it is."""
    import socket

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized() and mesh.world() == 1
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    try:
        assert mesh.init_distributed("cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo" and mesh.world() == 1
        assert mesh.init_distributed("cpu") == torch.device("cpu")
        assert mesh.rank() == 0
    finally:
        dist.destroy_process_group()
