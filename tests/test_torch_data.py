"""The port's data path and metrics against the JAX package.

- ``data/video_synthetic.py``: the stereo and sweep datasets' frames and
  ``assemble_inputs`` (mono and stereo) equal to JAX's bit for bit from the
  same seed; ``to_device`` moves every array once, as f32;
- ``data/scheduler.py``: ``epoch_plan`` over epochs, shuffles and host
  splits equal to JAX's; the no-prefetch, thread and spawned-process
  loaders yield JAX's batches in JAX's order, bit for bit; ``stop()`` mid
  epoch, and a generator closed early, leave no live worker (order and
  completeness only: no wall clock); a dataset error in the thread or the
  process, or the process's death, raises in the consumer;
- ``ops/metrics.py``: ``depth_error`` (one map and a batch) and
  ``eval_errors`` against JAX at rtol 1e-6 (f32, the same formula), the
  empty case NaN;
- ``ops/ufield.py``: ``compute_unc_field`` (with its mask) and
  ``compute_unc_rmse`` against JAX at rtol 1e-5, for the KITTI and the
  ILIM banding (quash);
- ``ops/geometry.py:add_noise_to_pose``: the quaternion maps against
  JAX's, the noise statistics (JAX's PRNG draws cannot be reproduced).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthestimation_tpu.data import scheduler as jsched
from depthestimation_tpu.data import video_synthetic as jvs
from depthestimation_tpu.ops import geometry as jgeo
from depthestimation_tpu.ops import metrics as jmet
from depthestimation_tpu.ops import ufield as juf
from depthestimation_tpu_torch.data import scheduler as tsched
from depthestimation_tpu_torch.data import video_synthetic as tvs
from depthestimation_tpu_torch.ops import geometry as tgeo
from depthestimation_tpu_torch.ops import metrics as tmet
from depthestimation_tpu_torch.ops import ufield as tuf

KW = dict(h=32, w=48, ndepth=16, d_min=5.0, d_max=40.0)


def assert_same(a, b, path=""):
    """Equal keys, equal values, equal dtypes (numpy) or equal python
    values, recursively."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("t_win", [1, 2])
def test_stereo_frames_equal_jax(t_win):
    j = jvs.SyntheticStereoVideoDataset(n_traj=3, traj_len=3, t_win=t_win,
                                        seed=7, **KW)
    t = tvs.SyntheticStereoVideoDataset(n_traj=3, traj_len=3, t_win=t_win,
                                        seed=7, **KW)
    assert t.n_trajectories() == 3 and t.traj_len(1) == 3
    for i in range(3):
        for f in range(3):
            assert_same(t.frame(i, f), j.frame(i, f), f"frame({i},{f})")


def test_sweep_frames_equal_jax():
    j = jvs.SyntheticSweepVideoDataset(n_traj=2, traj_len=2, planes=8,
                                       seed=3, **KW)
    t = tvs.SyntheticSweepVideoDataset(n_traj=2, traj_len=2, planes=8,
                                       seed=3, **KW)
    for i, f in ((0, 0), (1, 1)):
        assert_same(t.frame(i, f), j.frame(i, f))


@pytest.mark.parametrize("stereo", [False, True])
def test_assemble_inputs_equal_jax(stereo):
    ds = tvs.SyntheticSweepVideoDataset(n_traj=2, traj_len=2, planes=8,
                                        seed=1, **KW)
    batch = tsched._stack_frames([ds.frame(0, 1), ds.frame(1, 1)])
    for side in ("left", "right"):
        got = tvs.assemble_inputs(batch, side, stereo)
        want = jvs.assemble_inputs(batch, side, stereo)
        assert_same(got, want)
    mi, gt = got
    dev = tvs.to_device(mi, "cpu")
    assert dev["prev_output"] is None and dev["rgb"].dtype == torch.float32
    np.testing.assert_array_equal(dev["src_cam_poses"].numpy(),
                                  mi["src_cam_poses"])


def _datasets(n_traj=5, traj_len=3):
    return (jvs.SyntheticStereoVideoDataset(n_traj=n_traj, traj_len=traj_len,
                                            seed=4, **KW),
            tvs.SyntheticStereoVideoDataset(n_traj=n_traj, traj_len=traj_len,
                                            seed=4, **KW))


@pytest.mark.parametrize("shuffle,host", [(True, (0, 1)), (False, (0, 1)),
                                          (True, (1, 2))])
def test_epoch_plan_equal_jax(shuffle, host):
    jd, td = _datasets()
    kw = dict(shuffle=shuffle, seed=11, host_id=host[0], n_hosts=host[1])
    j = jsched.BatchScheduler(jd, 2, prefetch=False, **kw)
    t = tsched.BatchScheduler(td, 2, prefetch=False, **kw)
    assert t.traj_indices == j.traj_indices
    for _ in range(3):
        assert t.epoch_plan() == j.epoch_plan()
        assert t.epoch_length() == j.epoch_length()
        # advance an epoch on both sides (a truncated one)
        assert len(list(t.enumerate(max_steps=1))) == 1
        assert len(list(j.enumerate(max_steps=1))) == 1


def _batches(sched, **kw):
    return list(sched.enumerate(**kw))


@pytest.mark.parametrize("mode", ["plain", "thread", "process"])
def test_loaders_yield_jax_batches(mode):
    jd, td = _datasets(n_traj=4, traj_len=2)
    kw = {"plain": dict(prefetch=False), "thread": dict(prefetch=True),
          "process": dict(mload=True)}[mode]
    j = jsched.BatchScheduler(jd, 2, shuffle=True, seed=5, prefetch=False)
    t = tsched.BatchScheduler(td, 2, shuffle=True, seed=5, **kw)
    for epoch in range(2):
        want = _batches(j)
        got = _batches(t)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert_same(g, w, f"epoch {epoch}")
    if mode != "plain":
        assert not t._worker.is_alive()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_stop_mid_epoch_leaves_no_worker(mode):
    _, td = _datasets(n_traj=4, traj_len=4)
    kw = dict(prefetch=True) if mode == "thread" else dict(mload=True)
    t = tsched.BatchScheduler(td, 2, shuffle=False, qmax=2, **kw)
    it = t.enumerate()
    first = next(it)
    assert (first["batch_idx"], first["frame_count"]) == (0, 0)
    t.stop()
    rest = list(it)
    assert len(rest) <= 2       # what was already in the queue, at most
    assert not t._worker.is_alive()
    # the next epoch runs whole, in order
    got = [(b["batch_idx"], b["frame_count"]) for b in t.enumerate()]
    assert got == [(b, f) for b in range(2) for f in range(4)]
    assert not t._worker.is_alive()


class _FailingDataset(tvs.SyntheticStereoVideoDataset):
    """Raises at frame ``fail_at`` of every trajectory, as an unreadable
    file would, or with ``exit_code`` ends the loader's process there.
    Top-level, so the spawned loader can unpickle it."""

    fail_at, exit_code = 2, None

    def frame(self, i, t):
        if t == self.fail_at:
            if self.exit_code is not None:
                os._exit(self.exit_code)
            raise OSError(f"unreadable frame {i}/{t}")
        return super().frame(i, t)


@pytest.mark.parametrize("mode", ["thread", "process", "process_exit"])
def test_dataset_error_reaches_the_consumer(mode):
    """A dataset that fails mid-epoch raises in the consumer after the
    frames before it, in order; it does not end the epoch short. A loader
    process that dies without a word raises ``LoaderError`` with its exit
    code."""
    td = _FailingDataset(n_traj=4, traj_len=4, seed=4, **KW)
    if mode == "process_exit":
        td.fail_at, td.exit_code = 0, 3
    kw = dict(prefetch=True) if mode == "thread" else dict(mload=True)
    t = tsched.BatchScheduler(td, 2, shuffle=False, qmax=2, **kw)
    err, match = {"thread": (OSError, "unreadable frame 0/2"),
                  "process": (tsched.LoaderError, "OSError: unreadable "
                              "frame 0/2"),
                  "process_exit": (tsched.LoaderError, "exited with code 3")
                  }[mode]
    got = []
    with pytest.raises(err, match=match):
        for b in t.enumerate():
            got.append((b["batch_idx"], b["frame_count"]))
    assert got == [(0, f) for f in range(td.fail_at)]
    assert not t._worker.is_alive()


def test_closed_generator_leaves_no_thread():
    _, td = _datasets(n_traj=4, traj_len=4)
    t = tsched.BatchScheduler(td, 2, shuffle=False, qmax=1)
    it = t.enumerate()
    next(it)
    it.close()
    assert not t._worker.is_alive()


def _depth_pair(rs, shape):
    pred = rs.uniform(1.0, 50.0, shape).astype(np.float32)
    truth = rs.uniform(2.0, 40.0, shape).astype(np.float32)
    truth[rs.random(shape) < 0.3] = 0.0
    pred[rs.random(shape) < 0.05] = 0.0
    return pred, truth


def test_depth_error_and_eval_errors_match_jax():
    rs = np.random.RandomState(0)
    pred, truth = _depth_pair(rs, (3, 32, 48))
    want = np.stack([np.asarray(jmet.depth_error(jnp.asarray(p),
                                                 jnp.asarray(g)))
                     for p, g in zip(pred, truth)])
    got = tmet.depth_error(torch.from_numpy(pred), torch.from_numpy(truth))
    assert got.shape == (3, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    one = tmet.depth_error(torch.from_numpy(pred[0]),
                           torch.from_numpy(truth[0]))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-6)
    # a near-constant log error: the centered sil stays finite
    flat = tmet.depth_error(torch.full((8, 8), 10.0),
                            torch.full((8, 8), 10.0 * (1 + 1e-7)))
    assert torch.isfinite(flat).all()

    agg, agg_j = tmet.eval_errors(got), jmet.eval_errors(list(want))
    assert list(agg) == list(jmet.METRIC_NAMES)
    for k in agg:
        np.testing.assert_allclose(agg[k], agg_j[k], rtol=1e-6)
    for errors in ([], torch.zeros((0, 9))):
        empty = tmet.eval_errors(errors)
        assert all(np.isnan(v).all() for v in empty.values())
        assert set(empty) == set(jmet.eval_errors([]))


@pytest.mark.parametrize("dataset", ["kitti", "ilim"])
def test_unc_field_and_rmse_match_jax(dataset):
    rs = np.random.RandomState(1)
    b, d, h, w = 2, 16, 32, 48
    d_candi = np.linspace(5.0, 40.0, d)
    logits = rs.randn(b, d, h, w).astype(np.float32)
    dpv = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    soft = rs.random((b, d, h, w)).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    mask = (rs.random((b, h, w)) < 0.7).astype(np.float32)
    intr = np.array([[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h],
                     [0, 0, 1]], np.float32)
    intr_b = np.tile(intr[None], (b, 1, 1))
    p = tuf.UFieldParams.for_dataset(dataset)
    pj = juf.UFieldParams.for_dataset(dataset)
    assert p.quash == (dataset == "ilim")
    uf_t, uf_p, dbg = tuf.compute_unc_field(
        torch.from_numpy(dpv), torch.from_numpy(soft), d_candi,
        torch.from_numpy(intr_b), torch.from_numpy(mask), p)
    rmse = tuf.compute_unc_rmse(uf_t, uf_p, d_candi)
    assert rmse.shape == (b,)
    for i in range(b):
        wt, wp, wd = juf.compute_unc_field(
            jnp.asarray(dpv[i]), jnp.asarray(soft[i]), jnp.asarray(d_candi),
            jnp.asarray(intr), jnp.asarray(mask[i]), pj)
        np.testing.assert_allclose(uf_t[i].numpy(), np.asarray(wt),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(uf_p[i].numpy(), np.asarray(wp),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(dbg[i].numpy(), np.asarray(wd),
                                   rtol=1e-5, atol=1e-5)
        want = float(juf.compute_unc_rmse(wt, wp, jnp.asarray(d_candi)))
        np.testing.assert_allclose(float(rmse[i]), want, rtol=1e-5)


def test_pose_noise_maps_match_jax_and_statistics():
    rs = np.random.RandomState(2)
    # small rotations about random axes, as between video frames
    axes = rs.randn(6, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = rs.uniform(0.0, 0.2, 6)
    rots = []
    for a, th in zip(axes, angles):
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        rots.append(np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k)
    rots = np.asarray(rots, np.float32)
    uq = tgeo._rot_to_unitq(torch.from_numpy(rots))
    for i in range(6):
        want = np.asarray(jgeo._rot_to_unitq(jnp.asarray(rots[i])))
        np.testing.assert_allclose(uq[i].numpy(), want, rtol=1e-5,
                                   atol=1e-7)
        back = np.asarray(jgeo._unitq_to_rot(jnp.asarray(want)))
        np.testing.assert_allclose(tgeo._unitq_to_rot(uq[i]).numpy(), back,
                                   rtol=1e-5, atol=1e-6)

    poses = np.tile(np.eye(4, dtype=np.float32), (64, 32, 1, 1))
    poses[..., :3, :3] = rots[0]
    poses[..., :3, 3] = [0.5, -0.2, 1.0]
    gen = torch.Generator().manual_seed(0)
    noisy = tgeo.add_noise_to_pose(gen, torch.from_numpy(poses), 0.1)
    same = tgeo.add_noise_to_pose(torch.Generator().manual_seed(0),
                                  torch.from_numpy(poses), 0.1)
    torch.testing.assert_close(noisy, same, rtol=0, atol=0)
    r = noisy[..., :3, :3].reshape(-1, 3, 3)
    torch.testing.assert_close(r @ r.transpose(1, 2),
                               torch.eye(3).expand_as(r), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(noisy[..., 3, :],
                               torch.from_numpy(poses[..., 3, :]))
    # translation noise: zero mean, sigma = 0.1 x |t| per component
    dt = (noisy[..., :3, 3] - torch.from_numpy(poses[..., :3, 3])).reshape(
        -1, 3)
    sigma = 0.1 * float(np.linalg.norm([0.5, -0.2, 1.0]))
    assert abs(float(dt.mean())) < 4 * sigma / np.sqrt(dt.numel())
    np.testing.assert_allclose(dt.std(0).numpy(), sigma, rtol=0.1)
    zero = tgeo.add_noise_to_pose(gen, torch.from_numpy(poses), 0.0)
    np.testing.assert_allclose(zero.numpy(), poses, atol=1e-6)
