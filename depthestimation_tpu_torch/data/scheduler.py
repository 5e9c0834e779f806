"""Video-batch scheduling + host-side prefetch.

A copy of ``depthestimation_tpu/data/scheduler.py`` (host numpy; the port
imports nothing of the JAX package). "Video batches" are groups of
trajectories advanced one frame at a time so the trainer can carry
``prev_output``/``prev_lc`` DPVs across frames. The loader is a prefetch
thread, or with ``mload`` a spawned process, feeding a bounded queue of
ready numpy batches; the trainer moves each batch to the card once. The
spawned process imports only this module and the dataset's: it never
touches CUDA. ``host_id`` / ``n_hosts`` split the trajectories between
data-parallel processes. Unlike JAX's, a dataset error in the loader's
thread or process ends the epoch with that error in the consumer
(``LoaderError`` for the process), not with a short epoch.

A dataset is anything implementing the small ``VideoDataset`` protocol:
  n_trajectories, traj_len(i), frame(traj_idx, t) -> per-frame sample dicts.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Iterator, Protocol

import numpy as np


class VideoDataset(Protocol):
    def n_trajectories(self) -> int: ...
    def traj_len(self, i: int) -> int: ...
    def frame(self, i: int, t: int) -> dict: ...


class LoaderError(RuntimeError):
    """A failure in the spawned loader process: the dataset's traceback,
    or the exit code of a process that died without one."""


def _loader_process(dataset, batch_size, shuffle, seed, epoch, traj_indices,
                    max_steps, q, stop):
    """Loader-process entry (spawned): rebuilds a non-prefetching scheduler
    shell and streams one epoch into the bounded queue, then the sentinel
    None, or a ``LoaderError`` in its place if the dataset raised.
    Top-level so it pickles under the spawn start method."""
    end = None
    try:
        sched = BatchScheduler(dataset, batch_size, shuffle=shuffle,
                               seed=seed, prefetch=False)
        sched.traj_indices = list(traj_indices)
        sched._epoch = epoch
        for item in sched._produce(max_steps):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                break
    except BaseException:
        end = LoaderError("the loader process failed:\n"
                          + traceback.format_exc())
    finally:
        try:
            q.put(end, timeout=5)  # sentinel
        except Exception:
            pass


class BatchScheduler:
    """Groups ``batch_size`` trajectories and yields them frame-by-frame.

    Yields dicts with stacked per-frame samples plus bookkeeping
    (frame_count, traj_len, batch_idx, nbatch, iepoch) — the reference's
    ``enumerate()`` contract (batch_scheduler.py:329-343). Scene-level
    sharding across hosts mirrors batch_scheduler.py:378-385.
    """

    def __init__(self, dataset: VideoDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, qmax: int = 4,
                 host_id: int = 0, n_hosts: int = 1, prefetch: bool = True,
                 mload: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.qmax = qmax
        self.prefetch = prefetch
        # mload: decode in a spawned worker PROCESS (the reference's
        # BatchSchedulerMP, batch_scheduler.py:330-350) so PIL/velodyne work
        # never shares the GIL with the training loop
        self.mload = mload
        idx = [i for i in range(dataset.n_trajectories())
               if i % n_hosts == host_id]
        self.traj_indices = idx
        self._stop = threading.Event()
        self._epoch = 0
        self._worker = None   # the last epoch's loader thread or process

    def stop(self):
        self._stop.set()

    # -- iteration ---------------------------------------------------------

    def epoch_plan(self) -> list:
        """Deterministic schedule for the NEXT epoch: [(batch_idx, trajs,
        tlen)]. Derived from (seed, epoch) only, so every host can compute
        its own step count before loading any data."""
        rng = np.random.default_rng(self.seed + self._epoch)
        order = list(self.traj_indices)
        if self.shuffle:
            rng.shuffle(order)
        nbatch = len(order) // self.batch_size
        plan = []
        for batch_idx in range(nbatch):
            trajs = order[batch_idx * self.batch_size:
                          (batch_idx + 1) * self.batch_size]
            tlen = min(self.dataset.traj_len(i) for i in trajs)
            plan.append((batch_idx, trajs, tlen))
        return plan

    def epoch_length(self) -> int:
        """Steps this host yields next epoch (counts invalid frames too —
        the yield count is what must match across hosts)."""
        return sum(tlen for _, _, tlen in self.epoch_plan())

    def _produce(self, max_steps: int | None = None) -> Iterator[dict]:
        plan = self.epoch_plan()
        nbatch = len(plan)
        steps = 0
        for batch_idx, trajs, tlen in plan:
            if max_steps is not None and steps >= max_steps:
                break
            for t in range(tlen):
                if max_steps is not None and steps >= max_steps:
                    break
                steps += 1
                frames = [self.dataset.frame(i, t) for i in trajs]
                # corrupted-sample protocol (reference kitti.py:991-1000):
                # a frame may come back {"success": False}; mark the batch
                # invalid so the trainer can skip it
                if any(not f.get("success", True) for f in frames):
                    yield {"is_valid": False, "frame_count": t,
                           "traj_len": tlen, "batch_idx": batch_idx,
                           "nbatch": nbatch, "iepoch": self._epoch}
                    continue
                batch = _stack_frames(frames)
                batch.update({"frame_count": t, "traj_len": tlen,
                              "batch_idx": batch_idx, "nbatch": nbatch,
                              "iepoch": self._epoch, "is_valid": True})
                yield batch

    def enumerate(self, max_steps: int | None = None) -> Iterator[dict]:
        """Yield one epoch of batches. ``max_steps`` truncates the epoch:
        data-parallel processes run the same number of steps, so their
        gradient all-reduces stay matched."""
        self._stop.clear()
        try:
            if self.mload:
                yield from self._enumerate_mp(max_steps)
            elif self.prefetch:
                yield from self._enumerate_thread(max_steps)
            else:
                for item in self._produce(max_steps):
                    if self._stop.is_set():
                        break
                    yield item
        finally:
            self._epoch += 1

    def _enumerate_thread(self, max_steps):
        q: queue.Queue = queue.Queue(maxsize=self.qmax)
        SENTINEL = object()

        def worker():
            end = SENTINEL
            try:
                for item in self._produce(max_steps):
                    if self._stop.is_set():
                        break
                    q.put(item)
            except BaseException as e:  # re-raised by the consumer
                end = e
            finally:
                q.put(end)

        th = threading.Thread(target=worker, daemon=True,
                              name="BatchScheduler-loader")
        self._worker = th
        th.start()
        def is_end(x):
            return x is SENTINEL or isinstance(x, BaseException)

        done = False
        try:
            while True:
                item = q.get()
                if is_end(item):
                    done = True
                    if item is SENTINEL:
                        break
                    raise item
                if self._stop.is_set():
                    # drain so the worker can exit
                    continue
                yield item
        finally:
            if not done:
                # closed early: stop the worker and drain to its end
                self._stop.set()
                while not is_end(q.get()):
                    pass
            th.join(timeout=5)

    def _enumerate_mp(self, max_steps):
        """Spawned loader process + bounded queue + stop event — the
        reference's BatchSchedulerMP protocol (batch_scheduler.py:330-350,
        440-451: control Value, queue drain on early stop)."""
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        q = ctx.Queue(maxsize=self.qmax)
        stop = ctx.Event()
        proc = ctx.Process(
            target=_loader_process,
            args=(self.dataset, self.batch_size, self.shuffle, self.seed,
                  self._epoch, self.traj_indices, max_steps, q, stop),
            daemon=True)
        self._worker = proc
        proc.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if proc.is_alive():
                        continue
                    raise LoaderError(
                        "the loader process exited with code "
                        f"{proc.exitcode} before the end of the epoch")
                if item is None:  # sentinel: epoch exhausted
                    break
                if isinstance(item, LoaderError):
                    raise item
                if self._stop.is_set():
                    stop.set()
                    continue  # drain so the worker can exit
                yield item
        finally:
            stop.set()
            # drain anything left so the child's queue feeder thread exits
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()


def _stack_frames(frames: list) -> dict:
    """Stack a list of per-frame sample dicts along a new batch axis.
    Non-array values are taken from the first frame (shared metadata)."""
    shared = ("d_candi", "d_candi_up", "T_left2right", "intrinsics",
              "intrinsics_up", "unit_ray")
    out = {}
    for key in frames[0]:
        v0 = frames[0][key]
        if isinstance(v0, np.ndarray) and key not in shared:
            out[key] = np.stack([f[key] for f in frames])
        else:
            out[key] = v0
    return out
