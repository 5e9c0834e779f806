"""The data-parallel path of a cell with more than one chip, on the CPU:
two gloo ranks of the tiny training cell, through ``run.py``'s own
launcher, and the exchange left out.

    python3 -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import copy
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import run as bench  # noqa: E402

SEED = 4_444_444_444


def _tiny():
    spec = copy.deepcopy(bench.load_spec("exp7-train-b8"))
    spec["config"]["var"]["img_size"] = [96, 64]
    spec["traffic"].update(batch=2, groups=1, traj_len=4)
    return spec


def _rank(rank, world, port, spec, fault, out_dir):
    """One rank of the tiny cell (``fault`` planted, or none, with the
    window); rank 0 writes every rank's readings to ``out_dir``."""
    import json
    torch.set_num_threads(2)
    dev = bench.join_group(rank, world, port, "cpu")
    from harness import train
    out = train.run(spec, SEED, 0.5, False, time.perf_counter(), device=dev,
                    rank=rank, world=world, fault=fault)
    ref = train.reference(spec, SEED, device=dev, rank=rank, world=world,
                          seen=out["seen"])
    out["checks"] = train.compare(out.pop("seen"), ref)
    out["diagnosis"] = {}
    outs = bench.gather(out, world)
    if rank == 0:
        with open(os.path.join(out_dir, "outs.json"), "w") as f:
            json.dump(outs, f)


def _two_ranks(spec, fault, out_dir):
    """Both ranks in processes of their own (a process keeps its group
    state), through the launcher's ``spawn`` and ``join``."""
    import json
    import torch.multiprocessing as mp
    port = bench._free_port()
    procs = bench.spawn(_rank, 2, port, spec, fault, str(out_dir))
    r0 = mp.get_context("spawn").Process(
        target=bench._spawned,
        args=(_rank, 0, 2, port, spec, fault, str(out_dir)))
    r0.start()
    assert bench.join([r0] + procs)
    with open(os.path.join(out_dir, "outs.json")) as f:
        return json.load(f)


def test_two_ranks_give_one_correct_line(tmp_path):
    """f32: the port's plain versions, within the limits at any size."""
    spec = _tiny()
    spec["config"]["tpu"]["dtype"] = "float32"
    outs = _two_ranks(spec, None, tmp_path)
    line = bench.result(spec, outs, False, "cpu")
    assert line["device"]["count"] == 2
    assert line["attempted"] >= 1
    assert line["metrics"]["samples_per_s"]["value"] > 0
    # both ranks hold the same global step: the same loss gaps
    assert outs[0]["checks"]["loss_gap"] == outs[1]["checks"]["loss_gap"]
    assert line["correct"] is True, line["checks"]


def test_the_exchange_left_out_is_not_correct(tmp_path):
    spec = _tiny()
    outs = _two_ranks(spec, "no_exchange", tmp_path)
    line = bench.result(spec, outs, False, "cpu")
    assert line["correct"] is False, line["checks"]
