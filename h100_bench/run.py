"""The benchmark of ``depthestimation_tpu_torch`` on NVIDIA H100s.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its files are found by name: ``h100_bench/workloads/
<cell>.json`` (the checked limits), ``h100_bench/configs/<config>.json``
(the model's configuration as it is run, and the harness module that runs
it: its ``harness`` key, ``train`` where it has none) and ``h100_bench/
traffic/<traffic>.json`` (the traffic's parameters, which that module's
generator reads); each per-layer metric is read by ``h100_bench/metrics/
<metric>.py``.

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` profiles a window of the schedule's steps and
reports the per-layer metrics. Either way the run ends by comparing the
three steps it checked against the f32 reference (``ref/``). A harness
module (``harness/<name>.py``) has ``run``, ``reference``, ``compare``
and ``diagnose``, called as ``_rank_main`` calls them. The last
line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, are its last key and the last lines of
standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "depthestimation_tpu")


def load_spec(workload: str) -> dict:
    """The cell's entries and files, by the names in BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]

    def read(kind, name):
        with open(os.path.join(HERE, kind, name + ".json")) as f:
            return json.load(f)

    conf = read("configs", cell["config"])
    spec = {"entry": cell,
            "cell": dict(read("workloads", workload), name=workload),
            "config": conf["config"], "traffic": read("traffic",
                                                      cell["traffic"]),
            "harness": conf.get("harness", "train"),
            "work_dir": os.path.join(ROOT, "build", "h100_bench")}
    spec["end_to_end"] = [m for m in bench["end_to_end"]
                          if workload in m.get("workloads", [workload])]
    spec["per_layer"] = [m for m in bench["per_layer"]
                         if workload in m.get("workloads", [workload])]
    return spec


def _reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location("metric_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def _setup_env():
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "h100_bench")
    os.makedirs(cache, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join_group(rank: int, world: int, port: int, device: str):
    """This rank's device, in a process group of ``world`` (NCCL on the
    cards, gloo on the CPU), or alone."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device, rank) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(2)    # the CPU's ranks share its cores
    if world > 1:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, device_id=dev if dev.type == "cuda" else None)
    return dev


def gather(out, world: int):
    """Every rank's ``out`` on rank 0 (None elsewhere); leaves the group."""
    if world == 1:
        return [out]
    import torch.distributed as dist
    rank = dist.get_rank()
    outs = [None] * world
    dist.all_gather_object(outs, out)
    dist.destroy_process_group()
    return outs if rank == 0 else None


def harness_module(spec: dict):
    """The module that runs the cell's configuration: ``harness.<name>``,
    by the configuration file's ``harness`` key."""
    return importlib.import_module("harness." + spec["harness"])


def _rank_main(rank, world, port, args, spec, device="cuda"):
    """One rank: the run, the reference, its readings to rank 0."""
    dev = join_group(rank, world, port, device)
    mod = harness_module(spec)
    out = mod.run(spec, args.seed, args.seconds, bool(args.trace), T_START,
                  device=dev, rank=rank, world=world)
    ref = mod.reference(spec, args.seed, device=dev, rank=rank,
                        world=world, seen=out["seen"])
    out["checks"] = mod.compare(out["seen"], ref)
    out["diagnosis"] = mod.diagnose(out["seen"], ref)
    out.pop("seen")
    return gather(out, world)


def spawn(target, world: int, *args):
    """Ranks 1 .. world-1 of ``target(rank, world, *args)`` in spawned
    processes; the caller runs rank 0 and then ``join``s them."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(1, world):
        pr = ctx.Process(target=_spawned, args=(target, r, world) + args)
        pr.start()
        procs.append(pr)
    return procs


def join(procs) -> bool:
    """Wait for every spawned rank; True when all ended well."""
    for pr in procs:
        pr.join(timeout=900)
        if pr.is_alive():
            pr.terminate()
            pr.join()
    return not any(pr.exitcode for pr in procs)


def _spawned(target, rank, world, *args):
    _setup_env()
    target(rank, world, *args)


def result(spec: dict, outs: list, trace: bool, kind: str) -> dict:
    """The result's line from every rank's readings; ``kind`` is the
    card's name."""
    world = len(outs)
    cell = spec["cell"]
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                v = max(o["setup_s"] for o in outs)
            elif m["name"] == "samples_per_s":
                v = outs[0]["samples_per_s"]
            elif m["name"] == "peak_mem_gib":
                v = max(o["peak_bytes"] for o in outs) / 2 ** 30
            else:
                raise SystemExit(f"no reading for {m['name']!r}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            vals = []
            for o in outs:
                v = _reader(m["name"])({**o, "world": world,
                                        "config": spec["config"],
                                        "traffic": spec["traffic"],
                                        "cell": cell})
                if v is not None:
                    vals.append(v)
            if vals:
                metrics[m["name"]] = {"value": sum(vals) / len(vals),
                                      "unit": m["unit"]}
    limits = cell["limits"]
    checks = {}
    for name, lim in limits.items():
        vals = [o["checks"][name] for o in outs if name in o["checks"]]
        checks[name] = {"value": max(vals), "limit": lim}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu", "kind": kind,
              "count": world,
              "memory_peak_bytes": max(o["memory_peak_bytes"] for o in outs)}
    line = {"correct": correct, "attempted": outs[0]["steps"],
            "failed": max(o["failed"] for o in outs),
            "metrics": metrics, "device": device}
    if trace:
        ts = [o["trace"] for o in outs if o.get("trace")]
        device["busy_s"] = sum(t["busy_s"] for t in ts) / len(ts)
        device["window_s"] = sum(t["window_s"] for t in ts) / len(ts)
        line["breakdown"] = ts[0]["breakdown"]
    line["diagnosis"] = [o["diagnosis"] for o in outs]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _setup_env()
    spec = load_spec(args.workload)
    import torch
    world = int(spec["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"needs {world} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import depthestimation_tpu_torch  # noqa: F401  (fails outside a checkout)
    port = _free_port()
    procs = spawn(_rank_main, world, port, args, spec)
    try:
        outs = _rank_main(0, world, port, args, spec)
    finally:
        ok = join(procs)
    if not ok:
        print("a rank failed", file=sys.stderr)
        return 1
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 1
    line = result(spec, outs, bool(args.trace), torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
