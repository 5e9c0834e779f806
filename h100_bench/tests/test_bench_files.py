"""The benchmark's files, found by name, and what they may import.

    python3 -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "depthestimation_tpu"}
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_every_file_is_found_by_name():
    b = _bench()
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert os.path.dirname(c["file"]) == "h100_bench/configs"
    for w in b["workloads"]:
        assert w["config"] in names
        for kind, n in (("workloads", w["name"]), ("traffic", w["traffic"])):
            assert os.path.isfile(os.path.join(BENCH, kind, n + ".json"))
    for m in b["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        s = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert mod.read({"steps": 1}) is None      # nothing to read
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e


def test_names_units_and_limits_keep_the_format():
    b = _bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 0 < len(e[k]) <= 200 and "\n" not in e[k]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            assert json.load(f)["limits"]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = set(_top_imports(path))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if f"{os.sep}ref{os.sep}" in path:
            # the reference imports nothing of the program either
            assert "depthestimation_tpu_torch" not in tops, path


@pytest.mark.parametrize("imports", [
    "from harness import train, trace, probes, faults, counts, window\n"
    "from ref import train as rt\n"
    "import depthestimation_tpu_torch.trainer.default\n",
    "from harness import flow, pairs\n"
    "from ref import pwclite, flow_loss, flow_train\n"
    "import depthestimation_tpu_torch.trainer.sintel\n"
    "import depthestimation_tpu_torch.trainer.factory\n"
    "import depthestimation_tpu_torch.losses.factory\n"], ids=["depth", "flow"])
def test_a_run_loads_no_jax_module(imports):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, calibrate\n"
        "%s"
        "import depthestimation_tpu_torch.models.factory\n"
        "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
        "print(sorted(bad))\n" % (BENCH, ROOT, imports, FORBIDDEN))
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_config_without_a_harness_key_runs_the_depth_harness():
    import run as bench
    with open(os.path.join(BENCH, "configs", "kitti-exp7.json")) as f:
        assert "harness" not in json.load(f)
    spec = bench.load_spec("exp7-train-b8")
    assert spec["harness"] == "train"
    assert bench.harness_module(spec).__name__ == "harness.train"
    assert bench.load_spec("pwclite-train-b8")["harness"] == "flow"


def test_every_config_names_a_harness_module_with_its_four_functions():
    import run as bench
    for w in _bench()["workloads"]:
        mod = bench.harness_module(bench.load_spec(w["name"]))
        for fn in ("run", "reference", "compare", "diagnose", "control"):
            assert callable(getattr(mod, fn)), (w["name"], fn)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "exp7-train-b8",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
