"""The port is self-contained: importing depthestimation_tpu_torch and
every module under it loads neither JAX, flax nor the JAX package, nor
Pillow or OpenCV (the data path reads PNGs itself), and builds nothing
(the CUDA kernels and the native data-path library build at first
use)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import depthestimation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from depthestimation_tpu_torch.native import kittiops
from depthestimation_tpu_torch.ops import cuda_lib
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "jaxlib", "flax", "depthestimation_tpu")),
    "imaging": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("PIL", "cv2")),
    "built": cuda_lib._library is not None,
    "kittiops_built": kittiops._lib is not None}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["modules"]) >= 50, got["modules"]
    for name in ("losses.base_loss", "losses.blocks", "losses.factory",
                 "parallel.train_step", "parallel.mesh", "trainer.default",
                 "ops.combine_kernel", "lc.device", "lc.transform",
                 "lc.fieldwarp", "lc.planner", "lc.curtain", "lc.process",
                 "ops.correlation", "ops.correlation_kernel",
                 "ops.conv3d_kernel", "models.pwclite", "losses.flow_loss",
                 "utils", "utils.logger", "trainer.checkpoint",
                 "trainer.sintel", "trainer.factory",
                 "data.video_synthetic", "data.scheduler", "ops.metrics",
                 "utils.visual", "train", "lc.process_real",
                 "runtime.planner_runtime", "runtime.sensor_sampling",
                 "models.sweep", "losses.sweep_loss", "trainer.sweep",
                 "native.kittiops", "data.velodyne", "data.image",
                 "data.kitti", "data.ilim", "models.packnet"):
        assert f"depthestimation_tpu_torch.{name}" in got["modules"], name
    assert got["foreign"] == [], f"the port pulled in {got['foreign']}"
    assert "jax" not in got["foreign"]
    assert got["built"] is False
    assert got["imaging"] == [], f"the port pulled in {got['imaging']}"
    assert got["kittiops_built"] is False


def test_sources_name_no_jax():
    """No module of the port, nor chip_smoke.py, imports ``jax`` or the
    JAX package, not even inside a function (a static check: the probe
    above only sees what an import runs)."""
    import ast

    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT,
                                               "depthestimation_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 52
    foreign = ("jax", "jaxlib", "flax", "optax", "depthestimation_tpu")
    # the card's host has neither: the data path reads PNGs itself
    # (utils/visual.py's --viz panels import cv2 where they run)
    imaging = ("PIL", "cv2")
    data_path = [os.path.join(ROOT, "depthestimation_tpu_torch", d)
                 for d in ("data", "native")]
    for path in paths:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in foreign, (path, n)
                if path.startswith(tuple(data_path)) or path.endswith(
                        "chip_smoke.py"):
                    assert n.split(".")[0] not in imaging, (path, n)


def test_ctypes_signatures_match_the_c_launchers():
    """Every C launcher in csrc/ is bound with one ctypes argtype per
    parameter, pointer for pointer (a mismatch only shows on the card)."""
    import ctypes
    import re

    from depthestimation_tpu_torch.ops import cuda_lib

    decls = {}
    for src in cuda_lib.CSRC.glob("*.cu"):
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            decls[name] = [p.strip() for p in params.split(",")]
    assert set(decls) == set(cuda_lib._SIGNATURES)
    for name, params in decls.items():
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params]
        assert cuda_lib._SIGNATURES[name] == want, name
