"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, at first use, under the checkout's
``build/`` directory (listed in ``.gitignore``), and loaded with
``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited kernel is never served from a stale build. Nothing is
built or loaded at import time: the CPU tests import every module on a
machine without ``nvcc``. In a data-parallel group rank 0 builds while the
other ranks wait (``parallel/mesh.rank0_first``), then they load its
build. A C launcher runs on the calling thread's current CUDA device, so
the wrappers launch through ``launch``, which makes their tensors'
device current for the call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from depthestimation_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argtypes (every function returns cudaError_t)
_SIGNATURES = {
    "sweep_stage2_fwd": [_VP] * 8 + [_I] * 6 + [_VP],
    "sweep_stage2_bwd": [_VP] * 11 + [_I] * 6 + [_VP],
    "sweep_stage2_plan": [_I] * 6 + [_VP],
    "convcomb_fwd": [_VP] * 7 + [_I] * 8 + [_VP],
    "convcomb_fwd_occupancy": [_I, _I, _VP],
    "convcomb_bwd": [_VP] * 14 + [_I] * 11 + [_VP],
    "convbn2d_fwd": [_VP] * 7 + [_I] * 7 + [_VP],
    "convbn2d_bwd": [_VP] * 14 + [_I] * 10 + [_VP],
    "tap_combine_fwd": [_VP] * 2 + [_I] * 5 + [_VP],
    "tap_combine_bwd": [_VP] * 2 + [_I] * 5 + [_VP],
    "correlation_fwd": [_VP] * 4 + [_I] * 6 + [_VP],
    "correlation_bwd": [_VP] * 5 + [_I] * 6 + [_VP],
    "conv3d_flat_fwd": [_VP] * 3 + [_I] * 9 + [_VP],
    "conv3d_flat_dw": [_VP] * 5 + [_I] * 8 + [_VP],
}


class KernelLibrary:
    """The loaded ``.so``: its C functions, the build's wall time and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.de_error_string.argtypes = [ctypes.c_int]
        self._lib.de_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Run one C launcher on the current CUDA device; raise if the
        launch was refused."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.de_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


_lock = threading.Lock()
_library: KernelLibrary | None = None


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build(srcs: list[Path], target: Path) -> str:
    """Compile every source at once (one ``nvcc`` each), link them into
    ``target``; returns the compilers' report."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [p.name for p, proc in zip(srcs, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        os.replace(so, target)      # atomic: concurrent builds agree
    return log


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library; in a
    data-parallel group rank 0 first, the other ranks after it."""
    global _library
    with _lock:
        if _library is None:
            from depthestimation_tpu_torch.parallel import mesh
            _library = mesh.rank0_first(_load)
        return _library


def _load() -> KernelLibrary:
    """Build the library unless this source hash's build exists, and load
    it: the span ``setup.kernel_lib``, whose attribute ``built`` says
    whether this call built it."""
    with profiling.span("setup.kernel_lib") as sp:
        srcs = _sources()
        digest = hashlib.sha256()
        for p in srcs + sorted(CSRC.glob("*.cuh")):
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        target = BUILD_DIR / f"libde_kernels_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        log = ""
        built = not target.is_file()
        sp.note(built=built)
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            log = _build(srcs, target)
        return KernelLibrary(target, time.perf_counter() - t0, log)


def launch(name: str, *args, device) -> None:
    """Run C launcher ``name`` on ``device``, the card its pointers live
    on. The launchers ask the runtime for the current device (its SM
    count, its shared-memory limit) and launch there, so a rank whose
    tensors are on ``cuda:k`` makes ``cuda:k`` current for the call, and
    the calling thread's current device is restored after it. A device of
    another type (``meta``) has no card to select."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        library().call(name, *args)
        return
    with torch.cuda.device(device):
        library().call(name, *args)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA ``device`` (asked once)."""
    import torch
    d = torch.device(device)
    return _sm_count(d.index if d.index is not None
                     else torch.cuda.current_device())


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
