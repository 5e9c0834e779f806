"""The light-curtain planner's velocity-constrained DP on a hand-written
Hopper kernel (``csrc/planner_dp.cu``), beside its plain version.

JAX solves each field with one ``lax.scan`` (``depthestimation_tpu/lc/
planner.py``), which XLA compiles into one loop on the device. The port's
plain version, ``lc/planner._dp_solve``, is a host loop of PyTorch ops
(three launches a camera column, a gather a column back); the kernel is
the whole solve, its backtrack and the lookup of the design points in one
launch. It keeps the plain version's f32 arithmetic and its tie rule, so
the two give the same path to the bit.

The kernel reads the feasibility of each hop, the planner's penalty
(``lc/planner._velocity_penalty``: 0 or ``NEG``), as bits packed once by
``feasible_bits`` in the order its lanes scan: ``S`` lanes share a range
node and lane ``q`` scans the predecessors ``q, q + S, q + 2S, ...``.
The bit format and ``split`` live here alone. The kernel runs on the card
only; the planner keeps the plain version for CPU fields.
"""

from __future__ import annotations

import torch

from depthestimation_tpu_torch.ops import cuda_lib

#: threads a block aims at (``split``); a node takes 1 to 32 lanes
THREADS = 512
#: the most ranges the kernel takes (one node a thread at S = 1)
MAX_RANGES = 1024
#: shared memory a block may use on Hopper (232,448 bytes); back-pointers
#: that do not fit beside ``best`` go to a scratch in device memory
SMEM_LIMIT = 232448


def split(r: int) -> int:
    """The lanes that share one of ``r`` range nodes: the largest power of
    two up to 32 that keeps the block within ``THREADS`` (at least 1)."""
    s = 32
    while s > 1 and -(-r * s // 32) * 32 > THREADS:
        s //= 2
    return s


def words(r: int, s: int) -> int:
    """The 32-bit words of one lane's predecessors (ceil(r / s) bits)."""
    return -(-(-(-r // s)) // 32)


def pack_feasible(penalty: torch.Tensor, s: int) -> torch.Tensor:
    """penalty [K, R, R] (hop k from predecessor rp to r: 0 feasible, NEG
    not) -> int32 bits [K, W, R, s], W = ceil(ceil(R / s) / 32): bit b of
    word w of (k, r, q) is set iff rp = (w * 32 + b) * s + q < R is a
    feasible predecessor of r."""
    k, r, _ = penalty.shape
    w = words(r, s)
    ok = torch.zeros((k, w * 32 * s, r), dtype=torch.int64,
                     device=penalty.device)
    ok[:, :r] = penalty == 0
    ok = ok.reshape(k, w, 32, s, r)
    shifts = torch.arange(32, device=penalty.device).reshape(1, 1, 32, 1, 1)
    bits = (ok << shifts).sum(dim=2)                           # [K, W, s, R]
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).transpose(2, 3).contiguous()


def feasible_bits(penalty_of, hops: int, r: int) -> torch.Tensor:
    """The kernel's feasibility of ``hops`` hops between ``r`` ranges.
    ``penalty_of(a, b)`` gives the penalty [b - a, r, r] of hops a .. b-1;
    it is packed by ``pack_feasible`` about a million hops at a time, so
    the f32 penalty (50 MB at 768 rays and 128 ranges) is never whole on
    the card: the bits take 1.5 MB."""
    s = split(r)
    k = max(1, (1 << 20) // (r * r))
    return torch.cat([pack_feasible(penalty_of(a, min(a + k, hops)), s)
                      for a in range(0, hops, k)])


def _check(field, feasible, xz):
    if field.device.type == "cpu":
        raise ValueError("planner_dp: the kernel runs on the card, not on "
                         "a CPU tensor")
    if field.dtype != torch.float32 or not field.is_contiguous():
        raise ValueError("planner_dp: the field must be contiguous f32")
    m, r, c = field.shape
    if m < 1 or c < 2 or not 1 <= r <= MAX_RANGES:
        raise ValueError(f"planner_dp: the kernel takes M >= 1, C >= 2 and "
                         f"1 <= R <= {MAX_RANGES}, not {tuple(field.shape)}")
    want = (c - 1, words(r, split(r)), r, split(r))
    if (feasible.dtype != torch.int32 or not feasible.is_contiguous()
            or tuple(feasible.shape) != want):
        raise ValueError(f"planner_dp: feasible {tuple(feasible.shape)} "
                         f"{feasible.dtype}, not pack_feasible's int32 "
                         f"{want}")
    if (xz.dtype != torch.float32 or not xz.is_contiguous()
            or tuple(xz.shape) != (c, r, 2)):
        raise ValueError(f"planner_dp: xz {tuple(xz.shape)} is not a "
                         f"contiguous f32 {(c, r, 2)}")
    for name, t in (("feasible", feasible), ("xz", xz)):
        if t.device != field.device:
            raise ValueError(f"planner_dp: {name} on {t.device}, the field "
                             f"on {field.device}")


def planner_dp(field: torch.Tensor, feasible: torch.Tensor,
               xz: torch.Tensor):
    """field [M, R, C] f32, the hops' ``feasible_bits`` and xz [C, R, 2]
    (each node's design point) -> (points [M, C, 2], idx [M, C] int64):
    the design points and range index per ray of each field's best path,
    in one launch. Raises on what the kernel does not take: a CPU tensor,
    a field that is not contiguous f32, M < 1, C < 2, R > ``MAX_RANGES``.
    """
    _check(field, feasible, xz)
    m, r, c = field.shape
    points = torch.empty((m, c, 2), dtype=torch.float32, device=field.device)
    idx = torch.empty((m, c), dtype=torch.int64, device=field.device)
    bp_bytes = 1 if r <= 256 else 2
    scratch = None
    if 8 * r + (c - 1) * r * bp_bytes > SMEM_LIMIT:
        scratch = torch.empty(m * (c - 1) * r * bp_bytes, dtype=torch.uint8,
                              device=field.device)
    cuda_lib.launch(
        "planner_dp_fwd", field.data_ptr(), feasible.data_ptr(),
        xz.data_ptr(), points.data_ptr(), idx.data_ptr(),
        None if scratch is None else scratch.data_ptr(), m, r, c, split(r),
        cuda_lib.stream_ptr(field.device), device=field.device)
    planner_dp.launches += 1
    return points, idx


#: kernel launches since the last reset
planner_dp.launches = 0
