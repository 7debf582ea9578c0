"""H100 SXM peaks and the bound arithmetic of the kernels the benchmark
reads (NVIDIA's data sheet, dense rates, 700 W).  A frozen copy of the
program's smoke-test arithmetic (``bound_ms`` and the per-kernel byte and
operation counts), so that no change to the program moves the yardstick.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12          # HBM3
PEAK_OPS_S = 67e12              # f32 outside the tensor cores (an FMA is two)
PEAK_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: bytes over the bandwidth or
    operations over the f32 rate, the larger."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S)


def op_ingest_bound_s(b: int, q: int = 0) -> float:
    """B.1 over a batch of ``b`` ops and ``q`` pending slots: nine int32
    meta columns in and three out per op, four per slot; 13 operations per
    ordered pair of ops and 4 per (op, slot) pair."""
    pairs = b * (b - 1) / 2
    return bound_s(b * 9 * 4 + q * 4 * 4 + b * 3 * 4, pairs * 13 + 4 * b * q)


def vclock_chain_bound_s(b: int, c: int, p: int) -> float:
    """The clock chain over ``b`` ops, ``c`` sessions, ``p`` replicas:
    three int32 columns in, the session and replica clocks in and out, one
    clock out per op; four operations per clock component of each op."""
    return bound_s(3 * b * 4 + 2 * (c * c + p * c) * 4 + b * c * 4, b * c * 4)
