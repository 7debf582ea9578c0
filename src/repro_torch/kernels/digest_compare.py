"""The gossip digest compare.

Port of ``repro.kernels.digest_compare``: two replicas' per-range
digests (SUM, MAX, CHK, CNT) are diffed row by row into ``DIFFER``,
``A_BEHIND`` and ``B_BEHIND`` flags.  Inputs keep the reference's
packed layout (:func:`pack_digests`, one ``(DIG_COLS,)`` int32 row per
(pair, range), with a VALID column); outputs are ``(M, OUT_COLS)``
int32.

  * :func:`digest_compare_ref` — the plain version, a whole-array
    re-derivation of the reference's ``compare_tile``;
  * :func:`digest_compare_cuda` — the hand-written kernel
    (``csrc/digest_compare.cu``): one thread per row.

The component differences wrap like int32: the plain version subtracts
in int64 and wraps explicitly, the kernel subtracts in ``unsigned``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.gossip.digest import wrap_int32
from repro_torch.kernels import build

# Packed input layout (as in the reference); inert rows have VALID=0.
A_SUM, A_MAX, A_CHK, A_CNT = 0, 1, 2, 3
B_SUM, B_MAX, B_CHK, B_CNT = 4, 5, 6, 7
VALID = 8
DIG_COLS = 16

# Output layout (int32 0/1 flags).
DIFFER, A_BEHIND, B_BEHIND = 0, 1, 2
OUT_COLS = 4

THREADS = 256        # rows per block (as in the .cu)

launches = 0


def pack_digests(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Paired ``(M, 4)`` digest rows -> the ``(M, DIG_COLS)`` layout,
    every row valid.  The reference pads to its tile size; the kernel
    masks its ragged edge itself, so no padding is added."""
    m = a.shape[0]
    packed = torch.zeros((m, DIG_COLS), dtype=torch.int32, device=a.device)
    packed[:, A_SUM:A_CNT + 1] = a.to(torch.int32)
    packed[:, B_SUM:B_CNT + 1] = b.to(torch.int32)
    packed[:, VALID] = 1
    return packed


def digest_compare_ref(packed: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(M, OUT_COLS)`` verdicts of packed rows."""
    t = packed.long()

    def d(col_a, col_b):
        return wrap_int32(t[:, col_a] - t[:, col_b])

    d_sum, d_max = d(A_SUM, B_SUM), d(A_MAX, B_MAX)
    d_chk, d_cnt = d(A_CHK, B_CHK), d(A_CNT, B_CNT)
    valid = packed[:, VALID] > 0
    differ = valid & ((d_sum != 0) | (d_max != 0) | (d_chk != 0) | (d_cnt != 0))
    # Direction by (MAX, then SUM); a full tie that still differs is
    # divergence, and both sides need the merge.
    tie = (d_max == 0) & (d_sum == 0)
    a_behind = differ & ((d_max < 0) | ((d_max == 0) & (d_sum < 0)) | tie)
    b_behind = differ & ((d_max > 0) | ((d_max == 0) & (d_sum > 0)) | tie)
    return torch.stack(
        [differ, a_behind, b_behind, torch.zeros_like(differ)], dim=1
    ).to(torch.int32)


def _lib():
    fn = build.load("digest_compare").digest_compare_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def digest_compare_cuda(packed: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/digest_compare.cu`` on a CUDA ``(M, DIG_COLS)``
    int32 tensor; returns the ``(M, OUT_COLS)`` verdicts."""
    global launches
    if not packed.is_cuda:
        raise ValueError("digest_compare_cuda needs a CUDA tensor")
    if packed.dtype != torch.int32 or packed.dim() != 2 or packed.shape[1] != DIG_COLS:
        raise ValueError(f"packed must be (M, {DIG_COLS}) int32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    packed = packed.contiguous()
    m = packed.shape[0]
    out = torch.empty((m, OUT_COLS), dtype=torch.int32, device=packed.device)
    if m == 0:
        return out
    # Rows are read and written as int4 vectors.
    if packed.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("digest_compare_cuda needs 16-byte aligned tensors")
    err = _lib()(packed.data_ptr(), m, out.data_ptr(), build.stream_ptr(packed))
    build.check(err, "digest_compare")
    launches += 1
    return out
