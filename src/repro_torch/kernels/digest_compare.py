"""The gossip digest compare.

Port of ``repro.kernels.digest_compare``: two replicas' per-range
digests (SUM, MAX, CHK, CNT) are diffed row by row into ``DIFFER``,
``A_BEHIND`` and ``B_BEHIND`` flags.  The kernel works on the gathered
form, what ``gossip_round`` runs: a ``(P, K, 4)`` int32 digest table and
two ``(M,)`` replica index vectors give three ``(M, K)`` bool flags,
stacked as one ``(3, M, K)`` tensor.  :func:`digest_compare_pairs_cuda`
launches ONE kernel (``csrc/digest_compare.cu``, one thread per (pair,
range)) that reads the table and the indices itself and writes the
flags: no gathers, no packing, no casts.

The plain version keeps the reference's packed layout
(:func:`pack_digests`, one ``(DIG_COLS,)`` int32 row per (pair, range),
with a VALID column): :func:`digest_compare_ref` is a whole-array
re-derivation of the reference's ``compare_tile`` over such rows, and
:func:`digest_compare_pairs_ref` runs it on the gathered rows.

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


def check_pairs(host_pairs, p: int) -> None:
    """Raise ``ValueError`` unless every ``(a, b)`` of ``host_pairs`` (a
    host sequence) indexes one of ``p`` replicas."""
    for a, b in host_pairs:
        if not (0 <= a < p and 0 <= b < p):
            raise ValueError(f"digest pair ({a}, {b}) is outside the {p} replicas")


def digest_compare_pairs_ref(dig: torch.Tensor, a_idx: torch.Tensor,
                             b_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gathered form: the ``(3, M, K)`` bool flags
    (``DIFFER``, ``A_BEHIND``, ``B_BEHIND`` along axis 0) of ``dig[a_idx]``
    against ``dig[b_idx]``, through the packed rows."""
    m, k = a_idx.shape[0], dig.shape[1]
    out = digest_compare_ref(pack_digests(dig[a_idx].reshape(-1, 4),
                                          dig[b_idx].reshape(-1, 4)))
    return out[:, :OUT_COLS - 1].T.to(torch.bool).reshape(3, m, k)


_PAIRS_FN = None


def _pairs_lib():
    global _PAIRS_FN
    if _PAIRS_FN is None:
        fn = build.load("digest_compare").digest_pairs_launch
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_longlong]
        fn.restype = ctypes.c_int
        _PAIRS_FN = fn
    return _PAIRS_FN


def digest_compare_pairs_cuda(dig: torch.Tensor, a_idx: torch.Tensor,
                              b_idx: torch.Tensor, host_pairs=None) -> torch.Tensor:
    """Launch the gathered kernel: ``dig`` a contiguous CUDA ``(P, K, 4)``
    int32 table, ``a_idx`` / ``b_idx`` CUDA ``(M,)`` int64 replica
    indices (views with one common stride, e.g. the two columns of an
    ``(M, 2)`` pair tensor, are read in place).  ``host_pairs``, the same
    ``(a, b)`` pairs on the host, are checked against P there; without
    them the indices are copied to the host for the check.  Returns the
    ``(3, M, K)`` bool flags (``DIFFER``, ``A_BEHIND``, ``B_BEHIND`` along
    axis 0)."""
    global launches
    if not (dig.is_cuda and a_idx.is_cuda and b_idx.is_cuda):
        raise ValueError("digest_compare_pairs_cuda needs CUDA tensors")
    shape = dig.shape
    # Each digest is read as one int4.
    if (dig.dtype is not torch.int32 or len(shape) != 3 or shape[2] != 4
            or not dig.is_contiguous() or dig.data_ptr() & 15):
        raise ValueError(f"dig must be a contiguous, 16-byte aligned (P, K, 4) int32 "
                         f"tensor, got {tuple(shape)} {dig.dtype}")
    if a_idx.dim() != 1 or a_idx.shape != b_idx.shape:
        raise ValueError(f"a_idx and b_idx must be (M,) alike, got "
                         f"{tuple(a_idx.shape)} and {tuple(b_idx.shape)}")
    if a_idx.dtype is not torch.int64 or b_idx.dtype is not torch.int64:
        a_idx, b_idx = a_idx.long(), b_idx.long()
    stride = a_idx.stride(0)
    if b_idx.stride(0) != stride:
        a_idx, b_idx = a_idx.contiguous(), b_idx.contiguous()
        stride = 1
    p, k = shape[0], shape[1]
    m = a_idx.shape[0]
    if host_pairs is None:
        host_pairs = torch.stack([a_idx, b_idx], dim=1).tolist()
    check_pairs(host_pairs, p)
    out = torch.empty((3, m, k), dtype=torch.bool, device=dig.device)
    if m * k:
        err = (_PAIRS_FN or _pairs_lib())(
            dig.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), out.data_ptr(),
            build.stream_ptr(dig), p | k << 32, m | stride << 32)
        if err:
            build.check(err, "digest_compare")
        launches += 1
    return out

