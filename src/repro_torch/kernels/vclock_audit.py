"""Pairwise DUOT causality audit codes (port of
``repro.kernels.vclock_audit``).

Output codes, as in ``repro.kernels.ref.vclock_audit_ref``:
``phase | violation << 8 | timed << 9`` for every ordered pair of log
entries, with happens-before over N-component vector clocks

    a -> b  <=>  max_n(a_n - b_n) <= 0  and  min_n(a_n - b_n) < 0

Two implementations, equal bit for bit:

  * :func:`vclock_audit_ref` — the plain PyTorch version (row chunks of
    the dense ``(rows, M, N)`` compare, so M = 16384 fits in memory);
  * :func:`vclock_audit_cuda` — the hand-written kernel
    (``csrc/vclock_audit.cu``), 32 × 32 output tiles.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

BLOCK = 32
CLIENT, KIND, RESOURCE, VERSION, SEQ, VALID = 0, 1, 2, 3, 4, 5
META_COLS = 8

launches = 0


def vclock_audit_ref(
    vc, client, kind, resource, version, seq, valid, *, delta: int = 0,
    chunk_elems: int = 1 << 26,
) -> torch.Tensor:
    """Plain version: (M, M) int32 codes, computed in row chunks."""
    m, n = vc.shape
    out = torch.empty((m, m), dtype=torch.int32, device=vc.device)
    rows = max(1, chunk_elems // max(1, m * n))
    for i0 in range(0, m, rows):
        i1 = min(m, i0 + rows)
        sl = slice(i0, i1)
        a = vc[sl, None, :]
        b_ = vc[None, :, :]
        hb = torch.all(a <= b_, dim=-1) & torch.any(a < b_, dim=-1)

        base = (
            valid[sl, None] & valid[None, :]
            & (resource[sl, None] == resource[None, :])
            & (seq[sl, None] < seq[None, :])
        )
        same_client = client[sl, None] == client[None, :]
        ki = kind[sl, None]
        kj = kind[None, :]
        vi = version[sl, None]
        vj = version[None, :]

        phase = torch.zeros((i1 - i0, m), dtype=torch.int32, device=vc.device)
        sc = base & same_client & hb
        phase = torch.where(sc & (ki == 0) & (kj == 0), 1, phase)   # a1 MR
        phase = torch.where(sc & (ki == 1) & (kj == 1), 2, phase)   # a2 MW
        phase = torch.where(sc & (ki == 1) & (kj == 0), 3, phase)   # a3 RYW
        phase = torch.where(sc & (ki == 0) & (kj == 1), 4, phase)   # a4 WFR
        phase = torch.where(base & ~same_client & hb, 5, phase)     # b1 TCC
        phase = torch.where(base & ~hb, 6, phase)                   # b2 conc

        viol = (
            ((phase == 1) & (vj < vi))
            | ((phase == 2) & (vj <= vi))
            | ((phase == 3) & (vj < vi))
            | ((phase == 4) & (vj <= vi))
            | ((phase == 5) & (ki == 1) & (kj == 0) & (vj < vi))
        )
        gap = seq[None, :] - seq[sl, None]
        timed = (
            base & (ki == 1) & (kj == 0) & (gap > delta) & (vj < vi)
            if delta > 0 else torch.zeros_like(viol)
        )
        out[sl] = phase | (viol.to(torch.int32) << 8) | (timed.to(torch.int32) << 9)
    return out


def pack_meta(client, kind, resource, version, seq, valid) -> torch.Tensor:
    """(M, META_COLS) int32 meta rows, in the Pallas kernel's layout."""
    cols = [client, kind, resource, version, seq, valid]
    meta = torch.zeros((client.shape[0], META_COLS), dtype=torch.int32,
                       device=client.device)
    for j, x in enumerate(cols):
        meta[:, j] = x.to(torch.int32)
    return meta


def _lib():
    fn = build.load("vclock_audit").vclock_audit_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp]
        fn.restype = ci
    return fn


def vclock_audit_cuda(vc: torch.Tensor, meta: torch.Tensor, *, delta: int = 0) -> torch.Tensor:
    """Launch ``csrc/vclock_audit.cu``: (M, N) clocks + (M, 8) meta ->
    (M, M) int32 codes."""
    global launches
    if not vc.is_cuda or not meta.is_cuda:
        raise ValueError("vclock_audit_cuda needs CUDA tensors")
    for t in (vc, meta):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("vclock_audit_cuda needs contiguous int32 tensors")
    m, n = vc.shape
    if meta.shape != (m, META_COLS):
        raise ValueError(f"meta must be ({m}, {META_COLS}), got {tuple(meta.shape)}")
    out = torch.empty((m, m), dtype=torch.int32, device=vc.device)
    err = _lib()(
        vc.data_ptr(), meta.data_ptr(), m, n, int(delta), out.data_ptr(),
        build.stream_ptr(vc),
    )
    build.check(err, "vclock_audit")
    launches += 1
    return out
