"""Pairwise DUOT causality audit codes (port of
``repro.kernels.vclock_audit``).

Output codes, as in ``repro.kernels.ref.vclock_audit_ref``:
``phase | violation << 8 | timed << 9`` for every ordered pair of log
entries, with happens-before over N-component vector clocks

    a -> b  <=>  max_n(a_n - b_n) <= 0  and  min_n(a_n - b_n) < 0

A pair's code is 0 unless ``base`` (both valid, same resource,
``seq_i < seq_j``) holds, so only base pairs need the clock compare.
Three implementations, equal bit for bit:

  * :func:`vclock_audit_ref` — the plain PyTorch version (row chunks of
    the dense ``(rows, M, N)`` compare, so M = 16384 fits in memory);
  * :func:`vclock_audit_compacted` — plain twin of the kernel's
    decomposition: per tile, the base list, the compare over it only,
    a scatter into a zero tile;
  * :func:`vclock_audit_cuda` — the hand-written kernel
    (``csrc/vclock_audit.cu``): ``TI x TJ`` output tiles, one launch
    reading the clocks and the six columns in place; the compare runs
    over a compacted base list (``design="compact"``) or as register
    tiles over every pair of a warp's rows (``"dense"``); ``"auto"``
    picks per tile by its base count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# The kernel's output tile (as in the .cu) and its designs, as the C
# entry point numbers them.
TI, TJ = 128, 128
DESIGNS = ("auto", "dense", "compact")
COLUMNS = ("client", "kind", "resource", "version", "seq", "valid")
VALID = COLUMNS.index("valid")
_DESIGN_CODE = {d: c for c, d in enumerate(DESIGNS)}
_DTYPES = tuple(torch.bool if c == VALID else torch.int32 for c in range(len(COLUMNS)))

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


def vclock_audit_compacted(
    vc, client, kind, resource, version, seq, valid, *, delta: int = 0,
) -> torch.Tensor:
    """Plain twin of the kernel's decomposition: per ``TI x TJ`` tile, the
    list of ``base`` pairs (valid, same resource, ``seq_i < seq_j``), the
    clock compare over that list only, and a scatter of their codes into
    a zero tile.  Equal to :func:`vclock_audit_ref`."""
    m, n = vc.shape
    out = torch.zeros((m, m), dtype=torch.int32, device=vc.device)
    vc = vc.to(torch.int32)
    for i0 in range(0, m, TI):
        si = slice(i0, min(m, i0 + TI))
        for j0 in range(0, m, TJ):
            sj = slice(j0, min(m, j0 + TJ))
            base = (valid[si, None] & valid[None, sj]
                    & (resource[si, None] == resource[None, sj])
                    & (seq[si, None] < seq[None, sj]))
            il, jl = base.nonzero(as_tuple=True)            # the tile's list
            if il.numel() == 0:
                continue
            gi, gj = il + i0, jl + j0
            # The kernel's test: max_n(a_n - b_n) <= 0, then sum(a) < sum(b)
            # for the strict part.
            a, b = vc[gi], vc[gj]
            hb = ((a - b).amax(dim=1) <= 0) & (
                a.sum(dim=1, dtype=torch.int64) < b.sum(dim=1, dtype=torch.int64))
            same = client[gi] == client[gj]
            ki, kj = kind[gi], kind[gj]
            vi, vj = version[gi], version[gj]
            # The code if i -> j, then phase 6 where it does not.
            phase = torch.where(same, 0, 5)
            for ph, (k_i, k_j) in enumerate(((0, 0), (1, 1), (1, 0), (0, 1)), start=1):
                phase = torch.where(same & (ki == k_i) & (kj == k_j), ph, phase)
            wr = (ki == 1) & (kj == 0)
            viol = (((phase == 1) | (phase == 3)) & (vj < vi)) | (
                ((phase == 2) | (phase == 4)) & (vj <= vi)) | (
                (phase == 5) & wr & (vj < vi))
            timed = (wr & ((seq[gj] - seq[gi]) > delta) & (vj < vi)
                     if delta > 0 else torch.zeros_like(viol))
            phase = torch.where(hb, phase, 6)
            viol = viol & hb
            out[gi, gj] = (phase | (viol.to(torch.int32) << 8)
                           | (timed.to(torch.int32) << 9)).to(torch.int32)
    return out


_FN = None


def _lib():
    global _FN
    if _FN is None:
        fn = build.load("vclock_audit").vclock_audit_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 4
        fn.restype = ci
        _FN = fn
    return _FN


def vclock_audit_cuda(vc, client, kind, resource, version, seq, valid, *,
                      delta: int = 0, design: str = "auto") -> torch.Tensor:
    """Launch ``csrc/vclock_audit.cu``: (M, N) int32 clocks and the six
    (M,) columns (int32; ``valid`` bool), all on one CUDA device, read in
    place -> (M, M) int32 codes.  ``design`` is ``"auto"`` (per tile, by
    its base count), ``"dense"`` or ``"compact"``."""
    global launches
    code = _DESIGN_CODE.get(design)
    if code is None:
        raise ValueError(f"unknown design {design!r}; expected one of {DESIGNS}")
    if not vc.is_cuda:
        raise ValueError("vclock_audit_cuda needs CUDA tensors")
    if vc.dim() != 2:
        raise ValueError(f"vc must be (M, N), got {tuple(vc.shape)}")
    m, n = vc.shape
    if vc.dtype is not torch.int32 or not vc.is_contiguous():
        vc = vc.to(torch.int32).contiguous()
    dev, shape = vc.get_device(), (m,)
    cols = [client, kind, resource, version, seq, valid]
    for c, (x, want) in enumerate(zip(cols, _DTYPES)):
        if x.dtype is not want or not x.is_contiguous():
            x = cols[c] = (x != 0 if c == VALID else x.to(want)).contiguous()
        if x.shape != shape or x.get_device() != dev:
            raise ValueError(f"{COLUMNS[c]} must be ({m},) on {vc.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    out = torch.empty((m, m), dtype=torch.int32, device=vc.device)
    if m == 0:
        return out
    if n == 0:
        raise ValueError("vclock_audit_cuda needs clocks of at least one component")
    err = (_FN or _lib())(
        vc.data_ptr(), *(x.data_ptr() for x in cols), out.data_ptr(),
        build.stream_ptr(vc), m, n, int(delta), code,
    )
    if err:
        build.check(err, "vclock_audit")
    launches += 1
    return out
