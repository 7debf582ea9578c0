"""Batched op ingestion: the three per-op prefix reductions of
``core.xstcc.apply_op_batch`` (port of ``repro.kernels.op_ingest``).

For every op ``i`` of a ``(B,)`` batch, over the ops ``j < i`` and the
pending ring:

  * ``occ[i]``   — per-resource exclusive write count (version rank);
  * ``raw[i]``   — replica-visible version: ``raw0`` joined with every
    visible earlier batch write and every visible pending write;
  * ``floor[i]`` — session floor: ``floor0`` joined with the
    per-(client, resource) prefix max of earlier contributions.

Visibility is the closed-form cadence predicate

    visible(i, j) = is_write(j) ∧ same_resource ∧
                    (replica(i) == replica(j) ∨ op_index(i) >= apply_index(j))

Integer-exact implementations, equal bit for bit:

  * :func:`op_ingest_ref` — the plain PyTorch version, a port of
    ``repro.kernels.ref.op_ingest_ref`` with dense ``(B, B)`` masks;
  * :func:`op_ingest_chunked` — the plain twin of the large-batch kernels'
    decomposition: partials per :func:`ingest_plan` entry, combined by
    integer add (occ) and max (raw, floor);
  * :func:`op_ingest_cuda` — the hand-written kernels
    (``csrc/op_ingest.cu``).  A padded batch of at most ``SMALL_MAX`` rows
    runs ONE CUDA kernel: one CTA, one thread per row, the three passes
    separated by ``__syncthreads()``.  A larger batch runs three (one per
    pass, the pending sweep inside the first), each over 32-row tiles
    whose 16 warps split the candidates as :func:`ingest_plan` says.
    Either way the call allocates one ``(5, Bp)`` int32 buffer (rows occ,
    raw, floor, verw, contrib) and counts one launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

# Cadence sentinel: an apply index no op index ever reaches.
NEVER = 2 ** 30
TILE = 128
# op meta columns (Bp, OP_COLS) int32
CLIENT, REPLICA, RESOURCE, IS_WRITE, GLOBAL0, RAW0, FLOOR0 = 0, 1, 2, 3, 4, 5, 6
OPIDX, APPLYIDX = 7, 8
OP_COLS = 16
# pending meta columns (Qp, PEND_COLS) int32
PVER, PRES, PLIVE, PAPPLY = 0, 1, 2, 3
PEND_COLS = 8

# The large-batch kernels' tile: 32 rows (one per lane), 16 warps that
# split the candidates.
ROWS = 32
WARPS = 16
# Padded batches up to SMALL_MAX rows run the one-CTA kernel (one CUDA
# launch; it takes at most 1024): on the H100 the tile kernels tie it at
# 256 rows and win above (chip_smoke.py's kernels phase times both).
SMALL_MAX = 128

# Kernel launches made by op_ingest_cuda (one per call: one CUDA kernel
# up to SMALL_MAX rows, three above).
launches = 0
# (bp, qp, device) -> the plan on that device.
_PLANS: dict = {}


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def op_ingest_ref(
    client, replica, resource, is_write, g0, raw0, floor0, *,
    op_index=None, apply_index=None, pend_version=None,
    pend_resource=None, pend_live=None, pend_apply=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: dense O(B²) masks, as ``ref.op_ingest_ref``."""
    dev = client.device
    c, p, r = (_i32(x, dev) for x in (client, replica, resource))
    is_w = torch.as_tensor(is_write, device=dev).to(torch.bool)
    b = c.shape[0]

    idx = torch.arange(b, device=dev)
    lower = idx[:, None] > idx[None, :]
    same_r = r[:, None] == r[None, :]
    prior_w = lower & same_r & is_w[None, :]

    occ = prior_w.sum(dim=1, dtype=torch.int32)
    ver_w = _i32(g0, dev) + occ + 1
    verw_masked = torch.where(is_w, ver_w, 0)

    vis = prior_w & (p[:, None] == p[None, :])
    if apply_index is not None:
        g = _i32(op_index, dev)
        a = _i32(apply_index, dev)
        vis = vis | (prior_w & (g[:, None] >= a[None, :]))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    raw = torch.maximum(
        _i32(raw0, dev),
        torch.where(vis, verw_masked[None, :], zero).amax(dim=1),
    ) if b else _i32(raw0, dev)
    if pend_apply is not None and b:
        g = _i32(op_index, dev)
        pvis = (
            torch.as_tensor(pend_live, device=dev).to(torch.bool)[None, :]
            & (r[:, None] == _i32(pend_resource, dev)[None, :])
            & (g[:, None] >= _i32(pend_apply, dev)[None, :])
        )
        raw = torch.maximum(
            raw,
            torch.where(pvis, _i32(pend_version, dev)[None, :], zero).amax(dim=1),
        )

    same_cr = (c[:, None] == c[None, :]) & same_r
    contrib = torch.where(is_w, ver_w, raw)
    floor = torch.maximum(
        _i32(floor0, dev),
        torch.where(lower & same_cr, contrib[None, :], zero).amax(dim=1),
    ) if b else _i32(floor0, dev)
    return occ, raw, floor


class Packed(NamedTuple):
    meta: torch.Tensor   # (Bp, OP_COLS) int32, Bp a multiple of TILE
    pend: torch.Tensor   # (Qp, PEND_COLS) int32
    b: int               # true batch length (rows beyond it are inert)


def pack_ops(
    client, replica, resource, is_write, g0, raw0, floor0, *,
    op_index=None, apply_index=None, pend_version=None,
    pend_resource=None, pend_live=None, pend_apply=None,
) -> Packed:
    """The kernel's meta layout, with the reference's inert padding.

    The batch pads to a ``TILE`` multiple with reads on resource ``-1``
    (replica ``-1``, apply index ``NEVER``) that match no real op; the
    pending ring pads to a multiple of 8 with dead slots on resource
    ``-1``.  ``apply_index=None`` (scalar semantics) packs ``NEVER``.
    """
    dev = client.device
    b = client.shape[0]
    bp = max(TILE, -(-b // TILE) * TILE)
    meta = torch.zeros((bp, OP_COLS), dtype=torch.int32, device=dev)
    meta[b:, REPLICA] = -1
    meta[b:, RESOURCE] = -1
    meta[:, APPLYIDX] = NEVER
    cols = (
        (CLIENT, client), (REPLICA, replica), (RESOURCE, resource),
        (IS_WRITE, is_write), (GLOBAL0, g0), (RAW0, raw0), (FLOOR0, floor0),
        (OPIDX, op_index), (APPLYIDX, apply_index),
    )
    for j, x in cols:
        if x is not None:
            meta[:b, j] = _i32(x, dev)

    q = 0 if pend_version is None else pend_version.shape[0]
    qp = max(8, -(-q // 8) * 8)
    pend = torch.zeros((qp, PEND_COLS), dtype=torch.int32, device=dev)
    pend[:, PRES] = -1
    if q:
        pend[:q, PVER] = _i32(pend_version, dev)
        pend[:q, PRES] = _i32(pend_resource, dev)
        pend[:q, PLIVE] = _i32(pend_live, dev)
        pend[:q, PAPPLY] = (
            NEVER if pend_apply is None else _i32(pend_apply, dev)
        )
    return Packed(meta=meta, pend=pend, b=b)


def ingest_plan(bp: int, qp: int) -> torch.Tensor:
    """The large-batch kernels' slice table, ``(bp // ROWS, WARPS, 4)``
    int32: for row tile ``t`` (rows ``ROWS t .. ROWS t + ROWS - 1``) and warp
    ``w``, the batch candidates ``[lo, hi)`` and pending slots ``[plo,
    phi)`` that warp tests.  The tile's candidates ``[0, ROWS (t + 1))``
    (the kernel masks ``j >= i``) and the ring ``[0, qp)`` are each cut
    into ``WARPS`` contiguous slices, so every pair ``(i, j < i)`` and every
    (row, slot) pair falls in exactly one entry."""
    def cuts(n):
        c = -(-n // WARPS)
        return [(min(n, w * c), min(n, (w + 1) * c)) for w in range(WARPS)]

    pend = cuts(qp)
    plan = [[(lo, hi, plo, phi) for (lo, hi), (plo, phi) in
             zip(cuts(ROWS * (t + 1)), pend)] for t in range(bp // ROWS)]
    return torch.tensor(plan, dtype=torch.int32).reshape(bp // ROWS, WARPS, 4)


def op_ingest_chunked(packed: Packed) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the large-batch kernels: each pass sums (occ) or
    maxes (raw, floor) one partial per plan entry, as the warps do, with
    the pending max joined in pass 1.  Equal to :func:`op_ingest_ref` bit
    for bit (integer add and max do not depend on order)."""
    meta, pend, b = packed
    bp, qp = meta.shape[0], pend.shape[0]
    plan = ingest_plan(bp, qp)
    cli, rep, res = meta[:, CLIENT], meta[:, REPLICA], meta[:, RESOURCE]
    w, gi, app = meta[:, IS_WRITE] > 0, meta[:, OPIDX], meta[:, APPLYIDX]
    zero = torch.zeros((), dtype=torch.int32, device=meta.device)
    occ = torch.zeros(bp, dtype=torch.int32, device=meta.device)
    raw = meta[:, RAW0].clone()
    floor = meta[:, FLOOR0].clone()

    def entries():
        for t in range(bp // ROWS):
            i = torch.arange(t * ROWS, (t + 1) * ROWS, device=meta.device)
            for lo, hi, plo, phi in plan[t].tolist():
                j = torch.arange(lo, hi, device=meta.device)
                yield i, j, (j[None, :] < i[:, None]), plo, phi

    def part_max(mask, vals):
        return torch.where(mask, vals[None, :], zero).amax(dim=1) if mask.shape[1] else zero

    for i, j, lower, plo, phi in entries():        # pass 1 + pending
        occ[i] += (lower & w[j][None, :] & (res[j][None, :] == res[i][:, None])).sum(
            dim=1, dtype=torch.int32)
        pq = pend[plo:phi]
        pvis = ((pq[:, PLIVE] > 0)[None, :] & (pq[:, PRES][None, :] == res[i][:, None])
                & (gi[i][:, None] >= pq[:, PAPPLY][None, :]))
        raw[i] = torch.maximum(raw[i], part_max(pvis, pq[:, PVER]))
    verw = torch.where(w, meta[:, GLOBAL0] + occ + 1, zero)
    for i, j, lower, _, _ in entries():             # pass 2
        vis = (lower & w[j][None, :] & (res[j][None, :] == res[i][:, None])
               & ((rep[j][None, :] == rep[i][:, None]) | (gi[i][:, None] >= app[j][None, :])))
        raw[i] = torch.maximum(raw[i], part_max(vis, verw[j]))
    contrib = torch.where(w, verw, raw)
    for i, j, lower, _, _ in entries():             # pass 3
        same = (lower & (res[j][None, :] == res[i][:, None])
                & (cli[j][None, :] == cli[i][:, None]))
        floor[i] = torch.maximum(floor[i], part_max(same, contrib[j]))
    return occ[:b], raw[:b], floor[:b]


def _plan(bp: int, qp: int, device) -> torch.Tensor:
    key = (bp, qp, device)
    if key not in _PLANS:
        _PLANS[key] = ingest_plan(bp, qp).to(device)
    return _PLANS[key]


def _lib():
    lib = build.load("op_ingest")
    fn = lib.op_ingest_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, ci, vp, vp, vp]
        fn.restype = ci
    return fn


def op_ingest_cuda(packed: Packed) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/op_ingest.cu`` on CUDA tensors; ``(occ, raw, floor)``.
    A padded batch of at most ``SMALL_MAX`` rows runs the one-CTA kernel,
    a larger one the three tile kernels."""
    global launches
    meta, pend, b = packed
    if not meta.is_cuda or not pend.is_cuda:
        raise ValueError("op_ingest_cuda needs CUDA tensors")
    for t in (meta, pend):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("op_ingest_cuda needs contiguous int32 tensors")
    bp, qp = meta.shape[0], pend.shape[0]
    if bp % TILE:
        raise ValueError(f"padded batch {bp} is not a multiple of {TILE}")
    plan = None if bp <= SMALL_MAX else _plan(bp, qp, meta.device)
    out = torch.empty((5, bp), dtype=torch.int32, device=meta.device)
    err = _lib()(meta.data_ptr(), bp, pend.data_ptr(), qp, out.data_ptr(),
                 None if plan is None else plan.data_ptr(), build.stream_ptr(meta))
    build.check(err, "op_ingest")
    launches += 1
    return out[0, :b], out[1, :b], out[2, :b]
