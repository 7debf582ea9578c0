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

Two implementations, integer-exact and equal bit for bit:

  * :func:`op_ingest_ref` — the plain PyTorch version, a port of
    ``repro.kernels.ref.op_ingest_ref`` with dense ``(B, B)`` masks;
  * :func:`op_ingest_cuda` — the hand-written kernel
    (``csrc/op_ingest.cu``), three launches over 128-row tiles.
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

# Kernel launches made by op_ingest_cuda (one per call, three CUDA
# kernels each).
launches = 0


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


def _lib():
    lib = build.load("op_ingest")
    fn = lib.op_ingest_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def op_ingest_cuda(packed: Packed) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/op_ingest.cu`` on CUDA tensors; ``(occ, raw, floor)``."""
    global launches
    meta, pend, b = packed
    if not meta.is_cuda or not pend.is_cuda:
        raise ValueError("op_ingest_cuda needs CUDA tensors")
    for t in (meta, pend):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("op_ingest_cuda needs contiguous int32 tensors")
    bp = meta.shape[0]
    if bp % TILE:
        raise ValueError(f"padded batch {bp} is not a multiple of {TILE}")
    out = torch.empty((5, bp), dtype=torch.int32, device=meta.device)
    fn = _lib()
    err = fn(
        meta.data_ptr(), bp, pend.data_ptr(), pend.shape[0],
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), out[4].data_ptr(), build.stream_ptr(meta),
    )
    build.check(err, "op_ingest")
    launches += 1
    return out[0, :b], out[1, :b], out[2, :b]
