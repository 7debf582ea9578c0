"""Distributed User Operations Table (port of ``repro.core.duot``).

The DUOT is the timestamp-ordered log of client operations (paper
§3.2): a fixed-capacity structure of int32 tensors.  Entries:

  ``client``    user id ``U_i``
  ``kind``      READ=0 / WRITE=1
  ``resource``  resource id ``x``
  ``version``   version written (W) or observed (R)
  ``replica``   replica the op executed on
  ``seq``       global arrival timestamp
  ``vc``        (cap, n_clients) Fidge vector clock
  ``valid``     live entry (bool)

The table never wraps: once ``size`` reaches the capacity further
records are dropped (``next_seq`` still advances), so an audit covers
the first ``capacity`` ops of a run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

READ = 0
WRITE = 1


class Duot(NamedTuple):
    """Fixed-capacity distributed user operations table."""

    client: torch.Tensor    # (cap,) int32
    kind: torch.Tensor      # (cap,) int32
    resource: torch.Tensor  # (cap,) int32
    version: torch.Tensor   # (cap,) int32
    replica: torch.Tensor   # (cap,) int32
    seq: torch.Tensor       # (cap,) int32
    vc: torch.Tensor        # (cap, n_clients) int32
    valid: torch.Tensor     # (cap,) bool
    size: torch.Tensor      # () int32 — next free slot (never wraps)
    next_seq: torch.Tensor  # () int32 — next global timestamp

    @property
    def capacity(self) -> int:
        return self.client.shape[0]

    @property
    def n_clients(self) -> int:
        return self.vc.shape[1]


def make(capacity: int, n_clients: int, device: str | torch.device = "cuda") -> Duot:
    """Empty table: all logical clocks zero (paper §3.2)."""
    i32 = dict(dtype=torch.int32, device=device)
    return Duot(
        client=torch.full((capacity,), -1, **i32),
        kind=torch.zeros((capacity,), **i32),
        resource=torch.full((capacity,), -1, **i32),
        version=torch.zeros((capacity,), **i32),
        replica=torch.full((capacity,), -1, **i32),
        seq=torch.zeros((capacity,), **i32),
        vc=torch.zeros((capacity, n_clients), **i32),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        size=torch.zeros((), **i32),
        next_seq=torch.zeros((), **i32),
    )


_FIELDS = ("client", "kind", "resource", "version", "replica", "vc")


def append(
    table: Duot, *, client: int, kind: int, resource: int, version: int,
    replica: int, vc: torch.Tensor,
) -> Duot:
    """Register one operation; dropped when the table is full."""
    ops = {
        "client": torch.tensor([client]), "kind": torch.tensor([kind]),
        "resource": torch.tensor([resource]),
        "version": torch.tensor([version]),
        "replica": torch.tensor([replica]), "vc": vc.reshape(1, -1),
    }
    return record(table, ops)


def record(table: Duot, ops: dict[str, torch.Tensor]) -> Duot:
    """Bulk-append a batch of operations at slots ``[size, size+b)``.

    Rows past the capacity are dropped.  The reference picks between a
    contiguous copy and a scatter-with-drop under ``lax.cond``; here the
    branch is taken on the host from ``size``, and the kept prefix of
    the batch is copied in one slice per field — the same table either
    way.
    """
    b = ops["client"].shape[0]
    cap = table.capacity
    dev = table.client.device
    size = int(table.size)
    n = max(0, min(b, cap - size))
    seqs = table.next_seq + torch.arange(b, dtype=torch.int32, device=dev)
    new = {}
    for name in _FIELDS:
        arr = getattr(table, name).clone()
        arr[size:size + n] = torch.as_tensor(ops[name])[:n].to(dev, arr.dtype)
        new[name] = arr
    seq = table.seq.clone()
    seq[size:size + n] = seqs[:n]
    valid = table.valid.clone()
    valid[size:size + n] = True
    return Duot(
        **new, seq=seq, valid=valid,
        size=torch.tensor(size + n, dtype=torch.int32, device=dev),
        next_seq=table.next_seq + b,
    )


def gc(table: Duot, frontier: torch.Tensor) -> Duot:
    """Garbage collection (paper §3.4.1).

    Drops the entries whose clock the global stability frontier (the
    component-wise minimum of the replicas' applied clocks) covers:
    every server has observed them, so they can take part in no
    violation.  The kept entries move to the front in their order (a
    stable index select); the rest of the table takes the fill values of
    :func:`make` (-1 for client, resource and replica, 0 elsewhere).
    """
    cap = table.capacity
    dev = table.client.device
    covered = table.valid & torch.all(table.vc <= frontier, dim=-1)
    keep = table.valid & ~covered
    n_keep = keep.sum(dtype=torch.int32)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    live = torch.arange(cap, device=dev) < n_keep

    def compact(arr, fill):
        out = arr[order]
        mask = live if arr.ndim == 1 else live[:, None]
        return torch.where(mask, out, torch.full_like(out, fill))

    return Duot(
        client=compact(table.client, -1),
        kind=compact(table.kind, 0),
        resource=compact(table.resource, -1),
        version=compact(table.version, 0),
        replica=compact(table.replica, -1),
        seq=compact(table.seq, 0),
        vc=compact(table.vc, 0),
        valid=live,
        size=n_keep,
        next_seq=table.next_seq,
    )


def live_mask(table: Duot) -> torch.Tensor:
    return table.valid


def as_dict(table: Duot) -> dict[str, torch.Tensor]:
    return {
        "client": table.client,
        "kind": table.kind,
        "resource": table.resource,
        "version": table.version,
        "replica": table.replica,
        "seq": table.seq,
        "vc": table.vc,
        "valid": table.valid,
    }
