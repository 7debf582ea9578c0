"""Operations Dependency Graph (ODG) — paper §3.4.1 (port of
``repro.core.odg``).

The ODG is a directed graph over the operations logged in the DUOT with
three edge kinds:

  * **Timed**  — temporal priority: the next entry in ``seq`` order on
    the same resource;
  * **Causal** — vector-clock happens-before between operations;
  * **Data**   — read-from: a write of version v to a later read
    returning v on the same resource.

It decides which process observes which write and is the structure the
severity of violations is weighed over.  The edges are dense ``(m, m)``
boolean matrices (the log is bounded); the reductions are plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import vector_clock as vclock
from repro_torch.core.duot import READ, WRITE, Duot

INT32_MAX = 2 ** 31 - 1


class Odg(NamedTuple):
    timed: torch.Tensor    # (m, m) bool — temporal priority edges
    causal: torch.Tensor   # (m, m) bool — happens-before edges
    data: torch.Tensor     # (m, m) bool — read-from edges
    valid: torch.Tensor    # (m,)  bool — live vertices


def build(table: Duot) -> Odg:
    """The three edge sets of the DUOT.

    The reference marks a timed edge ``i -> j`` where no valid entry of
    the same resource lies strictly between them in ``seq``, through an
    ``(m, m, m)`` temporary (8.6 GB at m = 2048).  Here ``j`` is a timed
    successor of ``i`` when its ``seq`` equals the least ``seq`` above
    ``seq_i`` among the valid entries of ``i``'s resource: the same
    edges, ties in ``seq`` included, in ``(m, m)`` memory.
    """
    valid = table.valid
    pair = valid[:, None] & valid[None, :]
    same_res = table.resource[:, None] == table.resource[None, :]
    ordered = table.seq[:, None] < table.seq[None, :]
    base = pair & same_res & ordered

    # nxt[i]: the least seq above seq_i among valid entries of i's resource.
    later = same_res & valid[None, :] & ordered
    nxt = torch.where(later, table.seq[None, :], INT32_MAX).amin(dim=1)
    timed = base & (table.seq[None, :] == nxt[:, None])

    causal = pair & vclock.happens_before_matrix(table.vc)

    ki = table.kind[:, None]
    kj = table.kind[None, :]
    same_version = table.version[:, None] == table.version[None, :]
    data = base & (ki == WRITE) & (kj == READ) & same_version
    return Odg(timed=timed, causal=causal, data=data, valid=valid)


def reachability(adj: torch.Tensor, iters: int | None = None) -> torch.Tensor:
    """Transitive closure by repeated boolean squaring, the reference's
    step count (``(m - 1).bit_length()`` unless ``iters``).  The product
    of 0/1 matrices is taken in f32, exact while m <= 2**24."""
    m = adj.shape[0]
    steps = iters if iters is not None else max(1, (m - 1).bit_length())
    reach = adj
    for _ in range(steps):
        r = reach.to(torch.float32)
        reach = reach | (r @ r > 0)
    return reach


def dependency_closure(odg: Odg) -> torch.Tensor:
    """All-edges transitive closure — which operation is related to
    which, the relation behind the merge order."""
    return reachability(odg.timed | odg.causal | odg.data)


def observation_frontier(table: Duot, odg: Odg) -> torch.Tensor:
    """For each write w, the clients that have observed it (a data edge
    w -> r to a read r of that client), plus the writing client itself:
    ``(m, n_clients)`` bool.  A write every client has observed is
    collectable."""
    n = table.n_clients
    dev = table.client.device
    # one_hot as the reference takes it: ids outside [0, n) give no bit.
    reader = table.client[:, None] == torch.arange(n, device=dev)[None, :]
    obs = (odg.data.to(torch.float32) @ reader.to(torch.float32)) > 0
    is_write = table.kind == WRITE
    return obs | (reader & is_write[:, None])


def edge_counts(odg: Odg) -> dict[str, torch.Tensor]:
    return {
        "timed": odg.timed.sum(dtype=torch.int32),
        "causal": odg.causal.sum(dtype=torch.int32),
        "data": odg.data.sum(dtype=torch.int32),
    }


def severity_from_odg(
    odg: Odg, violation: torch.Tensor, *, w_timed=1.0, w_causal=2.0, w_data=3.0
) -> torch.Tensor:
    """The paper's severity over ODG edges: each edge whose endpoint pair
    is violated (``violation``, the audit's ``(m, m)`` matrix) adds its
    kind's weight; the total over all edges' weights, in f32.

    The reference sums f32 ones and then takes ``weight · count``, data
    + causal + timed, in f32; here each count is exact in int64, cast to
    f32 and weighed in the same order — the same value while each count
    stays below 2**24.
    """
    def term(w, mask):
        return (torch.tensor(w, dtype=torch.float32, device=mask.device)
                * mask.sum(dtype=torch.int64).to(torch.float32))

    data, causal, timed = odg.data, odg.causal, odg.timed
    num = (term(w_data, data & violation)
           + term(w_causal, causal & violation & ~data)
           + term(w_timed, timed & violation & ~causal & ~data))
    den = (term(w_data, data)
           + term(w_causal, causal & ~data)
           + term(w_timed, timed & ~causal & ~data))
    return num / torch.clamp(den, min=1.0)
