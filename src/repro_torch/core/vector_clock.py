"""Fidge/Mattern vector clocks on int32 tensors (port of
``repro.core.vector_clock``).

Clocks are ``(n_clients,)`` (or batched ``(..., n_clients)``) int32
tensors; the partial-order algebra is component-wise.
"""

from __future__ import annotations

import torch


def zeros(n_clients: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Initial clock: no operation has been performed (paper §3.2)."""
    return torch.zeros((n_clients,), dtype=torch.int32, device=device)


def tick(vc: torch.Tensor, client: int) -> torch.Tensor:
    """Advance ``client``'s component by one (a local event)."""
    out = vc.clone()
    out[int(client)] += 1
    return out


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Join of two clocks: component-wise max."""
    return torch.maximum(a, b)


def receive(local: torch.Tensor, incoming: torch.Tensor, client: int) -> torch.Tensor:
    """Message-receive rule: join then tick own component."""
    return tick(merge(local, incoming), client)


def leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a <= b`` in the partial order: every component <=."""
    return torch.all(a <= b, dim=-1)


def dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Strict happens-before ``a -> b``: a <= b and a != b (paper §3.3)."""
    return leq(a, b) & torch.any(a < b, dim=-1)


def concurrent(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a || b``: neither dominates."""
    return ~dominates(a, b) & ~dominates(b, a)


def happens_before_matrix(vcs: torch.Tensor) -> torch.Tensor:
    """Dense pairwise happens-before over ``(m, n)`` clocks -> ``(m, m)``.

    ``a -> b  <=>  max_n(a_n - b_n) <= 0  and  min_n(a_n - b_n) < 0``,
    reduced one component at a time with two ``(m, m)`` running extrema
    (no ``(m, m, n)`` temporary).  The CUDA audit kernel
    (``kernels/vclock_audit``) computes the same relation tile by tile.
    """
    m = vcs.shape[0]
    big = 2 ** 30
    maxd = torch.full((m, m), -big, dtype=torch.int32, device=vcs.device)
    mind = torch.full((m, m), big, dtype=torch.int32, device=vcs.device)
    for col in vcs.T:
        diff = col[:, None] - col[None, :]
        torch.maximum(maxd, diff, out=maxd)
        torch.minimum(mind, diff, out=mind)
    return (maxd <= 0) & (mind < 0)


def concurrency_matrix(vcs: torch.Tensor) -> torch.Tensor:
    """Pairwise concurrency (off-diagonal; the diagonal is False)."""
    hb = happens_before_matrix(vcs)
    m = vcs.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=vcs.device)
    return ~(hb | hb.T) & ~eye


def total_order_key(vcs: torch.Tensor, clients: torch.Tensor) -> torch.Tensor:
    """Deterministic linear extension of the causal order: concurrent
    clocks tie-break by (clock sum, client id), int32 arithmetic as in
    the reference (component sums strictly increase along
    happens-before edges)."""
    sums = torch.sum(vcs, dim=-1, dtype=torch.int32)
    n_clients = vcs.shape[-1]
    return sums * (n_clients + 1) + clients.to(torch.int32)
