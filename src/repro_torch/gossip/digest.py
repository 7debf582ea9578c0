"""Per-resource-range version digests, the gossip exchange unit (port of
``repro.gossip.digest``).

A replica's ``(R,)`` applied-version row is summarized over ``K``
contiguous resource ranges into four int32 components per range:

  * ``SUM`` — wrapping sum of applied versions in the range;
  * ``MAX`` — the range's version frontier;
  * ``CHK`` — position-weighted wrapping checksum (odd weights);
  * ``CNT`` — resources ever written.

SUM and CHK wrap like the reference's int32 sums.  Here they are summed
in int64 from per-element values already reduced mod 2^32, and wrapped
to int32 once at the end: the same residue, with no reliance on how an
int32 ``index_add`` accumulates.
"""

from __future__ import annotations

import torch

# Component order of a digest row (matches kernels.digest_compare).
SUM, MAX, CHK, CNT = 0, 1, 2, 3
N_COMPONENTS = 4
# Wire size of one range digest: four int32 components.
DIGEST_BYTES = 4 * N_COMPONENTS

# Knuth's multiplicative-hash constant; masked to 15 bits and forced odd.
_WEIGHT_MULT = 2654435761
_WEIGHT_MASK = (1 << 15) - 1
_MOD32 = 1 << 32


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    x = x & (_MOD32 - 1)
    return torch.where(x >= (1 << 31), x - _MOD32, x).to(torch.int32)


def range_of_resource(n_resources: int, n_ranges: int,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """(R,) int32 — the digest range covering each resource: contiguous
    ranges of ``ceil(R / K)`` resources, ``K`` clamped to ``[1, R]``."""
    k = max(1, min(int(n_ranges), n_resources))
    span = -(-n_resources // k)          # ceil
    rid = torch.arange(n_resources, dtype=torch.int32, device=device) // span
    return torch.clamp(rid, max=k - 1)


def checksum_weights(n_resources: int,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """(R,) int32 — odd per-resource weights ``(r * M mod 2^32) & 0x7fff
    | 1``; the low 15 bits of the product need no uint32, so the product
    is taken in int64."""
    r = torch.arange(n_resources, dtype=torch.int64, device=device)
    w = (r * _WEIGHT_MULT) & _WEIGHT_MASK
    return (w | 1).to(torch.int32)


def range_digests(replica_version: torch.Tensor, n_ranges: int) -> torch.Tensor:
    """Digest every replica's version row; ``(P, K, 4)`` int32 (a single
    ``(R,)`` row yields ``(K, 4)``)."""
    v = replica_version.to(torch.int32)
    squeeze = v.dim() == 1
    if squeeze:
        v = v[None]
    p, r = v.shape
    dev = v.device
    k = max(1, min(int(n_ranges), r))
    rid = range_of_resource(r, k, dev).long()
    w = checksum_weights(r, dev).long()
    v64 = v.long()
    z64 = torch.zeros((p, k), dtype=torch.int64, device=dev)
    s = z64.index_add(1, rid, v64 & (_MOD32 - 1))
    chk = z64.index_add(1, rid, (v64 * w[None, :]) & (_MOD32 - 1))
    cnt = z64.index_add(1, rid, (v > 0).long())
    mx = torch.zeros((p, k), dtype=torch.int32, device=dev).scatter_reduce(
        1, rid[None, :].expand(p, r), v, "amax", include_self=True)
    out = torch.stack(
        [wrap_int32(s), mx, wrap_int32(chk), cnt.to(torch.int32)], dim=-1)
    return out[0] if squeeze else out
