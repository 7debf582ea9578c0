"""Inter-pod gradient/delta compression (port of
``repro.sync.compression``).

The paper's monetary-cost model bills inter-DC (= inter-pod) traffic at
$0.01/GB while intra-DC is free (Table 2).  X-STCC already divides
inter-pod traffic by Δ; compression multiplies the saving:

  * ``int8``  — per-leaf symmetric quantization (1 B/elem on the wire
    instead of 2-4 B/elem), dequantized and averaged locally.
  * ``topk``  — magnitude top-k sparsification: (values, indices) pairs,
    k = ``fraction`` x size.

Trees are dicts of tensors (``repro_torch.tree``).  Rounding is half to
even on both sides (``torch.round`` as ``jnp.round``), so the int8 codes
equal the reference's.  Top-k keeps the reference's tie rule explicitly:
largest magnitude first, and among equal magnitudes the lower index
(``jax.lax.top_k``'s order; ``torch.topk`` promises none on CUDA).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.fp import div_f32
from repro_torch.tree import leaves, tree_map

Tensor = torch.Tensor


def int8_quantize(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-leaf int8.  Returns (q, scale)."""
    x32 = x.to(torch.float32)
    scale = div_f32(torch.clamp(torch.amax(torch.abs(x32)), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def int8_compress_tree(tree) -> Any:
    """Tree -> the same tree of ``(q, scale)`` pairs."""
    return tree_map(int8_quantize, tree)


def int8_decompress_tree(ctree, like) -> Any:
    return tree_map(lambda qs, x: int8_dequantize(qs[0], qs[1], x.dtype), ctree, like)


def topk_index(mag: Tensor, k: int) -> Tensor:
    """``(rows, k)`` int64 indices of each row's ``k`` largest entries of
    ``mag`` ``(rows, n)``: larger first, and among equal values the lower
    index first (``jax.lax.top_k``'s order), on any device."""
    rows = mag.shape[0]
    kth = torch.topk(mag, k, dim=1, sorted=False).values.amin(dim=1, keepdim=True)
    above = mag > kth
    tie = mag == kth
    room = k - above.sum(dim=1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie, dim=1) <= room))
    idx = take.nonzero()[:, 1].reshape(rows, k)          # ascending index
    order = torch.sort(torch.gather(mag, 1, idx), dim=1, descending=True,
                       stable=True).indices
    return torch.gather(idx, 1, order)


def topk_sparsify(x: Tensor, fraction: float) -> tuple[Tensor, Tensor, Tensor]:
    """Keep the top-|fraction| entries by magnitude.

    Returns (values (k,), indices (k,) int32, error_feedback residual)."""
    flat = x.to(torch.float32).reshape(-1)
    k = max(1, int(flat.shape[0] * fraction))
    idx = topk_index(torch.abs(flat)[None], k)[0]
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return kept, idx.to(torch.int32), residual.reshape(x.shape).to(x.dtype)


def topk_densify(values: Tensor, indices: Tensor, shape, dtype) -> Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=values.device)
    out.index_add_(0, indices.long(), values.to(torch.float32))
    return out.reshape(tuple(shape)).to(dtype)


def wire_bytes(tree, method: str, fraction: float = 0.01) -> int:
    """Analytic wire size of one pod's payload (for the cost model).
    Leaves need only ``shape`` and ``dtype`` (meta tensors do)."""
    total = 0
    for leaf in leaves(tree):
        n = 1
        for s in leaf.shape:
            n *= int(s)
        if method == "none":
            total += n * leaf.dtype.itemsize
        elif method == "int8":
            total += n * 1 + 4
        elif method == "topk":
            k = max(1, int(n * fraction))
            total += k * (4 + 4)
        else:
            raise ValueError(method)
    return total
