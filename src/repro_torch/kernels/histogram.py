"""Fixed-bin metric histograms.

Port of ``repro.kernels.histogram``: ``(M, B)`` f32 observations, each
row with its own ``[lo, 1/width]`` params, become ``(M, n_bins)`` int32
counts.  An observation lands in ``clip(floor((v - lo) * inv_w), 0,
n_bins - 1)`` — below ``lo`` saturates into bin 0, at or above ``hi``
into the top bin — and masked-out observations count nothing.

  * :func:`histogram_ref` — the plain version, a whole-array
    re-derivation of the reference's ``bin_tile`` summed over columns;
  * :func:`histogram_cuda` — the hand-written kernel
    (``csrc/histogram.cu``): one block per (row, column chunk), shared
    memory counts, atomics into the zeroed output.

The index keeps the reference's two f32 roundings (subtract, then
multiply) and its saturating float-to-int conversion (NaN -> 0), so the
plain version, the kernel and the reference agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Per-row bin params layout: (M, 2) f32.
LO, INV_W = 0, 1

COLS_PER_BLOCK = 1024   # observations per block (as in the .cu)
MAX_BINS = 12288        # shared-memory counts one block holds in 48 KB

launches = 0


def metric_params(lo, hi, n_bins: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Per-row ``[lo, n_bins / (hi - lo)]`` params as ``(M, 2)`` f32,
    computed in f32 as the reference does; ``lo``/``hi`` are scalars or
    ``(M,)`` and broadcast against each other."""
    lo = torch.atleast_1d(torch.as_tensor(lo, dtype=torch.float32, device=device))
    hi = torch.atleast_1d(torch.as_tensor(hi, dtype=torch.float32, device=device))
    lo, hi = torch.broadcast_tensors(lo, hi)
    inv_w = torch.tensor(float(n_bins), dtype=torch.float32, device=device) / (hi - lo)
    return torch.stack([lo, inv_w], dim=1)


def bin_index(vals: torch.Tensor, params: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(M, B) int64 bin of each observation."""
    f = torch.floor((vals - params[:, LO:LO + 1]) * params[:, INV_W:INV_W + 1])
    # The reference converts with saturation (NaN -> 0), then clips.
    f = torch.nan_to_num(f, nan=0.0).clamp(0, n_bins - 1)
    return f.long()


def histogram_ref(vals: torch.Tensor, mask: torch.Tensor, params: torch.Tensor,
                  *, n_bins: int) -> torch.Tensor:
    """Plain version: ``(M, n_bins)`` int32 masked counts."""
    m = vals.shape[0]
    idx = bin_index(vals.to(torch.float32), params, n_bins)
    rows = torch.arange(m, device=vals.device)[:, None] * n_bins
    out = torch.zeros(m * n_bins, dtype=torch.int64, device=vals.device)
    out.index_add_(0, (rows + idx).reshape(-1), (mask > 0).long().reshape(-1))
    return out.view(m, n_bins).to(torch.int32)


def _lib():
    fn = build.load("histogram").histogram_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp]
        fn.restype = ci
    return fn


def histogram_cuda(vals: torch.Tensor, mask: torch.Tensor, params: torch.Tensor,
                   *, n_bins: int) -> torch.Tensor:
    """Launch ``csrc/histogram.cu``: ``vals`` (M, B) f32, ``mask`` (M, B)
    int32, ``params`` (M, 2) f32, all on one CUDA device."""
    global launches
    vals = vals.to(torch.float32).contiguous()
    mask = mask.to(torch.int32).contiguous()
    params = params.to(torch.float32).contiguous()
    if not (vals.is_cuda and mask.is_cuda and params.is_cuda):
        raise ValueError("histogram_cuda needs CUDA tensors")
    if vals.dim() != 2 or mask.shape != vals.shape or params.shape != (vals.shape[0], 2):
        raise ValueError(
            f"vals/mask must be (M, B) and params (M, 2); got {tuple(vals.shape)}, "
            f"{tuple(mask.shape)}, {tuple(params.shape)}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"histogram_cuda takes 1..{MAX_BINS} bins, got {n_bins}")
    m, b = vals.shape
    out = torch.zeros((m, n_bins), dtype=torch.int32, device=vals.device)
    if m == 0 or b == 0:
        return out
    err = _lib()(vals.data_ptr(), mask.data_ptr(), params.data_ptr(), m, b,
                 n_bins, out.data_ptr(), build.stream_ptr(vals))
    build.check(err, "histogram")
    launches += 1
    return out


def hist_percentile(hist: torch.Tensor, lo, width, q: float) -> torch.Tensor:
    """The q-th percentile's bin lower edge from cumulative counts,
    ``rank = floor(q/100 * (n-1))`` (``percentile(method="lower")`` on
    bin-quantised observations); an empty histogram reports ``lo``."""
    hist = hist.to(torch.int32)
    n = hist.sum(dim=-1)
    rank = torch.floor(
        torch.tensor(q, dtype=torch.float32) / 100.0
        * torch.clamp(n - 1, min=0).to(torch.float32)
    ).to(torch.int32)
    cum = torch.cumsum(hist, dim=-1)
    idx = (cum <= rank[..., None]).to(torch.int32).sum(dim=-1)
    idx = torch.where(n > 0, torch.clamp(idx, max=hist.shape[-1] - 1), 0)
    lo = torch.as_tensor(lo, dtype=torch.float32)
    width = torch.as_tensor(width, dtype=torch.float32)
    return lo + idx.to(torch.float32) * width
