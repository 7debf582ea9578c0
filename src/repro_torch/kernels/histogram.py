"""Fixed-bin metric histograms.

Port of ``repro.kernels.histogram``: ``(M, B)`` f32 observations, each
row with its own ``[lo, 1/width]`` params, become ``(M, n_bins)`` int32
counts.  An observation lands in ``clip(floor((v - lo) * inv_w), 0,
n_bins - 1)`` — below ``lo`` saturates into bin 0, at or above ``hi``
into the top bin — and masked-out observations count nothing.

  * :func:`histogram_ref` — the plain version, a whole-array
    re-derivation of the reference's ``bin_tile`` summed over columns;
  * :func:`histogram_per_thread` — plain twin of the kernel's
    decomposition: per-thread counts over each thread's strided columns,
    summed per row;
  * :func:`histogram_cuda` — the hand-written kernel
    (``csrc/histogram.cu``): ONE launch per call, one CTA per row, whose
    shared-memory counts are written (or added into ``out``) bin by bin:
    no zero fill, no global atomics.

The index keeps the reference's two f32 roundings (subtract, then
multiply) and its saturating float-to-int conversion (NaN -> 0), so the
plain version, the kernel and the reference agree bit for bit.
:func:`row_params` computes the params once per ``(lo, hi, n_bins)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp import fma_f32

# Per-row bin params layout: (M, 2) f32.
LO, INV_W = 0, 1

THREADS = 512           # threads of one row's CTA (as in the .cu)
MAX_BINS = 12288        # shared-memory counts one block holds in 48 KB

launches = 0
# (lo bytes, hi bytes, n_bins, M, device) -> (M, 2) params on that device.
_PARAMS: dict = {}


def metric_params(lo, hi, n_bins: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Per-row ``[lo, n_bins / (hi - lo)]`` params as ``(M, 2)`` f32,
    computed in f32 as the reference does; ``lo``/``hi`` are scalars or
    ``(M,)`` and broadcast against each other."""
    lo = torch.atleast_1d(torch.as_tensor(lo, dtype=torch.float32, device=device))
    hi = torch.atleast_1d(torch.as_tensor(hi, dtype=torch.float32, device=device))
    lo, hi = torch.broadcast_tensors(lo, hi)
    inv_w = torch.tensor(float(n_bins), dtype=torch.float32, device=device) / (hi - lo)
    return torch.stack([lo, inv_w], dim=1)


def row_params(lo, hi, n_bins: int, m: int, device) -> torch.Tensor:
    """The ``(m, 2)`` f32 ``[lo, inv_w]`` params of ``lo``/``hi`` (scalars
    or ``(m,)``) on ``device``, contiguous.  Host values are computed once
    per ``(lo, hi, n_bins, m, device)`` and cached: ``n_bins / (hi - lo)``
    is an f32 division in numpy as in :func:`metric_params`, so both are
    the same bits; tensors go through :func:`metric_params` per call."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return metric_params(lo, hi, n_bins, device=device).expand(m, 2).contiguous()
    key = (np.asarray(lo, np.float32).tobytes(), np.asarray(hi, np.float32).tobytes(),
           n_bins, m, str(device))
    if key not in _PARAMS:
        lo32 = np.atleast_1d(np.asarray(lo, np.float32))
        hi32 = np.atleast_1d(np.asarray(hi, np.float32))
        lo32, hi32 = np.broadcast_arrays(lo32, hi32)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.float32(n_bins) / (hi32 - lo32)
        rows = np.broadcast_to(np.stack([lo32, inv], axis=1), (m, 2))
        _PARAMS[key] = torch.from_numpy(rows.copy()).to(device)
    return _PARAMS[key]


def bin_index(vals: torch.Tensor, params: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(M, B) int64 bin of each observation."""
    f = torch.floor((vals - params[:, LO:LO + 1]) * params[:, INV_W:INV_W + 1])
    # The reference converts with saturation (NaN -> 0), then clips.
    f = torch.nan_to_num(f, nan=0.0).clamp(0, n_bins - 1)
    return f.long()


def histogram_ref(vals: torch.Tensor, mask: torch.Tensor | None, params: torch.Tensor,
                  *, n_bins: int) -> torch.Tensor:
    """Plain version: ``(M, n_bins)`` int32 masked counts (``mask=None``:
    every observation counts)."""
    m = vals.shape[0]
    idx = bin_index(vals.to(torch.float32), params, n_bins)
    rows = torch.arange(m, device=vals.device)[:, None] * n_bins
    ones = (torch.ones(idx.shape, dtype=torch.int64, device=vals.device) if mask is None
            else (mask > 0).long())
    out = torch.zeros(m * n_bins, dtype=torch.int64, device=vals.device)
    out.index_add_(0, (rows + idx).reshape(-1), ones.reshape(-1))
    return out.view(m, n_bins).to(torch.int32)


def histogram_per_thread(vals: torch.Tensor, mask: torch.Tensor | None,
                         params: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """Plain twin of the kernel: thread ``t`` of row ``r``'s CTA counts
    columns ``t, t + THREADS, ...`` into its own ``n_bins`` counts; the
    row's counts are the sum over its ``THREADS`` threads.  Equal to
    :func:`histogram_ref`."""
    m, b = vals.shape
    thread = torch.arange(b, device=vals.device) % THREADS
    idx = bin_index(vals.to(torch.float32), params, n_bins)
    on = (torch.ones(idx.shape, dtype=torch.int64, device=vals.device) if mask is None
          else (mask > 0).long())
    slot = (torch.arange(m, device=vals.device)[:, None] * THREADS + thread) * n_bins + idx
    part = torch.zeros(m * THREADS * n_bins, dtype=torch.int64, device=vals.device)
    part.index_add_(0, slot.reshape(-1), on.reshape(-1))
    return part.view(m, THREADS, n_bins).sum(dim=1).to(torch.int32)


_FN = None


def _lib():
    global _FN
    if _FN is None:
        fn = build.load("histogram").histogram_launch
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def histogram_cuda(vals: torch.Tensor, mask: torch.Tensor | None, params: torch.Tensor,
                   *, n_bins: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/histogram.cu``: ``vals`` (M, B) f32; ``mask`` (M, B)
    int32 or bool, or ``None`` (every observation counts); ``params``
    (M, 2) f32; all on one CUDA device.  With ``out`` ((M, n_bins) int32)
    the counts are added into it."""
    global launches
    f32, i32 = torch.float32, torch.int32
    if vals.dtype is not f32 or not vals.is_contiguous():
        vals = vals.to(f32).contiguous()
    shape = vals.shape
    if not vals.is_cuda or len(shape) != 2:
        raise ValueError(f"vals must be a CUDA (M, B) tensor; got {tuple(shape)} "
                         f"on {vals.device}")
    m, b = shape
    m_ptr, m_bytes = None, 0
    if mask is not None:
        if mask.dtype is not i32 and mask.dtype is not torch.bool:
            mask = mask.to(i32)
        if not mask.is_contiguous():
            mask = mask.contiguous()
        if not mask.is_cuda or mask.shape != shape:
            raise ValueError(f"mask must be a CUDA tensor shaped like vals; got "
                             f"{tuple(mask.shape)} on {mask.device}")
        m_ptr, m_bytes = mask.data_ptr(), mask.dtype is not i32
    if params.dtype is not f32 or not params.is_contiguous():
        params = params.to(f32).contiguous()
    if not params.is_cuda or params.shape != (m, 2):
        raise ValueError(f"params must be a CUDA (M, 2) tensor; got "
                         f"{tuple(params.shape)} on {params.device}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"histogram_cuda takes 1..{MAX_BINS} bins; got {n_bins}")
    accumulate = out is not None
    if out is None:
        out = torch.empty((m, n_bins), dtype=i32, device=vals.device)
    elif (not out.is_cuda or out.shape != (m, n_bins) or out.dtype is not i32
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous CUDA int32 ({m}, {n_bins})")
    if m == 0:
        return out
    err = (_FN or _lib())(vals.data_ptr(), m_ptr, params.data_ptr(), out.data_ptr(),
                          build.stream_ptr(vals),
                          m | n_bins << 32 | accumulate << 46 | m_bytes << 47, b)
    if err:
        build.check(err, "histogram")
    launches += 1
    return out


def pack_observations(vals: torch.Tensor, mask: torch.Tensor | None, *,
                      block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad the observation axis to a ``block`` multiple with inert
    (mask 0) columns; returns ``(vals, mask)`` as f32 / int32 (the
    reference's layout for its tiled kernel; the port's kernel takes any
    row length)."""
    m, b = vals.shape
    vals = torch.as_tensor(vals).to(torch.float32)
    mask = (torch.ones((m, b), dtype=torch.int32, device=vals.device) if mask is None
            else torch.as_tensor(mask, device=vals.device).to(torch.int32))
    pad = (-b) % block
    if pad:
        vals = torch.nn.functional.pad(vals, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return vals, mask


def hist_edges(lo: float, hi: float, n_bins: int,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """The ``n_bins + 1`` f32 bin edges of one metric row, ``lo`` to
    ``hi``.  The reference's compiled ``linspace`` reassociates its
    ``lo·(1 − t) + hi·t``: ``t = i · f32(1 / n_bins)``, the second term
    ``i · (hi · f32(1 / n_bins))`` fused into the add.  That order is
    taken here; where XLA's code generator contracts differently an
    inner edge can differ from the reference's by one f32 ulp.  The last
    edge is ``hi`` itself."""
    f32 = dict(dtype=torch.float32, device=device)
    lo_t, hi_t = torch.tensor(lo, **f32), torch.tensor(hi, **f32)
    inv = torch.tensor(1.0, **f32) / torch.tensor(float(n_bins), **f32)
    i = torch.arange(n_bins, **f32)
    inner = fma_f32(i, (hi_t * inv).expand(n_bins), lo_t * (1 - i * inv))
    return torch.cat([inner, hi_t[None]])


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
