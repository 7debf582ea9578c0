"""Causal / windowed GQA flash attention, forward only (port of
``repro.kernels.flash_attention``).

Layouts: q (B, H, S, hd); k/v (B, Hkv, T, hd); out (B, H, S, hd), with
``H % Hkv == 0``: query head ``h`` reads kv head ``h // (H // Hkv)``.
The contract is ``repro.kernels.ref.flash_attention_ref``: softmax of
``q · kᵀ · scale`` (default ``hd ** -0.5``) over the keys, computed in
f32 and cast back to q's dtype.  Under ``causal`` key ``j`` is masked
for query ``i`` where ``j > i`` and, with ``window > 0``, where
``j <= i - window``; the window applies only under ``causal``, as in
``ref.py`` (the reference's Pallas kernel also applies it without).
Masked scores are ``NEG_INF = -2**30``.

  * :func:`flash_attention_ref` — the plain version, the reference's
    oracle written in PyTorch;
  * :func:`flash_attention_blocked` — the plain twin of the bf16 kernel's
    tile math: an online softmax over 64-key blocks in the log2 domain,
    with the probabilities rounded to bf16 before ``P · V``;
  * :func:`flash_schedule` — the bf16 kernel's work list: every (b, h,
    128-row q tile) once, the tiles with the most causal key blocks first;
  * :func:`flash_attention_cuda` — the hand-written kernels
    (``csrc/flash_attention.cu``), chosen by dtype with no fallback:
    f32 runs an FFMA kernel (no TF32: it would miss 2e-5), one CTA per
    (b, h, 64-row q block) with K/V staged through shared memory; bf16
    runs a wgmma kernel, one CTA of a TMA producer warpgroup and two
    consumer warpgroups per 128-row q tile, K/V streaming through a
    two-stage mbarrier ring, both products on the tensor cores.  The
    bf16 kernel reads q, k and v through TMA tensor maps, so their base
    addresses and (b, h, s) strides must be multiples of 16 bytes; it
    raises otherwise and never copies.

The reference defines no backward for its kernel (no ``custom_vjp``), and
neither does the port: :func:`flash_attention_cuda` raises when asked
for a gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The bf16 kernel's tile: 128 q rows per CTA (two warpgroups of 64), 64
# keys per pipeline stage.
BLOCK_Q = 128
BLOCK_K = 64
LOG2E = 1.4426950408889634

launches = 0
# (b, h, s, t, causal, device) -> the work list on that device.
_SCHEDULES: dict = {}


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softmax_scale: float | None = None):
    """Plain attention.  q: (B, H, S, hd); k/v: (B, Hkv, T, hd).  Returns
    (B, H, S, hd), computed in f32, cast back to q's dtype."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = (hd ** -0.5) if softmax_scale is None else softmax_scale
    qg = q.reshape(b, hkv, g, s, hd).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", weights, vf)
    return out.reshape(b, h, s, hd).to(q.dtype)


def flash_attention_blocked(q, k, v, *, causal: bool = True, window: int = 0,
                            softmax_scale: float | None = None,
                            block_k: int = BLOCK_K):
    """Plain twin of the bf16 kernel's numerics.  Per ``block_k`` keys:
    scores ``q · kᵀ`` in f32 scaled into the log2 domain, the kernel's
    masks (``NEG_INF`` for masked keys), the running max and sum, and
    ``P · V`` with P rounded to bf16 (for bf16 inputs) and summed in f32.
    Same layouts and result dtype as :func:`flash_attention_ref`."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = ((hd ** -0.5) if softmax_scale is None else softmax_scale) * LOG2E
    qf = q.reshape(b, hkv, g, s, hd).to(torch.float32)
    m = torch.full((b, hkv, g, s), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, s), device=q.device)
    acc = torch.zeros((b, hkv, g, s, hd), device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, t, block_k):
        kb = k[:, :, k0:k0 + block_k].to(torch.float32)
        vb = v[:, :, k0:k0 + block_k].to(torch.float32)
        x = torch.einsum("bkgsd,bknd->bkgsn", qf, kb) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
            masked = kpos > qpos
            if window > 0:
                masked = masked | (kpos <= qpos - window)
            x = torch.where(masked, torch.tensor(NEG_INF, device=q.device), x)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if q.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha[..., None] + torch.einsum("bkgsn,bknd->bkgsd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s, hd).to(q.dtype)


def flash_schedule(b: int, h: int, s: int, t: int | None = None, *,
                   causal: bool = True) -> list[int]:
    """The bf16 kernel's work list: one entry ``(bi * h + hi) * n_qt + qt``
    per (batch, head, ``BLOCK_Q``-row q tile), ordered by the number of
    key blocks the tile loads (``ceil(min(t, q0 + BLOCK_Q) / BLOCK_K)``
    under ``causal``), most first, ties in index order.  The kernel runs
    CTA ``i`` on entry ``i``, so the longest tiles start first."""
    t = s if t is None else t
    n_qt = -(-s // BLOCK_Q)

    def work(qt):
        end = min(t, (qt + 1) * BLOCK_Q) if causal else t
        return -(-end // BLOCK_K)

    items = range(b * h * n_qt)
    return sorted(items, key=lambda i: (-work(i % n_qt), i))


def _schedule(b, h, s, t, causal, device) -> torch.Tensor:
    key = (b, h, s, t, bool(causal), device)
    if key not in _SCHEDULES:
        _SCHEDULES[key] = torch.tensor(flash_schedule(b, h, s, t, causal=causal),
                                       dtype=torch.int32, device=device)
    return _SCHEDULES[key]


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ci, ci, ctypes.c_float,
                       vp, ci, vp]
        fn.restype = ci
    return fn


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory of the kernel instantiation that runs
    ``dtype`` at head dim ``hd`` (bytes; builds the library if needed)."""
    fn = build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return int(fn(_DTYPES[dtype], hd))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last (hd) axis; other strides are free."""
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softmax_scale: float | None = None, out=None):
    """Launch ``csrc/flash_attention.cu``.  q: (B, H, S, hd); k/v:
    (B, Hkv, T, hd), CUDA, f32 or bf16 alike, any strides with a
    contiguous hd axis (so (B, S, H, hd) tensors pass as transposed views
    without a copy).  ``out``, if given, is a (B, H, S, hd) view to write;
    otherwise a new tensor is returned."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda has no backward (the reference "
                           "kernel defines none); call it under torch.no_grad()")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda needs q, k, v all f32 or all bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, S, hd) and k, v (B, Hkv, T, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not agree "
                         "(batch, head_dim, or H % Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; the kernel takes {HEAD_DIMS}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    if out is None:
        out = torch.empty((b, h, s, hd), dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype or out.stride(-1) != 1:
        raise ValueError("out must be a (B, H, S, hd) view of q's dtype with a "
                         "contiguous last axis")
    scale = (hd ** -0.5) if softmax_scale is None else softmax_scale
    st = [x.stride()[:3] for x in (q, k, v, out)]
    sched, n_items = None, 0
    if q.dtype == torch.bfloat16:
        for name, x, xs in zip("qkv", (q, k, v), st):
            if x.data_ptr() % 16 or any(e % 8 for e in xs):
                raise ValueError(f"flash_attention_cuda (bf16) reads {name} through a "
                                 "TMA tensor map: its base address and (b, h, s) strides "
                                 f"must be multiples of 16 bytes, got strides {xs}")
        if out.data_ptr() % 4 or any(e % 2 for e in st[3]):
            raise ValueError("flash_attention_cuda (bf16) writes bf16 pairs: out needs "
                             "even (b, h, s) strides and a 4-byte aligned base")
        sched = _schedule(b, h, s, t, causal, q.device)
        n_items = sched.numel()
    strides = (ctypes.c_longlong * 12)(*(e for xs in st for e in xs))
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, h, hkv, s, t, hd, strides, int(bool(causal)), int(window),
        float(scale), None if sched is None else sched.data_ptr(), n_items,
        build.stream_ptr(q),
    )
    build.check(err, "flash_attention")
    launches += 1
    return out
