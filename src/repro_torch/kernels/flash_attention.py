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
  * :func:`flash_attention_cuda` — the hand-written kernel
    (``csrc/flash_attention.cu``): one CTA per (b, h, 64-row q block),
    K/V tiles staged through shared memory, the online-softmax state in
    registers, f32 FFMA for f32 and bf16 inputs alike.

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

launches = 0


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


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    return fn


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
    strides = (ctypes.c_longlong * 12)(*(x.stride(i) for x in (q, k, v, out)
                                         for i in range(3)))
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, h, hkv, s, t, hd, strides, int(bool(causal)), int(window),
        float(scale), build.stream_ptr(q),
    )
    build.check(err, "flash_attention")
    launches += 1
    return out
