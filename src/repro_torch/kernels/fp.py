"""Exact float32 arithmetic that PyTorch does not promise on every device.

The reference's jitted scorers (``placement_score``, ``policy_score``,
``policy.sla.epoch_cost``) contract some ``a·b + c`` into one fused
multiply-add, so their contract rounds once where eager code rounds
twice.  The plain versions of the port reproduce that rounding with
:func:`fma_f32`; the CUDA kernels write ``__fmaf_rn``.
"""

from __future__ import annotations

import torch


def fma_f32(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``x·y + c`` on any device.

    The product of two f32 values is exact in f64.  The f64 sum is
    rounded to nearest; TwoSum gives its exact error, and where the
    error is nonzero and the sum's last bit is even the sum steps one
    f64 ulp toward the error — round-to-odd.  53 ≥ 2·24 + 2, so the
    final round to f32 is the single rounding of the exact value.
    """
    p = x.to(torch.float64) * y.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def div_f32(x: torch.Tensor, d: float) -> torch.Tensor:
    """Correctly rounded ``x / d`` for a Python number ``d``, on any device.

    On CUDA, PyTorch divides by a host scalar as a multiplication by its
    reciprocal, which can differ from the quotient in the last bit; a
    divisor on ``x``'s device keeps the true division the reference does.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
