"""Dispatch between the hand-written CUDA kernels and their plain
PyTorch versions (port of ``repro.kernels.ops``).

``impl`` is ``"auto"`` (the kernel for CUDA tensors, the plain version
for CPU tensors), ``"cuda"`` (the kernel; a CPU tensor raises) or
``"torch"`` (the plain version on whatever device the tensors are).
A CUDA tensor under ``"auto"`` launches its kernel or raises: nothing
falls back to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import digest_compare as _dc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import histogram as _hg
from repro_torch.kernels import op_ingest as _oi
from repro_torch.kernels import placement_score as _pls
from repro_torch.kernels import policy_score as _ps
from repro_torch.kernels import session_floor as _sf
from repro_torch.kernels import vclock_audit as _va
from repro_torch.kernels import vclock_chain as _vch

IMPLS = ("auto", "cuda", "torch")
# name -> (module, its counter): each wrapper counts its own launches.
_COUNTED = {"op_ingest": (_oi, "launches"), "vclock_audit": (_va, "launches"),
            "vclock_chain": (_vch, "launches"), "digest_compare": (_dc, "launches"),
            "histogram": (_hg, "launches"), "placement_score": (_pls, "launches"),
            "placement_select": (_pls, "select_launches"),
            "policy_score": (_ps, "launches"), "session_floor": (_sf, "launches"),
            "flash_attention": (_fa, "launches")}


def resolve_impl(impl: str | None, t: torch.Tensor) -> str:
    """``"cuda"`` or ``"torch"`` for tensor ``t`` under ``impl``."""
    impl = "auto" if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)


def op_ingest(
    client, replica, resource, is_write, g0, raw0, floor0, *,
    op_index=None, apply_index=None, pend_version=None,
    pend_resource=None, pend_live=None, pend_apply=None,
    impl: str | None = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched op-ingestion prefixes ``(occ, raw, floor)`` — the contract
    of ``repro.kernels.ref.op_ingest_ref``, bit for bit."""
    impl = resolve_impl(impl, client)
    if op_index is None and (apply_index is not None or pend_apply is not None):
        op_index = torch.zeros(client.shape, dtype=torch.int32, device=client.device)
    kw = dict(
        op_index=op_index, apply_index=apply_index,
        pend_version=pend_version, pend_resource=pend_resource,
        pend_live=pend_live, pend_apply=pend_apply,
    )
    if impl == "torch":
        return _oi.op_ingest_ref(
            client, replica, resource, is_write, g0, raw0, floor0, **kw
        )
    return _oi.op_ingest_cuda(
        _oi.pack_ops(client, replica, resource, is_write, g0, raw0, floor0, **kw)
    )


def vclock_audit(
    vc, client, kind, resource, version, seq, valid, *, delta: int = 0,
    impl: str | None = "auto", design: str = "auto",
) -> torch.Tensor:
    """(M, M) audit codes ``phase | viol << 8 | timed << 9``; ``design``
    picks the kernel's compare (``vclock_audit.DESIGNS``)."""
    impl = resolve_impl(impl, vc)
    if impl == "torch":
        return _va.vclock_audit_ref(
            vc, client, kind, resource, version, seq, valid, delta=delta
        )
    return _va.vclock_audit_cuda(vc, client, kind, resource, version, seq, valid,
                                 delta=delta, design=design)


def audit_duot(duot, *, delta: int = 0, impl: str | None = "auto") -> torch.Tensor:
    """Audit codes of a ``core.duot.Duot``.  The reference pads the log
    to its block with invalid entries; the codes of the real entries do
    not depend on that, so neither route pads (the kernel masks its
    ragged edge)."""
    return vclock_audit(duot.vc, duot.client, duot.kind, duot.resource,
                        duot.version, duot.seq, duot.valid, delta=delta, impl=impl)


def audit_summary(codes: torch.Tensor) -> dict[str, torch.Tensor]:
    """Counts from the packed code matrix: pairs audited, violations
    (rule and timed bound), and violations by phase a1 .. b1."""
    phase = codes & 0xFF
    viol = (codes >> 8) & 1
    timed = (codes >> 9) & 1
    return {
        "n_audited": (phase > 0).sum(dtype=torch.int32),
        "n_violations": viol.sum(dtype=torch.int32) + timed.sum(dtype=torch.int32),
        "by_phase": torch.stack([((phase == c) & (viol > 0)).sum(dtype=torch.int32)
                                 for c in range(1, 6)]),
    }


def vclock_chain(client, replica, is_write, session_vc, replica_vc, *,
                 impl: str | None = "auto"):
    """Serial clock chain of one batch -> ``(session_vc, replica_vc, vcs)``."""
    impl = resolve_impl(impl, session_vc)
    if impl == "torch":
        return _vch.vclock_chain_ref(client, replica, is_write, session_vc,
                                     replica_vc)
    return _vch.vclock_chain_cuda(client, replica, is_write, session_vc,
                                  replica_vc)


def digest_compare(a, b, *, impl: str | None = "auto"):
    """Diff two sides' range digests ``(..., 4)`` -> ``(differ, a_behind,
    b_behind)`` bool masks over the leading axes — the contract of
    ``repro.kernels.ref.digest_compare_ref``, bit for bit.  The plain
    version reads the reference's packed rows; on the card the two sides
    are one ``(2, n, 4)`` table for the gathered kernel."""
    impl = resolve_impl(impl, a)
    lead = tuple(a.shape[:-1])
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    if impl == "torch":
        out = _dc.digest_compare_ref(_dc.pack_digests(a, b))
        return tuple(out[:, col].to(torch.bool).reshape(lead)
                     for col in (_dc.DIFFER, _dc.A_BEHIND, _dc.B_BEHIND))
    side = torch.arange(2, device=a.device)
    flags = _dc.digest_compare_pairs_cuda(
        torch.stack([a, b]).to(torch.int32), side[:1], side[1:], [(0, 1)])
    return tuple(f.reshape(lead) for f in flags)


def digest_compare_pairs(dig, a_idx, b_idx, *, host_pairs=None,
                         impl: str | None = "auto") -> torch.Tensor:
    """Diff the range digests of replica pairs: ``dig`` (P, K, 4) int32,
    ``a_idx`` / ``b_idx`` (M,) int64 -> the (3, M, K) bool flags ``differ,
    a_behind, b_behind = flags`` — ``digest_compare(dig[a_idx],
    dig[b_idx])`` stacked, with the gathers done by the kernel.
    ``host_pairs`` (the same pairs on the host) are checked against P
    without a device sync; an index outside the table raises
    ``ValueError`` on either route."""
    impl = resolve_impl(impl, dig)
    if impl == "cuda":
        return _dc.digest_compare_pairs_cuda(dig, a_idx, b_idx, host_pairs)
    if host_pairs is None:
        host_pairs = torch.stack([a_idx, b_idx], dim=1).tolist()
    _dc.check_pairs(host_pairs, dig.shape[0])
    return _dc.digest_compare_pairs_ref(dig, a_idx, b_idx)


def histogram(values, *, lo, hi, n_bins: int, mask=None, out=None,
              impl: str | None = "auto") -> torch.Tensor:
    """Fixed-bin histograms of ``(M, B)`` (or ``(B,)``) observations ->
    ``(M, n_bins)`` (or ``(n_bins,)``) int32 counts — the contract of
    ``repro.kernels.ref.histogram_ref``, bit for bit.  ``lo``/``hi`` are
    scalars or ``(M,)`` (host values: the params are computed once, see
    ``histogram.row_params``); ``mask`` (same shape, 0/1 or bool) drops
    observations.  With ``out`` (same shape as the result, int32) the
    counts are added into it in place and ``out`` is returned."""
    impl = resolve_impl(impl, values)
    one_d = values.dim() == 1
    vals = torch.atleast_2d(values)
    m = vals.shape[0]
    msk = None if mask is None else torch.atleast_2d(mask)
    acc = None if out is None else out.view(m, n_bins)
    params = _hg.row_params(lo, hi, n_bins, m, vals.device)
    if impl == "torch":
        counts = _hg.histogram_ref(vals, msk, params, n_bins=n_bins)
        if acc is not None:
            acc += counts
    else:
        counts = _hg.histogram_cuda(vals, msk, params, n_bins=n_bins, out=acc)
    if acc is not None:
        return out
    return counts[0] if one_d else counts


def placement_score(reads, writes, read_price, write_price, read_rtt, cand_meta,
                    *, max_latency_ms: float, impl: str | None = "auto"):
    """(resources × candidate plans) placement scoring -> ``(utility (R, K)
    f32, feasible (R, K) int32)`` — the fused contract of
    ``repro.kernels.ref.placement_score_ref`` under ``jit``, bit for bit.
    Inputs: ``reads``/``writes`` (R, G), ``read_price``/``write_price``/
    ``read_rtt`` (K, G), ``cand_meta`` (2, K), all f32."""
    impl = resolve_impl(impl, reads)
    fn = _pls.placement_score_ref if impl == "torch" else _pls.placement_score_cuda
    return fn(reads, writes, read_price, write_price, read_rtt, cand_meta,
              max_latency_ms=max_latency_ms)


def placement_select(reads, writes, read_price, write_price, read_rtt, cand_meta,
                     *, max_latency_ms: float, impl: str | None = "auto"):
    """The planner's selection -> ``(3, R)`` int32 ``[choice; utility's f32
    bits; feasible]``: per resource the first candidate of maximal
    utility (``np.argmax``'s rule) and that cell of ``placement_score``,
    bit for bit.  Same inputs as ``placement_score``.  One kernel launch
    on the card, which never writes the (R, K) grid."""
    impl = resolve_impl(impl, reads)
    fn = _pls.placement_select_ref if impl == "torch" else _pls.placement_select_cuda
    return fn(reads, writes, read_price, write_price, read_rtt, cand_meta,
              max_latency_ms=max_latency_ms)


def policy_score(sess, table, stale, viol, count, *, impl: str | None = "auto"):
    """(sessions × levels) SLA scoring -> ``(utility (S, L) f32, feasible
    (S, L) int32)`` — the fused contract of ``repro.kernels.ref.
    policy_score_ref`` under ``jit``, bit for bit.  Inputs: ``sess``
    (S, SP_COLS), ``table`` (LVL_COLS, L), ``stale``/``viol``/``count``
    (S, L), all f32.  The reference pads S to its block with invalid rows
    and strips them; here neither version pads, and invalid rows
    (``SP_VALID == 0``) score 0 / 0 as there."""
    impl = resolve_impl(impl, stale)
    fn = _ps.policy_score_ref if impl == "torch" else _ps.policy_score_cuda
    return fn(sess, table, stale, viol, count)


def policy_select(stale_win, viol_win, reads_win, table, bounds, *, read_frac=0.5,
                  valid=None, explore_u=None, arm=None, epsilon=None,
                  impl: str | None = "auto"):
    """The controller's selection from its three (W, S, L) f32 count rings
    (``AdaptiveController.select``, or ``scores`` without draws): the
    windowed rates, the session parameters of ``bounds`` = ``(max_stale,
    max_viol, max_lat, max_age)`` with ``read_frac`` (a value or (S,)) and
    ``valid`` (None: every row), the ``policy_score`` contract, then with
    ``explore_u`` (S,) f32, ``arm`` (S,) int32 and ``epsilon`` (an f32
    value) each session's level, (S,) int32 — the reference's ``argmax``
    and exploration arm, bit for bit; without them ``(utility, feasible)``,
    each (S, L).  One kernel launch on the card."""
    impl = resolve_impl(impl, stale_win)
    fn = _ps.policy_select_ref if impl == "torch" else _ps.policy_select_cuda
    return fn(stale_win, viol_win, reads_win, table, bounds, read_frac=read_frac,
              valid=valid, explore_u=explore_u, arm=arm, epsilon=epsilon)


def session_admit(replica_version, read_floor, write_floor, client, replica,
                  resource, *, enforce: bool = True, valid=None,
                  impl: str | None = "auto"):
    """Batched session-floor admission -> ``(served (B,) int32, admissible
    (B,) bool, floor (B,) int32, new_read_floor (C, R) int32)`` — the
    contract of ``repro.kernels.ref.session_admit_ref``, exact.  Every op
    is checked against the pre-batch floors; ``valid`` (B,) bool masks
    ops out (all valid when omitted)."""
    impl = resolve_impl(impl, read_floor)
    fn = _sf.session_admit_ref if impl == "torch" else _sf.session_admit_cuda
    return fn(replica_version, read_floor, write_floor, client, replica, resource,
              enforce=enforce, valid=valid)


def session_check(replica_version, read_floor, write_floor, index, *, resource=None,
                  valid=None, out=None, impl: str | None = "auto") -> torch.Tensor:
    """The admission check without the floor update -> ``(2, B)`` int32
    ``[admissible, floor]``: ``session_admit``'s admissible and floor
    outputs (floor 0 where ``valid`` is false).  ``index`` is (2, B) int32,
    the client ids then the replicas; ``resource`` (B,) or None (every op
    at resource 0).  With ``out`` ((2, B) int32) the result is written
    there and ``out`` returned."""
    impl = resolve_impl(impl, read_floor)
    fn = _sf.session_check_ref if impl == "torch" else _sf.session_check_cuda
    return fn(replica_version, read_floor, write_floor, index, resource=resource,
              valid=valid, out=out)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    layout: str = "bshd", block_q: int = 128, block_k: int = 128,
                    impl: str | None = "auto"):
    """GQA flash attention — the contract of ``repro.kernels.ref.
    flash_attention_ref`` (atol = rtol 2e-5 in f32, 2e-2 in bf16).

    layout ``"bshd"``: q (B, S, H, hd), k/v (B, T, Hkv, hd) — the model
    substrate's layout, read and written in place through strides (no
    transposed copy); ``"bhsd"``: q (B, H, S, hd), k/v (B, Hkv, T, hd).
    ``block_q`` / ``block_k`` keep the reference's signature and its
    divisibility rule (``S % min(block_q, S) == 0``, likewise for T), which
    raises ``ValueError`` here where the reference asserts; the kernels
    tile by their own blocks (64 x 64 in f32, 128 q rows x 64 keys in
    bf16), and the result does not depend on the block shape."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown layout {layout!r}; expected 'bshd' or 'bhsd'")
    impl = resolve_impl(impl, q)
    if layout == "bshd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    s, t = q.shape[2], k.shape[2]
    bq, bk = min(block_q, s), min(block_k, t)
    if bq <= 0 or bk <= 0 or s % bq or t % bk:
        raise ValueError(f"sequence lengths S={s}, T={t} must be multiples of "
                         f"block_q={bq}, block_k={bk}")
    if impl == "torch":
        out = _fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        return out.transpose(1, 2) if layout == "bshd" else out
    if layout == "bshd":
        b, h, _, hd = q.shape
        out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
        _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                 out=out.transpose(1, 2))
        return out
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
