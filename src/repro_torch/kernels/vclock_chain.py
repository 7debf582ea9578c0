"""The vector-clock chain of one op batch.

Port of the ``clock_step`` scan of ``repro.core.xstcc.apply_op_batch``:
for each op ``i`` in order, ``svc = max(session_vc[c], replica_vc[p])``
with ``svc[c] += 1``; the session row takes ``svc``, and a write joins it
into its coordinator's row.  Returns the updated ``(session_vc,
replica_vc)`` and the ``(B, C)`` op clocks.

  * :func:`vclock_chain_ref` — the plain version, a Python loop over the
    batch;
  * :func:`vclock_chain_segments` and :func:`vclock_chain_levels` — plain
    twins of the kernel's two batch-parallel designs: the batch cut into
    segments whose max-plus maps are composed, then replayed from their
    entry states; or the ops ranked into dependence levels
    (:func:`chain_levels`) and run a level at a time;
  * :func:`vclock_chain_cuda` — the hand-written kernels
    (``csrc/vclock_chain.cu``).  :func:`design_for` picks one per call: a
    batch of at most ``SMALL_MAX`` ops whose clocks fit one block's shared
    memory runs ONE CTA that walks the batch (one launch); narrow clocks
    (C <= ``SEG_MAX_C``, P <= ``SEG_MAX_P``) run the segment design (one
    launch); wider ones the level design (two launches).  ``design=``
    forces one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# The kernel's designs, as the C entry point numbers them.
DESIGNS = ("small", "segments", "levels")
# Batches up to SMALL_MAX ops run the one-CTA walk when the clocks fit
# one block's shared memory (chip_smoke.py times the walk against the
# segment design on either side of it, by device time too: the walk
# wins at the main path's 128 ops of 16 components).
SMALL_MAX = 256
SMALL_MAX_C = 1024                 # one thread per component
SMEM_MAX = 232448                  # shared memory one H100 block can use
SMALL_CAP = 1024                   # ops the walk stages at once (as in the .cu)
# The segment design: one CTA of SEG_THREADS threads per component, each
# thread walking up to SEG_PAIRS map columns; local row ids are bytes.
SEG_MAX_C = 256
SEG_MAX_P = 64
SEG_THREADS = 1024
SEG_PAIRS = 4                      # map words (4 source rows each) per thread
SEG_LENS = (32, 64, 128)
CARRY_COST = 6                     # walk steps one carry step costs (plan model)
# The level design's client table lives in shared memory up to this many
# clients, in device memory above.
LEVEL_TBL_SMEM = 32768

launches = 0


def vclock_chain_ref(client, replica, is_write, session_vc, replica_vc):
    """Plain version: one op per Python step."""
    svcs = session_vc.clone()
    rvcs = replica_vc.clone()
    b = client.shape[0]
    vcs = torch.empty((b, svcs.shape[1]), dtype=torch.int32, device=svcs.device)
    cl = client.tolist()
    pl = replica.tolist()
    wl = is_write.tolist()
    for i in range(b):
        ci, pi = cl[i], pl[i]
        svc = torch.maximum(svcs[ci], rvcs[pi])
        svc[ci] += 1
        svcs[ci] = svc
        if wl[i]:
            rvcs[pi] = torch.maximum(rvcs[pi], svc)
        vcs[i] = svc
    return svcs, rvcs, vcs


# -- the segment design -------------------------------------------------------


def seg_smem(c: int, p: int, seg_len: int, n_seg: int, umax: int) -> int:
    """Dynamic shared memory of the segment kernel (its layout; a map row
    is ``ceil(umax / 4)`` words)."""
    return ((c + p) * 4 + n_seg * seg_len * 4 + n_seg * umax * 8 + n_seg * 4
            + (-(-(n_seg * c) // 16) * 16) + n_seg * umax * 4 * (-(-umax // 4)))


@functools.lru_cache(maxsize=256)
def segment_plan(b: int, c: int, p: int) -> tuple[int, int, int]:
    """``(seg_len, n_seg, umax)`` of the segment design: the segment length
    L, the segments per chunk S (the chunk's maps must fit shared memory,
    and its map columns S * umax the CTA's threads) and the local rows a
    segment may touch, ``umax = min(L, C) + P``; a thread walks up to
    SEG_PAIRS map words of four source rows.  Picks the L whose critical
    path, ``ceil(B / (S L)) * (2 L + S)`` steps, is cheapest, a carry step
    (a U x U max-plus product between two barriers) counted as
    ``CARRY_COST`` walk steps."""
    best = None
    for seg_len in SEG_LENS:
        umax = min(seg_len, c) + p
        n_seg = max(1, min(-(-b // seg_len), SEG_THREADS * SEG_PAIRS // -(-umax // 4)))
        while n_seg > 1 and seg_smem(c, p, seg_len, n_seg, umax) > SMEM_MAX:
            n_seg -= 1
        if seg_smem(c, p, seg_len, n_seg, umax) > SMEM_MAX:
            continue
        cost = -(-b // (n_seg * seg_len)) * (2 * seg_len + CARRY_COST * n_seg)
        if best is None or cost < best[0]:
            best = (cost, seg_len, n_seg, umax)
    if best is None:
        raise ValueError(f"no segment plan fits C={c}, P={p}")
    return best[1:]


def vclock_chain_segments(client, replica, is_write, session_vc, replica_vc, *,
                          plan: tuple[int, int, int] | None = None):
    """Plain twin of the segment design: for each chunk of ``n_seg``
    segments of ``seg_len`` ops, every segment's max-plus map over its
    local rows (its distinct clients in client order, then the P replica
    rows) for all components at once, entries ``1 + count`` of the
    column's own client's ops on the best path (0: no path); a serial
    carry of the state through the maps; then each segment's replay from
    its entry state.  Equal to :func:`vclock_chain_ref`."""
    c, p = session_vc.shape[0], replica_vc.shape[0]
    b = client.shape[0]
    seg_len, n_seg, _ = plan or segment_plan(max(b, 1), c, p)
    dev = session_vc.device
    x = torch.cat([session_vc, replica_vc]).to(torch.int64)     # (C + P, C)
    vcs = torch.empty((b, c), dtype=torch.int32, device=dev)
    cl, pl, wl = client.tolist(), replica.tolist(), [bool(w) for w in is_write.tolist()]
    comp = torch.arange(c, device=dev)
    neg = torch.iinfo(torch.int64).min // 2
    for base in range(0, b, n_seg * seg_len):
        segs = []
        for s0 in range(base, min(b, base + n_seg * seg_len), seg_len):
            ks = range(s0, min(b, s0 + seg_len))
            loc = sorted({cl[k] for k in ks})
            ids = {g: j for j, g in enumerate(loc)}
            rows = loc + [c + q for q in range(p)]
            u = len(rows)
            ops = [(ids[cl[k]], len(loc) + pl[k], wl[k], cl[k], k) for k in ks]
            # (1) map[n, j, k]: row j from source row k, for component n.
            m = torch.eye(u, dtype=torch.int64, device=dev).expand(c, u, u).clone()
            for lc, lp, w, ci, _ in ops:
                e = torch.maximum(m[:, lc], m[:, lp])
                e[ci] += (e[ci] != 0).to(torch.int64)
                m[:, lc] = e
                if w:
                    m[:, lp] = e
            segs.append((torch.tensor(rows, device=dev), m, ops))
        for rows, m, ops in segs:
            # (2) carry: entry state, then exit = max_k entry[k] + map - 1.
            ent = x[rows].T                                           # (C, U)
            out = torch.where(m > 0, ent[:, None, :] + m - 1, neg).amax(dim=2)
            x[rows] = out.T
            # (3) replay from the entry state.
            st = ent.clone()
            for lc, lp, w, ci, k in ops:
                v = torch.maximum(st[:, lc], st[:, lp]) + (comp == ci)
                st[:, lc] = v
                if w:
                    st[:, lp] = v
                vcs[k] = v.to(torch.int32)
    x = x.to(torch.int32)
    return x[:c].clone(), x[c:].clone(), vcs


# -- the level design ---------------------------------------------------------


def chain_levels(client, replica, is_write, n_clients: int):
    """The level design's plan: ``(level (B,) int64, first (B,) bool)``.
    Op i's level is 1 + the largest level of client c_i's previous op, of
    the last earlier write to replica p_i and, for a write, of every read
    of p_i since; ``first`` marks an op whose client has no earlier op in
    the batch.  Ops of one level touch distinct session rows, and a
    written replica row is touched by no other op of the level."""
    cl, pl, wl = client.tolist(), replica.tolist(), is_write.tolist()
    last = [0] * n_clients
    n_rep = max(pl, default=-1) + 1
    wlev, rlev = [0] * n_rep, [0] * n_rep
    level, first = [], []
    for ci, pi, wi in zip(cl, pl, wl):
        t = last[ci]
        lv = 1 + max(t, rlev[pi] if wi else wlev[pi])
        last[ci] = lv
        if wi:
            wlev[pi] = rlev[pi] = lv
        else:
            rlev[pi] = max(rlev[pi], lv)
        level.append(lv)
        first.append(t == 0)
    return (torch.tensor(level, dtype=torch.int64),
            torch.tensor(first, dtype=torch.bool))


def vclock_chain_levels(client, replica, is_write, session_vc, replica_vc):
    """Plain twin of the level design: the ops of each level at once —
    first-touch ops read the input clocks, the rest the running state —
    and the session rows no op touches copied.  Equal to
    :func:`vclock_chain_ref`."""
    c = session_vc.shape[0]
    b = client.shape[0]
    dev = session_vc.device
    level, first = chain_levels(client, replica, is_write, c)
    level, first = level.to(dev), first.to(dev)
    new_s = torch.empty_like(session_vc)
    touched = torch.zeros(c, dtype=torch.bool, device=dev)
    touched[client.long()] = True
    new_s[~touched] = session_vc[~touched]
    new_r = replica_vc.clone()
    vcs = torch.empty((b, c), dtype=torch.int32, device=dev)
    cli, rep, w = client.long(), replica.long(), is_write.to(torch.bool)
    depth = int(level.max()) if b else 0
    for lv in range(1, depth + 1):
        i = torch.nonzero(level == lv).flatten()
        ci, pi = cli[i], rep[i]
        src = torch.where(first[i][:, None], session_vc[ci], new_s[ci])
        v = torch.maximum(src, new_r[pi])
        v[torch.arange(i.numel(), device=dev), ci] += 1
        new_s[ci] = v
        vcs[i] = v
        wi = w[i]
        new_r[pi[wi]] = v[wi]
    return new_s, new_r, vcs


def level_scratch_words(b: int, c: int) -> int:
    """int32 words of the level design's scratch: sorted ops (4 per op),
    level codes, level ends (B + 2), untouched rows, meta, and a client
    table when it is too wide for shared memory."""
    return 6 * b + 2 + c + 4 + (c if c > LEVEL_TBL_SMEM else 0)


# -- dispatch -----------------------------------------------------------------


def small_fits(c: int, p: int) -> bool:
    return c <= SMALL_MAX_C and (c * c + p * c + 2 * SMALL_CAP) * 4 <= SMEM_MAX


def design_for(b: int, c: int, p: int) -> str:
    """The design :func:`vclock_chain_cuda` runs for a (B, C, P) call."""
    if b <= SMALL_MAX and small_fits(c, p):
        return "small"
    if c <= SEG_MAX_C and p <= SEG_MAX_P:
        return "segments"
    return "levels"


def serial_depth(design: str, client, replica, is_write, c: int, p: int) -> int:
    """Steps on the design's critical path for this batch: B for the
    walk; ``ceil(B / (S L)) * (2 L + S)`` for segments; the level pass's
    B scalar steps plus the number of levels."""
    b = client.shape[0]
    if design == "small":
        return b
    if design == "segments":
        seg_len, n_seg, _ = segment_plan(b, c, p)
        return -(-b // (n_seg * seg_len)) * (2 * seg_len + n_seg)
    level, _ = chain_levels(client.cpu(), replica.cpu(), is_write.cpu(), c)
    return b + (int(level.max()) if b else 0)


_FN = None


def _lib():
    global _FN
    if _FN is None:
        fn = build.load("vclock_chain").vclock_chain_launch
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [vp] * 10 + [ll, ll]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def vclock_chain_cuda(client, replica, is_write, session_vc, replica_vc, *,
                      design: str | None = None):
    """Launch ``csrc/vclock_chain.cu`` on CUDA tensors; ``design`` forces
    ``"small"``, ``"segments"`` or ``"levels"`` (default: :func:`design_for`)."""
    global launches
    i32 = torch.int32
    c_, p_, w_, svc, rvc = (
        t if t.dtype is i32 and t.is_contiguous() else t.to(i32).contiguous()
        for t in (client, replica, is_write, session_vc, replica_vc))
    if not (c_.is_cuda and p_.is_cuda and w_.is_cuda and svc.is_cuda and rvc.is_cuda):
        raise ValueError("vclock_chain_cuda needs CUDA tensors")
    b = c_.shape[0]
    c = svc.shape[0]
    p = rvc.shape[0]
    if svc.shape != (c, c) or rvc.shape[1] != c:
        raise ValueError("session_vc must be (C, C) and replica_vc (P, C)")
    design = design or design_for(b, c, p)
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; expected one of {DESIGNS}")
    if design == "small" and not small_fits(c, p):
        raise ValueError(f"the one-CTA walk does not fit C={c}, P={p}")
    if design == "segments" and (c > SEG_MAX_C or p > SEG_MAX_P):
        raise ValueError(f"the segment design takes C <= {SEG_MAX_C}, P <= "
                         f"{SEG_MAX_P}; got C={c}, P={p}")
    if design == "levels" and p * 32 * 4 > SMEM_MAX:
        raise ValueError(f"the level design takes P <= {SMEM_MAX // 128}; got {p}")
    vcs = torch.empty((b, c), dtype=torch.int32, device=svc.device)
    if b == 0:
        return svc.clone(), rvc.clone(), vcs
    new_svc = torch.empty_like(svc)
    new_rvc = torch.empty_like(rvc)
    plan = p | DESIGNS.index(design) << 20
    scratch = None
    if design == "segments":
        seg_len, n_seg, umax = segment_plan(b, c, p)
        plan |= seg_len << 24 | n_seg << 32 | umax << 48
    elif design == "levels":
        scratch = torch.empty(level_scratch_words(b, c), dtype=torch.int32,
                              device=svc.device)
        plan |= (c <= LEVEL_TBL_SMEM) << 22
    err = (_FN or _lib())(
        c_.data_ptr(), p_.data_ptr(), w_.data_ptr(), svc.data_ptr(), rvc.data_ptr(),
        vcs.data_ptr(), new_svc.data_ptr(), new_rvc.data_ptr(),
        None if scratch is None else scratch.data_ptr(), build.stream_ptr(svc),
        b | c << 32, plan,
    )
    if err:
        build.check(err, "vclock_chain")
    launches += 1
    return new_svc, new_rvc, vcs
