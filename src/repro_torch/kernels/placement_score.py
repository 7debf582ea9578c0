"""The (resources × candidate plans) placement scorer.

Port of ``repro.kernels.placement_score``: for every resource ``r`` with
regional demand ``reads[r]``, ``writes[r]`` (``(G,)`` each) and every
candidate placement ``k`` (pre-digested by
``repro_torch.geo.placement.candidate_tables`` into ``(K, G)`` price and
latency rows and ``(2, K)`` [storage $, validity]):

    cost   = store[k];  excess = 0
    for g in 0 .. G-1:                     (this order, always)
        cost    = fma(reads[r, g],  read_price[k, g],  cost)
        cost    = fma(writes[r, g], write_price[k, g], cost)
        excess += 10 · ((reads + writes)[r, g] > 0 and rtt[k, g] > max_lat)
    excess += 10 · not (valid[k] > 0)
    feasible = excess == 0;   utility = -cost - 1e6 · excess

Each cost update rounds once, as a fused multiply-add: the reference's
jitted scorer (``ref.placement_score_ref`` under ``jit``, its tiled twin
and its Pallas kernel) contracts ``cost + x · price`` into an FMA, and
that fused result is the contract.

  * :func:`placement_score_ref` — the plain version.  PyTorch has no
    FMA that it promises on every device, so
    :func:`repro_torch.kernels.fp.fma_f32` emulates one exactly in
    float64;
  * :func:`placement_score_cuda` — the hand-written kernel
    (``csrc/placement_score.cu``), ``__fmaf_rn`` for the two updates.

The planner needs only each row's choice: the first ``k`` of maximal
utility (``np.argmax``'s rule: ties to the lowest ``k``, a NaN above
every number), with that cell's utility and feasibility.  The same
module computes that as one ``(3, R)`` int32 result, ``[choice; the
utility's f32 bits; feasible]``:

  * :func:`placement_select_ref` — the plain version: the grid above,
    ``torch.argmax`` and ``torch.gather`` (:func:`select_from_grid`),
    ``ROWS_PER_CHUNK`` rows at a time;
  * :func:`placement_select_cuda` — one launch of the fused score-and-
    select kernel (``placement_select_kernel``), which never writes the
    grid.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp import fma_f32

STRUCTURAL_WEIGHT = 10.0       # SLA excess per structural violation
INFEASIBLE_PENALTY = 1.0e6     # utility cost per unit of excess

ROWS_PER_CHUNK = 1 << 19       # plain version: rows scored per pass
SMEM_MAX = 48 * 1024           # the kernels' static shared-memory budget
SELECT_MAX_G = 8               # regions the select kernel is built for

launches = 0                   # placement_score_cuda's kernel
select_launches = 0            # placement_select_cuda's kernel


def _score_rows(reads, writes, rprice, wprice, rtt, meta, max_lat):
    r, g = reads.shape
    k = rprice.shape[0]
    cost = meta[0][None, :].expand(r, k)
    excess = torch.zeros((r, k), dtype=torch.float32, device=reads.device)
    structural = torch.tensor(STRUCTURAL_WEIGHT, dtype=torch.float32,
                              device=reads.device)
    for gi in range(g):                 # fixed order, as the reference
        rd, wr = reads[:, gi:gi + 1], writes[:, gi:gi + 1]
        cost = fma_f32(rd, rprice[None, :, gi], cost)
        cost = fma_f32(wr, wprice[None, :, gi], cost)
        late = ((rd + wr) > 0) & (rtt[None, :, gi] > max_lat)
        excess = excess + structural * late.to(torch.float32)
    excess = excess + structural * (~(meta[1][None, :] > 0)).to(torch.float32)
    feas = excess == 0
    penalty = torch.tensor(INFEASIBLE_PENALTY, dtype=torch.float32,
                           device=reads.device)
    return -cost - penalty * excess, feas.to(torch.int32)


def _check(reads, writes, rprice, wprice, rtt, meta):
    r, g = reads.shape
    k = rprice.shape[0]
    for name, t, shape in (("writes", writes, (r, g)), ("read_price", rprice, (k, g)),
                           ("write_price", wprice, (k, g)), ("read_rtt", rtt, (k, g)),
                           ("cand_meta", meta, (2, k))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def placement_score_ref(reads, writes, read_price, write_price, read_rtt,
                        cand_meta, *, max_latency_ms: float):
    """Plain version: ``(utility (R, K) f32, feasible (R, K) int32)``,
    bit-equal to the reference's fused contract.  Scores
    ``ROWS_PER_CHUNK`` rows at a time to bound its f64 temporaries."""
    args = [t.to(torch.float32) for t in (reads, writes, read_price,
                                          write_price, read_rtt, cand_meta)]
    _check(*args)
    reads, writes, rprice, wprice, rtt, meta = args
    max_lat = torch.tensor(max_latency_ms, dtype=torch.float32, device=reads.device)
    r, k = reads.shape[0], rprice.shape[0]
    util = torch.empty((r, k), dtype=torch.float32, device=reads.device)
    feas = torch.empty((r, k), dtype=torch.int32, device=reads.device)
    for lo in range(0, r, ROWS_PER_CHUNK):
        hi = min(r, lo + ROWS_PER_CHUNK)
        util[lo:hi], feas[lo:hi] = _score_rows(
            reads[lo:hi], writes[lo:hi], rprice, wprice, rtt, meta, max_lat)
    return util, feas


def select_from_grid(util, feas):
    """``(3, R)`` int32 ``[choice; utility bits; feasible]`` of an (R, K)
    grid: ``torch.argmax`` (the first maximum; a NaN above every number,
    the first NaN kept, as ``np.argmax``) and the chosen cells."""
    choice = torch.argmax(util, dim=1, keepdim=True)
    return torch.cat([choice.to(torch.int32).T,
                      torch.gather(util, 1, choice).view(torch.int32).T,
                      torch.gather(feas, 1, choice).T])


def _check_select(k: int) -> None:
    if k < 1:
        raise ValueError("placement_select needs at least one candidate")


def placement_select_ref(reads, writes, read_price, write_price, read_rtt,
                         cand_meta, *, max_latency_ms: float):
    """Plain version of the planner's selection: ``(3, R)`` int32
    ``[choice; utility bits; feasible]``, bit-equal to
    :func:`placement_score_ref` followed by :func:`select_from_grid`.
    Scores and selects ``ROWS_PER_CHUNK`` rows at a time, so the whole
    grid is never held."""
    args = [t.to(torch.float32) for t in (reads, writes, read_price,
                                          write_price, read_rtt, cand_meta)]
    _check(*args)
    reads, writes, rprice, wprice, rtt, meta = args
    _check_select(rprice.shape[0])
    max_lat = torch.tensor(max_latency_ms, dtype=torch.float32, device=reads.device)
    r = reads.shape[0]
    out = torch.empty((3, r), dtype=torch.int32, device=reads.device)
    for lo in range(0, r, ROWS_PER_CHUNK):
        hi = min(r, lo + ROWS_PER_CHUNK)
        out[:, lo:hi] = select_from_grid(*_score_rows(
            reads[lo:hi], writes[lo:hi], rprice, wprice, rtt, meta, max_lat))
    return out


def _cuda_inputs(name, *tensors):
    """The six inputs, contiguous (views already contiguous are kept, not
    copied), checked to be CUDA float32 of consistent shapes."""
    ins = [t.contiguous() for t in tensors]
    if not all(t.is_cuda for t in ins):
        raise ValueError(f"{name} needs CUDA tensors")
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"{name} needs float32 tensors")
    _check(*ins)
    return ins


def _lib():
    fn = build.load("placement_score").placement_score_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci,
                       ctypes.c_float, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def placement_score_cuda(reads, writes, read_price, write_price, read_rtt,
                         cand_meta, *, max_latency_ms: float):
    """Launch ``csrc/placement_score.cu`` on CUDA f32 tensors; returns
    ``(utility, feasible)``.  The resource axis needs no padding: the
    kernel masks the ragged tail itself."""
    global launches
    reads, writes, rprice, wprice, rtt, meta = _cuda_inputs(
        "placement_score_cuda", reads, writes, read_price, write_price, read_rtt,
        cand_meta)
    r, g = reads.shape
    k = rprice.shape[0]
    if (3 * k * g + 2 * k) * 4 > SMEM_MAX:
        raise ValueError(f"placement_score_cuda: K={k}, G={g} exceed one "
                         "block's shared memory")
    util = torch.empty((r, k), dtype=torch.float32, device=reads.device)
    feas = torch.empty((r, k), dtype=torch.int32, device=reads.device)
    if r == 0 or k == 0:
        return util, feas
    err = _lib()(
        reads.data_ptr(), writes.data_ptr(), rprice.data_ptr(), wprice.data_ptr(),
        rtt.data_ptr(), meta.data_ptr(), r, k, g, float(max_latency_ms),
        util.data_ptr(), feas.data_ptr(), build.stream_ptr(reads),
    )
    build.check(err, "placement_score")
    launches += 1
    return util, feas


def _select_lib():
    fn = build.load("placement_score").placement_select_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci,
                       ctypes.c_float, vp, vp]
        fn.restype = ci
    return fn


def placement_select_cuda(reads, writes, read_price, write_price, read_rtt,
                          cand_meta, *, max_latency_ms: float):
    """One launch of ``placement_select_kernel`` on CUDA f32 tensors:
    :func:`placement_select_ref`'s ``(3, R)`` int32 result, without the
    (R, K) grid.  Contiguous inputs (views into one copy, as the planner
    passes them) are read in place."""
    global select_launches
    reads, writes, rprice, wprice, rtt, meta = _cuda_inputs(
        "placement_select_cuda", reads, writes, read_price, write_price, read_rtt,
        cand_meta)
    r, g = reads.shape
    k = rprice.shape[0]
    _check_select(k)
    if not 1 <= g <= SELECT_MAX_G:
        raise ValueError(f"placement_select_cuda: G={g} regions (1 <= G <= "
                         f"{SELECT_MAX_G})")
    if k * ((3 * g + 2 + 3) // 4) * 16 > SMEM_MAX:
        raise ValueError(f"placement_select_cuda: K={k}, G={g} exceed one "
                         "block's shared memory")
    out = torch.empty((3, r), dtype=torch.int32, device=reads.device)
    if r == 0:
        return out
    err = _select_lib()(
        reads.data_ptr(), writes.data_ptr(), rprice.data_ptr(),
        wprice.data_ptr(), rtt.data_ptr(), meta.data_ptr(), r, k, g,
        float(max_latency_ms), out.data_ptr(), build.stream_ptr(reads))
    build.check(err, "placement_select")
    select_launches += 1
    return out
