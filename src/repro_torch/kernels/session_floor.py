"""Batched session-floor admission: the serving router's per-op check.

Port of ``repro.kernels.session_floor``.  For every op ``i`` of a
``(B,)`` batch, with client ``c``, replica ``p``, resource ``r``:

    raw    = replica_version[p, r]
    floor  = max(read_floor[c, r], write_floor[c, r])
    adm    = ok and raw >= floor
    served = (max(raw, floor) if enforce else raw) if ok else 0

and the read floors absorb the served versions:
``new_read_floor[c, r] = max(read_floor[c, r], served)`` over every op
(an invalid op's 0 included).  Every op is checked against the
*pre-batch* floors (the router admits a batch concurrently).  The
contract is ``repro.kernels.ref.session_admit_ref``, exact int32; the
reference's Pallas body gathers through f32 one-hot matmuls, exact only
below 2^24, and is not carried over.

  * :func:`session_admit_ref` — the plain version: integer gathers and a
    ``scatter_reduce_("amax")`` on a clone of the floors;
  * :func:`session_admit_cuda` — the hand-written kernel
    (``csrc/session_floor.cu``): one thread per op, integer gathers and
    ``atomicMax`` into a separate copy of the floors.

Both return ``(served, admissible, floor, new_read_floor)``.  The
routers discard the floor update (their observe read commits the floors
later), so their admission is the check alone: :func:`session_check_ref`
(gathers, max and compare) and :func:`session_check_cuda` (the same
source's check kernel: no served version, no (C, R) copy, no atomics)
return ``admissible`` and ``floor`` as one ``(2, B)`` int32 tensor, from
the client ids and replicas as one ``(2, B)`` int32 index.  Indices must
lie in the tables: out of range, the plain versions raise (past the end)
or wrap (negative), where the kernels treat the op as invalid.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0


def session_admit_ref(replica_version, read_floor, write_floor, client, replica,
                      resource, *, enforce: bool = True, valid=None):
    """Plain version of the batched admission check + floor update."""
    dev = read_floor.device
    c, p, r = (torch.as_tensor(x, device=dev).long() for x in (client, replica, resource))
    ok = (torch.ones(c.shape, dtype=torch.bool, device=dev) if valid is None
          else torch.as_tensor(valid, device=dev).to(torch.bool))
    raw = replica_version[p, r]
    floor = torch.maximum(read_floor[c, r], write_floor[c, r])
    admissible = ok & (raw >= floor)
    served = torch.maximum(raw, floor) if enforce else raw
    zero = torch.zeros((), dtype=served.dtype, device=dev)
    served = torch.where(ok, served, zero)
    new_rf = read_floor.clone()
    new_rf.view(-1).scatter_reduce_(0, c * read_floor.shape[1] + r, served, "amax",
                                    include_self=True)
    return served, admissible, torch.where(ok, floor, zero), new_rf


def session_check_ref(replica_version, read_floor, write_floor, index, *,
                      resource=None, valid=None, out=None):
    """Plain version of the admission check: ``(2, B)`` int32
    ``[admissible, floor]`` (floor 0 where ``valid`` is false)."""
    dev = read_floor.device
    idx = torch.as_tensor(index, device=dev).long()
    c, p = idx[0], idx[1]
    r = (torch.zeros_like(c) if resource is None
         else torch.as_tensor(resource, device=dev).long())
    ok = (torch.ones(c.shape, dtype=torch.bool, device=dev) if valid is None
          else torch.as_tensor(valid, device=dev).to(torch.bool))
    floor = torch.maximum(read_floor[c, r], write_floor[c, r])
    res = torch.stack([(ok & (replica_version[p, r] >= floor)).to(torch.int32),
                       torch.where(ok, floor, 0).to(torch.int32)])
    if out is None:
        return res
    return out.copy_(res)


def _lib():
    fn = build.load("session_floor").session_floor_launch
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, ci, cll, cll, vp, vp, vp, vp, cll, ci,
                       vp, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def session_admit_cuda(replica_version, read_floor, write_floor, client, replica,
                       resource, *, enforce: bool = True, valid=None):
    """Launch ``csrc/session_floor.cu`` on CUDA int32 tensors."""
    global launches
    tables = [t.contiguous() for t in (replica_version, read_floor, write_floor)]
    idx = [t.to(torch.int32).contiguous() for t in (client, replica, resource)]
    if not all(t.is_cuda for t in tables + idx):
        raise ValueError("session_admit_cuda needs CUDA tensors")
    if any(t.dtype != torch.int32 for t in tables):
        raise ValueError("session_admit_cuda needs int32 version and floor tables")
    rv, rf, wf = tables
    c, p, r = idx
    if rv.dim() != 2 or rf.dim() != 2 or wf.shape != rf.shape or rv.shape[1] != rf.shape[1]:
        raise ValueError("replica_version must be (P, R) and the floors (C, R), got "
                         f"{tuple(rv.shape)}, {tuple(rf.shape)}, {tuple(wf.shape)}")
    b = c.shape[0]
    if c.dim() != 1 or p.shape != (b,) or r.shape != (b,):
        raise ValueError("client, replica and resource must be (B,) each")
    ok = None
    if valid is not None:
        ok = torch.as_tensor(valid, device=rf.device).to(torch.bool).contiguous()
        if ok.shape != (b,):
            raise ValueError(f"valid must be ({b},), got {tuple(ok.shape)}")
    dev = rf.device
    served = torch.empty((b,), dtype=torch.int32, device=dev)
    adm = torch.empty((b,), dtype=torch.bool, device=dev)
    floor = torch.empty((b,), dtype=torch.int32, device=dev)
    new_rf = torch.empty_like(rf)
    err = _lib()(
        rv.data_ptr(), rf.data_ptr(), wf.data_ptr(), rv.shape[0], rf.shape[0],
        rf.shape[1], c.data_ptr(), p.data_ptr(), r.data_ptr(),
        None if ok is None else ok.data_ptr(), b, int(bool(enforce)),
        served.data_ptr(), adm.data_ptr(), floor.data_ptr(), new_rf.data_ptr(),
        build.stream_ptr(rf),
    )
    build.check(err, "session_floor")
    launches += 1
    return served, adm, floor, new_rf


_CHECK_FN = None


def _check_lib():
    global _CHECK_FN
    if _CHECK_FN is None:
        fn = build.load("session_floor").session_check_launch
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, ci, cll, cll, vp, vp, vp, cll, vp, vp]
        fn.restype = ci
        _CHECK_FN = fn
    return _CHECK_FN


def session_check_cuda(replica_version, read_floor, write_floor, index, *,
                       resource=None, valid=None, out=None):
    """Launch the check kernel of ``csrc/session_floor.cu``: contiguous
    CUDA int32 tables, ``index`` a contiguous CUDA (2, B) int32 tensor;
    writes ``out`` ((2, B) int32, contiguous; allocated when None)."""
    global launches
    rv, rf, wf = replica_version, read_floor, write_floor
    if not (rv.is_cuda and rf.is_cuda and wf.is_cuda and index.is_cuda):
        raise ValueError("session_check_cuda needs CUDA tensors")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in (rv, rf, wf, index)):
        raise ValueError("session_check_cuda needs contiguous int32 tables and index")
    if rv.dim() != 2 or rf.dim() != 2 or wf.shape != rf.shape or rv.shape[1] != rf.shape[1]:
        raise ValueError("replica_version must be (P, R) and the floors (C, R), got "
                         f"{tuple(rv.shape)}, {tuple(rf.shape)}, {tuple(wf.shape)}")
    if index.dim() != 2 or index.shape[0] != 2:
        raise ValueError(f"index must be (2, B), got {tuple(index.shape)}")
    b = index.shape[1]
    if resource is not None:
        resource = torch.as_tensor(resource, device=rf.device).to(torch.int32).contiguous()
        if resource.shape != (b,):
            raise ValueError(f"resource must be ({b},), got {tuple(resource.shape)}")
    if valid is not None:
        valid = torch.as_tensor(valid, device=rf.device).to(torch.bool).contiguous()
        if valid.shape != (b,):
            raise ValueError(f"valid must be ({b},), got {tuple(valid.shape)}")
    if out is None:
        out = torch.empty((2, b), dtype=torch.int32, device=rf.device)
    elif (out.dtype != torch.int32 or out.shape != (2, b) or not out.is_contiguous()
          or out.device != rf.device):
        raise ValueError(f"out must be a contiguous (2, {b}) int32 tensor on the card")
    if b:
        err = (_CHECK_FN or _check_lib())(
            rv.data_ptr(), rf.data_ptr(), wf.data_ptr(), rv.shape[0], rf.shape[0],
            rf.shape[1], index.data_ptr(),
            None if resource is None else resource.data_ptr(),
            None if valid is None else valid.data_ptr(), b, out.data_ptr(),
            build.stream_ptr(rf))
        if err:
            build.check(err, "session_floor")
        launches += 1
    return out
