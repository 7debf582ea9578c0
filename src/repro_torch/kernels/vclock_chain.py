"""The serial vector-clock chain of one op batch.

Port of the ``clock_step`` scan of ``repro.core.xstcc.apply_op_batch``:
for each op ``i`` in order, ``svc = max(session_vc[c], replica_vc[p])``
with ``svc[c] += 1``; the session row takes ``svc``, and a write joins it
into its coordinator's row.  Returns the updated ``(session_vc,
replica_vc)`` and the ``(B, C)`` op clocks.

  * :func:`vclock_chain_ref` — the plain version, a Python loop over the
    batch;
  * :func:`vclock_chain_cuda` — the hand-written kernel
    (``csrc/vclock_chain.cu``): thread n walks component n, on clocks
    staged in one block's shared memory, or, for clocks too wide for it
    (the serving engine's one component per session), in device memory
    across ceil(C / 256) blocks.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

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


def _lib():
    fn = build.load("vclock_chain").vclock_chain_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, vp, vp, ci, ci, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def vclock_chain_cuda(client, replica, is_write, session_vc, replica_vc):
    """Launch ``csrc/vclock_chain.cu`` on CUDA tensors."""
    global launches
    ins = [t.to(torch.int32).contiguous()
           for t in (client, replica, is_write, session_vc, replica_vc)]
    if not all(t.is_cuda for t in ins):
        raise ValueError("vclock_chain_cuda needs CUDA tensors")
    c_, p_, w_, svc, rvc = ins
    b = c_.shape[0]
    c = svc.shape[0]
    p = rvc.shape[0]
    if svc.shape != (c, c) or rvc.shape[1] != c:
        raise ValueError("session_vc must be (C, C) and replica_vc (P, C)")
    vcs = torch.empty((b, c), dtype=torch.int32, device=svc.device)
    new_svc = torch.empty_like(svc)
    new_rvc = torch.empty_like(rvc)
    err = _lib()(
        c_.data_ptr(), p_.data_ptr(), w_.data_ptr(), b, svc.data_ptr(),
        rvc.data_ptr(), c, p, vcs.data_ptr(), new_svc.data_ptr(),
        new_rvc.data_ptr(), build.stream_ptr(svc),
    )
    build.check(err, "vclock_chain")
    launches += 1
    return new_svc, new_rvc, vcs
