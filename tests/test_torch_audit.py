"""Port's DUOT audit == JAX's: the plain vclock_audit against
``ref.vclock_audit_ref`` and the interpreted Pallas kernel, and
``core.audit.audit`` in every field (severity bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import audit as jaudit
from repro.core import duot as jduot
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.kernels import ops as jops
from repro.kernels.ref import vclock_audit_ref as j_ref
from repro_torch import convert
from repro_torch.core import audit as taudit
from repro_torch.kernels import ops
from repro_torch.kernels import vclock_audit as va

from torch_port_helpers import AUDIT_MIXES as MIXES, CPU, as_np, audit_mix, jax_to_numpy

torch.set_num_threads(1)


def _random_duot(seed, m=200, n=8, fill=None):
    """A JAX DUOT with ``fill`` random entries (rest invalid)."""
    rng = np.random.default_rng(seed)
    fill = m - 13 if fill is None else fill
    t = jduot.make(m, n)
    batch = {
        "client": jnp.asarray(rng.integers(0, n, fill), jnp.int32),
        "kind": jnp.asarray(rng.integers(0, 2, fill), jnp.int32),
        "resource": jnp.asarray(rng.integers(0, 5, fill), jnp.int32),
        "version": jnp.asarray(rng.integers(0, 40, fill), jnp.int32),
        "replica": jnp.asarray(rng.integers(0, 3, fill), jnp.int32),
        "vc": jnp.asarray(rng.integers(0, 25, (fill, n)), jnp.int32),
    }
    return jduot.record(t, batch)


def _port_duot(jt):
    return convert.duot_from_numpy(jax_to_numpy(jt), device=CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("delta", [0, 8])
def test_plain_codes_match_reference_and_pallas(seed, delta):
    jt = _random_duot(seed)             # M = 200: not a multiple of 128
    tt = _port_duot(jt)
    want = np.asarray(j_ref(jt.vc, jt.client, jt.kind, jt.resource, jt.version,
                            jt.seq, jt.valid, delta=delta))
    got = as_np(ops.audit_duot(tt, delta=delta))
    np.testing.assert_array_equal(want, got)
    pallas = np.asarray(jops.audit_duot(jt, delta=delta, interpret=True))
    np.testing.assert_array_equal(pallas, got)
    # Row chunks give the same codes as one dense block.
    chunked = va.vclock_audit_ref(tt.vc, tt.client, tt.kind, tt.resource,
                                  tt.version, tt.seq, tt.valid, delta=delta,
                                  chunk_elems=7 * 200 * 8)
    np.testing.assert_array_equal(want, as_np(chunked))


def _mix(name, m, n=8, seed=0):
    return audit_mix(name, np.random.default_rng(seed), m, n)


def _base(vc, client, kind, resource, version, seq, valid):
    return (valid[:, None] & valid[None, :] & (resource[:, None] == resource[None, :])
            & (seq[:, None] < seq[None, :]))


def _jduot(arrays):
    """A JAX DUOT holding the mix's entries."""
    vc, client, kind, resource, version, seq, valid = arrays
    m, n = vc.shape
    return jduot.make(m, n)._replace(
        vc=jnp.asarray(vc), client=jnp.asarray(client), kind=jnp.asarray(kind),
        resource=jnp.asarray(resource), version=jnp.asarray(version),
        seq=jnp.asarray(seq), valid=jnp.asarray(valid))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("m", [200, 333])
@pytest.mark.parametrize("delta", [0, 8, 96])
def test_reference_code_is_zero_off_base(mix, m, delta):
    """The premise of the kernel's skip: the reference's code is 0 wherever
    ``base`` (both valid, same resource, seq_i < seq_j) is false, so only
    base pairs need the clock compare."""
    arrays = _mix(mix, m, seed=m)
    codes = np.asarray(j_ref(*map(jnp.asarray, arrays), delta=delta))
    base = _base(*arrays)
    assert not codes[~base].any()
    if mix in ("distinct_resources", "all_invalid"):
        assert not base.any()
    if mix == "equal_clocks":            # base pairs, all concurrent
        assert base.any() and (codes[base] & 0xFF == 6).all()


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("m", [200, 333])
@pytest.mark.parametrize("delta", [-5, 0, 8, 96])
def test_compacted_twin_matches_reference_and_pallas(mix, m, delta):
    arrays = _mix(mix, m, seed=m + delta)
    want = np.asarray(j_ref(*map(jnp.asarray, arrays), delta=delta))
    t = [torch.from_numpy(x) for x in arrays]
    np.testing.assert_array_equal(va.vclock_audit_compacted(*t, delta=delta).numpy(), want)
    np.testing.assert_array_equal(va.vclock_audit_ref(*t, delta=delta).numpy(), want)
    if delta == 8:
        pallas = np.asarray(jops.audit_duot(_jduot(arrays), delta=delta, interpret=True))
        np.testing.assert_array_equal(pallas, want)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("delta", [0, 8])
def test_audit_duot_unpadded_equals_padded(seed, delta):
    """``ops.audit_duot`` no longer pads the log; padding it to a 32-row
    multiple with invalid entries (the earlier route) gives the same codes
    for the real entries."""
    tt = _port_duot(_random_duot(seed, m=203, n=6))
    got = ops.audit_duot(tt, delta=delta)
    assert got.shape == (203, 203)
    pad = (-203) % 32

    def p(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype)])

    padded = ops.vclock_audit(p(tt.vc), p(tt.client, -1), p(tt.kind), p(tt.resource, -1),
                              p(tt.version), p(tt.seq), p(tt.valid, False), delta=delta)
    np.testing.assert_array_equal(as_np(got), as_np(padded[:203, :203]))


def test_vclock_audit_cuda_refuses_cpu_tensors_and_unknown_designs():
    t = [torch.from_numpy(x) for x in _mix("random", 16)]
    with pytest.raises(ValueError):
        va.vclock_audit_cuda(*t)
    with pytest.raises(ValueError):
        ops.vclock_audit(*t, impl="cuda")
    with pytest.raises(ValueError):
        va.vclock_audit_cuda(*t, design="tiles")


def _assert_audit_equal(want, got):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), as_np(getattr(got, f))
        np.testing.assert_array_equal(w, g, err_msg=f)
    assert as_np(got.severity).dtype == np.float32
    # Bit for bit, not merely equal as floats.
    assert np.asarray(want.severity).tobytes() == as_np(got.severity).tobytes()


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("delta", [0, 8, 96])
def test_audit_matches_in_every_field(seed, delta):
    jt = _random_duot(seed, m=160, n=6)
    tt = _port_duot(jt)
    want = jaudit.audit(jt, delta=delta, use_kernel=False)
    _assert_audit_equal(want, taudit.audit(tt, delta=delta))
    # The codes path (what the CUDA kernel feeds) assembles the same result.
    _assert_audit_equal(want, taudit._audit_from_codes(tt, delta, impl="torch"))
    if seed == 0:
        _assert_audit_equal(jaudit.audit(jt, delta=delta, use_kernel=True),
                            taudit.audit(tt, delta=delta))
    jr = jaudit.session_guarantee_report(want)
    tr = taudit.session_guarantee_report(taudit.audit(tt, delta=delta))
    assert {k: int(v) for k, v in jr.items()} == {k: int(v) for k, v in tr.items()}


@pytest.mark.parametrize("level", [JL.X_STCC, JL.CAUSAL, JL.ONE])
def test_audit_of_a_reference_run_matches(level):
    """The DUOT of a real replay (nonzero severity for the weak levels)."""
    store = JStore(3, 16, 24, level=level, duot_cap=512)
    st = store.init()
    rng = np.random.default_rng(len(level.value))
    for rd in range(3):
        ops_ = {k: jnp.asarray(rng.integers(0, n, 128), jnp.int32)
                for k, n in (("client", 16), ("replica", 3), ("resource", 24),
                             ("kind", 2))}
        st, _ = store.apply_batch(st, **ops_, op_step0=rd * 128)
        st, _ = store.merge(st)
    tt = _port_duot(st.duot)
    d = store.delta or 0
    _assert_audit_equal(store.audit(st, delta=d), taudit.audit(tt, delta=d))
