"""Port's session admission and serving store == JAX's: the plain
``session_admit`` against ``ref.session_admit_ref`` and the interpreted
Pallas kernel, exactly (duplicate (client, resource) pairs and invalid
ops included); the plain ``session_check`` (the routers' check alone)
against their admissible and floor outputs; and the store's ``install``
/ ``read_batch`` / ``write_batch`` / ``session_floor`` / ``admit_batch``
/ ``session_check`` against the reference store on random states
(per-op ``enforce``, ``record=False``, no op index: the serving
engine's branch of ``apply_batch``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.kernels import ops
from repro_torch.kernels import session_floor as tsf

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy

torch.set_num_threads(1)

SHAPES = [(2, 3, 4, 10), (4, 16, 8, 100), (8, 64, 1, 256)]


def _admit_inputs(rng, shape, dup: bool = False):
    p, c, r, b = shape
    rv = rng.integers(0, 40, (p, r)).astype(np.int32)
    rf = rng.integers(0, 40, (c, r)).astype(np.int32)
    wf = rng.integers(0, 40, (c, r)).astype(np.int32)
    cl = rng.integers(0, c, b).astype(np.int32)
    pl = rng.integers(0, p, b).astype(np.int32)
    res = rng.integers(0, r, b).astype(np.int32)
    if dup:
        # Every (client, resource) pair of the batch appears several
        # times, at replicas of different versions.
        cl[1::2] = cl[0::2][: b // 2]
        res[1::2] = res[0::2][: b // 2]
        cl[2::3] = cl[0]
        res[2::3] = res[0]
    return rv, rf, wf, cl, pl, res


def _assert_admit_equal(want, got):
    for w, g, name in zip(want, got, ("served", "admissible", "floor", "new_rf")):
        np.testing.assert_array_equal(np.asarray(w), as_np(g), err_msg=name)
    assert got[1].dtype == torch.bool and got[3].dtype == torch.int32


@pytest.mark.parametrize("enforce", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "dup"])
def test_plain_session_admit_matches_ref_and_pallas(enforce, shape, dup):
    args = _admit_inputs(np.random.default_rng(shape[3] + dup), shape, dup)
    jargs = [jnp.asarray(a) for a in args]
    want = jref.session_admit_ref(*jargs, enforce=enforce)
    pallas = jops.session_admit(*jargs, enforce=enforce, interpret=True)
    _assert_admit_equal(want, [torch.as_tensor(np.array(x)) for x in pallas])
    got = ops.session_admit(*(torch.as_tensor(a) for a in args), enforce=enforce)
    _assert_admit_equal(want, got)


@pytest.mark.parametrize("enforce", [True, False])
def test_plain_session_admit_valid_mask_and_negative_floors(enforce):
    """Invalid ops serve 0 and still enter the floor max, as the
    reference's do: negative floors at their cells rise to 0."""
    rng = np.random.default_rng(7)
    rv, rf, wf, cl, pl, res = _admit_inputs(rng, (3, 6, 5, 40), dup=True)
    rf = rf - 20
    valid = rng.random(40) < 0.6
    want = jref.session_admit_ref(*(jnp.asarray(a) for a in (rv, rf, wf, cl, pl, res)),
                                  enforce=enforce, valid=jnp.asarray(valid))
    got = tsf.session_admit_ref(*(torch.as_tensor(a) for a in (rv, rf, wf, cl, pl, res)),
                                enforce=enforce, valid=torch.as_tensor(valid))
    _assert_admit_equal(want, got)
    assert (as_np(got[3]) != rf).any()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "dup"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "partly_valid"])
def test_plain_session_check_matches_ref_and_pallas(shape, dup, masked):
    """``[admissible, floor]`` of the reference's admission (and of its
    Pallas kernel where every op is valid), negative floors included; the
    resource defaults to 0 and ``out`` receives the result."""
    rng = np.random.default_rng(shape[3] + 2 * dup + masked)
    rv, rf, wf, cl, pl, res = _admit_inputs(rng, shape, dup)
    rf = rf - 20
    valid = rng.random(shape[3]) < 0.6 if masked else None
    jargs = [jnp.asarray(a) for a in (rv, rf, wf, cl, pl, res)]
    jvalid = None if valid is None else jnp.asarray(valid)
    wants = [jref.session_admit_ref(*jargs, valid=jvalid)]
    if valid is None:
        wants.append(jops.session_admit(*jargs, interpret=True))
    tables = [torch.as_tensor(a) for a in (rv, rf, wf)]
    index = torch.as_tensor(np.stack([cl, pl]))
    tvalid = None if valid is None else torch.as_tensor(valid)
    got = ops.session_check(*tables, index, resource=torch.as_tensor(res), valid=tvalid)
    assert got.dtype == torch.int32 and got.shape == (2, shape[3])
    for want in wants:
        np.testing.assert_array_equal(
            got.numpy(), np.stack([np.asarray(want[1]), np.asarray(want[2])]))
    # Resource 0 by default; the result written into a caller's buffer.
    want0 = jref.session_admit_ref(*jargs[:5], jnp.zeros_like(jargs[5]), valid=jvalid)
    out = torch.full((2, shape[3]), -7, dtype=torch.int32)
    assert tsf.session_check_ref(*tables, index, valid=tvalid, out=out) is out
    np.testing.assert_array_equal(
        out.numpy(), np.stack([np.asarray(want0[1]), np.asarray(want0[2])]))


def test_session_admit_dispatch_on_the_cpu():
    args = [torch.as_tensor(a) for a in _admit_inputs(np.random.default_rng(1),
                                                      SHAPES[0])]
    ops.reset_launch_counts()
    a = ops.session_admit(*args, impl="auto")
    b = ops.session_admit(*args, impl="torch")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ops.launch_counts()["session_floor"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.session_admit(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tsf.session_admit_cuda(*args)
    index = torch.stack(args[3:5])
    assert torch.equal(ops.session_check(*args[:3], index, resource=args[5]),
                       torch.stack([a[1].to(torch.int32), a[2]]))
    assert ops.launch_counts()["session_floor"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.session_check(*args[:3], index, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tsf.session_check_cuda(*args[:3], index)


# -- the store's serving methods ------------------------------------------------


LEVELS = [TL.X_STCC, TL.ONE, TL.ALL]


def _random_stores(level, seed, p=3, c=6, r=4, q=8):
    """The reference store and the port's on one random state: versions,
    floors, clocks, a partly live pending ring and a clock counter."""
    jstore = JStore(p, c, r, level=JL[level.name], pending_cap=q, duot_cap=32)
    tstore = TStore(p, c, r, level=level, pending_cap=q, duot_cap=32, device=CPU)
    rng = np.random.default_rng(seed)
    st = jax_to_numpy(jstore.init())
    cl = st["cluster"]
    gv = rng.integers(5, 30, r).astype(np.int32)
    cl["global_version"] = gv
    cl["replica_version"] = (gv[None, :] - rng.integers(0, 6, (p, r))).astype(np.int32)
    cl["read_floor"] = (gv[None, :] - rng.integers(0, 9, (c, r))).astype(np.int32)
    cl["write_floor"] = (gv[None, :] - rng.integers(0, 12, (c, r))).astype(np.int32)
    cl["session_vc"] = rng.integers(0, 9, (c, c)).astype(np.int32)
    cl["replica_vc"] = rng.integers(0, 9, (p, c)).astype(np.int32)
    live = rng.random(q) < 0.5
    cl["pend_live"] = live
    cl["pend_client"] = np.where(live, rng.integers(0, c, q), -1).astype(np.int32)
    cl["pend_resource"] = np.where(live, rng.integers(0, r, q), -1).astype(np.int32)
    cl["pend_version"] = np.where(live, rng.integers(1, 30, q), 0).astype(np.int32)
    cl["clock"] = np.int32(rng.integers(0, 100))
    jst = jax_to_numpy(jstore.init())
    jst["cluster"] = cl
    from repro.core.replicated_store import StoreState as JState
    from repro.core.xstcc import ClusterState as JCluster
    from repro.core import duot as jduot

    jstate = JState(
        cluster=JCluster(**{k: jnp.asarray(v) for k, v in cl.items()}),
        duot=jduot.Duot(**{k: jnp.asarray(v) for k, v in jst["duot"].items()}),
        pend_apply=jnp.asarray(jst["pend_apply"]),
    )
    tstate = convert.store_state_from_numpy(jst, device=CPU)
    assert_tree_equal(jstate, tstate, "start")
    return jstore, jstate, tstore, tstate, rng


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.name)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_batch_per_op_enforce_matches_reference(level, seed):
    jstore, jst, tstore, tst, rng = _random_stores(level, seed)
    b = 9  # one batch shape: the reference compiles per shape
    for step in range(3):
        kw = dict(client=rng.integers(0, 6, b).astype(np.int32),
                  replica=rng.integers(0, 3, b).astype(np.int32),
                  resource=rng.integers(0, 4, b).astype(np.int32))
        enforce = rng.random(b) < 0.5
        jst, jres = jstore.read_batch(jst, **{k: jnp.asarray(v) for k, v in kw.items()},
                                      record=False, enforce=jnp.asarray(enforce))
        tst, tres = tstore.read_batch(tst, **kw, record=False,
                                      enforce=torch.as_tensor(enforce))
        for f in ("version", "vc", "admissible", "stale", "violation", "slot"):
            np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                          as_np(getattr(tres, f)), err_msg=f"{step} {f}")
        assert_tree_equal(jst, tst, f"read {step}")
    # A scalar enforce and a recorded read, then a write batch.
    jst, _ = jstore.read_batch(jst, client=jnp.asarray([1, 2], jnp.int32),
                               replica=jnp.asarray([0, 2], jnp.int32),
                               resource=jnp.asarray([3, 3], jnp.int32), enforce=False)
    tst, _ = tstore.read_batch(tst, client=[1, 2], replica=[0, 2], resource=[3, 3],
                               enforce=False)
    jst, jw = jstore.write_batch(jst, client=jnp.asarray([0, 4, 0], jnp.int32),
                                 replica=jnp.asarray([1, 1, 2], jnp.int32),
                                 resource=jnp.asarray([2, 2, 0], jnp.int32))
    tst, tw = tstore.write_batch(tst, client=[0, 4, 0], replica=[1, 1, 2],
                                 resource=[2, 2, 0])
    np.testing.assert_array_equal(np.asarray(jw.version), as_np(tw.version))
    assert_tree_equal(jst, tst, "write")


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.name)
@pytest.mark.parametrize("seed", [0, 1])
def test_install_session_floor_and_admit_batch_match_reference(level, seed):
    jstore, jst, tstore, tst, rng = _random_stores(level, seed)
    for replica, resource, version in ((0, 1, 50), (2, 1, 3), (1, 3, 31)):
        jst = jstore.install(jst, replica=replica, resource=resource, version=version)
        tst = tstore.install(tst, replica=replica, resource=resource, version=version)
    assert_tree_equal(jst, tst, "install")
    c = rng.integers(0, 6, 20).astype(np.int32)
    r = rng.integers(0, 4, 20).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jstore.session_floor(jst, jnp.asarray(c), jnp.asarray(r))),
        as_np(tstore.session_floor(tst, c, r)))
    assert int(tstore.session_floor(tst, 3, 2)) == int(jstore.session_floor(jst, 3, 2))
    p = rng.integers(0, 3, 20).astype(np.int32)
    c[5:9], r[5:9] = c[0], r[0]
    want = jstore.admit_batch(jst, client=jnp.asarray(c), replica=jnp.asarray(p),
                              resource=jnp.asarray(r), use_kernel=False)
    for impl in (None, "torch"):
        got = tstore.admit_batch(tst, client=c, replica=p, resource=r, impl=impl)
        assert_tree_equal(want[0], got[0], "admit state")
        for w, g in zip(want[1:], got[1:3]):
            np.testing.assert_array_equal(np.asarray(w), as_np(g))
        np.testing.assert_array_equal(
            np.asarray(jstore.session_floor(jst, jnp.asarray(c), jnp.asarray(r))),
            as_np(got[3]))


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.name)
@pytest.mark.parametrize("seed", [0, 1])
def test_store_session_check_matches_admit_batch(level, seed):
    """The routers' check equals ``admit_batch``'s admissible and floor
    outputs (the port's, and the reference's admissible and session
    floors), from a host (2, B) index, and leaves the state as it was."""
    jstore, jst, tstore, tst, rng = _random_stores(level, seed)
    c = rng.integers(0, 6, 24).astype(np.int32)
    p = rng.integers(0, 3, 24).astype(np.int32)
    r = rng.integers(0, 4, 24).astype(np.int32)
    c[5:9], r[5:9] = c[0], r[0]
    for resource, res in ((r, r), (None, np.zeros_like(r))):
        got = tstore.session_check(tst, np.stack([c, p]), resource=resource)
        _, _, adm, floor = tstore.admit_batch(tst, client=c, replica=p, resource=res)
        np.testing.assert_array_equal(
            got.numpy(), np.stack([as_np(adm).astype(np.int32), as_np(floor)]))
        jargs = {k: jnp.asarray(v) for k, v in (("client", c), ("replica", p),
                                                ("resource", res))}
        want = jstore.admit_batch(jst, **jargs, use_kernel=False)
        np.testing.assert_array_equal(got[0].numpy().astype(bool), np.asarray(want[2]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(
            jstore.session_floor(jst, jargs["client"], jargs["resource"])))
    assert_tree_equal(jst, tst, "check leaves the state")


def test_store_write_read_merge_roundtrip():
    """The reference's facade round trip on the port's store."""
    store = TStore(3, 4, 2, level=TL.X_STCC, device=CPU)
    st = store.init()
    idx = torch.arange(3, dtype=torch.int32)
    st, w = store.write_batch(st, client=idx, replica=idx,
                              resource=torch.zeros(3, dtype=torch.int32))
    assert w.version.tolist() == [1, 2, 3]
    st, n = store.merge(st, delta=0)
    assert int(n) == 3
    st, r = store.read_batch(st, client=idx, replica=(idx + 1) % 3,
                             resource=torch.zeros(3, dtype=torch.int32))
    assert not r.stale.any() and not r.violation.any()
    assert int(st.duot.size) == 6


def test_store_session_floor_and_install():
    store = TStore(2, 2, 1, level=TL.X_STCC, device=CPU)
    st = store.install(store.init(), replica=0, resource=0, version=7)
    assert int(st.cluster.replica_version[0, 0]) == 7
    assert int(st.cluster.global_version[0]) == 7
    st, r = store.read_batch(st, client=[0], replica=[0], resource=[0])
    assert int(r.version[0]) == 7 and int(store.session_floor(st, 0, 0)) == 7
    # At the stale replica, enforcement serves the floor (repair).
    st, r2 = store.read_batch(st, client=[0], replica=[1], resource=[0])
    assert int(r2.version[0]) == 7 and not bool(r2.violation[0])


def test_store_admit_batch_matches_read_floor_semantics():
    store = TStore(2, 3, 1, level=TL.X_STCC, device=CPU)
    st = store.install(store.init(), replica=0, resource=0, version=5)
    st = store.install(st, replica=1, resource=0, version=2)
    st, _ = store.read_batch(st, client=[0], replica=[0], resource=[0])
    st2, served, adm, floor = store.admit_batch(st, client=[0, 1], replica=[1, 1],
                                                resource=[0, 0])
    assert adm.tolist() == [False, True]
    assert served.tolist() == [5, 2]
    assert floor.tolist() == [5, 0]
    assert int(store.session_floor(st2, 1, 0)) == 2
