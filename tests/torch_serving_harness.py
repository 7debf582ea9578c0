"""Run one serving script through the JAX reference's ``ServingEngine``
and the port's, and compare everything they observe.

A script is a function of a :class:`Side`; it builds engines and routers
through the side (``side.engine("X_STCC", max_sessions=8)``), drives them
with plain Python values, and returns ``(log, units)``: a list of what
each step returned (an exception as ``("raise", type name, message)``)
and the engines and routers whose state is compared at the end.
:func:`run_both` runs the script on both sides and asserts the logs, the
counters (``retry_wait_ms`` included), the per-session telemetry and
levels, the region and age histograms, and the whole store state equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from repro.core.consistency import ConsistencyLevel as JL
from repro.geo import topology as jtopo
from repro.serve import engine as jserve
from repro_torch import convert
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.geo import topology as ttopo
from repro_torch.serve import engine as tserve

from torch_port_helpers import CPU, jax_to_numpy, plain, serving_counters


class NullModel:
    """A model the engine never computes with."""

    def prefill(self, params, batch):
        raise NotImplementedError

    def decode_step(self, params, cache, tokens):
        return "logits", "cache"


class Side:
    """One package's serving API, driven with plain Python values.
    ``use_kernel`` is the reference ``route_batch``'s admission path (the
    interpreted Pallas kernel or its oracle; the two agree, and the
    oracle is faster on the CPU)."""

    def __init__(self, name: str, use_kernel: bool = False):
        self.name = name
        self.is_jax = name == "jax"
        self.use_kernel = use_kernel
        self.serve = jserve if self.is_jax else tserve
        self.topo = jtopo if self.is_jax else ttopo

    def level(self, name: str):
        return (JL if self.is_jax else TL)[name]

    def engine(self, level: str = "X_STCC", model=None, **kw):
        m = NullModel() if model is None else model
        if self.is_jax:
            return jserve.ServingEngine(m, JL[level], jit=False, **kw)
        return tserve.ServingEngine(m, TL[level], device=CPU, **kw)

    def router(self, *args, level: str = "X_STCC", **kw):
        if self.is_jax:
            return jserve.ShardedServingRouter(*args, level=JL[level], **kw)
        return tserve.ShardedServingRouter(*args, level=TL[level], device=CPU, **kw)

    def session(self, sid: int, floor: int = 0):
        return self.serve.ServeSession(sid, read_floor=floor)

    def policy(self, **kw):
        return self.serve.RetryPolicy(**kw)

    def route_batch(self, eng, sessions, preferred=None):
        if self.is_jax:
            pref = None if preferred is None else jnp.asarray(preferred, jnp.int32)
            rep, srv = eng.route_batch(sessions, preferred=pref,
                                       use_kernel=self.use_kernel)
        else:
            rep, srv = eng.route_batch(sessions, preferred=preferred)
        return np.asarray(rep).tolist(), np.asarray(srv).tolist()

    def router_route(self, router, sid, preferred=None):
        if self.is_jax:
            pref = None if preferred is None else jnp.asarray(preferred, jnp.int32)
            rep, srv = router.route(jnp.asarray(sid, jnp.int32), preferred=pref)
        else:
            rep, srv = router.route(np.asarray(sid), preferred=preferred)
        return np.asarray(rep).tolist(), np.asarray(srv).tolist()

    def uniform_topology(self, replica_region, **kw):
        return self.topo.uniform_topology(tuple(replica_region), **kw)


def _store_state(unit, is_jax: bool) -> dict:
    if is_jax:
        return plain(jax_to_numpy(unit._st if hasattr(unit, "_st") else unit))
    st = unit._st
    if isinstance(st, list):   # the port's router: one store per shard
        per = [convert.to_numpy(s) for s in st]
        return plain(_stack(per))
    return plain(convert.to_numpy(st))


def _stack(trees: list[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees])) for k in trees[0]}


def snapshot(unit, is_jax: bool) -> dict:
    """Everything an engine or router has observed, as plain values."""
    return dict(serving_counters(unit), store=_store_state(unit, is_jax))


def run_both(script, use_kernel: bool = False):
    """Run ``script`` on both sides; assert everything equal and return
    the port's log."""
    results = {}
    for name in ("jax", "torch"):
        side = Side(name, use_kernel=use_kernel)
        log, units = script(side)
        results[name] = (plain(log), {k: snapshot(u, side.is_jax)
                                       for k, u in units.items()})
    (jlog, jsnap), (tlog, tsnap) = results["jax"], results["torch"]
    assert tlog == jlog
    assert set(tsnap) == set(jsnap)
    for k in jsnap:
        for f in jsnap[k]:
            assert tsnap[k][f] == jsnap[k][f], f"{k}.{f}"
    return tlog
