"""Carry protocol state and topologies between the JAX package and the
port.

The storage system has no weights; its state is ``ClusterState``, ``Duot``,
``HintState``, ``DuraState``, ``StoreState`` and the engine's ``obs``
carry.  The JAX package's pytrees cross as ``{field: np.ndarray}``
dictionaries (``StoreState`` nests its ``cluster``, ``duot`` and, when
present, ``hints`` and ``dura`` dictionaries; the obs carry is
``{"hist": ..., "counters": {name: ...}}``), so state taken from a
reference run can be fed to the port and compared field by field.
:func:`region_topology` rebuilds a reference ``RegionTopology`` from its
plain fields, so both packages can run on one topology.  The LM
substrate's parameters cross as the reference's nested param dict of
numpy arrays (:func:`params_from_numpy`), leaf for leaf.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.cost_model import EgressMatrix
from repro_torch.core.duot import Duot
from repro_torch.core.replicated_store import DuraState, HintState, StoreState
from repro_torch.core.xstcc import ClusterState
from repro_torch.device import resolve_device
from repro_torch.geo.topology import RegionTopology


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _build(cls, d: dict[str, Any], device: torch.device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return cls(**{f: _tensor(d[f], device) for f in cls._fields})


def cluster_state_from_numpy(d: dict[str, Any], device="cuda") -> ClusterState:
    return _build(ClusterState, d, resolve_device(device))


def duot_from_numpy(d: dict[str, Any], device="cuda") -> Duot:
    return _build(Duot, d, resolve_device(device))


def hint_state_from_numpy(d: dict[str, Any], device="cuda") -> HintState:
    return _build(HintState, d, resolve_device(device))


def dura_state_from_numpy(d: dict[str, Any], device="cuda") -> DuraState:
    return _build(DuraState, d, resolve_device(device))


def store_state_from_numpy(d: dict[str, Any], device="cuda") -> StoreState:
    """A ``StoreState``; ``hints`` / ``dura`` stay ``None`` when the
    dictionary has no such entry, as in a store built without them."""
    dev = resolve_device(device)
    return StoreState(
        cluster=cluster_state_from_numpy(d["cluster"], dev),
        duot=duot_from_numpy(d["duot"], dev),
        pend_apply=_tensor(d["pend_apply"], dev),
        hints=hint_state_from_numpy(d["hints"], dev) if d.get("hints") is not None else None,
        dura=dura_state_from_numpy(d["dura"], dev) if d.get("dura") is not None else None,
    )


def _leaf_tensor(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (JAX's) crosses through its 16-bit pattern:
        # torch.from_numpy does not take that dtype.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: dict[str, Any], device="cuda", mesh=None,
                      cfg=None) -> dict[str, Any]:
    """The port's parameter dict from the reference's param pytree given as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``):
    the same keys and leaf shapes, the same values and dtypes (bf16 bit
    for bit).  With a ``DeviceMesh`` ``mesh`` the leaves are DTensors
    placed by the reference's rules for ``cfg``
    (``sharding.distribute_params``), each placed as it is converted, so
    the device never holds the whole tree."""
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.models import sharding

        with sharding.use_mesh(mesh):
            return sharding.distribute_params(tree, cfg, convert=lambda a: _leaf_tensor(a, dev))
    return {k: params_from_numpy(v, dev) if isinstance(v, dict) else _leaf_tensor(v, dev)
            for k, v in tree.items()}


def obs_from_numpy(d: dict[str, Any], device="cuda") -> dict[str, Any]:
    """The engine's obs carry from ``{"hist", "counters"}`` arrays."""
    dev = resolve_device(device)
    return {
        "hist": _tensor(d["hist"], dev),
        "counters": {k: _tensor(v, dev) for k, v in d["counters"].items()},
    }


def obs_to_numpy(carry: dict[str, Any]) -> dict[str, Any]:
    """``{"hist", "counters"}`` numpy arrays of the engine's obs carry."""
    return {
        "hist": carry["hist"].detach().cpu().numpy(),
        "counters": {k: np.asarray(v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor) else v)
                     for k, v in carry["counters"].items()},
    }


def to_numpy(state: NamedTuple) -> dict[str, Any]:
    """``{field: np.ndarray}`` of a port state (nested for StoreState;
    ``None`` fields are left out)."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if v is None:
            continue
        out[f] = to_numpy(v) if isinstance(v, tuple) else v.detach().cpu().numpy()
    return out


def region_topology(ref) -> RegionTopology:
    """The port's :class:`RegionTopology` with the fields of ``ref``, any
    object with ``replica_region``, ``rtt_ms``, ``client_region`` and an
    ``egress`` holding ``pair_class``, ``class_per_gb`` and
    ``class_tiers`` (the reference's topology, read without importing
    its package)."""
    e = ref.egress
    return RegionTopology(
        replica_region=tuple(int(r) for r in ref.replica_region),
        rtt_ms=tuple(tuple(float(x) for x in row) for row in ref.rtt_ms),
        egress=EgressMatrix(
            pair_class=tuple(tuple(int(k) for k in row) for row in e.pair_class),
            class_per_gb=tuple(float(x) for x in e.class_per_gb),
            class_tiers=tuple(
                tuple((float(u), float(p)) for u, p in tiers)
                for tiers in e.class_tiers
            ),
        ),
        client_region=(None if ref.client_region is None
                       else tuple(int(r) for r in ref.client_region)),
    )
