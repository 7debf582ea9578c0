"""Carry protocol state between the JAX package and the port.

The system has no weights; its state is ``ClusterState``, ``Duot`` and
``StoreState``.  The JAX package's pytrees cross as ``{field:
np.ndarray}`` dictionaries (``StoreState`` nests its ``cluster`` and
``duot`` dictionaries), so state taken from a reference run can be fed
to the port and compared field by field.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.duot import Duot
from repro_torch.core.replicated_store import StoreState
from repro_torch.core.xstcc import ClusterState
from repro_torch.device import resolve_device


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


def store_state_from_numpy(d: dict[str, Any], device="cuda") -> StoreState:
    dev = resolve_device(device)
    return StoreState(
        cluster=cluster_state_from_numpy(d["cluster"], dev),
        duot=duot_from_numpy(d["duot"], dev),
        pend_apply=_tensor(d["pend_apply"], dev),
    )


def to_numpy(state: NamedTuple) -> dict[str, Any]:
    """``{field: np.ndarray}`` of a port state (nested for StoreState)."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        out[f] = to_numpy(v) if isinstance(v, tuple) else v.detach().cpu().numpy()
    return out
