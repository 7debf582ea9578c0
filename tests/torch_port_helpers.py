"""Shared helpers of the ``test_torch_*`` files: move state between the
JAX reference and the PyTorch port as numpy arrays, and compare it."""

from __future__ import annotations

import numpy as np
import torch

from repro.core.consistency import ConsistencyLevel as JLevel
from repro_torch.core.consistency import ConsistencyLevel as TLevel

CPU = "cpu"


def jlevel(level: TLevel) -> JLevel:
    return JLevel[level.name]


def tlevel(level: JLevel) -> TLevel:
    return TLevel[level.name]


def jax_to_numpy(tree) -> dict:
    """``{field: np.ndarray}`` of a JAX NamedTuple (nested for StoreState;
    ``None`` fields are left out)."""
    out = {}
    for f in tree._fields:
        v = getattr(tree, f)
        if v is None:
            continue
        out[f] = jax_to_numpy(v) if isinstance(v, tuple) else np.asarray(v)
    return out


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_equal(want, got, context: str = "") -> None:
    """Every field of a JAX NamedTuple equals the port's (dtype-blind
    values, exact)."""
    for f in want._fields:
        w = getattr(want, f)
        if w is None:
            continue
        g = getattr(got, f)
        if isinstance(w, tuple):
            assert_tree_equal(w, g, f"{context}.{f}")
            continue
        np.testing.assert_array_equal(
            np.asarray(w), as_np(g), err_msg=f"{context}.{f} diverged"
        )
