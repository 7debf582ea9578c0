"""Logical-axis sharding rules (port of ``repro.models.sharding``).

The framework uses a (pod, data, model) mesh.  Model code never names
mesh axes directly; it names *logical* axes, which these rules map to
mesh axes:

  batch                  -> 'data'
  heads/ff/vocab/experts -> 'model'   (tensor/expert parallelism)
  kv_seq (decode cache)  -> 'model'   (sequence-sharded flash-decode)
  fsdp                   -> 'data'    (ZeRO-3 weight sharding)

A placement is the reference's ``PartitionSpec`` as a tuple: one entry
per tensor dimension, each a mesh axis name, a tuple of names (the
dimension split over all of them, major first) or ``None``
(replicated).  The rules read only the mesh's axis sizes, through
:func:`mesh_shape`: a ``torch.distributed`` ``DeviceMesh``, a
:class:`MeshShape` (axis sizes and no devices, the dry run's stand-in
for the reference's ``AbstractMesh``) or any object with a ``shape``
mapping.  On a ``DeviceMesh``, :func:`param_placements` and
:func:`named_sharding` also give the DTensor placements: ``Shard(d)`` on
every mesh dimension named for tensor dimension ``d``, ``Replicate()``
on the rest.

``set_mesh(None)`` (the default) makes :func:`shard` the identity, so
the same model code runs on one device.  The reference's
``set_pod_vmap`` has no counterpart: the port loops over pods.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


class MeshShape:
    """A mesh's axis names and sizes, with no devices and no process
    group (the reference's ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape: dict[str, int]):
        self.shape = {str(k): int(v) for k, v in shape.items()}

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of ``mesh`` (``{}`` for ``None``)."""
    if mesh is None:
        return {}
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


# Logical -> mesh axis map.  Overridable for hillclimb experiments.
_DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": "data",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": "model",
    "embed": None,
    "fsdp": "data",
    "seq": None,
    "residual": None,  # set to "model" for full sequence-parallel residuals
}


def set_rule(logical: str, mesh_axis: str | tuple[str, ...] | None) -> None:
    _DEFAULT_RULES[logical] = mesh_axis


def get_rule(logical: str | None):
    if logical is None:
        return None
    return _DEFAULT_RULES.get(logical)


def spec(*logical_axes: str | None) -> tuple:
    """The placement of logical axes (``None`` = replicated dim)."""
    return tuple(get_rule(a) for a in logical_axes)


def axis_names(entry) -> tuple[str, ...]:
    """The mesh axes of one placement entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(shape: dict[str, int], entry) -> int:
    """Devices one placement entry splits its dimension over (axes the
    mesh lacks count 1)."""
    n = 1
    for a in axis_names(entry):
        n *= int(shape.get(a, 1))
    return n


def shard_shape(shape: tuple[int, ...], placement, mesh=None) -> tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``placement``
    (``None`` or ``()``: the whole tensor)."""
    sizes = mesh_shape(get_mesh() if mesh is None else mesh)
    entries = tuple(placement or ()) + (None,) * (len(shape) - len(placement or ()))
    return tuple(-(-int(d) // axis_size(sizes, e)) for d, e in zip(shape, entries))


def dtensor_placements(mesh, placement) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for a tuple
    placement: ``Shard(d)`` on each mesh dimension named for tensor
    dimension ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(placement or ()):
        for a in axis_names(entry):
            if a not in names:
                raise ValueError(f"placement {placement} names axis {a!r}, which the "
                                 f"mesh {tuple(names)} lacks")
            out[names.index(a)] = Shard(d)
    return out


def _on_mesh(placement):
    """``placement`` as the active mesh takes it: DTensor placements on a
    ``DeviceMesh``, the tuple otherwise."""
    mesh = get_mesh()
    if mesh is not None and _is_device_mesh(mesh):
        return dtensor_placements(mesh, placement)
    return placement


def shard(x, *logical_axes: str | None):
    """Place ``x`` by logical axes; the identity without an active mesh.

    Axes that do not evenly divide their dimension are dropped (a 4-way
    kv-head dim on a 16-way model axis would otherwise force padded or
    replicated layouts).  A DTensor is redistributed to the resolved
    placement; a plain tensor is returned unchanged."""
    mesh = get_mesh()
    if mesh is None:
        return x
    sizes = mesh_shape(mesh)
    resolved = []
    for dim, logical in zip(x.shape, logical_axes):
        axis = get_rule(logical)
        size = axis_size(sizes, axis)
        resolved.append(axis if (axis is not None and size > 1 and dim % size == 0)
                        else None)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and _is_device_mesh(mesh):
        return x.redistribute(mesh, dtensor_placements(mesh, tuple(resolved)))
    return x


def named_sharding(*logical_axes: str | None):
    """The placement of logical axes on the active mesh; ``None`` without
    one."""
    if get_mesh() is None:
        return None
    return _on_mesh(spec(*logical_axes))


def pspec_for_param(path: tuple[str, ...], shape: tuple[int, ...], cfg) -> tuple:
    """Weight-sharding rule by parameter name/shape.

    2-D weights get (fsdp?, model) style sharding; biases/norms are
    replicated; expert weights shard the expert dim over 'model' and the
    ff dim is left replicated (EP, not TP-within-expert); embeddings
    shard the vocab dim.
    """
    name = "/".join(str(p) for p in path)
    fsdp = get_rule("fsdp") if getattr(cfg, "fsdp_params", True) else None
    model = get_rule("heads")

    def dim_ok(d, axis):
        if axis is None:
            return False
        mesh = get_mesh()
        if mesh is None:
            return True
        size = mesh_shape(mesh)[axis] if isinstance(axis, str) else 1
        return size > 1 and d % size == 0

    nd = len(shape)
    if nd <= 1:
        return ()
    if "embed" in name or "lm_head" in name:
        # (vocab, d) or (d, vocab): shard the big dim over 'model'.
        big = 0 if shape[0] >= shape[-1] else nd - 1
        out = [None] * nd
        if dim_ok(shape[big], model):
            out[big] = model
        other = nd - 1 - big
        if dim_ok(shape[other], fsdp):
            out[other] = fsdp
        return tuple(out)
    if "expert" in name and nd >= 3:
        # (..., E, d_in, d_out): expert-parallel over 'model' (EP),
        # FSDP over d_in; leading dims are layer stacking.
        lead = nd - 3
        e = model if dim_ok(shape[lead], model) else None
        f = fsdp if dim_ok(shape[lead + 1], fsdp) else None
        return (None,) * lead + (e, f, None)
    # Generic (..., in, out) with any leading layer-stack dims:
    # FSDP on in, TP on out — except out-projections which are
    # transposed: TP on in, FSDP on out.
    transposed = any(
        k in name for k in ("wo", "out_proj", "w2", "down", "w_o", "cm_v"))
    a0 = model if transposed else fsdp
    a1 = fsdp if transposed else model
    a0 = a0 if dim_ok(shape[-2], a0) else None
    a1 = a1 if dim_ok(shape[-1], a1) else None
    if a0 == a1 and a0 is not None:
        a1 = None
    return (None,) * (nd - 2) + (a0, a1)


def _with_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def param_placements(params, cfg):
    """The placement of every leaf of a parameter tree (tensors, meta
    tensors or anything with a ``shape``): the tuple of
    :func:`pspec_for_param`, or DTensor placements when the active mesh
    is a ``DeviceMesh`` (the reference's ``params_shardings``)."""
    return _with_paths(
        lambda path, leaf: _on_mesh(pspec_for_param(path, tuple(leaf.shape), cfg)), params)

