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

:func:`shard_map` is the port of ``jax.shard_map`` for the regions whose
collectives run over one named mesh axis: the ring attention over
``kv_seq`` and the flash-decode combine (``models/attention.py``).  The
models hold plain global tensors, so the region takes them, runs its
body on each shard of that axis with ``permute`` / ``pmax`` / ``psum``
between the shards, and returns global tensors again.  The active mesh's
type picks how: on a ``DeviceMesh`` each rank runs its own shard and the
collectives are ``torch.distributed`` functional collectives over the
axis's process group; on a :class:`MeshShape` (no process group: the dry
run, one card) every shard runs in this process, stacked on a leading
dimension, as ``shard_map`` on forced host devices computes.  Entries of
a placement that name other axes (the batch's ``data``) only split
independent rows: every rank keeps those rows whole.  The per-data-shard
MoE dispatch (``models/moe.py``) has no collective and runs its blocks
stacked in one process on any mesh.

SPMD on a ``DeviceMesh`` (the dense transformer's serving path):
:func:`distribute_params` places a parameter tree as DTensors by
:func:`param_placements`, each rank holding only its blocks; the
models' :func:`shard` constraints then redistribute the activations
(FSDP over ``data``, TP over ``model``), and :func:`spmd` lets the plain
tensors a model makes (positions, masks) meet DTensors as replicated
values.  :func:`local_map` runs a function on each rank's local blocks
(the flash kernel, the decode's cache write) and wraps its result with
the placement it was computed under; :func:`shard_map` takes DTensors
too, one block per rank.  Plain tensors on a ``DeviceMesh`` (the
collective regions above, training) keep their behaviour.
"""

from __future__ import annotations

import contextlib
import threading

import torch

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


def resolve(shape, logical_axes) -> tuple:
    """The placement tuple of logical axes for a tensor of ``shape`` on
    the active mesh: axes that do not evenly divide their dimension, or
    have size 1, are dropped (a 4-way kv-head dim on a 16-way model axis
    would otherwise force padded or replicated layouts), as the
    reference's ``shard`` drops them."""
    sizes = mesh_shape(get_mesh())
    out = []
    for dim, logical in zip(shape, logical_axes):
        axis = get_rule(logical)
        size = axis_size(sizes, axis)
        out.append(axis if (axis is not None and size > 1 and dim % size == 0) else None)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _redistribute(x, mesh, placements):
    """``x`` (a DTensor) on ``placements``.  Partial mesh dims reduce
    first, each to its target (a ``_MaskPartial``, the vocab-sharded
    embedding's, always to ``Replicate``), then the shards move."""
    from torch.distributed.tensor import Partial, Replicate

    cur = list(x.placements)
    if any(p.is_partial() for p in cur):
        mid = [(t if type(p) is Partial else Replicate()) if p.is_partial() else p
               for p, t in zip(cur, placements)]
        x = x.redistribute(mesh, mid)
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(mesh, placements)


def shard(x, *logical_axes: str | None):
    """Place ``x`` by logical axes (:func:`resolve`); the identity without
    an active mesh.  A DTensor is redistributed to the resolved placement;
    a plain tensor is returned unchanged."""
    mesh = get_mesh()
    if mesh is None or not is_dtensor(x) or not _is_device_mesh(mesh):
        return x
    return _redistribute(x, mesh, dtensor_placements(mesh, resolve(x.shape, logical_axes)))


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


# ---- SPMD on a DeviceMesh ------------------------------------------------------


def _block_of(t, mesh, placements):
    """This rank's block of the whole tensor ``t`` under DTensor
    ``placements``: each sharded mesh dim, in mesh order, splits what the
    earlier ones left (DTensor's layout)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    block = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            block = block.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return block


def _from_whole(t, mesh, placements):
    """A DTensor holding this rank's block of ``t`` (a copy when the block
    is a part, so the whole can be freed); no collective.  Every sharded
    dimension divides evenly (:func:`resolve`, :func:`pspec_for_param`)."""
    from torch.distributed.tensor import DTensor

    block = _block_of(t, mesh, placements)
    if block.shape != t.shape:
        block = block.contiguous().clone()
    return DTensor.from_local(block, mesh, placements, run_check=False)


def distribute_params(params, cfg, convert=None):
    """``params`` as DTensors on the active ``DeviceMesh``, each leaf placed
    by :func:`param_placements` and each rank keeping only its blocks
    (sliced from the whole leaf, which every rank holds: no collective).
    ``convert`` (a leaf -> tensor function, applied first) lets the leaves
    be anything with a shape, each converted only as it is placed.  The
    identity with no mesh or on a :class:`MeshShape` (but for
    ``convert``).  Only the dense transformer's constraints are ported
    (ROADMAP A.2); any other family raises ``NotImplementedError`` rather
    than run replicated."""
    mesh = get_mesh()
    if mesh is None or not _is_device_mesh(mesh):
        return params if convert is None else _with_paths(lambda _, leaf: convert(leaf),
                                                            params)
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): SPMD on a DeviceMesh covers the dense transformer "
            f"only; the MoE's expert parallelism and the other families' constraints are "
            f"ROADMAP A.2's next steps")
    placed = param_placements(params, cfg)

    def place(path, leaf):
        pl = placed
        for k in path:
            pl = pl[k]
        return _from_whole(leaf if convert is None else convert(leaf), mesh, pl)

    return _with_paths(place, params)


def local_nbytes(tree) -> int:
    """The bytes this rank holds of a tree of tensors or DTensors."""
    if isinstance(tree, dict):
        return sum(local_nbytes(v) for v in tree.values())
    t = tree.to_local() if is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def spmd(params):
    """The context a model's entry point runs in: where ``params`` are
    DTensors, plain tensors (tokens, positions, masks, scalars) meet them
    as replicated values (``implicit_replication``); else nothing."""
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if not is_dtensor(leaf):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _as_placed(x, placement, mesh):
    """``x`` (a DTensor, or a plain tensor every rank holds whole) as a
    DTensor on the placement tuple ``placement``."""
    target = dtensor_placements(mesh, placement)
    if is_dtensor(x):
        return _redistribute(x, mesh, target)
    return _from_whole(x, mesh, target)


def block_start(shape, placement, dim: int) -> int:
    """Where this rank's block of dimension ``dim`` starts in the whole
    tensor of ``shape`` under the placement tuple ``placement`` on the
    active ``DeviceMesh`` (0 when the dimension is whole)."""
    mesh = get_mesh()
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    entry = (tuple(placement) + (None,) * len(shape))[dim]
    idx, n = 0, 1
    for i, name in enumerate(names):
        if name in axis_names(entry):
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx * (int(shape[dim]) // n)


def local_map(fn, in_axes, out_axes):
    """``fn`` on each rank's local blocks.

    ``in_axes`` holds logical axes for each argument: the argument (a
    DTensor, or a plain tensor every rank holds whole) is placed by
    :func:`resolve` and ``fn`` gets its local block.  ``fn``'s result, one
    tensor with the whole shape of the first argument, is this rank's
    block of a DTensor placed by ``out_axes`` (resolved against that
    shape).  With no DTensor argument, or off a ``DeviceMesh``, ``fn``
    runs on the arguments as they are."""
    def run(*args):
        mesh = get_mesh()
        if mesh is None or not _is_device_mesh(mesh) or not any(map(is_dtensor, args)):
            return fn(*args)
        from torch.distributed.tensor import DTensor

        local = [_as_placed(x, resolve(x.shape, axes), mesh).to_local()
                 for x, axes in zip(args, in_axes)]
        out = dtensor_placements(mesh, resolve(args[0].shape, out_axes))
        return DTensor.from_local(fn(*local).contiguous(), mesh, out, run_check=False)

    return run


# ---- shard_map ---------------------------------------------------------------


def _axis_dim(placement, axis: str) -> int | None:
    """The tensor dimension a placement splits over ``axis`` (``None``:
    replicated over it)."""
    for d, entry in enumerate(placement or ()):
        if axis in axis_names(entry):
            return d
    return None


def _shift(pairs, n: int) -> int:
    """The shift of a cyclic ``permute``: every pair is ``(j, (j + s) % n)``."""
    s = (pairs[0][1] - pairs[0][0]) % n
    if sorted(pairs) != [(j, (j + s) % n) for j in range(n)]:
        raise ValueError(f"permute takes a cyclic shift of all {n} shards, not {pairs}")
    return s


class StackedAxis:
    """The axis handle of :func:`shard_map` on a :class:`MeshShape`: all
    ``size`` shards in this process, on a leading dimension.  Autograd
    differentiates every step as it is."""

    def __init__(self, size: int):
        self.size = size

    def enter(self, x, dim):
        if dim is None:
            return x.unsqueeze(0).expand((self.size,) + tuple(x.shape))
        return x.unflatten(dim, (self.size, -1)).movedim(dim, 0)

    def leave(self, y, dim):
        if dim is None:
            return y[0]
        return y.movedim(0, dim).flatten(dim, dim + 1)

    def permute(self, x, pairs):
        """Shard ``j``'s block goes to shard ``k`` for each ``(j, k)``."""
        return torch.roll(x, _shift(pairs, self.size), dims=0)

    def pmax(self, x):
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def psum(self, x):
        """The sum over the shards, added in ascending shard order."""
        acc = x[0]
        for j in range(1, self.size):
            acc = acc + x[j]
        return acc.unsqueeze(0).expand_as(x)


def _funcol():
    import torch.distributed._functional_collectives as funcol

    return funcol


def _gather(x, group):
    """Every rank's ``x`` stacked on dim 0, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _all_reduce(x, op: str, group):
    funcol = _funcol()
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


def _permute(x, src_dst: list[int], group):
    """``src_dst[m] == n``: rank m's ``x`` goes to rank n (flattened:
    ``permute_tensor`` splits its input's first dim by element counts)."""
    funcol = _funcol()
    out = funcol.permute_tensor(x.contiguous().reshape(-1), src_dst, group)
    return funcol.wait_tensor(out).reshape(x.shape)


def _block(x, dim: int, axis):
    """This rank's block of ``x`` along ``dim``, on a leading dim of 1."""
    return x.unflatten(dim, (axis.size, -1)).movedim(dim, 0)[axis.rank:axis.rank + 1]


def _whole(y, dim: int, axis):
    """Every rank's block of ``y`` (leading dim 1), joined along ``dim``."""
    return _gather(y, axis.group).movedim(0, dim).flatten(dim, dim + 1)


class _Enter(torch.autograd.Function):
    """A rank's block of a global tensor; the backward gathers every
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.dim, ctx.axis), None, None


class _Leave(torch.autograd.Function):
    """The global tensor from every rank's block; the backward keeps this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, y, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _whole(y, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.axis), None, None


class _EnterReplicated(torch.autograd.Function):
    """A replicated tensor on every rank; the backward sums the ranks'
    gradients (the stacked mode's ``expand``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.unsqueeze(0)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.axis.group)[0], None


class _LeaveReplicated(torch.autograd.Function):
    """A replicated output, the same on every rank; the backward takes the
    gradient through rank 0's copy only (the stacked mode's ``y[0]``)."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return y[0]

    @staticmethod
    def backward(ctx, g):
        g = g.unsqueeze(0)
        return (g if ctx.axis.rank == 0 else torch.zeros_like(g)), None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, axis):
        ctx.shift, ctx.axis = shift, axis
        n = axis.size
        return _permute(x, [(j + shift) % n for j in range(n)], axis.group)

    @staticmethod
    def backward(ctx, g):
        n = ctx.axis.size
        return _permute(g, [(j - ctx.shift) % n for j in range(n)], ctx.axis.group), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, "sum", axis.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.axis.group), None


class GroupAxis:
    """The axis handle of :func:`shard_map` on a ``DeviceMesh``: this
    rank's shard (a leading dimension of 1) and functional collectives
    over the axis's process group.  ``permute``'s backward is the inverse
    permute, ``psum``'s a ``psum``; ``pmax`` has no gradient here (only
    the decode, which no backward reaches, takes it)."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.rank = mesh.get_local_rank(axis)
        self.size = mesh_shape(mesh)[axis]

    def enter(self, x, dim):
        if dim is None:
            return _EnterReplicated.apply(x, self)
        return _Enter.apply(x, dim, self)

    def leave(self, y, dim):
        if dim is None:
            return _LeaveReplicated.apply(y, self)
        return _Leave.apply(y, dim, self)

    def permute(self, x, pairs):
        return _Permute.apply(x, _shift(pairs, self.size), self)

    def pmax(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError("pmax over a process group has no gradient")
        return _all_reduce(x, "max", self.group)

    def psum(self, x):
        return _Psum.apply(x, self)


def shard_map(fn, in_specs, out_specs, axis: str):
    """``jax.shard_map`` over the mesh axis ``axis`` of the active mesh.

    ``fn(ax, *blocks)`` gets an axis handle ``ax`` (``ax.size`` shards;
    ``ax.permute(x, pairs)``, ``ax.pmax(x)``, ``ax.psum(x)``) and each
    input's shard with a leading shard dimension: 1 on a ``DeviceMesh``
    rank, ``ax.size`` on a :class:`MeshShape`; it returns one tensor that
    keeps that dimension.  ``in_specs`` (one per input) and ``out_specs``
    are placement tuples: a dimension whose entry names ``axis`` is split
    into ``ax.size`` contiguous blocks, the others stay whole.  The
    returned function takes and returns global tensors; a replicated
    output is shard 0's.  Given DTensors on a ``DeviceMesh``, every entry
    splits (``data`` too) and the result is a DTensor
    (:func:`_shard_map_blocks`)."""
    def run(*args):
        mesh = get_mesh()
        if _is_device_mesh(mesh) and any(map(is_dtensor, args)):
            return _shard_map_blocks(fn, args, in_specs, out_specs, axis, mesh)
        if _is_device_mesh(mesh):
            ax = GroupAxis(mesh, axis)
        else:
            ax = StackedAxis(int(mesh_shape(mesh)[axis]))
        blocks = [ax.enter(x, _axis_dim(spec, axis)) for x, spec in zip(args, in_specs)]
        return ax.leave(fn(ax, *blocks), _axis_dim(out_specs, axis))

    return run


def _shard_map_blocks(fn, args, in_specs, out_specs, axis: str, mesh):
    """:func:`shard_map` on DTensor arguments (plain ones are every rank's
    whole copy): each argument is placed by its spec, entries that do not
    divide their dimension dropped, and ``fn`` gets this rank's block
    (a leading dimension of 1) and the ``axis`` group's handle; its
    result is this rank's block of a DTensor placed by ``out_specs``
    (less the axes an input dropped)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_shape(mesh)
    dropped: set[str] = set()
    blocks = []
    for x, spec in zip(args, in_specs):
        fitted = []
        for dim, entry in zip(x.shape, tuple(spec) + (None,) * (x.dim() - len(spec))):
            n = axis_size(sizes, entry)
            if n > 1 and dim % n:
                dropped.update(axis_names(entry))
            fitted.append(entry if n > 1 and dim % n == 0 else None)
        blocks.append(_as_placed(x, tuple(fitted), mesh).to_local().unsqueeze(0))
    y = fn(GroupAxis(mesh, axis), *blocks)[0].contiguous()
    out = tuple(None if entry is None or axis_size(sizes, entry) == 1
                or dropped & set(axis_names(entry)) else entry for entry in out_specs)
    return DTensor.from_local(y, mesh, dtensor_placements(mesh, out), run_check=False)
