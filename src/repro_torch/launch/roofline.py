"""Roofline of one step on a mesh of H100s (port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs per device       / PEAK_FLOPS
  memory     = bytes per device       / HBM_BW
  collective = collective wire bytes  / (chips x LINK_BW)

The reference reads the first two from XLA's ``cost_analysis()`` of the
compiled program and parses the collectives out of its optimized HLO
text (``parse_collectives``).  The port compiles nothing: the dry run
counts FLOPs and bytes on the meta device (``repro_torch.launch.dryrun``),
and :func:`collectives_for` derives the collectives of one step from the
parameter placements instead of parsing HLO — the FSDP all-gathers and
gradient reduce-scatters over 'data', the tensor-parallel all-reduces
over 'model', and the pods' merge over 'pod' — each priced with the
reference's ring model (:func:`_ring_wire_bytes`) and classified
intra-pod or inter-pod from its device groups, as the reference's
``_parse_groups`` does.  The split is the paper's intra-DC / inter-DC.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.models import sharding
from repro_torch.tree import items

# One NVIDIA H100 (nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W"), the
# data sheet's dense rates at the full 700 W power limit:
PEAK_FLOPS = 989e12        # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12           # bytes/s, HBM3
# Per-GPU link rate for collectives that leave an 8-GPU node: one 400 Gb/s
# NDR port per GPU.  Every 16-wide axis of the production meshes spans two
# nodes, so the ring runs at the inter-node rate, not NVLink's.
LINK_BW = 50e9             # bytes/s per GPU


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int      # per-device result size
    group_size: int
    n_groups: int
    spans_pods: bool
    wire_bytes: float      # total traffic across the whole system


def _ring_wire_bytes(kind: str, result_bytes: int, gs: int, ng: int) -> float:
    """Total bytes on the wire (sum over devices of bytes sent), ring
    algorithms; `result_bytes` is the per-device result size."""
    if gs <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (gs - 1) * result_bytes * ng
    if kind == "all-gather":
        return (gs - 1) * result_bytes * ng
    if kind == "reduce-scatter":
        return gs * (gs - 1) * result_bytes * ng
    if kind == "all-to-all":
        return (gs - 1) * result_bytes * ng
    if kind == "collective-permute":
        return result_bytes * gs * ng
    return 0.0


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_total: float
    inter_pod_bytes: float
    intra_pod_bytes: float
    n_chips: int
    model_flops: float = 0.0      # 6·N·D (or 6·N_active·D) for the shape
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_total / (self.n_chips * self.link_bw)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate: max of the three terms (perfect
        overlap assumption — the optimistic bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — remat/redundancy waste probe."""
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x step_time) — roofline fraction."""
        denom = self.n_chips * self.peak_flops * self.step_time_s
        return self.model_flops / denom if denom > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_total": self.collective_bytes_total,
            "inter_pod_bytes": self.inter_pod_bytes,
            "intra_pod_bytes": self.intra_pod_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N·D for train (fwd+bwd), 2·N·D for inference; N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---- collectives from placements --------------------------------------------


def device_groups(axes: dict[str, int], group_axes: tuple[str, ...]):
    """``(group_size, n_groups, spans_pods)`` of a collective over
    ``group_axes`` of a mesh with axis sizes ``axes`` (devices numbered
    row-major in the mesh's axis order, pods the leading axis, as XLA
    numbers them).  Axes the mesh lacks are left out."""
    names = list(axes)
    sizes = [int(axes[a]) for a in names]
    n = int(np.prod(sizes)) if sizes else 1
    ids = np.arange(n).reshape(sizes or [1])
    inner = [names.index(a) for a in group_axes if a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    gs = int(np.prod([sizes[i] for i in inner])) if inner else 1
    groups = np.transpose(ids, outer + inner).reshape(-1, gs) if names else ids.reshape(1, 1)
    pods = int(axes.get("pod", 1))
    spans = False
    if pods > 1:
        pod_of = groups // (n // pods)
        spans = bool(np.any(pod_of != pod_of[:, :1]))
    return gs, int(groups.shape[0]), spans


def _op(kind: str, result_bytes: int, axes: dict[str, int],
        group_axes: tuple[str, ...]) -> CollectiveOp:
    gs, ng, spans = device_groups(axes, group_axes)
    return CollectiveOp(kind=kind, result_bytes=int(result_bytes), group_size=gs,
                        n_groups=ng, spans_pods=spans,
                        wire_bytes=_ring_wire_bytes(kind, int(result_bytes), gs, ng))


# Out-projections: their input dim is the one sharded over 'model' (the
# reference's ``pspec_for_param`` transposes them), so each application
# ends in an all-reduce of its output over 'model'.
_ROW_PARALLEL = ("wo", "out_proj", "w2", "down", "w_o", "cm_v")


def collectives_for(params, cfg, mesh, *, kind: str, rows: int, enc_rows: int = 0,
                    act_bytes: int = 2, remat: str = "none", attn_mode: str = "tp",
                    merge: tuple[str, float, float] | None = None) -> list[CollectiveOp]:
    """The collectives of one step of ``cfg`` on ``mesh``, derived from the
    placements of ``params`` (one pod's tree; meta tensors will do).

    * FSDP: every leaf sharded over 'data' is all-gathered over 'data'
      before use, once per layer slice (forward; a train step gathers
      again for the backward), and in a train step its gradient is
      reduce-scattered over 'data'; a train step all-reduces the gradient
      of every other leaf over 'data'.
    * Tensor parallelism: every application of an out-projection sharded
      over 'model' on its input dim, and of an expert-parallel
      ``expert_down``, all-reduces its output activations — ``rows``
      tokens per device (``enc_rows`` in the audio encoder) x d_out — over
      'model': once in a forward, twice in a train step (the backward's
      input gradient), three times under remat (the recomputed forward).
      Attention in ``attn_mode`` "dp" is not split over 'model' and has
      none.
    * Pods: ``merge = (kind, per-device result bytes, wire bytes)`` adds
      the pods' merge over 'pod', its wire bytes those of
      ``SyncEngine.merge_wire_bytes``.
    """
    axes = sharding.mesh_shape(mesh)
    train = kind == "train"
    tp_uses = (3 if remat != "none" else 2) if train else 1
    gathers = 2 if train else 1
    sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else 1
    out: list[CollectiveOp] = []
    with sharding.use_mesh(mesh):
        for name, leaf in items(params):
            path = tuple(name.split("/"))
            shape = tuple(leaf.shape)
            spec = sharding.pspec_for_param(path, shape, cfg) or (None,) * len(shape)
            itemsize = leaf.dtype.itemsize
            expert = "expert" in name and len(shape) >= 3
            lead = len(shape) - (3 if expert else 2) if len(shape) >= 2 else 0
            layers = math.prod(shape[:lead]) if lead > 0 else (
                sites if name.startswith("shared_attn") else 1)
            inner, inner_spec = shape[lead:], spec[lead:]
            shard = sharding.shard_shape(inner, inner_spec)
            shard_bytes = math.prod(shard) * itemsize
            data_sharded = any("data" in sharding.axis_names(e) for e in inner_spec)
            if data_sharded:
                no_data = tuple(None if "data" in sharding.axis_names(e) else e
                                for e in inner_spec)
                gathered = math.prod(sharding.shard_shape(inner, no_data)) * itemsize
                for _ in range(layers * gathers):
                    out.append(_op("all-gather", gathered, axes, ("data",)))
                if train:
                    for _ in range(layers):
                        out.append(_op("reduce-scatter", shard_bytes, axes, ("data",)))
            elif train:
                for _ in range(layers):
                    out.append(_op("all-reduce", shard_bytes, axes, ("data",)))
            # Tensor parallelism: the partial sums of a row-parallel product.
            contracted = inner_spec[0] if expert else (
                inner_spec[-2] if len(inner_spec) >= 2 else None)
            if expert:
                row_parallel = path[-1] == "expert_down"
            else:
                row_parallel = any(k in path[-1] for k in _ROW_PARALLEL)
            if row_parallel and "model" in sharding.axis_names(contracted):
                if "attn" in name and attn_mode == "dp":
                    continue
                n_rows = enc_rows if name.startswith("enc_") else rows
                act = n_rows * int(inner[-1]) * act_bytes
                for _ in range(layers * tp_uses):
                    out.append(_op("all-reduce", act, axes, ("model",)))
    if merge is not None:
        merge_kind, result, wire = merge
        gs, ng, spans = device_groups(axes, ("pod",))
        out.append(CollectiveOp(kind=merge_kind, result_bytes=int(result), group_size=gs,
                                n_groups=ng, spans_pods=spans,
                                wire_bytes=float(wire) if gs > 1 else 0.0))
    return out
