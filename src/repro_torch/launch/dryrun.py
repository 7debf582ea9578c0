"""Multi-pod dry run: count every (arch x shape x mesh) cell on the meta
device (port of ``repro.launch.dryrun``).

For each cell the dry run:
  1. takes the production mesh's axis sizes (16 x 16 single-pod, 2 x 16 x
     16 multi-pod) as a device-free stand-in: no process group, no
     devices, every cell in this process;
  2. resolves the parameter, batch and cache placements
     (``repro_torch.models.sharding``, ``configs.input_specs`` /
     ``cache_specs`` with ``mesh=``);
  3. runs the real step on the meta device at the global shapes and full
     depth — the train local step (``make_train_fns``) for train shapes,
     ``prefill`` or ``decode_step`` for serving — under
     ``torch.utils.flop_counter.FlopCounterMode``, so every layer is
     counted and nothing is allocated (the reference compiles depth-1 and
     depth-2 probes and extrapolates, because XLA counts a scan body
     once).  The step runs under the mesh's ``MeshShape``, so the mesh's
     regions run as on a mesh, their shards stacked in this process:
     "dp" cells take the ring attention over ``kv_seq`` (its einsums
     count the plain attention's S² FLOPs), and MoE cells with more than
     2048 tokens per pod route each data shard on its own;
  4. derives the roofline (``launch.roofline``, H100 rates) and the
     per-device state, which must fit the card's 80 GB;
  5. prices 1000 steps with the paper's monetary cost model, splitting
     collective traffic intra-pod (intra-DC, free) vs inter-pod
     (inter-DC, billed).

Per-device FLOPs are each op's FLOPs divided by the devices that split
it: the batch's (pod x data for training), times 'model' where the
placements shard the op — a product with a parameter sharded over
'model', that parameter's gradient, and the per-head work (attention,
the SSM and WKV scans) when ``attn_parallel_mode`` is "tp" (a decode
step: when the cache's sequence is sharded over 'model'; the ring's
stacked shards are counted whole, as the "dp" attention was before the
ring, an upper bound P times its per-device work).  Bytes are the
input and output bytes of every aten op that is not a view, divided the
same way: an upper bound, since nothing is fused.  For ``--program sync``
the pods' merge is not run: it is priced from the placements
(``roofline.collectives_for``) with ``SyncEngine.merge_wire_bytes``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from repro_torch.models.sharding import axis_names

# The card's memory: an H100 80GB HBM3.
HBM_PER_CHIP = 80e9


def depth_info(cfg):
    """(full_groups, cfg_at_depth(g)) — the homogeneous-stack knob."""
    if cfg.family in ("dense", "moe", "vlm"):
        per = cfg.moe_interleave if cfg.n_experts else 1
        full = cfg.n_layers // per
        mk = lambda g: dataclasses.replace(cfg, n_layers=g * per)
    elif cfg.family == "hybrid":
        per = cfg.attn_every if cfg.attn_every else cfg.n_layers
        full = cfg.n_layers // per
        rem = cfg.n_layers % per
        mk = lambda g: dataclasses.replace(cfg, n_layers=g * per + rem)
    elif cfg.family == "ssm":
        full = cfg.n_layers
        mk = lambda g: dataclasses.replace(cfg, n_layers=g)
    else:  # audio: encoder and decoder stacks vary together
        full = cfg.n_layers
        mk = lambda g: dataclasses.replace(
            cfg, n_layers=g, n_encoder_layers=g)
    return full, mk


def _storage(t) -> int:
    return t.untyped_storage()._cdata


class _Split:
    """Which ops the 'model' axis splits: the storages of the parameters
    (stacked leaves; their per-layer views share the storage), the ones
    sharded over 'model', the shapes of those leaves' per-layer slices
    (a gradient product has one), and the per-head rule."""

    def __init__(self, leaves_specs, per_head: bool, attn_mode: str):
        self.params, self.split, self.shapes = set(), set(), set()
        self.per_head = per_head
        for path, leaf, inner, spec in leaves_specs:
            self.params.add(_storage(leaf))
            if not any("model" in axis_names(e) for e in spec):
                continue
            if "attn" in "/".join(path) and attn_mode == "dp":
                continue            # gathered over 'model' and run whole
            self.split.add(_storage(leaf))
            if len(inner) >= 2:
                k = 3 if "expert" in path[-1] and len(inner) >= 3 else 2
                one = tuple(inner[-k:])
                self.shapes.update({one, one[:-2] + one[-2:][::-1]})

    def __call__(self, tensors, outs) -> bool:
        ids = {_storage(t) for t in tensors}
        if ids & self.split:
            return True
        if ids & self.params:
            return False
        if any(tuple(o.shape) in self.shapes for o in outs):
            return True
        return self.per_head


def _counter(split: _Split, batch_split: int, model: int):
    """A dispatch mode that sums each aten op's FLOPs (the formulas of
    ``torch.utils.flop_counter``) and bytes, total and per device."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class StepCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = self.bytes = 0          # exact totals (ints)
            self.flops_per_device = self.bytes_per_device = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            div = batch_split * (model if split(ins, outs) else 1)
            packet = func._overloadpacket
            if packet in flop_registry:
                f = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += f
                self.flops_per_device += f / div
            if not func.is_view:
                b = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
                self.bytes += b
                self.bytes_per_device += b / div
            return out

    return StepCounter()


def _meta(specs: dict) -> dict:
    import torch

    return {k: torch.zeros(v.shape, dtype=v.dtype, device="meta") for k, v in specs.items()}


def _spec_bytes(specs: dict, mesh) -> int:
    from repro_torch.models.sharding import shard_shape

    return sum(math.prod(shard_shape(v.shape, v.placement, mesh)) * v.dtype.itemsize
               for v in specs.values())


def _leaf_specs(params, cfg, mesh, pod_dim: bool = False):
    """``(path, leaf, per-pod shape, placement of that shape)`` for every
    leaf; ``pod_dim``: the leaves carry the pods' leading dim."""
    from repro_torch.models import sharding
    from repro_torch.tree import items

    out = []
    with sharding.use_mesh(mesh):
        for key, leaf in items(params):
            path = tuple(key.split("/"))
            inner = tuple(leaf.shape[1:] if pod_dim else leaf.shape)
            spec = sharding.pspec_for_param(path, inner, cfg) or (None,) * len(inner)
            out.append((path, leaf, inner, spec))
    return out


def _state_bytes(specs, mesh, itemsize: int | None = None, pods: int = 0) -> int:
    """Per-device bytes of a tree placed as ``specs``, each element of
    ``itemsize`` bytes (default: the leaf's dtype); ``pods`` > 0 adds the
    ``(P, ...)`` pod dim, sharded over 'pod' where the mesh has it (the
    reference's ``P("pod", *spec)``)."""
    from repro_torch.models.sharding import mesh_shape, shard_shape

    pod = ("pod" if "pod" in mesh_shape(mesh) else None,)
    total = 0
    for _, leaf, inner, spec in specs:
        if pods:
            shape = shard_shape((pods,) + inner, pod + tuple(spec), mesh)
        else:
            shape = shard_shape(inner, spec, mesh)
        total += math.prod(shape) * (leaf.dtype.itemsize if itemsize is None else itemsize)
    return total


def _sync_bytes(sync, specs, mesh, pods: int) -> int:
    """Per-device bytes of the sync state's compression tensors, placed as
    ``train_step.distribute_state`` places them: the anchor as one pod's
    parameters, the top-k residual as the pod-stacked parameters (the
    store's clocks and DUOT, a few KiB, are not counted)."""
    return ((sync.anchor is not None) * _state_bytes(specs, mesh)
            + (sync.residual is not None) * _state_bytes(specs, mesh, pods=pods))


def _batch_devices(axes: dict, b: int, pods: int) -> int:
    """The devices a batch of ``b`` is split over: (pod, data), else data
    alone, else none (the reference's decode ``tok_spec`` rule)."""
    for names in ((("pod", "data") if pods > 1 and "pod" in axes else ("data",)), ("data",)):
        n = math.prod(axes.get(a, 1) for a in names)
        if b % n == 0:
            return n
    return 1


def dry_run(cfg, shape, mesh, *, pricing, program: str = "sync", policy: str = "X_STCC",
            delta: int = 8, compress: str = "none", pods: int | None = None) -> dict:
    """One cell: ``cfg`` at ``shape`` on ``mesh`` (anything
    ``sharding.mesh_shape`` reads; only its axis sizes are used).
    ``pods`` defaults to the mesh's 'pod' axis; more pods than that run
    one after another on each device, as the trainer runs them.  Returns
    the cell's dict (the reference's keys where they carry over)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import cache_specs, input_specs
    from repro_torch.core.cost_model import training_run_cost
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import n_pods
    from repro_torch.models import abstract_params, build_model, sharding
    from repro_torch.models.attention import attn_parallel_mode

    t0 = time.perf_counter()
    axes = sharding.mesh_shape(mesh)
    mesh = sharding.MeshShape(axes)
    n_chips = mesh.size
    pods = n_pods(mesh) if pods is None else pods
    model_axis = int(axes.get("model", 1))
    with sharding.use_mesh(mesh):
        attn_mode = attn_parallel_mode(cfg)
    model = build_model(cfg)
    act_bytes = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    if shape.kind == "train":
        from repro_torch.core import policy_for
        from repro_torch.optim import AdamWConfig
        from repro_torch.train.train_step import make_train_fns, split_batch_for_pods

        pol = policy_for(policy, delta_steps=delta, compress_inter_pod=compress)
        opt_cfg = AdamWConfig(state_dtype=cfg.optimizer_state_dtype)
        fns = make_train_fns(model, opt_cfg, pol, pods, device="meta")
        state = fns.init(params=abstract_params(model))
        if shape.global_batch % max(pods, 1):
            raise ValueError(f"a batch of {shape.global_batch} does not split over {pods} pods")
        specs = input_specs(cfg, shape, mesh=mesh)
        batch = split_batch_for_pods(_meta(specs), pods)
        leaf_specs = _leaf_specs(state.params, cfg, mesh, pod_dim=True)
        batch_n = _batch_devices(axes, shape.global_batch, pods)
        split = _Split(leaf_specs, attn_mode == "tp", attn_mode)
        run = lambda: fns.local_step(state, batch)
        moment = torch.empty((), dtype=getattr(torch, opt_cfg.state_dtype)).element_size()
        memory = {
            "params_bytes": _state_bytes(leaf_specs, mesh, pods=pods),
            "grads_bytes": _state_bytes(leaf_specs, mesh),
            "opt_bytes": 2 * _state_bytes(leaf_specs, mesh, moment, pods),
            "sync_bytes": _sync_bytes(state.sync, leaf_specs, mesh, pods),
            "batch_bytes": _spec_bytes(specs, mesh),
        }
        rows = shape.global_batch // batch_n * shape.seq_len
        merge = None
        if program == "sync":
            payload = fns.engine.payload_bytes(state.params)
            kind = "collective-permute" if pol.level.name == "ONE" else "all-reduce"
            per_device = payload / max(n_chips // int(axes.get("pod", 1)), 1)
            merge = (kind, per_device, fns.engine.merge_wire_bytes(payload))
        coll_params, coll_cfg, coll_kind = abstract_params(model), cfg, "train"
    else:
        # Serving layout: weights replicated over 'data' (TP-only) when
        # the per-device model shard fits comfortably; very large models
        # keep FSDP, the gather being the price of fitting at all.
        per_dev_gb = 2.0 * cfg.param_count() / max(model_axis, 1) / 1e9
        serve_cfg = cfg if per_dev_gb > 4.0 else dataclasses.replace(cfg, fsdp_params=False)
        params = abstract_params(model)
        leaf_specs = _leaf_specs(params, serve_cfg, mesh)
        memory = {"params_bytes": _state_bytes(leaf_specs, mesh)}
        if shape.kind == "prefill":
            specs = input_specs(cfg, shape, mesh=mesh)
            inputs = _meta(specs)
            memory["batch_bytes"] = _spec_bytes(specs, mesh)
            batch_n = _batch_devices(axes, shape.global_batch, pods)
            per_head = attn_mode == "tp"
            run = lambda: model.prefill(params, inputs)
            rows = shape.global_batch // batch_n * shape.seq_len
        else:
            cspecs = cache_specs(cfg, shape, mesh=mesh)
            cache = _meta(cspecs)
            batch_n = _batch_devices(axes, shape.global_batch, pods)
            tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device="meta")
            memory["cache_bytes"] = _spec_bytes(cspecs, mesh)
            memory["batch_bytes"] = shape.global_batch // batch_n * 4
            per_head = any(v.placement and len(v.placement) == 5 and "model" in axis_names(
                v.placement[2]) for v in cspecs.values())
            run = lambda: model.decode_step(params, cache, tokens)
            rows = shape.global_batch // batch_n
        split = _Split(leaf_specs, per_head, attn_mode)
        merge = None
        coll_params, coll_cfg, coll_kind = params, serve_cfg, shape.kind

    counter = _counter(split, batch_n, model_axis)
    with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        with sharding.use_mesh(mesh), FlopCounterMode(display=False) as fc, counter:
            run()
    t_count = time.perf_counter()
    if counter.flops != fc.get_total_flops():
        raise RuntimeError(f"per-op FLOPs {counter.flops} != FlopCounterMode's "
                           f"{fc.get_total_flops()}")
    colls = rl.collectives_for(
        coll_params, coll_cfg, mesh, kind=coll_kind, rows=rows,
        enc_rows=rows // max(shape.seq_len, 1) * cfg.n_frames if cfg.is_encdec else 0,
        act_bytes=act_bytes, remat=cfg.remat, attn_mode=attn_mode, merge=merge)
    total = sum(c.wire_bytes for c in colls)
    inter = sum(c.wire_bytes for c in colls if c.spans_pods)
    roof = rl.Roofline(
        flops_per_device=counter.flops_per_device,
        bytes_per_device=counter.bytes_per_device,
        collective_bytes_total=total,
        inter_pod_bytes=inter,
        intra_pod_bytes=total - inter,
        n_chips=n_chips,
        model_flops=rl.model_flops_for(cfg, shape),
    )
    cost = training_run_cost(
        n_chips=n_chips,
        step_time_s=roof.step_time_s,
        n_steps=1000,
        inter_pod_bytes_per_step=roof.inter_pod_bytes,
        intra_pod_bytes_per_step=roof.intra_pod_bytes,
        ckpt_bytes=2.0 * cfg.param_count(),
        ckpt_every=100,
        pricing=pricing,
    )
    used = sum(memory.values())
    full_groups, _ = depth_info(cfg)
    by_kind: dict = {}
    for c in colls:
        k = by_kind.setdefault(c.kind, {"n": 0, "wire_bytes": 0.0})
        k["n"] += 1
        k["wire_bytes"] += c.wire_bytes
    return {
        "shape": shape.name,
        "status": "ok",
        "program": program if shape.kind == "train" else shape.kind,
        "policy": policy if shape.kind == "train" else None,
        "n_chips": n_chips,
        "n_pods": pods,
        "mesh_axes": axes,
        "attn_parallel_mode": attn_mode,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "flops": counter.flops,
        "bytes": counter.bytes,
        "memory": dict(memory, used_bytes_per_device=used, hbm_per_chip=HBM_PER_CHIP,
                       fits=bool(used <= HBM_PER_CHIP)),
        "roofline": roof.as_dict(),
        "rates": {"peak_flops": roof.peak_flops, "hbm_bw": roof.hbm_bw,
                  "link_bw": roof.link_bw},
        "collectives": {"n": len(colls), "by_kind": by_kind},
        "depth": {"full_groups": full_groups,
                  "counted": "every layer, on the meta device (no depth probes)"},
        "monetary_cost_1000_steps": cost.as_dict(),
        "timing": {"count_s": t_count - t0},
    }


def _cell(arch: str, shape_name: str, mesh_kind: str, args) -> dict:
    from repro_torch.configs import SHAPES_BY_NAME, adjust_config, get_config, shapes_for
    from repro_torch.core.cost_model import PAPER_PRICING
    from repro_torch.launch.mesh import production_mesh_shape

    head = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    shape = SHAPES_BY_NAME[shape_name]
    cfg0 = get_config(arch)
    if shape_name not in [s.name for s in shapes_for(cfg0)]:
        return dict(head, status="skipped",
                    reason="long_500k requires a sub-quadratic path "
                           "(DESIGN.md §6); full-attention arch")
    cfg = adjust_config(cfg0, shape)
    cfg = dataclasses.replace(cfg, dtype="bfloat16", remat=args.remat)
    mesh = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    res = dry_run(cfg, shape, mesh, pricing=PAPER_PRICING, program=args.program,
                  policy=args.policy, delta=args.delta, compress=args.compress)
    return dict(head, **res)


def run_cell(arch, shape_name, mesh_kind, args) -> dict:
    try:
        return _cell(arch, shape_name, mesh_kind, args)
    except Exception as e:  # noqa: BLE001 — a dry-run failure IS the signal
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc(limit=20),
        }


def all_cells(mesh_kinds):
    from repro_torch.configs import get_config, list_archs, shapes_for

    for arch in list_archs():
        for shape in shapes_for(get_config(arch)):
            for mk in mesh_kinds:
                yield arch, shape.name, mk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default="X_STCC")
    ap.add_argument("--delta", type=int, default=8)
    ap.add_argument("--compress", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--program", default="sync", choices=("sync", "local"))
    ap.add_argument("--remat", default="full",
                    choices=("none", "full", "selective"))
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    mesh_kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = list(all_cells(mesh_kinds))
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, mk) for mk in mesh_kinds]
    else:
        ap.error("--arch and --shape (or --all)")
    os.makedirs(args.out_dir, exist_ok=True)
    tag = f"__{args.tag}" if args.tag else ""
    rc = 0
    for arch, shape_name, mk in cells:
        out = os.path.join(args.out_dir, f"{mk}__{arch}__{shape_name}{tag}.json")
        if args.skip_existing and os.path.exists(out):
            try:
                with open(out) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            except (OSError, ValueError):
                pass
        res = run_cell(arch, shape_name, mk, args)
        with open(out, "w") as f:
            json.dump(res, f, indent=2)
        status = res["status"]
        extra = ""
        if status == "ok":
            r = res["roofline"]
            extra = (f" dom={r['dominant']} step={r['step_time_s']:.4f}s "
                     f"mfu={r['mfu']:.3f} fits={res['memory']['fits']}")
        elif status == "error":
            extra = " " + res["error"][:200]
            rc = 1
        print(f"[{status}] {mk} {arch} {shape_name}{extra}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
