"""Production mesh construction (port of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 GPUs (data x model).
Multi-pod:  2 x 16 x 16 = 512 GPUs (pod x data x model) — the 'pod'
axis carries the paper's replica semantics (each pod = one parameter
replica / one "datacenter" for the cost model).

The meshes are ``torch.distributed`` ``DeviceMesh``es over the processes
of an initialized process group, one GPU per process.  The caller starts
the group (``torch.distributed.init_process_group`` with its address,
world size and rank); a group whose world size is not the mesh's size is
refused, never shrunk into a smaller mesh.  Functions, not module-level
constants: importing this module touches no device and no process group.
"""

from __future__ import annotations

import math

from repro_torch.models.sharding import MeshShape, mesh_shape

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over every
    process of the initialized process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call "
                           "torch.distributed.init_process_group first")
    need, world = math.prod(shape), dist.get_world_size()
    if world != need:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} processes; the process "
                         f"group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's axis sizes, with no devices (the dry run's
    stand-in for the reference's mesh of fake CPU devices)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return MeshShape(dict(zip(axes, shape)))


def n_pods(mesh) -> int:
    return int(mesh_shape(mesh).get("pod", 1))


def devices_required(*, multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
