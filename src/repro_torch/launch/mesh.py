"""Production mesh construction.

The port of ``repro.launch.mesh``, on ``torch.distributed.device_mesh``
with one process a device.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; the `pod` axis
composes with `data` for batch/FSDP sharding (the slowest-linked axis
first).

``make_production_mesh`` is a function (never a module-level constant), so
importing this module touches no process group.  The sharding rules, the
dry run and the tests need the production shapes without 256 or 512
ranks: :class:`ShapeMesh` is a mesh of shapes only, and every function
here and in ``launch.sharding`` takes it as it takes a ``DeviceMesh``.
"""

from __future__ import annotations

import math

from ..models.shard_ctx import axis_names, axis_sizes

PRODUCTION_SHAPES = {
    "single_pod_16x16": {"data": 16, "model": 16},
    "multi_pod_2x16x16": {"pod": 2, "data": 16, "model": 16},
}


class ShapeMesh:
    """A mesh of shapes only: ``.shape`` (axis name → size, in mesh order)
    and ``.axis_names`` — what a jax mesh offers the sharding rules."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def production_mesh_shape(*, multi_pod: bool = False) -> ShapeMesh:
    """The production mesh's shape, no process group needed."""
    return ShapeMesh(PRODUCTION_SHAPES["multi_pod_2x16x16" if multi_pod
                                       else "single_pod_16x16"])


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production ``DeviceMesh`` (256 or 512 ranks, under a process
    group of that size)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_mesh_shape(multi_pod=multi_pod).shape
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_host_mesh(data: int = 1, model: int = 1, device_type=None):
    """A (data, model) ``DeviceMesh`` over the process group that is up
    (``torchrun``'s, or one the caller made); ``device_type`` ``cuda`` by
    default (each rank on ``cuda:<local rank>``) or ``cpu`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh):
    """The device this rank's tensors on ``mesh`` live on: the CPU, or
    the rank's card (``cuda:<local rank>``, which ``init_device_mesh``
    makes the current one)."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch (and FSDP): ('pod','data') when the
    pod axis exists, else ('data',)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


__all__ = ["ShapeMesh", "PRODUCTION_SHAPES", "production_mesh_shape",
           "make_production_mesh", "make_host_mesh", "mesh_device", "batch_axes",
           "axis_size"]
