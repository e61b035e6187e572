"""The reference's device meshes as plain axis -> size mappings.

One card has no device mesh, so the port builds no process group here.
These shapes give :mod:`.sharding` its divisibility rules without any
device, so that the dry-run can record how the reference's meshes would
shard each parameter and input:

Single pod: 16x16 = 256 chips -> ("data", "model")
Multi-pod:  2x16x16 = 512 chips -> ("pod", "data", "model")

The reference's ``mesh_context`` (a shim over jax versions' ambient-mesh
call) has no counterpart.
"""
from __future__ import annotations

MeshShape = dict[str, int]  # axis name -> size, in the mesh's axis order


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_smoke_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The tiny mesh of the reference's CI-scale dry-run (8 host devices)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))
