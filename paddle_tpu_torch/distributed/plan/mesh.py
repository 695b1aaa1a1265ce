"""Mesh declaration for sharding plans (counterpart of
``paddle_tpu/distributed/plan/mesh.py``).

One place that turns ``{"dp": 2, "tp": 2}`` into a mesh over the ranks of
the default ``torch.distributed`` process group, with the reference's
canonical axis vocabulary. Every rank of the port is a process, so the
mesh is over ranks, not devices: a :class:`RankMesh` (a plain record of
axis names, degrees and the ranks laid out row-major over them), or a
``torch.distributed.device_mesh.DeviceMesh`` that the caller initialised
and hands to ``Plan.build`` in place of the axes. Without an initialised
process group the world is one rank; a mesh over ranks that do not exist
here (``devices=range(8)``) is still a valid record for describing and
fingerprinting a plan.
"""

from __future__ import annotations

__all__ = ["AXES", "RankMesh", "make_mesh", "mesh_axes", "mesh_ranks"]

# canonical axis order: pipeline outermost, then the batch-ish axes, then
# the within-layer axes. A plan mesh uses a subset, in this order, so two
# plans over the same degrees fingerprint identically.
AXES = ("pp", "dp", "fsdp", "tp", "sep", "ep")


class RankMesh:
    """Axis names and degrees over ``ranks`` (row-major: the last axis
    varies fastest)."""

    def __init__(self, axis_names, shape, ranks):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.ranks = tuple(int(r) for r in ranks)

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in
                         zip(self.axis_names, self.shape))
        return f"RankMesh({axes}; ranks {list(self.ranks)})"


def _world_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(axes, devices=None):
    """Build a named rank mesh from ``{"axis": degree}``.

    ``axes`` may be a dict or a sequence of ``(name, degree)`` pairs. Axis
    names outside :data:`AXES` are allowed (custom meshes) but dict inputs
    are reordered to the canonical order; pair-sequences keep caller order.
    Degree-1 axes are kept. ``devices`` are the ranks to lay the mesh over
    (default: every rank of the default process group)."""
    if isinstance(axes, dict):
        known = [a for a in AXES if a in axes]
        extra = [a for a in axes if a not in AXES]
        names = tuple(known + extra)
        sizes = tuple(int(axes[a]) for a in names)
    else:
        pairs = list(axes)
        names = tuple(str(n) for n, _ in pairs)
        sizes = tuple(int(s) for _, s in pairs)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate mesh axis names: {names}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axis degrees must be >= 1: "
                         f"{dict(zip(names, sizes))}")
    need = 1
    for s in sizes:
        need *= s
    if devices is None:
        devices = range(_world_size())
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {need} ranks, have "
            f"{len(devices)}; start {need} processes and join them with "
            f"torch.distributed.init_process_group(world_size={need}) "
            "(distributed.init_parallel_env) to get them")
    return RankMesh(names, sizes, devices[:need])


def _is_device_mesh(mesh):
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "mesh")


def mesh_axes(mesh):
    """``{axis: degree}`` of a mesh, in mesh order."""
    if _is_device_mesh(mesh):
        return {str(name): int(size) for name, size in
                zip(mesh.mesh_dim_names, mesh.mesh.shape)}
    return dict(zip(mesh.axis_names, mesh.shape))


def mesh_ranks(mesh):
    """The mesh's ranks, row-major."""
    if _is_device_mesh(mesh):
        return tuple(int(r) for r in mesh.mesh.flatten().tolist())
    return mesh.ranks
