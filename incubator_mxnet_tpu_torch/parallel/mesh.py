"""Process meshes (port of ``incubator_mxnet_tpu/parallel/mesh.py``).

The reference names the axes of a ``jax.sharding.Mesh`` of devices and
lets XLA place the collectives.  Here one process drives one device, so
a mesh is an axis over the processes of the ``torch.distributed`` group
with a process group per axis: ``make_mesh({"dp": N})`` is data
parallelism over N processes, one device each (``N`` the world size, or
``-1`` for it).  Model-parallel axes (``tp``, ``sp``, ``pp``, ``ep``)
are ROADMAP A8 items c and d and raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "current_devices", "global_devices",
           "spans_processes"]

_MODEL_AXES = ("tp", "sp", "pp", "ep")


class Mesh:
    """Named axes over the processes: ``axis_names``, ``shape`` (``{name:
    size}``), the global ``devices`` (one per process, in rank order) and
    a process group per axis (``group(name)``; None when the axis holds
    this process alone and no group exists)."""

    def __init__(self, axis_names, sizes, devices, groups):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.devices = list(devices)
        self._groups = dict(zip(self.axis_names, groups))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def group(self, axis_name):
        if axis_name not in self.shape:
            raise ValueError("mesh has axes %s, not %r"
                             % (self.axis_names, axis_name))
        return self._groups[axis_name]

    def axis_index(self, axis_name) -> int:
        """This process's position on ``axis_name``."""
        import torch.distributed as dist

        g = self.group(axis_name)
        return 0 if g is None else dist.get_rank(g)

    def local_slice(self, x, axis_name="dp", dim=0):
        """This process's contiguous 1/N of ``x`` along ``dim`` (the
        global batch's slice a data-parallel step is given); N must
        divide the dimension."""
        n = self.shape[axis_name]
        size = x.shape[dim]
        if size % n:
            raise ValueError(
                "a global batch of %d does not split evenly over %s=%d: "
                "make it a multiple of %d" % (size, axis_name, n, n))
        per = size // n
        r = self.axis_index(axis_name)
        return x.narrow(dim, r * per, per)

    @property
    def local_device(self) -> torch.device:
        from .distributed import process_index

        return self.devices[process_index()]

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv for kv in self.shape.items())


def current_devices(platform=None) -> List[torch.device]:
    """This process's device: ``cuda:(rank % device_count)``, or the CPU
    for ``platform="cpu"``."""
    from .distributed import local_device

    return [local_device(platform)]


def global_devices(platform=None) -> List[torch.device]:
    """Every process's device in rank order, by the rule of
    :func:`current_devices` applied to each rank."""
    from .distributed import local_device, process_count

    return [local_device(platform, r) for r in range(process_count())]


def spans_processes(mesh: Mesh) -> bool:
    """True when the mesh holds more than this process: state is then
    replicated or sharded across processes, and a checkpoint needs the
    multi-process commit."""
    return mesh is not None and mesh.size > 1


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """A data-parallel mesh over the processes, e.g. ``make_mesh({"dp":
    4})`` in each of 4 processes.

    One axis, whose size must be the world size (``-1`` infers it).
    ``devices`` are the processes' devices in rank order (default
    :func:`global_devices`: each rank's card)."""
    from .distributed import is_initialized, process_count

    names = list(axes.keys())
    model = [a for a in names if a in _MODEL_AXES]
    if model or len(names) != 1:
        raise NotImplementedError(
            "mesh axes %s: the port's meshes are one data-parallel axis "
            "over the processes; tensor, sequence, pipeline and expert "
            "parallelism are ROADMAP A8 items c and d" % (names,))
    world = process_count()
    size = int(axes[names[0]])
    if size == -1:
        size = world
    if size != world:
        raise ValueError(
            "mesh axis %s=%d needs %d processes (one device each), the "
            "group has %d" % (names[0], size, size, world))
    devices = [torch.device(d) for d in devices] if devices is not None \
        else global_devices()
    if len(devices) != size:
        raise ValueError("mesh axis %s=%d needs %d devices, have %d"
                         % (names[0], size, size, len(devices)))
    group = None
    if is_initialized():
        import torch.distributed as dist

        group = dist.group.WORLD
    return Mesh(names, [size], devices, [group])
