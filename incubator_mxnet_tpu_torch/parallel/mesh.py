"""Process meshes (port of ``incubator_mxnet_tpu/parallel/mesh.py``).

The reference names the axes of a ``jax.sharding.Mesh`` of devices and
lets XLA place the collectives.  Here one process drives one device, so
a mesh names axes over the processes of the ``torch.distributed`` group:
``make_mesh({"dp": 2, "pp": 2})`` in each of 4 processes.  Ranks sit
row-major in axis order, as the reference's
``np.array(devices).reshape(sizes)`` places devices, so rank r has the
mesh coordinates of the reference's device r.  Each axis has one process
group per line of the mesh along it (the ranks that differ only in that
axis's coordinate): ``group(name)`` is this process's line, and
``axis_index(name)`` its position there.

Axis convention (the reference's): ``dp`` data parallel, ``tp`` tensor
parallel (``param_shardings`` of the train step), ``pp`` pipeline
parallel (:mod:`.pipeline`), ``sp`` sequence parallel
(:mod:`.ring_attention`), ``ep`` expert parallel (:mod:`.moe`).
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["Mesh", "P", "make_mesh", "current_devices", "global_devices",
           "spans_processes"]


class P(tuple):
    """A partition spec: one mesh axis name (or None, not sharded) per
    dimension of a tensor, as the reference's ``PartitionSpec``:
    ``P("tp", None)`` shards dim 0 over ``tp``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(e) for e in self)


class Mesh:
    """Named axes over the processes: ``axis_names``, ``shape`` (``{name:
    size}``), the global ``devices`` (one per process, in rank order),
    this process's ``coords`` (``{name: index}``) and a process group per
    axis (``group(name)``: this process's line along the axis; None when
    the line holds this process alone and no group exists)."""

    def __init__(self, axis_names, sizes, devices, groups, coords=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.devices = list(devices)
        self._groups = dict(zip(self.axis_names, groups))
        self.coords = dict(coords) if coords is not None else \
            {a: 0 for a in self.axis_names}

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
        if axis_name not in self.shape:
            raise ValueError("mesh has axes %s, not %r"
                             % (self.axis_names, axis_name))
        return self.coords[axis_name]

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The process at mesh coordinates ``coords`` (missing axes: 0),
        row-major in axis order."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords.get(a, 0))
        return r

    def local_slice(self, x, axis_name="dp", dim=0):
        """This process's contiguous 1/N of ``x`` along ``dim``, N the
        size of ``axis_name`` (the global batch's slice a data-parallel
        step is given); N must divide the dimension."""
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


def _unravel(rank, sizes):
    coords = []
    for s in reversed(sizes):
        coords.append(rank % s)
        rank //= s
    return coords[::-1]


def _axis_groups(sizes, me, world):
    """One process group per axis for process ``me``: its line along the
    axis.  Every process creates every line's group, in the same order
    (``new_group`` is collective over the whole group); a line of one
    process gets none, an axis spanning the world is the world group."""
    import torch.distributed as dist

    from .distributed import DEFAULT_TIMEOUT

    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT)
    groups = []
    for ax, n in enumerate(sizes):
        if n == 1:
            groups.append(None)
            continue
        if n == world:
            groups.append(dist.group.WORLD)
            continue
        mine = None
        lines = {}
        for r in range(world):
            c = _unravel(r, sizes)
            key = tuple(c[:ax] + c[ax + 1:])
            lines.setdefault(key, []).append(r)
        for key in sorted(lines):
            g = dist.new_group(lines[key], timeout=timeout)
            if me in lines[key]:
                mine = g
        groups.append(mine)
    return groups


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the processes, e.g. ``make_mesh({"dp": 2, "tp": 2})``
    in each of 4 processes.

    The axis sizes must multiply to the world size; one axis may be
    ``-1``, inferred from the others.  ``devices`` are the processes'
    devices in rank order (default :func:`global_devices`: each rank's
    card)."""
    from .distributed import is_initialized, process_count, process_index

    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    world = process_count()
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("only one axis may be -1")
    known = 1
    for s in sizes:
        if s != -1:
            known *= s
    if unknown:
        if known < 1 or world % known:
            raise ValueError(
                "mesh axes %s=%s: %d processes do not divide by %d"
                % (names, sizes, world, known))
        sizes[unknown[0]] = world // known
    total = 1
    for s in sizes:
        total *= s
    one = len(names) == 1
    if total != world:
        if one:
            raise ValueError(
                "mesh axis %s=%d needs %d processes (one device each), the "
                "group has %d" % (names[0], total, total, world))
        raise ValueError("mesh axes %s=%s need %d processes (one device "
                         "each), the group has %d"
                         % (names, sizes, total, world))
    devices = [torch.device(d) for d in devices] if devices is not None \
        else global_devices()
    if len(devices) != total:
        if one:
            raise ValueError("mesh axis %s=%d needs %d devices, have %d"
                             % (names[0], total, total, len(devices)))
        raise ValueError("mesh axes %s=%s need %d devices, have %d"
                         % (names, sizes, total, len(devices)))
    me = process_index()
    groups = _axis_groups(sizes, me, world) if is_initialized() \
        else [None] * len(names)
    return Mesh(names, sizes, devices, groups,
                dict(zip(names, _unravel(me, sizes))))
