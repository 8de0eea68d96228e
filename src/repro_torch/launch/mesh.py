"""Device meshes of the port (reference: ``repro/launch/mesh.py:39-60``).

A :class:`Mesh` names its axes, gives each a size and holds a grid of
that shape.  Its positions are one of two kinds, kept apart because they
are different things:

* :class:`Link` s (``make_test_mesh``): one memory port of the paged
  store each, an index and the torch device its pages stream to.  Every
  link of a mesh lies on the one compute device, so a mesh of N links on
  one card is N fetch workers and N copy streams feeding one device (the
  sharded paged store, ``core/paging.ShardedPagedStore``).
* :class:`Rank` s (``make_rank_mesh``): the processes of one
  ``torch.distributed`` process group, the port's counterpart of the
  reference's devices.  A rank mesh also carries the torch ``DeviceMesh``
  (``device_mesh``) and gives the process group of an axis
  (``group(axis)``); the sharded train step, the checkpoint's elastic
  restore, the compressed all-reduce and the pipeline run over it
  (``parallel/distributed.py``).  Every rank of a card machine with one
  card lies on ``cuda:0``.

The sharding rules (``parallel/sharding.py``) read only ``axis_names``
and ``shape``, whichever the positions are.

Unlike the reference's ``make_test_mesh``, which clamps the shape to
``jax.device_count()``, the port never clamps: the shape asked for is the
shape built, whatever number of cards is present (ROADMAP C, the
differences kept on purpose).  Ranks on several cards under NCCL, and a
production mesh, are not here (ROADMAP A11 (b) item 6, A12 (d)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Link:
    """One position of a mesh: its row-major ``index`` and the ``device``
    its pages stream to."""
    index: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device}/link{self.index}"


@dataclasses.dataclass(frozen=True)
class Rank:
    """One position of a rank mesh: the process's global ``index`` in its
    process group and the ``device`` it computes on."""
    index: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device}/rank{self.index}"


class Mesh:
    """``axis_names``, ``shape`` ({axis name: size}, in axis order) and
    ``devices``, a numpy object grid of :class:`Link` s or :class:`Rank` s
    of that shape: the surface of ``jax.sharding.Mesh`` that the sharding
    rules, the sharded paged store and the rank functions read.  A rank
    mesh also holds ``device_mesh``, the torch ``DeviceMesh`` of its
    ranks."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device_mesh: Optional[Any] = None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid cannot take "
                             f"axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of this rank's ranks along ``axis``."""
        if self.device_mesh is None:
            raise ValueError("a mesh of links has no process groups; build "
                             "a rank mesh with make_rank_mesh")
        return self.device_mesh.get_group(axis)

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        if self.device_mesh is None:
            raise ValueError("a mesh of links has no calling rank")
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    @property
    def links(self) -> Tuple[Link, ...]:
        """Every link, in row-major order."""
        return tuple(self.devices.reshape(-1).tolist())


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"),
                   device: DeviceLike = None) -> Mesh:
    """The reference's small test mesh as links that all stream to
    ``device`` (default ``cuda``; raises without a card): never clamped to
    the number of cards present."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"shape {shape} and axes {tuple(axes)} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh dims must be >= 1, got {shape}")
    dev = resolve_device(device)
    grid = np.empty(math.prod(shape), dtype=object)
    for i in range(grid.size):
        grid[i] = Link(i, dev)
    return Mesh(grid.reshape(shape), axes)


def make_rank_mesh(shape: Sequence[int], axes: Sequence[str],
                   device: DeviceLike = None) -> Mesh:
    """A mesh of ``shape`` over the ranks of the initialised default
    process group, which must hold ``prod(shape)`` of them: rank ``i`` sits
    at row-major position ``i``, every rank on ``device`` (default
    ``cuda``; raises without a card).  Every rank calls it, with the same
    arguments, as it builds the process group of each axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_rank_mesh needs an initialised process "
                           "group (parallel/distributed.run_ranks starts one)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {dist.get_world_size()}")
    dev = resolve_device(device)
    dmesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    grid = np.empty(math.prod(shape), dtype=object)
    for i in range(grid.size):
        grid[i] = Rank(i, dev)
    return Mesh(grid.reshape(shape), axes, device_mesh=dmesh)
