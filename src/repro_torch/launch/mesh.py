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
differences kept on purpose).  Ranks on several cards under NCCL are not
here (ROADMAP A11 (b) item 6).

``make_production_mesh`` gives the reference's production meshes, (16, 16)
("data", "model") or (2, 16, 16) ("pod", "data", "model"), as rank 0 of a
process group of 256 or 512 ranks (``fake_rank_mesh``, any shape) of
PyTorch's ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg``, a private module): a
process group object of any size that runs in this one process, whose
collectives return at once and move nothing.  The dry-run
(``launch/dryrun.py``) needs the rank's program and nothing else: the
``DeviceMesh`` and its subgroups, DTensor placement and every collective
call of the train step run unchanged, and the step counts its own traffic
(``metrics["comm"]``).  A counting transport inside
``parallel/distributed``'s wrappers would not reach the collectives that
``DeviceMesh`` and DTensor make themselves.
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
    ``cuda``; raises without a card).  Ranks on ``meta`` (a fake group's,
    shapes only) keep their torch ``DeviceMesh`` on the CPU: DTensor
    takes no ``meta`` mesh.  Every rank calls it, with the same arguments,
    as it builds the process group of each axis."""
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
    dmesh = init_device_mesh("cpu" if dev.type == "meta" else dev.type,
                             shape, mesh_dim_names=axes)
    grid = np.empty(math.prod(shape), dtype=object)
    for i in range(grid.size):
        grid[i] = Rank(i, dev)
    return Mesh(grid.reshape(shape), axes, device_mesh=dmesh)


# PyTorch's in-process process-group backend whose collectives move nothing
FAKE_BACKEND = "fake"


def fake_process_group(world: int) -> None:
    """Make the default process group one of ``world`` ranks of the
    ``"fake"`` backend, this process rank 0: kept if it is one already, a
    fake group of another size replaced.  A real group raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != FAKE_BACKEND:
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is up; the "
                "production mesh runs on a fake one in its own process")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=world)


def fake_rank_mesh(shape: Sequence[int], axes: Sequence[str],
                   device: DeviceLike = None) -> Mesh:
    """A rank mesh of ``shape`` over a fake process group of its size
    (:func:`fake_process_group`), this process rank 0.  On
    ``device="meta"`` the positions lie on ``meta`` and the torch
    ``DeviceMesh`` on the CPU (:func:`make_rank_mesh`); otherwise both on
    ``device`` (default ``cuda``; raises without a card).  The collectives
    of a program on it return at once and move nothing: gathered buffers
    hold no data."""
    fake_process_group(math.prod(int(s) for s in shape))
    return make_rank_mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The reference's production mesh, 16x16 = one pod of 256 ranks
    ("data", "model"); ``multi_pod`` adds a 2-pod axis, 512 ranks ("pod",
    "data", "model"): a :func:`fake_rank_mesh` (``device`` as there)."""
    if multi_pod:
        return fake_rank_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return fake_rank_mesh((16, 16), ("data", "model"), device)
