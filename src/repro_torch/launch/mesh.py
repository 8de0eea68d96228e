"""Device meshes of the port (reference: ``repro/launch/mesh.py:39-60``).

A :class:`Mesh` names its axes, gives each a size and holds a grid of
that shape whose positions are :class:`Link` s.  A link is one memory
port of the paged store: an index and the torch device its pages stream
to.  In this slice every link of a mesh lies on the one compute device, so
a mesh of N positions on one card is N fetch workers and N copy streams
feeding one device: the sharding rules (``parallel/sharding.py``) and the
sharded paged store (``core/paging.ShardedPagedStore``) read the axis
names and sizes, the store the links.

Unlike the reference's ``make_test_mesh``, which clamps the shape to
``jax.device_count()``, the port never clamps: the shape asked for is the
shape built, whatever number of cards is present (ROADMAP C, the
differences kept on purpose).  Links on more than one card, and a
production mesh, are not here (ROADMAP A11 (b), A12 (d)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

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


class Mesh:
    """``axis_names``, ``shape`` ({axis name: size}, in axis order) and
    ``devices``, a numpy object grid of :class:`Link` s of that shape: the
    surface of ``jax.sharding.Mesh`` that the sharding rules and the
    sharded paged store read."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
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
