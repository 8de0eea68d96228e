"""Atomic, async checkpointing of tensor trees (reference:
``repro/checkpoint/manager.py``), in the reference's on-disk format.

A checkpoint is a directory ``step_XXXXXXXX`` holding one ``leaf_N.npy``
per leaf and a ``manifest.json`` keyed by the leaf's ``/``-joined tree path
(dict keys, list indices) with its file, shape and logical dtype; leaves
are numbered in ``jax.tree_util`` order (``core/tree.py``) and bf16 leaves
are stored as f32.  So a checkpoint written by either package restores in
the other.

  * **Atomicity** -- written to ``step_XXXXXXXX.tmp`` and renamed once
    every leaf and the manifest are written; a crashed writer never leaves
    a directory that ``all_steps`` lists.
  * **Async** -- ``save`` copies the tree into fresh host memory before it
    returns and writes in a background thread.  The copy is needed: the
    reference relies on JAX arrays being immutable, but a torch tensor may
    be written in place after ``save`` returns, and ``.cpu()`` of a CPU
    tensor is the same storage.
  * **Keep-N** garbage collection, restore-latest and step indexing for
    the fault-tolerant trainer (``runtime/trainer.py``).

``restore`` puts each leaf on ``device`` (default: the device of the
template's leaf), or with ``shardings=`` (``NamedSharding`` s of a rank
mesh, ``parallel/distributed.py``) keeps each rank's block of it: the
elastic restore onto another mesh than the one that saved (reference
``:91-121``).

A tree of DTensors (a rank mesh's state) is saved whole: ``save``
gathers each leaf on every rank on the calling thread (the gather is a
collective, so it cannot run on the writer thread), and rank 0 alone
writes, in the same format, so a checkpoint of any mesh, or of either
package, restores onto any other.  Once a manager has saved such a tree,
``wait`` puts a barrier behind rank 0's write, and ``latest_step``,
``all_steps`` and ``restore`` wait first, so no rank looks before the
write has landed.  Every rank calls the same manager methods in the same
order.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.device import DeviceLike
from repro_torch.parallel import distributed


class CheckpointRestoreError(RuntimeError):
    """A restore failed; names the step (and root) it failed for.

    Raised when no checkpoint exists to restore, or when the named step's
    directory is unreadable (missing or corrupt manifest, missing leaf
    file): everything short of a structural mismatch with the caller's
    ``tree_like``, which keeps its specific KeyError / ValueError."""

    def __init__(self, message: str, *, step: Optional[int] = None,
                 root: Optional[Path] = None):
        self.step = step
        self.root = root
        super().__init__(message)


def _flatten(tree: Any) -> List[Tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in T.flatten_with_paths(tree)]


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A copy in fresh host memory, whatever the leaf's device."""
    return leaf.detach().to("cpu", copy=True)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name as the reference writes it)."""
    t = leaf.detach().cpu()
    logical = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        # no native .npy bf16: stored as f32 (lossless), restored via the
        # template's dtype
        t = t.to(torch.float32)
    return t.numpy(), logical


def save_pytree(tree: Any, directory: str | Path) -> None:
    """Atomic synchronous save of one tree of tensors."""
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, logical = _to_numpy(leaf)
        fname = f"leaf_{i}.npy"
        np.save(tmp / fname, arr)
        manifest[key] = dict(file=fname, shape=list(arr.shape),
                             dtype=logical)
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def restore_pytree(tree_like: Any, directory: str | Path,
                   shardings: Any = None, device: DeviceLike = None) -> Any:
    """Restore into the structure and dtypes of ``tree_like`` (a tree of
    tensors or DTensors); each leaf goes to ``device``, default its
    template's.  ``shardings`` (``tree_like``'s structure, a
    ``parallel/distributed.NamedSharding`` a leaf) re-shards: each leaf is
    this rank's block of it on its mesh, read from the file alone."""
    directory = Path(directory)
    with open(directory / "manifest.json") as f:
        manifest = json.load(f)
    flat = _flatten(tree_like)
    shard_flat = ([None] * len(flat) if shardings is None
                  else T.leaves(shardings))
    if len(shard_flat) != len(flat):
        raise ValueError(f"{len(shard_flat)} shardings for {len(flat)} "
                         "leaves")
    out = []
    for (key, leaf), sh in zip(flat, shard_flat):
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(directory / manifest[key]["file"],
                      mmap_mode=None if sh is None else "r")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if sh is None:
            out.append(torch.from_numpy(arr).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype))
            continue
        mesh = sh.mesh
        places = distributed.placements(sh.spec, mesh)
        block = np.array(distributed.block_of(arr, mesh.device_mesh, places))
        out.append(distributed.placed(
            torch.from_numpy(block).to(device=mesh.devices.flat[0].device,
                                       dtype=leaf.dtype),
            mesh.device_mesh, places, arr.shape))
    return T.unflatten(tree_like, out)


class CheckpointManager:
    def __init__(self, root: str | Path, keep_n: int = 3,
                 async_save: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._ranked = False        # saved a rank mesh's tree: barriers

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False) -> None:
        # the gather is a collective: every rank takes part.  Rank 0, which
        # writes, snapshots into fresh host memory before returning: the
        # caller may overwrite its tensors (in place, or on the card) right
        # after
        self._ranked |= any(isinstance(leaf, distributed.DTensor)
                            for leaf in T.leaves(tree))
        whole = distributed.gather_tree(tree)
        lead = distributed.is_lead()
        host_tree = T.tree_map(_snapshot, whole) if lead else None
        del whole
        self.wait()                     # one writer at a time
        if not lead:
            return

        def _write():
            try:
                save_pytree(host_tree, self.root / f"step_{step:08d}")
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self._last_error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._ranked:
            distributed.barrier()       # rank 0's write has landed
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def _gc(self) -> None:
        steps = self._steps_on_disk()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        if self._ranked:
            self.wait()
        return self._steps_on_disk()

    def _steps_on_disk(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.root.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None, device: DeviceLike = None
                ) -> Tuple[int, Any]:
        if self._ranked:
            self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise CheckpointRestoreError(
                f"no checkpoints under {self.root}", root=self.root)
        try:
            tree = restore_pytree(tree_like, self.root / f"step_{step:08d}",
                                  shardings, device=device)
        except (OSError, json.JSONDecodeError) as e:
            # a half-written .tmp never reaches all_steps(), so landing
            # here means the renamed directory itself is damaged
            raise CheckpointRestoreError(
                f"checkpoint step {step} under {self.root} is unreadable: "
                f"{e}", step=step, root=self.root) from e
        return step, tree
