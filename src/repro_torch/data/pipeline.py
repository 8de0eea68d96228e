"""Deterministic, restart-safe synthetic LM data pipeline: a copy of the
reference's framework-free ``repro/data/pipeline.py``, so batches equal
the reference's bit for bit.

Properties needed at scale and provided here:
  * **step-indexed determinism** — batch(step) is a pure function of
    (seed, step, host_id), so a restarted/elastically-resized job resumes
    mid-epoch with zero bookkeeping (no iterators to checkpoint);
  * **host sharding** — each host materializes only its slice of the
    global batch;
  * **prefetch** — a background thread keeps ``depth`` batches in flight
    (the IO-DMA double-buffering discipline of the paper, at the data tier).

The token stream is a Zipf-ish categorical over the vocab with
Markov structure, giving non-trivial learnable statistics for the
end-to-end examples while staying dependency-free and offline.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 family: str = "lm", d_model: int = 0, n_frames: int = 0,
                 n_patches: int = 0):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self.family = family
        self.d_model = d_model
        self.n_frames = n_frames
        self.n_patches = n_patches
        # fixed Markov mixing weights (learnable structure)
        base = np.random.default_rng(seed).normal(size=(64,))
        self._mix = base / np.linalg.norm(base)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_id)
        b, s = self.local_batch, self.seq
        # zipf-ish marginal + short-range structure: next token correlates
        # with (token % 64) of the previous one
        z = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        tokens = z % self.vocab
        shift = (tokens[:, :-1] % 64).astype(np.int64)
        tokens = (tokens[:, 1:] + shift) % self.vocab
        prev = np.concatenate([rng.integers(0, self.vocab, (b, 1)),
                               tokens[:, :-1]], axis=1)
        out: Dict[str, Any] = dict(tokens=prev.astype(np.int32),
                                   labels=tokens.astype(np.int32))
        if self.family == "encdec":
            out["frames"] = rng.normal(
                size=(b, self.n_frames, self.d_model)).astype(np.float32)
        if self.family == "vlm":
            out["patches"] = rng.normal(
                size=(b, self.n_patches, self.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def prefetch(dataset: SyntheticLMDataset, start_step: int = 0,
             depth: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetch of ``depth`` batches."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put(dataset.batch(step))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
