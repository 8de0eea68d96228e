"""Carry parameters over from the JAX package (no reference module).

The JAX package draws its weights with ``jax.random``, which PyTorch cannot
reproduce, so parity runs export the JAX parameter tree as nested dicts of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and load it
here.  Two kinds of tree come across:

- the LM's, dense or frozen, of any ported family (dense, MoE, SSM,
  hybrid, VLM): layers stacked on axis 0 (``repro/models/transformer.py:134-150``),
  packed leaves as ``{"packed", "scale"}`` dicts, the MoE block's router,
  stacked (E, F, D) experts (packed (E, F, D/f) with (E, F) scales), shared
  expert and arctic's ``dense`` residual, and the SSM leaves and hymba's
  ``meta_tokens`` as they are (:func:`params_from_numpy`); and the
  encoder-decoder's (``repro/models/encdec.py:50-63``): ``dec_pos``, the
  stacked ``enc_layers`` and ``dec_layers`` (with ``xattn``),
  ``enc_final_norm``;
- MobileNet-V2's, one entry per N-EUREKA job: the float ``{"w", "bias"}``
  tree of ``init_params`` or the frozen ``{"packed", "mult", "bias"}`` tree
  of ``freeze_packed`` (:func:`mobilenet_from_numpy`);
- an optimizer state of ``repro/optim/optimizers.py``: AdamW's
  ``dict(mu, nu, count)`` or Adafactor's ``dict(v=[...], count)``, whose
  list follows the params' leaves in ``jax.tree_util`` order
  (:func:`opt_state_from_numpy`).

:func:`params_to_numpy` exports any of them back, so tests compare the two
packages' trees leaf by leaf.  This module never imports JAX; the caller does the ``jax -> numpy`` step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.perf_model import mobilenet_v2_jobs
from repro_torch.models.config import ModelConfig


def _leaf_to_torch(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes; numpy has no bf16
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    # copy: arrays exported from JAX are read-only views
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: DeviceLike = None) -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors on ``device``
    (default ``cuda``).  Checks each stacked layer axis against ``cfg``:
    ``layers`` and ``dec_layers`` against ``n_layers``, ``enc_layers``
    against ``n_encoder_layers``."""
    dev = resolve_device(device)

    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf_to_torch(t, dev)

    out = walk(tree)
    embed = out.get("embed") if isinstance(out, dict) else None
    if embed is not None and tuple(embed.shape) != (cfg.vocab_size,
                                                    cfg.d_model):
        raise ValueError(f"embed {tuple(embed.shape)} does not match "
                         f"{cfg.name} ({cfg.vocab_size}, {cfg.d_model})")
    stacks = (("layers", "n_layers"), ("dec_layers", "n_layers"),
              ("enc_layers", "n_encoder_layers"))
    for key, field in stacks:
        for t in _leaves(out.get(key, {}) if isinstance(out, dict) else {}):
            if t.shape[0] != getattr(cfg, field):
                raise ValueError(f"stacked {key} axis {t.shape[0]} != "
                                 f"{cfg.name} {field} "
                                 f"{getattr(cfg, field)}")
    return out


_MNV2_LEAVES = ({"w", "bias"}, {"packed", "mult", "bias"})


def mobilenet_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A MobileNet-V2 tree of numpy arrays, float or frozen, -> the same tree
    of tensors on ``device`` (default ``cuda``).  Checks that it has one
    entry per job of ``mobilenet_v2_jobs`` and one kind of leaf set."""
    dev = resolve_device(device)
    jobs = [j.name for j in mobilenet_v2_jobs()]
    if not isinstance(tree, dict) or set(tree) != set(jobs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"not a MobileNet-V2 tree: want the {len(jobs)} "
                         f"jobs {jobs[:2]}..., got {got}")
    kinds = {frozenset(leaf) for leaf in tree.values()}
    if len(kinds) != 1 or set(next(iter(kinds))) not in _MNV2_LEAVES:
        raise ValueError("MobileNet-V2 job entries must all be {w, bias} or "
                         f"all {{packed, mult, bias}}, got {kinds}")
    return {name: {k: _leaf_to_torch(v, dev) for k, v in leaf.items()}
            for name, leaf in tree.items()}


def opt_state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """An optimizer state of numpy arrays (dicts and lists) -> the same
    tree of tensors on ``device`` (default ``cuda``); ``count`` stays
    int32."""
    dev = resolve_device(device)
    if not isinstance(tree, dict) or "count" not in tree or not (
            {"mu", "nu"} <= set(tree) or isinstance(tree.get("v"), list)):
        raise ValueError("not an AdamW dict(mu, nu, count) or Adafactor "
                         "dict(v=[...], count) state")

    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _leaf_to_torch(t, dev)

    return walk(tree)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy` and
    :func:`opt_state_from_numpy`: tensors -> numpy arrays on the host
    (bf16 leaves come back as float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
