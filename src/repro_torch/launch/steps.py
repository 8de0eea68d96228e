"""The train and serve steps (reference: ``repro/launch/steps.py:40-140``).

``make_train_step`` takes the gradient of the family's loss
(``encdec.seq2seq_loss`` for the encoder-decoder, ``transformer.lm_loss``
for the rest), clips it to a global norm of 1.0 and applies the optimizer,
as the reference's does; it returns a plain function (no ``jit``).
``make_prefill_step`` / ``make_decode_step`` build the serve steps of
every family: the decoder-only LM's
``transformer.step``, the VLM's with patch embeddings prepended, and the
encoder-decoder's ``encode`` -> ``precompute_cross_kv`` -> ``encdec.step``.
They run under ``torch.no_grad``.

``param_specs``, ``serve_param_specs`` and ``cache_specs``
(``:52-60, 143-157``) give a config's parameter, packed-store and cache
trees as ``meta`` tensors, PyTorch's counterpart of ``jax.eval_shape``:
every shape of a full-width config (arctic-480b's ~484 B parameters
among them) without allocating it, for the sharding rules.

The dry-run's cells (``:25-30, 79-97, 167-250``; ``launch/dryrun.py``):
``train_batch_specs``, ``train_input_specs`` and ``serve_input_specs``
give each cell's inputs as trees of ``sharding.ShapeSpec`` (a ``meta``
tensor with its spec, the reference's ``ShapeDtypeStruct`` with a
``NamedSharding``), and ``cell_specs`` the cell's trees at the
reference's bf16 ``dtype``.  ``build_cell`` returns ``(fn, args, {})``,
the one-rank program of a cell: a train cell is
``dist_steps.make_distributed_train_step`` on the mesh with the params
and optimizer state ``shard_tree`` 'd and the whole batch, as rank 0 runs
it; a serve cell is the one-device prefill or decode step on the rank's
dp rows (``rank_rows``) with the whole packed weights, since the port has
no model-split serve.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.core import tree as T
from repro_torch.core.placement import PlacementPlan
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (Optimizer, clip_by_global_norm,
                               pick_optimizer)
from repro_torch.parallel import sharding


# the reference's engine dict of a serve cell, kept by name: nothing reads
# it (a serve cell takes ``PlacementPlan.uniform(bits=serve_bits)``, and
# ``placement.as_plan`` of this dict is DEFAULT_SERVE_PLAN)
DEFAULT_SERVE_ENGINE = dict(scenario="l1mram", mode="xla", bits=8)
# the serve steps' placement when the caller gives none (the reference's
# DEFAULT_SERVE_PLAN)
DEFAULT_SERVE_PLAN = PlacementPlan.uniform()


def _loss_fn(cfg: ModelConfig) -> Callable:
    _init_fn(cfg)                       # refuse an unknown family now
    if cfg.family == "encdec":
        return encdec.seq2seq_loss
    return tfm.lm_loss


def _init_fn(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        encdec.check_family(cfg)
        return encdec.init_params
    tfm.check_family(cfg)
    return tfm.init_params


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, engine: Optional[Any] = None,
                   denom: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``jax.value_and_grad`` of the family's loss on
    detached copies of the leaves, so ``params`` is left as it was.  A leaf
    the loss never reads (hymba's ``ssm_norm``: its SSM heads take the
    attention's normalised input) gets zeros, as under JAX.  ``denom``
    replaces the loss's token count (``transformer.token_nll``)."""
    loss_fn = _loss_fn(cfg)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(T.unflatten(params, leaves), batch, cfg,
                       engine=engine, denom=denom)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), T.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    lr: float = 3e-4, engine: Optional[Any] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; ``batch`` holds tensors on the params'
    device."""
    _loss_fn(cfg)                       # refuse an unknown family now

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, engine=engine)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = optimizer.update(
            grads, opt_state, params,
            torch.tensor(lr, dtype=torch.float32, device=loss.device))
        return new_params, new_opt, dict(loss=loss, grad_norm=gnorm)

    return train_step


def make_prefill_step(cfg: ModelConfig, engine: Optional[Any] = None
                      ) -> Callable:
    """The serve prefill: ``prefill(params, tokens, cache)``, for the VLM
    ``prefill(params, patches, tokens, cache)``, for the encoder-decoder
    ``prefill(params, frames, tokens, cache)``; each returns (logits over
    the token positions, cache) and fills the cache from position 0.
    ``engine`` is a PlacementPlan or the legacy engine dict (default: the
    uniform l1mram plan)."""
    engine = engine if engine is not None else DEFAULT_SERVE_PLAN
    _init_fn(cfg)                       # refuse an unknown family now
    if cfg.family == "encdec":
        @torch.no_grad()
        def prefill(params, frames, tokens, cache):
            enc_out = encdec.encode(params, frames, cfg, engine=engine)
            cache = encdec.precompute_cross_kv(params, enc_out, cfg, cache,
                                               engine=engine)
            return encdec.step(params, tokens, cache, 0, cfg, engine=engine)
        return prefill
    if cfg.family == "vlm":
        @torch.no_grad()
        def prefill(params, patches, tokens, cache):
            return tfm.step(params, tokens, cache, 0, cfg, engine=engine,
                            extra_embeds=patches)
        return prefill

    @torch.no_grad()
    def prefill(params, tokens, cache):
        return tfm.step(params, tokens, cache, 0, cfg, engine=engine)
    return prefill


def make_decode_step(cfg: ModelConfig, engine: Optional[Any] = None
                     ) -> Callable:
    """``decode(params, token, cache, pos) -> (logits, cache)``: one token
    a row at position ``pos`` (which counts a VLM's patches)."""
    engine = engine if engine is not None else DEFAULT_SERVE_PLAN
    _init_fn(cfg)
    step = encdec.step if cfg.family == "encdec" else tfm.step

    @torch.no_grad()
    def decode(params, token, cache, pos):
        return step(params, token, cache, pos, cfg, engine=engine)
    return decode


def param_specs(cfg: ModelConfig) -> Any:
    """The parameter tree as ``meta`` tensors: every leaf's shape and
    dtype, nothing drawn or allocated."""
    return _init_fn(cfg)(cfg, device="meta")


def serve_param_specs(cfg: ModelConfig, bits: int = 8,
                      plan: Optional[PlacementPlan] = None) -> Any:
    """The packed At-MRAM store as ``meta`` tensors: each packable leaf a
    {"packed" uint8, "scale" f32} dict, as ``freeze_for_serving`` gives
    it; ``plan`` sets the bits per parameter path
    (``sharding.serve_spec_like``)."""
    return sharding.serve_spec_like(param_specs(cfg), bits, plan)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    """The serve cache of ``batch`` rows of ``max_len`` as ``meta``
    tensors."""
    _init_fn(cfg)
    init = (encdec.init_serve_cache if cfg.family == "encdec"
            else tfm.init_serve_cache)
    return init(cfg, batch, max_len, device="meta")


# ---------------------------------------------------------------------------
# the dry-run's cells
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh: Any
                      ) -> Dict[str, sharding.ShapeSpec]:
    """The global batch of a train cell, rows over the dp axes."""
    b, s = cell.global_batch, cell.seq_len
    rows, rows3 = (sharding.batch_pspec(b, mesh, extra_dims=n)
                   for n in (1, 2))
    batch: Dict[str, Any] = {}
    if cfg.family == "encdec":
        batch["frames"] = sharding.sds(
            (b, cfg.n_audio_frames, cfg.d_model), tfm._dtype(cfg), rows3)
    elif cfg.family == "vlm":
        batch["patches"] = sharding.sds((b, cfg.n_patches, cfg.d_model),
                                        tfm._dtype(cfg), rows3)
        s = s - cfg.n_patches
    batch["tokens"] = sharding.sds((b, s), torch.int32, rows)
    batch["labels"] = sharding.sds((b, s), torch.int32, rows)
    return batch


def cell_optimizer(params: Any, mesh: Any) -> Optimizer:
    """The reference's choice for a train cell on ``mesh``: AdamW where
    its state fits a chip's budget, else Adafactor (``pick_optimizer``).
    ``params``' leaves need only a ``shape``."""
    return pick_optimizer(sum(math.prod(leaf.shape)
                              for leaf in T.leaves(params)),
                          n_chips=mesh.devices.size)


def train_input_specs(cfg: ModelConfig, cell: ShapeCell, mesh: Any
                      ) -> Dict[str, Any]:
    """A train cell's inputs: ``params``, ``opt_state`` (of
    :func:`cell_optimizer`) and ``batch``, trees of ``ShapeSpec``."""
    params = param_specs(cfg)
    opt_state = cell_optimizer(params, mesh).init(params)
    return dict(
        params=sharding.with_shardings(
            params, sharding.param_shardings(params, mesh)),
        opt_state=sharding.with_shardings(
            opt_state, sharding.opt_state_shardings(opt_state, mesh,
                                                    params)),
        batch=train_batch_specs(cfg, cell, mesh))


def serve_input_specs(cfg: ModelConfig, cell: ShapeCell, mesh: Any,
                      bits: int = 8, plan: Optional[PlacementPlan] = None
                      ) -> Dict[str, Any]:
    """Specs for prefill / decode cells: params (packed), inputs, cache,
    trees of ``ShapeSpec``."""
    b, s = cell.global_batch, cell.seq_len
    dt = tfm._dtype(cfg)
    rows, rows3 = (sharding.batch_pspec(b, mesh, extra_dims=n)
                   for n in (1, 2))
    pspecs = serve_param_specs(cfg, bits, plan=plan)
    cspecs = cache_specs(cfg, b, s)
    out: Dict[str, Any] = dict(
        params=sharding.with_shardings(
            pspecs, sharding.param_shardings(pspecs, mesh)),
        cache=sharding.with_shardings(
            cspecs, sharding.cache_shardings(cspecs, mesh, b)))
    if cell.kind == "prefill":
        out["tokens"] = sharding.sds((b, prompt_len(cfg, s)), torch.int32,
                                     rows)
        if cfg.family == "encdec":
            out["frames"] = sharding.sds(
                (b, cfg.n_audio_frames, cfg.d_model), dt, rows3)
        if cfg.family == "vlm":
            out["patches"] = sharding.sds((b, cfg.n_patches, cfg.d_model),
                                          dt, rows3)
    else:  # decode: one token against a seq_len-deep cache
        out["tokens"] = sharding.sds((b, 1), torch.int32, rows)
        out["pos"] = sharding.sds((), torch.int32, sharding.P())
    return out


def prompt_len(cfg: ModelConfig, seq_len: int) -> int:
    """A prefill cell's tokens: the sequence less the VLM's patches and
    hymba's meta tokens, which the step prepends."""
    return (seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
            - cfg.n_meta_tokens)


def cell_specs(cfg: ModelConfig, cell: ShapeCell, mesh: Any,
               serve_bits: int = 8) -> Dict[str, Any]:
    """The trees of :func:`build_cell`'s inputs, at the reference's bf16
    ``dtype``: what a rank holds of them is ``sharding.rank_bytes``."""
    cfg = cfg.replace(dtype="bfloat16")
    if cell.kind == "train":
        return train_input_specs(cfg, cell, mesh)
    return serve_input_specs(cfg, cell, mesh, bits=serve_bits)


def rank_rows(batch: int, mesh: Any) -> int:
    """The rows of a ``batch`` one rank serves: its block over the dp axes
    where they divide the batch, else every row (``batch_pspec``)."""
    if sharding.batch_pspec(batch, mesh)[0] is None:
        return batch
    return batch // sharding.dp_size(mesh)


def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh: Any,
               serve_bits: int = 8
               ) -> Tuple[Callable, Tuple, Dict[str, Any]]:
    """Returns (fn, args, {}): the program that rank 0 of ``mesh`` (ranks
    on ``meta``, ``launch/mesh.make_production_mesh(device="meta")``) runs
    for the cell, and its ``meta`` arguments.

    A train cell is ``dist_steps.make_distributed_train_step`` with the
    reference's optimizer (:func:`cell_optimizer`), its args the params
    and optimizer state placed by their specs (``distributed.shard_tree``)
    and the whole batch.  A serve cell is the one-device prefill or decode
    step on the rank's :func:`rank_rows` with the whole packed weights
    (the port splits no serve step over ranks) at ``serve_bits`` for every
    leaf; a decode step reads the cache's last row, ``seq_len - 1``."""
    cfg = cfg.replace(dtype="bfloat16")
    if cell.kind == "train":
        from repro_torch.launch import dist_steps
        from repro_torch.parallel import distributed
        specs = train_input_specs(cfg, cell, mesh)

        def placed(tree):
            return distributed.shard_tree(T.tree_map(lambda x: x.value, tree),
                                          T.tree_map(lambda x: x.spec, tree),
                                          mesh)

        opt = cell_optimizer(specs["params"], mesh)
        fn = dist_steps.make_distributed_train_step(cfg, opt, mesh)
        batch = {k: v.value for k, v in specs["batch"].items()}
        return fn, (placed(specs["params"]), placed(specs["opt_state"]),
                    batch), {}

    plan = PlacementPlan.uniform(bits=serve_bits)
    rows, s = rank_rows(cell.global_batch, mesh), cell.seq_len
    params = serve_param_specs(cfg, serve_bits, plan=plan)
    cache = cache_specs(cfg, rows, s)

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "decode":
        fn = make_decode_step(cfg, engine=plan)
        return fn, (params, meta(rows, 1), cache, s - 1), {}
    fn = make_prefill_step(cfg, engine=plan)
    tokens = meta(rows, prompt_len(cfg, s))
    dt = tfm._dtype(cfg)
    if cfg.family == "encdec":
        frames = meta(rows, cfg.n_audio_frames, cfg.d_model, dtype=dt)
        return fn, (params, frames, tokens, cache), {}
    if cfg.family == "vlm":
        patches = meta(rows, cfg.n_patches, cfg.d_model, dtype=dt)
        return fn, (params, patches, tokens, cache), {}
    return fn, (params, tokens, cache), {}
