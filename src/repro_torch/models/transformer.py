"""Decoder-only LM: init / forward / prefill / decode, dense family
(reference: ``repro/models/transformer.py:24-470``).

Parameters keep the reference's tree: nested dicts of tensors with the
layers stacked on axis 0, so ``interop`` carries a JAX tree over leaf for
leaf.  The reference scans the stacked layers with ``jax.lax.scan``; here a
Python loop walks them.  Packed linears go through the Hopper ``qmatmul_f32``
kernel and ``forward`` / prefill ``step`` attention through the Hopper flash
kernel (``kernels.ops``); decode attention stays in PyTorch ops.

Only the dense family is ported so far.  The MoE, SSM, hybrid, VLM and
encoder-decoder families raise ``NotImplementedError`` (ROADMAP A9).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP A9); the port runs the dense family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters with the reference's structure and distributions.

    Weights are drawn on the generator's device (default: a CPU generator
    seeded 0) and moved to ``device`` (default ``cuda``).  The draws differ
    from ``jax.random``'s, so parity tests carry JAX weights over through
    ``interop`` instead.
    """
    check_family(cfg)
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dt = _dtype(cfg)
    n = cfg.n_layers

    def normal(shape, std):
        w = torch.randn(shape, generator=g, dtype=torch.float32,
                        device=g.device) * std
        return w.to(device=dev, dtype=dt)

    def dense(out_d, in_d):                         # stacked over layers
        return normal((n, out_d, in_d), in_d ** -0.5)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm(d, stacked=True):
        lead = (n,) if stacked else ()
        if cfg.norm_type == "nonparam_ln":
            return {}
        if cfg.norm_type == "layernorm":
            return dict(scale=torch.ones(lead + (d,), dtype=dt, device=dev),
                        bias=zeros(*lead, d))
        return dict(scale=zeros(*lead, d))          # rmsnorm (1 + s)

    attn = dict(wq=dense(cfg.q_dim, cfg.d_model),
                wk=dense(cfg.kv_dim, cfg.d_model),
                wv=dense(cfg.kv_dim, cfg.d_model),
                wo=dense(cfg.d_model, cfg.q_dim))
    if cfg.qkv_bias:
        attn.update(bq=zeros(n, cfg.q_dim), bk=zeros(n, cfg.kv_dim),
                    bv=zeros(n, cfg.kv_dim))
    if cfg.qk_norm:
        attn.update(q_norm=zeros(n, cfg.hd), k_norm=zeros(n, cfg.hd))
    if cfg.mlp_act in ("swiglu", "geglu"):
        mlp = dict(w_gate=dense(cfg.d_ff, cfg.d_model),
                   w_up=dense(cfg.d_ff, cfg.d_model),
                   w_down=dense(cfg.d_model, cfg.d_ff))
    else:
        mlp = dict(w_up=dense(cfg.d_ff, cfg.d_model), b_up=zeros(n, cfg.d_ff),
                   w_down=dense(cfg.d_model, cfg.d_ff),
                   b_down=zeros(n, cfg.d_model))
    params: Params = dict(
        embed=normal((cfg.vocab_size, cfg.d_model), 0.02),
        final_norm=norm(cfg.d_model, stacked=False),
        layers=dict(attn_norm=norm(cfg.d_model), attn=attn,
                    mlp_norm=norm(cfg.d_model), mlp=mlp),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, cfg.d_model),
                                   cfg.d_model ** -0.5)
    return params


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """The stacked layer tree as one dict of views per layer."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]
    return [take(params["layers"], i) for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _attn_apply(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos: Optional[attn_lib.Pos] = None,
                engine: Optional[Any] = None) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.hd
    q = L.linear(x, p["wq"], engine=engine, path="layers/attn/wq",
                 bias=p.get("bq"))
    k = L.linear(x, p["wk"], engine=engine, path="layers/attn/wk",
                 bias=p.get("bk"))
    v = L.linear(x, p["wv"], engine=engine, path="layers/attn/wv",
                 bias=p.get("bv"))
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
        k = L.rmsnorm(k, p["k_norm"])
    ar = torch.arange(s, device=x.device)
    start = 0 if cache_pos is None else cache_pos
    if isinstance(start, torch.Tensor) and start.ndim == 1:   # per-batch
        pos = start.to(x.device)[:, None] + ar[None]
    else:
        pos = start + ar
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)

    if cache is not None:
        cache = attn_lib.update_cache(cache, k, v, start)
        if s == 1:                      # decode: plain PyTorch ops
            o = attn_lib.decode_attention(q, cache["k"], cache["v"],
                                          cache_len=start + 1,
                                          window=cfg.window)
        else:                           # prefill into the cache
            # attend over the updated cache at the chunk's offset so that
            # earlier chunks' keys are visible; rows past the chunk are
            # causally masked, so unwritten cache rows are inert
            o = kops.attention(q, cache["k"], cache["v"], causal=True,
                               window=cfg.window, q_offset=start)
    else:
        o = kops.attention(q, k, v, causal=True, window=cfg.window,
                           q_offset=start)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return L.linear(o, p["wo"], engine=engine, path="layers/attn/wo")


def _layer_apply(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_pos: Optional[attn_lib.Pos] = None,
                 engine: Optional[Any] = None) -> torch.Tensor:
    h = L.apply_norm(x, p.get("attn_norm"), cfg.norm_type)
    x = x + _attn_apply(h, p["attn"], cfg, cache=cache, cache_pos=cache_pos,
                        engine=engine)
    h = L.apply_norm(x, p.get("mlp_norm"), cfg.norm_type)
    return x + L.mlp(h, p["mlp"], cfg.mlp_act, engine=engine,
                     path="layers/mlp")


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    x = L.embed(tokens, params["embed"]).to(_dtype(cfg))
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(x, params.get("final_norm"), cfg.norm_type)
    logits = L.unembed(x, params.get("lm_head", params["embed"]))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            engine: Optional[Any] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V)."""
    check_family(cfg)
    x = _embed(params, tokens, cfg)
    for p in layer_params(params, cfg):
        x = _layer_apply(x, p, cfg, engine=engine)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: prefill + decode with the stacked per-layer cache
# ---------------------------------------------------------------------------

def init_serve_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: DeviceLike = None) -> Dict[str, Any]:
    check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return dict(kv=dict(k=torch.zeros(shape, dtype=_dtype(cfg), device=dev),
                        v=torch.zeros(shape, dtype=_dtype(cfg), device=dev)))


def step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
         pos: attn_lib.Pos, cfg: ModelConfig, *,
         engine: Optional[Any] = None,
         layers: Optional[List[Params]] = None
         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Serve step: run ``tokens`` (B, S) through the model, reading and
    writing the stacked cache at ``pos`` (scalar, or (B,) per batch row).
    S == 1 is decode, S > 1 prefill.  The cache is updated in place and
    returned.  ``layers`` may pass a cached :func:`layer_params` list."""
    check_family(cfg)
    x = _embed(params, tokens, cfg)
    kv = cache["kv"]
    for i, p in enumerate(layers if layers is not None
                          else layer_params(params, cfg)):
        x = _layer_apply(x, p, cfg, cache=dict(k=kv["k"][i], v=kv["v"][i]),
                         cache_pos=pos, engine=engine)
    return _head(params, x, cfg), cache
