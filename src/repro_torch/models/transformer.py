"""Decoder-only LM: init / forward / prefill / decode for the dense, MoE, SSM
and hybrid families (reference: ``repro/models/transformer.py:24-470``).

Parameters keep the reference's tree: nested dicts of tensors with the
layers stacked on axis 0, so ``interop`` carries a JAX tree over leaf for
leaf.  The reference scans the stacked layers with ``jax.lax.scan``; here a
Python loop walks them.  Packed linears go through the Hopper ``qmatmul_f32``
kernel (the MoE experts' through its grouped launch, ``models/moe.py``),
``forward`` / prefill ``step`` attention through the Hopper flash kernel and
every SSM scan through the Hopper selective-scan kernel (``kernels.ops``);
decode attention stays in PyTorch ops.

The SSM family (falcon-mamba) is attention-free; the hybrid family (hymba)
runs attention and SSM heads in parallel on the same normalised input,
mixes sliding-window and global attention layers, and prepends learned meta
tokens.  The MoE family (qwen2-moe, arctic) replaces the dense MLP with
top-k routed experts, a shared expert and arctic's dense residual.  The VLM
and encoder-decoder families raise ``NotImplementedError`` (ROADMAP A9),
and so does hymba's ``segmented_window_scan`` fast path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP A9); the port runs the {', '.join(FAMILIES)} families")
    if cfg.segmented_window_scan:
        raise NotImplementedError(
            f"{cfg.name}: segmented_window_scan is not ported yet "
            "(ROADMAP A9)")
    # the card's attention and scan kernels compute in f32 only: a config
    # that asks for another compute dtype is refused, not run in f32
    for field in ("attn_dtype", "scan_dtype"):
        if getattr(cfg, field) != "float32":
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                "(ROADMAP C6 / C7); the port computes attention and the "
                "selective scan in float32 only")


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
                        device=g.device)
        w.mul_(std)                       # in place: no second f32 copy
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

    layers: Params = {}
    if cfg.family in ("dense", "moe", "hybrid"):
        attn = dict(wq=dense(cfg.q_dim, cfg.d_model),
                    wk=dense(cfg.kv_dim, cfg.d_model),
                    wv=dense(cfg.kv_dim, cfg.d_model),
                    wo=dense(cfg.d_model, cfg.q_dim))
        if cfg.qkv_bias:
            attn.update(bq=zeros(n, cfg.q_dim), bk=zeros(n, cfg.kv_dim),
                        bv=zeros(n, cfg.kv_dim))
        if cfg.qk_norm:
            attn.update(q_norm=zeros(n, cfg.hd), k_norm=zeros(n, cfg.hd))
        layers.update(attn_norm=norm(cfg.d_model), attn=attn)
    if cfg.family in ("ssm", "hybrid"):
        layers.update(ssm_norm=norm(cfg.d_model), ssm=_ssm_params(
            cfg, dense, normal, zeros, n, dev))
    def mlp(d_ff):
        if cfg.mlp_act in ("swiglu", "geglu"):
            return dict(w_gate=dense(d_ff, cfg.d_model),
                        w_up=dense(d_ff, cfg.d_model),
                        w_down=dense(cfg.d_model, d_ff))
        return dict(w_up=dense(d_ff, cfg.d_model), b_up=zeros(n, d_ff),
                    w_down=dense(cfg.d_model, d_ff),
                    b_down=zeros(n, cfg.d_model))

    if cfg.family == "moe":
        layers.update(mlp_norm=norm(cfg.d_model),
                      moe=_moe_params(cfg, dense, normal, mlp, n))
    elif cfg.family != "ssm":
        layers.update(mlp_norm=norm(cfg.d_model), mlp=mlp(cfg.d_ff))
    params: Params = dict(
        embed=normal((cfg.vocab_size, cfg.d_model), 0.02),
        final_norm=norm(cfg.d_model, stacked=False),
        layers=layers,
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, cfg.d_model),
                                   cfg.d_model ** -0.5)
    if cfg.n_meta_tokens:
        params["meta_tokens"] = normal((cfg.n_meta_tokens, cfg.d_model), 0.02)
    return params


def _moe_params(cfg: ModelConfig, dense, normal, mlp, n: int) -> Params:
    """The MoE block's stacked leaves (``transformer.py:78-97``): a router,
    the experts' (E, F, D) / (E, D, F) weights, and the shared expert and
    arctic's dense residual as plain MLPs."""
    e, f, d = cfg.n_experts, cfg.moe_d_ff, cfg.d_model
    p = dict(router=dense(e, d),
             w_gate=normal((n, e, f, d), d ** -0.5),
             w_up=normal((n, e, f, d), d ** -0.5),
             w_down=normal((n, e, d, f), f ** -0.5))
    if cfg.shared_d_ff:
        p["shared"] = mlp(cfg.shared_d_ff)
    if cfg.dense_residual_d_ff:
        p["dense"] = mlp(cfg.dense_residual_d_ff)
    return p


def _ssm_params(cfg: ModelConfig, dense, normal, zeros, n: int,
                dev: torch.device) -> Params:
    """The mixer's stacked leaves (``transformer.py:98-113``): A_log, D and
    dt_bias keep the reference's values and dtypes."""
    di, ns, r, k = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    # numpy's f32 log, not torch.log: the reference's log(7) is one ulp
    # above the correctly rounded value that torch.log returns, numpy's
    # f32 log gives the reference's
    a_log = torch.from_numpy(np.log(np.arange(1, ns + 1, dtype=np.float32))
                             ).to(dev)
    return dict(
        in_proj=dense(2 * di, cfg.d_model),
        conv_w=normal((n, di, k), k ** -0.5),
        conv_b=zeros(n, di),
        x_proj=dense(r + 2 * ns, di),
        dt_proj=dense(di, r),
        dt_bias=torch.full((n, di), -4.6, dtype=_dtype(cfg), device=dev),
        A_log=a_log.expand(n, di, ns).contiguous(),
        D=torch.ones((n, di), dtype=torch.float32, device=dev),
        out_proj=dense(cfg.d_model, di),
    )


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
                window: Optional[int],
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
                                          window=window)
        else:                           # prefill into the cache
            # attend over the updated cache at the chunk's offset so that
            # earlier chunks' keys are visible; rows past the chunk are
            # causally masked, so unwritten cache rows are inert
            o = kops.attention(q, cache["k"], cache["v"], causal=True,
                               window=window, q_offset=start)
    else:
        o = kops.attention(q, k, v, causal=True, window=window,
                           q_offset=start)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return L.linear(o, p["wo"], engine=engine, path="layers/attn/wo")


def _layer_apply(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                 window: Optional[int] = None,
                 cache: Optional[Dict[str, Any]] = None,
                 cache_pos: Optional[attn_lib.Pos] = None,
                 lengths: Optional[torch.Tensor] = None,
                 engine: Optional[Any] = None) -> torch.Tensor:
    """One layer.  ``cache`` is the layer's slice of the serve cache,
    {"kv": {"k", "v"}, "ssm": {"h", "conv"}} as the family has them; the KV
    rows and the SSM state are written in place."""
    ssm_state = cache.get("ssm") if cache is not None else None

    def mixer(h):
        return ssm_lib.mamba_mixer(
            h, p["ssm"], d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
            dt_rank=cfg.dt_rank, conv_k=cfg.ssm_conv,
            shard_inner=cfg.ssm_shard_inner, state=ssm_state,
            lengths=lengths, engine=engine, in_place=True)[0]

    if "attn" in p:
        h = L.apply_norm(x, p.get("attn_norm"), cfg.norm_type)
        a = _attn_apply(h, p["attn"], cfg, window=window,
                        cache=cache.get("kv") if cache is not None else None,
                        cache_pos=cache_pos, engine=engine)
        if cfg.family == "hybrid":
            # hymba: attention and SSM heads run in parallel on the same
            # normalised input; their outputs are averaged
            a = 0.5 * (a + mixer(h))
        x = x + a
    elif "ssm" in p:                                # pure SSM family
        h = L.apply_norm(x, p.get("ssm_norm"), cfg.norm_type)
        x = x + mixer(h)
    if "moe" in p:
        h = L.apply_norm(x, p.get("mlp_norm"), cfg.norm_type)
        x = x + moe_lib.moe_apply(
            h, p["moe"], n_experts=cfg.n_experts, k=cfg.n_experts_active,
            capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
            groups=max(cfg.moe_groups, 1), engine=engine)
    elif "mlp" in p:
        h = L.apply_norm(x, p.get("mlp_norm"), cfg.norm_type)
        x = x + L.mlp(h, p["mlp"], cfg.mlp_act, engine=engine,
                      path="layers/mlp")
    return x


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Per-layer attention window (``transformer.py:278-288``): hymba's
    global layers -- first, last and evenly spaced middles -- get 2**30."""
    if cfg.window is None:
        return [None] * cfg.n_layers
    w = [cfg.window] * cfg.n_layers
    if cfg.n_global_layers:
        for i in np.linspace(0, cfg.n_layers - 1,
                             cfg.n_global_layers).round().astype(np.int32):
            w[int(i)] = 2 ** 30
    return w


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


def _prefix(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Prepend hymba's meta tokens (``transformer.py:306-315``)."""
    if not cfg.n_meta_tokens:
        return x
    meta = params["meta_tokens"][None].expand(
        x.shape[0], cfg.n_meta_tokens, cfg.d_model).to(x.dtype)
    return torch.cat([meta, x], dim=1)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            engine: Optional[Any] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, n_meta_tokens + S, V)."""
    check_family(cfg)
    x = _prefix(params, _embed(params, tokens, cfg), cfg)
    for p, w in zip(layer_params(params, cfg), layer_windows(cfg)):
        x = _layer_apply(x, p, cfg, window=w, engine=engine)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: prefill + decode with the stacked per-layer cache
# ---------------------------------------------------------------------------

def init_serve_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked per-layer cache: "kv" for the attention families, "ssm"
    (f32 state h and the conv window) for the SSM and hybrid families."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {}
    if cfg.family in ("dense", "moe", "hybrid"):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
        cache["kv"] = dict(k=torch.zeros(shape, dtype=dt, device=dev),
                           v=torch.zeros(shape, dtype=dt, device=dev))
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = dict(
            h=torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
                          dtype=torch.float32, device=dev),
            conv=torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                              cfg.d_inner), dtype=dt, device=dev))
    return cache


def step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
         pos: attn_lib.Pos, cfg: ModelConfig, *,
         engine: Optional[Any] = None,
         layers: Optional[List[Params]] = None,
         add_prefix: bool = True,
         lengths: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Serve step: run ``tokens`` (B, S) through the model, reading and
    writing the stacked cache at ``pos`` (scalar, or (B,) per batch row).
    S == 1 is decode, S > 1 prefill.  The cache is updated in place and
    returned.  ``layers`` may pass a cached :func:`layer_params` list.

    On prefill the meta-token prefix is prepended as in :func:`forward`,
    unless ``add_prefix=False`` (chunks after the first); the logits cover
    the last S (token) positions only, and ``pos`` must count the prefix
    (the first decode position is prefix + prompt length).

    ``lengths`` (B,) is each row's count of real tokens in a right-padded
    prefill chunk; the SSM mixer treats the pads as exact state no-ops.
    """
    check_family(cfg)
    s_tokens = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    if s_tokens > 1 and add_prefix:
        x = _prefix(params, x, cfg)
    if lengths is not None and s_tokens > 1:
        # the prepended prefix tokens are real positions too
        lengths = lengths + (x.shape[1] - s_tokens)
    parts = {name: cache[name] for name in ("kv", "ssm") if name in cache}
    for i, (p, w) in enumerate(zip(
            layers if layers is not None else layer_params(params, cfg),
            layer_windows(cfg))):
        layer_cache = {name: {k: t[i] for k, t in part.items()}
                       for name, part in parts.items()}
        x = _layer_apply(x, p, cfg, window=w, cache=layer_cache,
                         cache_pos=pos,
                         lengths=lengths if s_tokens > 1 else None,
                         engine=engine)
    return _head(params, x[:, -s_tokens:], cfg), cache
