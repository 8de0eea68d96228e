"""Decoder-only LM: init / forward / prefill / decode for the dense, MoE, SSM,
hybrid and VLM families (reference: ``repro/models/transformer.py:24-470``).

Parameters keep the reference's tree: nested dicts of tensors with the
layers stacked on axis 0, so ``interop`` carries a JAX tree over leaf for
leaf.  The reference scans the stacked layers with ``jax.lax.scan``; here a
Python loop walks them.  Packed linears go through the Hopper ``qmatmul_f32``
kernel (the MoE experts' through its grouped launch, ``models/moe.py``),
``forward`` / prefill ``step`` attention through the Hopper flash kernel and
every SSM scan through the Hopper selective-scan kernel (``kernels.ops``);
decode attention stays in PyTorch ops.

Training (``lm_loss``, ``transformer.py:367-380``) runs none of the Hopper
kernels, which are forward-only: ``forward(train=True)`` computes attention
with ``models/attention.chunked_attention`` and the SSM scan with the
reference's chunked associative scan (``models/ssm.selective_scan``), as
the reference's training path does, and wraps each layer in
``torch.utils.checkpoint`` when ``cfg.remat`` is set, as ``jax.checkpoint``
wraps the reference's scan body.  Every family of this module trains.

The SSM family (falcon-mamba) is attention-free; the hybrid family (hymba)
runs attention and SSM heads in parallel on the same normalised input,
mixes sliding-window and global attention layers, and prepends learned meta
tokens.  The MoE family (qwen2-moe, arctic) replaces the dense MLP with
top-k routed experts, a shared expert and arctic's dense residual.  The VLM
family (llava) is the dense LM with patch embeddings prepended as prompt
positions (``extra_embeds``; ``models/vlm.py``).  With
``segmented_window_scan`` hymba's sliding-window layers run with a static
window (``transformer.py:321-347``): on the CPU through the q-blocked
``attention.windowed_attention``, on the card through the flash kernel with
the window, whose tile walk skips the hidden keys.  The encoder-decoder
family (whisper) has its own module, ``models/encdec.py``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree as T
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def compute_dtypes(cfg: ModelConfig) -> Tuple[torch.dtype, torch.dtype]:
    """(attention, scan) compute dtypes: ``cfg.attn_dtype`` and
    ``cfg.scan_dtype`` (``float32`` or ``bfloat16``)."""
    return getattr(torch, cfg.attn_dtype), getattr(torch, cfg.scan_dtype)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# the families whose layers attend (and so keep a KV cache)
ATTENTION_FAMILIES = ("dense", "moe", "hybrid", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family runs in "
            "repro_torch.models.encdec (serve steps: "
            "repro_torch.launch.steps.make_prefill_step), not in the "
            "decoder-only transformer")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Draw:
    """The reference's initialisers (``transformer.py:33-113``) over one
    generator: every leaf is drawn in f32 on the generator's device and
    moved to ``dev`` in ``cfg.dtype``; ``n`` is the stacked layer count of
    the ``dense`` / ``zeros`` / ``norm`` / ``attn`` / ``mlp`` leaves.  The
    encoder-decoder family draws its two stacks through it too.

    With ``bits``, each drawn weight named ``name`` is frozen the moment it
    is drawn (``sharding.freeze_leaf``, the rule ``freeze_for_serving``
    applies leaf by leaf), before the next one is drawn: the f32 tree never
    exists whole, and no two stacked f32 weights are alive at once."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator,
                 dev: torch.device, n: int, bits: Optional[int] = None):
        self.cfg, self.g, self.dev, self.n = cfg, g, dev, n
        self.dt = _dtype(cfg)
        self.bits = bits

    def normal(self, shape, std, name: str = "") -> Any:
        if self.dev.type == "meta":       # shapes only: nothing is drawn
            w = torch.empty(shape, dtype=self.dt, device=self.dev)
        else:
            w = torch.randn(shape, generator=self.g, dtype=torch.float32,
                            device=self.g.device)
            w.mul_(std)                   # in place: no second f32 copy
            w = w.to(device=self.dev, dtype=self.dt)
        if self.bits is None:
            return w
        return sharding.freeze_leaf(name, w, self.bits, self.dev)

    def weights(self, **specs: Tuple[Tuple[int, ...], float]) -> Params:
        """Each ``key=(shape, std)`` drawn in order under its key, which
        names it for ``freeze_leaf``; each is frozen before the next is
        drawn."""
        return {key: self.normal(shape, std, key)
                for key, (shape, std) in specs.items()}

    def dense(self, out_d: int, in_d: int) -> Tuple[Tuple[int, ...], float]:
        """A stacked (out_d, in_d) weight's (shape, std) for ``weights``."""
        return (self.n, out_d, in_d), in_d ** -0.5

    def zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dt, device=self.dev)

    def norm(self, d: int, stacked: bool = True) -> Params:
        cfg = self.cfg
        lead = (self.n,) if stacked else ()
        if cfg.norm_type == "nonparam_ln":
            return {}
        if cfg.norm_type == "layernorm":
            return dict(scale=torch.ones(lead + (d,), dtype=self.dt,
                                         device=self.dev),
                        bias=self.zeros(*lead, d))
        return dict(scale=self.zeros(*lead, d))    # rmsnorm (1 + s)

    def attn(self) -> Params:
        cfg, n = self.cfg, self.n
        attn = self.weights(wq=self.dense(cfg.q_dim, cfg.d_model),
                            wk=self.dense(cfg.kv_dim, cfg.d_model),
                            wv=self.dense(cfg.kv_dim, cfg.d_model),
                            wo=self.dense(cfg.d_model, cfg.q_dim))
        if cfg.qkv_bias:
            attn.update(bq=self.zeros(n, cfg.q_dim),
                        bk=self.zeros(n, cfg.kv_dim),
                        bv=self.zeros(n, cfg.kv_dim))
        if cfg.qk_norm:
            attn.update(q_norm=self.zeros(n, cfg.hd),
                        k_norm=self.zeros(n, cfg.hd))
        return attn

    def mlp(self, d_ff: int) -> Params:
        cfg, n = self.cfg, self.n
        if cfg.mlp_act in ("swiglu", "geglu"):
            return self.weights(w_gate=self.dense(d_ff, cfg.d_model),
                                w_up=self.dense(d_ff, cfg.d_model),
                                w_down=self.dense(cfg.d_model, d_ff))
        return dict(**self.weights(w_up=self.dense(d_ff, cfg.d_model),
                                   w_down=self.dense(cfg.d_model, d_ff)),
                    b_up=self.zeros(n, d_ff),
                    b_down=self.zeros(n, cfg.d_model))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, bits: Optional[int] = None
                ) -> Params:
    """Random parameters with the reference's structure and distributions.

    Weights are drawn on the generator's device (default: a CPU generator
    seeded 0) and moved to ``device`` (default ``cuda``).  The draws differ
    from ``jax.random``'s, so parity tests carry JAX weights over through
    ``interop`` instead.

    With ``bits`` the tree comes out frozen for serving, each weight packed
    as soon as it is drawn (:class:`Draw`): it equals
    ``freeze_for_serving(init_params(cfg, g), bits=bits)`` bit for bit,
    leaf for leaf, from a generator in the same state, while the device
    holds at most one f32 weight and its packed form beside the packed tree
    so far (llava-next-34b: a 35.2 GB f32 leaf at most, where the whole f32
    tree is 137 GB).
    """
    check_family(cfg)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    draw = Draw(cfg, g, resolve_device(device), cfg.n_layers, bits)
    layers: Params = {}
    if cfg.family in ATTENTION_FAMILIES:
        layers.update(attn_norm=draw.norm(cfg.d_model), attn=draw.attn())
    if cfg.family in ("ssm", "hybrid"):
        layers.update(ssm_norm=draw.norm(cfg.d_model),
                      ssm=_ssm_params(cfg, draw))
    if cfg.family == "moe":
        layers.update(mlp_norm=draw.norm(cfg.d_model),
                      moe=_moe_params(cfg, draw))
    elif cfg.family != "ssm":           # dense / hybrid / vlm: a dense MLP
        layers.update(mlp_norm=draw.norm(cfg.d_model),
                      mlp=draw.mlp(cfg.d_ff))
    params: Params = dict(
        **draw.weights(embed=((cfg.vocab_size, cfg.d_model), 0.02)),
        final_norm=draw.norm(cfg.d_model, stacked=False),
        layers=layers,
    )
    if not cfg.tie_embeddings:
        params.update(draw.weights(lm_head=((cfg.vocab_size, cfg.d_model),
                                            cfg.d_model ** -0.5)))
    if cfg.n_meta_tokens:
        params.update(draw.weights(
            meta_tokens=((cfg.n_meta_tokens, cfg.d_model), 0.02)))
    return params


def _moe_params(cfg: ModelConfig, draw: Draw) -> Params:
    """The MoE block's stacked leaves (``transformer.py:78-97``): a router,
    the experts' (E, F, D) / (E, D, F) weights, and the shared expert and
    arctic's dense residual as plain MLPs."""
    e, f, d, n = cfg.n_experts, cfg.moe_d_ff, cfg.d_model, draw.n
    p = draw.weights(router=draw.dense(e, d),
                     w_gate=((n, e, f, d), d ** -0.5),
                     w_up=((n, e, f, d), d ** -0.5),
                     w_down=((n, e, d, f), f ** -0.5))
    if cfg.shared_d_ff:
        p["shared"] = draw.mlp(cfg.shared_d_ff)
    if cfg.dense_residual_d_ff:
        p["dense"] = draw.mlp(cfg.dense_residual_d_ff)
    return p


def _ssm_params(cfg: ModelConfig, draw: Draw) -> Params:
    """The mixer's stacked leaves (``transformer.py:98-113``): A_log, D and
    dt_bias keep the reference's values and dtypes."""
    di, ns, r, k = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    n, dev = draw.n, draw.dev
    # numpy's f32 log, not torch.log: the reference's log(7) is one ulp
    # above the correctly rounded value that torch.log returns, numpy's
    # f32 log gives the reference's
    a_log = torch.from_numpy(np.log(np.arange(1, ns + 1, dtype=np.float32))
                             ).to(dev)
    return dict(
        **draw.weights(in_proj=draw.dense(2 * di, cfg.d_model),
                       conv_w=((n, di, k), k ** -0.5),
                       x_proj=draw.dense(r + 2 * ns, di),
                       dt_proj=draw.dense(di, r),
                       out_proj=draw.dense(cfg.d_model, di)),
        conv_b=draw.zeros(n, di),
        dt_bias=torch.full((n, di), -4.6, dtype=_dtype(cfg), device=dev),
        A_log=a_log.expand(n, di, ns).contiguous(),
        D=torch.ones((n, di), dtype=torch.float32, device=dev),
    )


def count_params(params: Any) -> int:
    return sum(p.numel() for p in T.leaves(params))


def unstack(stacked: Params, n: int) -> List[Params]:
    """A tree of leaves stacked on axis 0 as ``n`` dicts of views."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]
    return [take(stacked, i) for i in range(n)]


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """The stacked layer tree as one dict of views per layer."""
    return unstack(params["layers"], cfg.n_layers)


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _attn_apply(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                window: Optional[int],
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos: Optional[attn_lib.Pos] = None,
                engine: Optional[Any] = None,
                attend: Optional[Callable] = None) -> torch.Tensor:
    """``attend`` replaces the flash kernel where no cache is given (the
    training path's ``chunked_attention``).  Every branch computes in
    ``cfg.attn_dtype``, as the reference's ``_attn_apply`` does.

    In the train step on a rank mesh, where "model" splits the heads
    (``layers.head_split``), q, k and v stay the rank's heads through the
    qk-norm, RoPE and attention, and ``o`` is gathered over "model" before
    ``wo``."""
    b, s, _ = x.shape
    adt = compute_dtypes(cfg)[0]
    hd = cfg.hd
    axis = (L.head_split(p, cfg.n_heads, cfg.n_kv_heads) if cache is None
            else None)
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    if axis is None:
        q = L.linear(x, p["wq"], engine=engine, path="layers/attn/wq",
                     bias=p.get("bq"))
        k = L.linear(x, p["wk"], engine=engine, path="layers/attn/wk",
                     bias=p.get("bk"))
        v = L.linear(x, p["wv"], engine=engine, path="layers/attn/wv",
                     bias=p.get("bv"))
        norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else None
    else:
        n_q, n_kv = n_q // axis.size, n_kv // axis.size
        xc = axis.copy(x)
        q, k, v = (L.column(xc, p[w], bias=p.get(bias)) for w, bias in
                   (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        # the norms' scales act on the rank's heads only: their gradient
        # is summed over "model"
        norms = (axis.copy(torch.stack([p["q_norm"], p["k_norm"]]))
                 if cfg.qk_norm else None)
    q = q.reshape(b, s, n_q, hd).transpose(1, 2)
    k = k.reshape(b, s, n_kv, hd).transpose(1, 2)
    v = v.reshape(b, s, n_kv, hd).transpose(1, 2)
    if norms is not None:
        q = L.rmsnorm(q, norms[0])
        k = L.rmsnorm(k, norms[1])
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
                                          window=window, compute_dtype=adt)
        else:                           # prefill into the cache
            # attend over the updated cache at the chunk's offset so that
            # earlier chunks' keys are visible; rows past the chunk are
            # causally masked, so unwritten cache rows are inert
            o = kops.attention(q, cache["k"], cache["v"], causal=True,
                               window=window, q_offset=start,
                               compute_dtype=adt)
    else:
        o = (attend or kops.attention)(q, k, v, causal=True, window=window,
                                       q_offset=start, compute_dtype=adt)
    o = o.transpose(1, 2).reshape(b, s, n_q * hd)
    if axis is not None:
        o = axis.gather(o, -1)
    return L.linear(o, p["wo"], engine=engine, path="layers/attn/wo")


def _layer_apply(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                 window: Optional[int] = None,
                 cache: Optional[Dict[str, Any]] = None,
                 cache_pos: Optional[attn_lib.Pos] = None,
                 lengths: Optional[torch.Tensor] = None,
                 engine: Optional[Any] = None,
                 attend: Optional[Callable] = None,
                 scan: Optional[Callable] = None) -> torch.Tensor:
    """One layer.  ``cache`` is the layer's slice of the serve cache,
    {"kv": {"k", "v"}, "ssm": {"h", "conv"}} as the family has them; the KV
    rows and the SSM state are written in place.  ``attend`` and ``scan``
    replace the flash and scan kernels (the training path's)."""
    ssm_state = cache.get("ssm") if cache is not None else None

    def mixer(h):
        return ssm_lib.mamba_mixer(
            h, p["ssm"], d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
            dt_rank=cfg.dt_rank, conv_k=cfg.ssm_conv,
            shard_inner=cfg.ssm_shard_inner, state=ssm_state,
            lengths=lengths, engine=engine, in_place=True, scan=scan,
            scan_dtype=compute_dtypes(cfg)[1])[0]

    if "attn" in p:
        h = L.apply_norm(x, p.get("attn_norm"), cfg.norm_type)
        a = _attn_apply(h, p["attn"], cfg, window=window,
                        cache=cache.get("kv") if cache is not None else None,
                        cache_pos=cache_pos, engine=engine, attend=attend)
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


def _prefix(params: Params, x: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prepend VLM patch embeddings and then hymba's meta tokens
    (``transformer.py:306-315``)."""
    prefix = []
    if extra_embeds is not None:
        prefix.append(extra_embeds.to(device=x.device, dtype=x.dtype))
    if cfg.n_meta_tokens:
        prefix.append(params["meta_tokens"][None].expand(
            x.shape[0], cfg.n_meta_tokens, cfg.d_model).to(x.dtype))
    return torch.cat(prefix + [x], dim=1) if prefix else x


def segmented(cfg: ModelConfig) -> bool:
    """Whether ``forward`` takes hymba's segmented path (``transformer.py:
    321-347``): global layers without a window, the sliding-window layers
    with the static ``cfg.window``."""
    return bool(cfg.segmented_window_scan and cfg.window is not None
                and cfg.n_global_layers)


def _windowed(q, k, v, *, causal: bool, window: int, q_offset,
              compute_dtype: torch.dtype) -> torch.Tensor:
    return attn_lib.windowed_attention(q, k, v, window=window,
                                       q_offset=q_offset,
                                       compute_dtype=compute_dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            engine: Optional[Any] = None, train: bool = False,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, P + n_meta_tokens + S, V), with
    ``extra_embeds`` (B, P, D) (VLM patches) prepended.

    ``train`` selects the training path (``lm_loss``): attention by
    ``chunked_attention`` and the SSM scan by ``ssm.selective_scan`` (chunks
    of ``cfg.ssm_chunk``), in differentiable torch ops, instead of the
    forward-only flash and scan kernels, and with ``cfg.remat`` each layer's
    activations recomputed in the backward pass instead of kept.

    With ``segmented_window_scan`` (hymba) the global layers attend without
    a window and the sliding-window layers with ``cfg.window``: on the card
    through the flash kernel, on the CPU (and when training) through the
    q-blocked ``windowed_attention``, as the reference's fast path does."""
    check_family(cfg)
    x = _prefix(params, _embed(params, tokens, cfg), cfg, extra_embeds)
    attend = (functools.partial(attn_lib.chunked_attention,
                                block=cfg.attn_block) if train else None)
    scan = (functools.partial(ssm_lib.selective_scan, chunk=cfg.ssm_chunk,
                              compute_dtype=compute_dtypes(cfg)[1])
            if train else None)
    windows = layer_windows(cfg)
    attends = [attend] * cfg.n_layers
    if segmented(cfg):
        win_attend = (_windowed if train or x.device.type == "cpu"
                      else None)
        attends = [attend if w != cfg.window else win_attend
                   for w in windows]
        windows = [w if w == cfg.window else None for w in windows]
    fetch = layer_fetch(engine)
    if fetch is None:
        plist, apply = layer_params(params, cfg), _layer_apply
    else:
        plist = [functools.partial(fetch, "layers", i)
                 for i in range(cfg.n_layers)]
        apply = _fetched_layer_apply
    for p, w, att in zip(plist, windows, attends):
        layer = functools.partial(apply, p=p, cfg=cfg, window=w,
                                  engine=engine, attend=att, scan=scan)
        if train and cfg.remat:
            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x = layer(x)
    return _head(params, x, cfg)


def layer_fetch(engine: Optional[Any]) -> Optional[Callable]:
    """``engine["layer_fetch"]``: the sharded train step's source of whole
    layer leaves, ``fetch(key, i)`` -> layer ``i`` of the stacked
    ``params[key]``, read in place of :func:`layer_params` (inside the
    layer's ``remat`` region, so a remat layer fetches again in the
    backward; ``launch/dist_steps.make_distributed_train_step``).  None on
    one device."""
    return engine.get("layer_fetch") if isinstance(engine, dict) else None


def _fetched_layer_apply(x: torch.Tensor, p: Callable, **kw) -> torch.Tensor:
    return _layer_apply(x, p(), **kw)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, engine: Optional[Any] = None,
            denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy (``transformer.py:367-380``).  batch:
    tokens (B, S), labels (B, S), optional loss_mask, and for the VLM family
    patches (B, P, D), which carry no labels.  ``denom``: see
    :func:`token_nll`."""
    logits = forward(params, batch["tokens"], cfg, engine=engine, train=True,
                     extra_embeds=batch.get("patches"))
    return token_nll(logits[:, -batch["labels"].shape[1]:], batch, denom,
                     vocab=L.vocab_split(params.get("lm_head",
                                                    params["embed"])))


def token_nll(logits: torch.Tensor, batch: Dict[str, torch.Tensor],
              denom: Optional[torch.Tensor] = None,
              vocab: Optional[Any] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``batch["labels"]`` (B, S) under
    ``logits`` (B, S, V), over ``batch["loss_mask"]`` where there is one.
    ``denom`` replaces the count of those tokens: a rank of the sharded
    train step divides its rows' sum by the whole batch's count, so that
    the ranks' losses add up to the batch's mean
    (``launch/dist_steps.make_distributed_train_step``).

    ``vocab`` (``layers.vocab_split``): ``logits`` are the rank's vocab
    block (B, S, V / M) of the head split over "model"; the log-softmax
    is vocab-parallel (the max and the sum of exponentials reduced over
    "model", the label's logit from the rank that holds it), and no rank
    forms whole logits."""
    labels = batch["labels"].long()
    if vocab is None:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    else:
        ll = _vocab_ll(logits.to(torch.float32), labels, vocab)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    if denom is None:
        denom = torch.clamp(torch.sum(mask), min=1.0)
    return -torch.sum(ll * mask) / denom


def _vocab_ll(logits: torch.Tensor, labels: torch.Tensor,
              vocab: Any) -> torch.Tensor:
    """log softmax(logits)[labels] from each model rank's vocab block of
    the f32 logits: the row max over "model" (no gradient; it cancels),
    then the sum of exp(logit - max) and the label's logit (zero on the
    ranks that do not hold it) summed over "model" in one all-reduce."""
    axis, n = vocab.axis, logits.shape[-1]
    top = axis.max(torch.amax(logits.detach(), dim=-1, keepdim=True))
    local = labels - vocab.start
    ours = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, torch.where(
        ours, local, torch.zeros_like(local))[..., None])[..., 0]
    both = axis.sum(torch.stack([
        torch.sum(torch.exp(logits - top), dim=-1),
        torch.where(ours, picked, torch.zeros_like(picked))], dim=-1))
    return both[..., 1] - (top[..., 0] + torch.log(both[..., 0]))


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
    if cfg.family in ATTENTION_FAMILIES:
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
         lengths: Optional[torch.Tensor] = None,
         extra_embeds: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Serve step: run ``tokens`` (B, S) through the model, reading and
    writing the stacked cache at ``pos`` (scalar, or (B,) per batch row).
    S == 1 is decode, S > 1 prefill.  The cache is updated in place and
    returned.  ``layers`` may pass a cached :func:`layer_params` list.

    On prefill the prefix -- ``extra_embeds`` (VLM patches), then the meta
    tokens -- is prepended as in :func:`forward`, unless
    ``add_prefix=False`` (chunks after the first); the logits cover the
    last S (token) positions only, and ``pos`` must count the prefix (the
    first decode position is prefix + prompt length).  The step ignores
    ``segmented_window_scan``, as the reference's does.

    ``lengths`` (B,) is each row's count of real tokens in a right-padded
    prefill chunk; the SSM mixer treats the pads as exact state no-ops.
    """
    check_family(cfg)
    s_tokens = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    if s_tokens > 1 and add_prefix:
        x = _prefix(params, x, cfg, extra_embeds)
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


# ---------------------------------------------------------------------------
# parameter counts (``transformer.py:477-527``): plain arithmetic on cfg
# ---------------------------------------------------------------------------

def _mixer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    n = 0
    if cfg.family in ("dense", "moe", "hybrid", "vlm", "encdec"):
        n += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        n += (d * 2 * di + di * cfg.ssm_conv
              + di * (cfg.dt_rank + 2 * cfg.ssm_state)
              + cfg.dt_rank * di + di * d)
    return n


def _ffn_params(cfg: ModelConfig, experts: int) -> int:
    d = cfg.d_model
    if cfg.family == "moe":
        n = 3 * d * cfg.moe_d_ff * experts
        if cfg.shared_d_ff:
            n += 3 * d * cfg.shared_d_ff
        if cfg.dense_residual_d_ff:
            n += 3 * d * cfg.dense_residual_d_ff
        return n + d * cfg.n_experts                  # router
    if cfg.family == "ssm":
        return 0
    mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    return mult * d * cfg.d_ff


def _param_count(cfg: ModelConfig, experts: int) -> int:
    d = cfg.d_model
    n = cfg.n_layers * (_mixer_params(cfg) + _ffn_params(cfg, experts))
    n += cfg.vocab_size * d                   # embedding / unembedding
    return n + cfg.n_encoder_layers * (4 * d * d + 2 * d * cfg.d_ff)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE counts only active experts)."""
    return _param_count(cfg, cfg.n_experts_active)


def total_param_count(cfg: ModelConfig) -> int:
    return _param_count(cfg, cfg.n_experts)
