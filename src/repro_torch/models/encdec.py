"""Whisper-style encoder-decoder backbone (reference:
``repro/models/encdec.py:24-246``).

The conv / mel frontend is a stub, as in the reference: callers pass
precomputed frame embeddings (B, n_audio_frames, d_model).  The backbone
follows the reference: an encoder with sinusoid positions and bidirectional
attention, a decoder with learned positions (``dec_pos``), causal
self-attention and cross-attention over the encoder states, layernorm with
bias and GELU MLPs with biases throughout.  The parameter tree and the
placement paths (``enc_layers/attn/wq``, ``dec_layers/xattn/wk``, ...) are
the reference's, so ``interop`` carries a JAX tree over and one
``PlacementPlan`` addresses the same leaves in both packages.

Packed linears go through the Hopper ``qmatmul_f32`` kernel.  The reference
computes every attention of this module with the jnp
``chunked_attention``; the port's serving sends the encoder's
self-attention, the decoder's prefill self-attention and every
cross-attention through its flash kernel (``kernels.ops.attention``; not
causal for the encoder and the cross-attention), as the decoder-only
families' prefill does, and decode self-attention through
``attention.decode_attention`` in torch ops.  The kernels are
forward-only, so training (``seq2seq_loss``) runs ``encode`` and
``decode`` with ``train=True``: every attention through
``attention.chunked_attention``, as the reference's ``_mha`` does.

The serve path follows the reference where it is odd: prefill
self-attention attends over the chunk's own keys at offset 0, not over the
cache, ``step`` adds ``dec_pos[pos : pos + S]``, and decode
cross-attention runs over all ``n_audio_frames`` keys.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

# learned decoder positions: the reference's 4,096 + 32,768 rows
N_DEC_POS = 4096 + 32768


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: models.encdec runs the 'encdec' "
                         f"family, not {cfg.family!r}")
    # the reference's encoder-decoder never reads attn_dtype (or scan_dtype):
    # its attention computes in f32 whatever the config says, and so does
    # this module's


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) f32: sin of the angles, then cos (``encdec.py:24-28``)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters with the reference's tree (``encdec.py:50-63``):
    ``embed``, ``dec_pos``, the stacked ``enc_layers`` and ``dec_layers``,
    ``enc_final_norm`` and ``final_norm``.  Drawn on the generator's device
    (default: a CPU generator seeded 0) and moved to ``device`` (default
    ``cuda``)."""
    check_family(cfg)
    g = (generator if generator is not None
         else torch.Generator().manual_seed(0))
    dev = resolve_device(device)
    enc = tfm.Draw(cfg, g, dev, cfg.n_encoder_layers)
    dec = tfm.Draw(cfg, g, dev, cfg.n_layers)
    d = cfg.d_model
    return dict(
        embed=enc.normal((cfg.vocab_size, d), 0.02),
        dec_pos=enc.normal((N_DEC_POS, d), 0.01),
        enc_layers=dict(attn_norm=enc.norm(d), attn=enc.attn(),
                        mlp_norm=enc.norm(d), mlp=enc.mlp(cfg.d_ff)),
        dec_layers=dict(attn_norm=dec.norm(d), attn=dec.attn(),
                        xattn_norm=dec.norm(d), xattn=dec.attn(),
                        mlp_norm=dec.norm(d), mlp=dec.mlp(cfg.d_ff)),
        enc_final_norm=enc.norm(d, stacked=False),
        final_norm=enc.norm(d, stacked=False),
    )


def _heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, H * hd) -> (B, H, S, hd)."""
    b, s, _ = t.shape
    return t.reshape(b, s, heads, hd).transpose(1, 2)


def _merge(o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, H, S, hd) -> (B, S, H * hd)."""
    b, _, s, _ = o.shape
    return o.transpose(1, 2).reshape(b, s, cfg.q_dim)


def _mha(x: torch.Tensor, kv_src: torch.Tensor, p: Params, cfg: ModelConfig,
         *, causal: bool, engine: Optional[Any] = None,
         path: Optional[str] = None, train: bool = False) -> torch.Tensor:
    """Attention of ``x``'s queries over ``kv_src``'s keys and values
    (``encdec.py:66-85``), through the flash kernel, or with ``train``
    through ``chunked_attention`` in differentiable torch ops.  In the
    train step on a rank mesh, where "model" splits the heads
    (``layers.head_split``), the rank attends with its heads and ``o`` is
    gathered over "model" before ``wo``."""
    sub = L._subpath
    axis = L.head_split(p, cfg.n_heads, cfg.n_kv_heads)
    if axis is None:
        n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
        q = L.linear(x, p["wq"], engine=engine, path=sub(path, "wq"))
        k = L.linear(kv_src, p["wk"], engine=engine, path=sub(path, "wk"))
        v = L.linear(kv_src, p["wv"], engine=engine, path=sub(path, "wv"))
    else:
        n_q, n_kv = cfg.n_heads // axis.size, cfg.n_kv_heads // axis.size
        xc = axis.copy(x)
        kc = xc if kv_src is x else axis.copy(kv_src)
        q = L.column(xc, p["wq"])
        k, v = L.column(kc, p["wk"]), L.column(kc, p["wv"])
    q, k, v = _heads(q, n_q, cfg.hd), _heads(k, n_kv, cfg.hd), _heads(
        v, n_kv, cfg.hd)
    q_offset = k.shape[2] - q.shape[2] if causal else 0
    if train:
        o = attn_lib.chunked_attention(q, k, v, causal=causal,
                                       q_offset=q_offset,
                                       block=cfg.attn_block)
    else:
        o = kops.attention(q, k, v, causal=causal, q_offset=q_offset)
    b, _, s, _ = o.shape
    o = o.transpose(1, 2).reshape(b, s, n_q * cfg.hd)
    if axis is not None:
        o = axis.gather(o, -1)
    return L.linear(o, p["wo"], engine=engine, path=sub(path, "wo"))


def enc_layer_apply(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                    engine: Optional[Any] = None,
                    train: bool = False) -> torch.Tensor:
    h = L.apply_norm(x, p.get("attn_norm"), cfg.norm_type)
    x = x + _mha(h, h, p["attn"], cfg, causal=False, engine=engine,
                 path="enc_layers/attn", train=train)
    h = L.apply_norm(x, p.get("mlp_norm"), cfg.norm_type)
    return x + L.mlp(h, p["mlp"], cfg.mlp_act, engine=engine,
                     path="enc_layers/mlp")


def dec_train_layer_apply(x: torch.Tensor, enc_out: torch.Tensor, p: Params,
                          cfg: ModelConfig, *, engine: Optional[Any] = None,
                          train: bool = False) -> torch.Tensor:
    """One decoder layer without a cache: causal self-attention,
    cross-attention over the encoder states, MLP (``encdec.py:98-113``)."""
    h = L.apply_norm(x, p.get("attn_norm"), cfg.norm_type)
    x = x + _mha(h, h, p["attn"], cfg, causal=True, engine=engine,
                 path="dec_layers/attn", train=train)
    h = L.apply_norm(x, p.get("xattn_norm"), cfg.norm_type)
    x = x + _mha(h, enc_out, p["xattn"], cfg, causal=False, engine=engine,
                 path="dec_layers/xattn", train=train)
    h = L.apply_norm(x, p.get("mlp_norm"), cfg.norm_type)
    return x + L.mlp(h, p["mlp"], cfg.mlp_act, engine=engine,
                     path="dec_layers/mlp")


def _layers(params: Params, key: str, n: int, engine: Optional[Any]):
    """The stacked ``params[key]``'s layers in order: views, or on a rank
    mesh each fetched whole just before its use
    (``transformer.layer_fetch``)."""
    fetch = tfm.layer_fetch(engine)
    if fetch is None:
        yield from tfm.unstack(params[key], n)
    else:
        for i in range(n):
            yield fetch(key, i)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           engine: Optional[Any] = None, train: bool = False
           ) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D);
    ``train`` attends in differentiable torch ops (see :func:`_mha`)."""
    check_family(cfg)
    dt = tfm._dtype(cfg)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model,
                                  frames.device).to(dt)[None]
    for p in _layers(params, "enc_layers", cfg.n_encoder_layers, engine):
        x = enc_layer_apply(x, p, cfg, engine=engine, train=train)
    return L.apply_norm(x, params.get("enc_final_norm"), cfg.norm_type)


def decode(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, *, engine: Optional[Any] = None,
           train: bool = False) -> torch.Tensor:
    """tokens (B, S) + encoder states -> logits (B, S, V); ``train`` as in
    :func:`encode`."""
    check_family(cfg)
    dt = tfm._dtype(cfg)
    s = tokens.shape[1]
    x = L.embed(tokens, params["embed"]).to(dt) + params["dec_pos"][
        None, :s].to(dt)
    for p in _layers(params, "dec_layers", cfg.n_layers, engine):
        x = dec_train_layer_apply(x, enc_out, p, cfg, engine=engine,
                                  train=train)
    x = L.apply_norm(x, params.get("final_norm"), cfg.norm_type)
    return L.unembed(x, params["embed"])


def seq2seq_loss(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, engine: Optional[Any] = None,
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over the encoded
    ``batch["frames"]`` (``encdec.py:144-151``); batch: frames (B, T, D),
    tokens (B, S), labels (B, S), optional loss_mask.  ``denom``: see
    ``transformer.token_nll``."""
    enc_out = encode(params, batch["frames"], cfg, engine=engine, train=True)
    return tfm.token_nll(decode(params, batch["tokens"], enc_out, cfg,
                                engine=engine, train=True), batch, denom,
                         vocab=L.vocab_split(params["embed"]))


# -- serving: decoder KV cache + precomputed cross-attention KV -------------

def init_serve_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The decoder's stacked self-attention cache "kv" and the
    cross-attention keys / values "xk", "xv" over ``n_audio_frames``."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = tfm._dtype(cfg)
    n, h, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def zeros(rows):
        return torch.zeros((n, batch, h, rows, hd), dtype=dt, device=dev)

    return dict(kv=dict(k=zeros(max_len), v=zeros(max_len)),
                xk=zeros(cfg.n_audio_frames), xv=zeros(cfg.n_audio_frames))


def precompute_cross_kv(params: Params, enc_out: torch.Tensor,
                        cfg: ModelConfig, cache: Dict[str, Any], *,
                        engine: Optional[Any] = None) -> Dict[str, Any]:
    """Every decoder layer's cross-attention keys and values of
    ``enc_out``, computed once: a new cache dict with "xk", "xv"."""
    check_family(cfg)
    xk, xv = [], []
    for p in tfm.unstack(params["dec_layers"], cfg.n_layers):
        xk.append(_heads(L.linear(enc_out, p["xattn"]["wk"], engine=engine,
                                  path="dec_layers/xattn/wk"),
                         cfg.n_kv_heads, cfg.hd))
        xv.append(_heads(L.linear(enc_out, p["xattn"]["wv"], engine=engine,
                                  path="dec_layers/xattn/wv"),
                         cfg.n_kv_heads, cfg.hd))
    dt = tfm._dtype(cfg)
    return dict(cache, xk=torch.stack(xk).to(dt), xv=torch.stack(xv).to(dt))


def dec_layer_apply(x: torch.Tensor, p: Params,
                    layer_cache: Dict[str, torch.Tensor], xk: torch.Tensor,
                    xv: torch.Tensor, pos: attn_lib.Pos, cfg: ModelConfig, *,
                    engine: Optional[Any] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer of the serve path: self-attention (the new rows
    written into ``layer_cache`` in place), cross-attention over the
    precomputed ``xk`` / ``xv``, MLP (``encdec.py:183-227``)."""
    s = x.shape[1]
    h = L.apply_norm(x, p.get("attn_norm"), cfg.norm_type)
    a = p["attn"]
    q = _heads(L.linear(h, a["wq"], engine=engine, path="dec_layers/attn/wq"),
               cfg.n_heads, cfg.hd)
    k = _heads(L.linear(h, a["wk"], engine=engine, path="dec_layers/attn/wk"),
               cfg.n_kv_heads, cfg.hd)
    v = _heads(L.linear(h, a["wv"], engine=engine, path="dec_layers/attn/wv"),
               cfg.n_kv_heads, cfg.hd)
    kv = attn_lib.update_cache(layer_cache, k, v, pos)
    if s == 1:                          # decode: plain PyTorch ops
        o = attn_lib.decode_attention(q, kv["k"], kv["v"], cache_len=pos + 1)
    else:                               # prefill: the chunk's own keys
        o = kops.attention(q, k, v, causal=True, q_offset=0)
    x = x + L.linear(_merge(o, cfg), a["wo"], engine=engine,
                     path="dec_layers/attn/wo")
    h = L.apply_norm(x, p.get("xattn_norm"), cfg.norm_type)
    q = _heads(L.linear(h, p["xattn"]["wq"], engine=engine,
                        path="dec_layers/xattn/wq"), cfg.n_heads, cfg.hd)
    o = kops.attention(q, xk, xv, causal=False, q_offset=0)
    x = x + L.linear(_merge(o, cfg), p["xattn"]["wo"], engine=engine,
                     path="dec_layers/xattn/wo")
    h = L.apply_norm(x, p.get("mlp_norm"), cfg.norm_type)
    x = x + L.mlp(h, p["mlp"], cfg.mlp_act, engine=engine,
                  path="dec_layers/mlp")
    return x, kv


def _dec_positions(dec_pos: torch.Tensor, pos: attn_lib.Pos,
                   s: int) -> torch.Tensor:
    """``dec_pos`` rows [pos, pos + s), the start clamped so the rows fit as
    ``jax.lax.dynamic_slice_in_dim`` clamps it: (1, s, D), or (B, s, D) for
    a (B,) ``pos``."""
    top = dec_pos.shape[0] - s
    if isinstance(pos, torch.Tensor):
        start = torch.clamp(pos.to(device=dec_pos.device, dtype=torch.long),
                            0, top)
        return dec_pos[start.reshape(-1, 1)
                       + torch.arange(s, device=dec_pos.device)]
    start = min(max(int(pos), 0), top)
    return dec_pos[None, start:start + s]


def step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
         pos: attn_lib.Pos, cfg: ModelConfig, *,
         engine: Optional[Any] = None
         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder serve step (S == 1 decode, S > 1 prefill) with
    cross-attention; ``cache`` (from :func:`precompute_cross_kv`) has its
    self-attention rows written in place and is returned."""
    check_family(cfg)
    dt = tfm._dtype(cfg)
    s = tokens.shape[1]
    x = (L.embed(tokens, params["embed"]).to(dt)
         + _dec_positions(params["dec_pos"], pos, s).to(dt))
    kv = cache["kv"]
    for i, p in enumerate(tfm.unstack(params["dec_layers"], cfg.n_layers)):
        x, _ = dec_layer_apply(x, p, {"k": kv["k"][i], "v": kv["v"][i]},
                               cache["xk"][i], cache["xv"][i], pos, cfg,
                               engine=engine)
    x = L.apply_norm(x, params.get("final_norm"), cfg.norm_type)
    return L.unembed(x, params["embed"]), cache
