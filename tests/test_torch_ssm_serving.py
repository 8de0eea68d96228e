"""Port parity: the SSM family (falcon-mamba-7b) and the hybrid family
(hymba-1.5b) through ``repro_torch.models.transformer`` and the serving
engine, against ``repro.models.transformer`` and the JAX ``ServingEngine``
on the smoke configs, with the JAX weights frozen at 8 bits and carried
over by ``repro_torch.interop``.

Logits and states agree within 2e-4 (absolute and relative): both sides
compute in f32, and the port's scan runs one step after another where the
reference runs a chunked associative scan (the tolerance of
``test_moe_ssm.py``).  Greedy tokens are equal per uid: SSM prompts longer
than ``prefill_chunk`` go through several pow2 buckets carrying the state,
hymba prompts longer than its smoke window of 16 prefill in one shot behind
8 meta tokens.  Prompt lengths are few, since each costs a JAX compile."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE = dict(scenario="l1mram", mode="xla", bits=8)
ARCHS = ("falcon-mamba-7b", "hymba-1.5b")
# falcon: lengths around prefill_chunk = 8 (buckets 4 and 8, several chunks);
# hymba: two lengths, one beyond the smoke window of 16
LENGTHS = {"falcon-mamba-7b": (21, 5, 13, 21, 5, 13),
           "hymba-1.5b": (20, 5, 20, 5, 20, 5)}
SLOTS, MAX_LEN, CHUNK, MAX_NEW = 2, 64, 8, 5


def _prompts(arch, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENGTHS[arch]]


def _parked(eng, make, prompts, params):
    """Slot 0 decodes while slot 1 is still prefilling (falcon: after the
    first of its three chunks; hymba, whose prefill is one shot: before it
    starts), then both run to the end."""
    eng.assign(make(0, prompts[0]), 0)
    eng.prefill_tick(params, complete=False)
    eng.assign(make(1, prompts[1]), 1)
    if eng.cfg.family == "ssm":
        eng.prefill_tick(params, complete=False)
    eng.decode_tick(params)
    eng.decode_tick(params)
    while eng.pending:
        eng.prefill_tick(params, complete=False)
        eng.decode_tick(params)
    return {r.uid: r.generated for r in eng.finished}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The arch's smoke model frozen at 8 bits, and the JAX engine's tokens
    for the mixed requests and for the parked-slot sequence."""
    arch = request.param
    cfg = get_config(arch).smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    packed = jfreeze(params, bits=8)
    tcfg = tget(arch).smoke()
    tpacked = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, packed), tcfg, device="cpu")
    prompts = _prompts(arch)
    eng = JEngine(cfg, packed, batch_slots=SLOTS, max_len=MAX_LEN,
                  engine=ENGINE, prefill_chunk=CHUNK)
    for uid, p in enumerate(prompts):
        eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    mixed = {r.uid: r.generated for r in eng.run_until_done()}
    eng = JEngine(cfg, packed, batch_slots=SLOTS, max_len=MAX_LEN,
                  engine=ENGINE, prefill_chunk=CHUNK)
    parked = _parked(eng, lambda u, p: JRequest(uid=u, prompt=p,
                                                max_new_tokens=MAX_NEW),
                     [prompts[0][:5], prompts[0]], packed)
    return dict(arch=arch, cfg=cfg, packed=packed, tcfg=tcfg,
                tpacked=tpacked, prompts=prompts, mixed=mixed,
                parked=parked)


def _port_engine(m, **kw):
    return ServingEngine(m["tcfg"], m["tpacked"], batch_slots=SLOTS,
                         max_len=MAX_LEN, engine=ENGINE, device="cpu",
                         prefill_chunk=CHUNK, **kw)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_forward_matches(served):
    m = served
    toks = _tokens((2, 20), 1)
    expect = jtfm.forward(m["packed"], jnp.asarray(toks), m["cfg"],
                          engine=ENGINE)
    got = tfm.forward(m["tpacked"], torch.from_numpy(toks).long(), m["tcfg"],
                      engine=ENGINE)
    assert got.shape == (2, m["cfg"].n_meta_tokens + 20,
                         m["cfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_step_prefill_then_decode_matches(served):
    """Prefill (with the prefix), a second chunk at per-row offsets with
    per-row lengths, then per-row decode: logits and every cache part."""
    m = served
    cfg, tcfg = m["cfg"], m["tcfg"]
    b, pre = 2, cfg.n_meta_tokens
    jcache = jtfm.init_serve_cache(cfg, b, MAX_LEN)
    tcache = tfm.init_serve_cache(tcfg, b, MAX_LEN, device="cpu")

    def both(toks, pos, add_prefix=True, lengths=None):
        nonlocal jcache, tcache
        jl, jcache = jtfm.step(
            m["packed"], jnp.asarray(toks), jcache,
            jnp.asarray(pos, jnp.int32), cfg, engine=ENGINE,
            add_prefix=add_prefix,
            lengths=None if lengths is None else jnp.asarray(lengths))
        tl, tcache = tfm.step(
            m["tpacked"], torch.from_numpy(toks).long(), tcache,
            torch.tensor(pos, dtype=torch.int32), tcfg, engine=ENGINE,
            add_prefix=add_prefix,
            lengths=None if lengths is None else torch.tensor(lengths))
        rows = lengths if lengths is not None else [toks.shape[1]] * b
        for j, n in enumerate(rows):
            np.testing.assert_allclose(tl[j, :n].numpy(),
                                       np.asarray(jl)[j, :n], **TOL)
        for part, names in jtfm.init_serve_cache(cfg, 1, 1).items():
            for n in names:
                np.testing.assert_allclose(tcache[part][n].numpy(),
                                           np.asarray(jcache[part][n]), **TOL)

    both(_tokens((b, 8), 2), [0, 0])
    lens = [8, 3] if cfg.family == "ssm" else None
    both(_tokens((b, 8), 3), [pre + 8, pre + 8], add_prefix=False,
         lengths=lens)
    done = [pre + 16, pre + 16] if lens is None else [pre + 16, pre + 11]
    for t in range(3):
        both(_tokens((b, 1), 4 + t), [p + t for p in done])


def test_greedy_tokens_match_per_uid(served):
    """Six requests over two slots: chunked SSM prefill carrying the state
    across chunks, reused slots starting cold."""
    m = served
    eng = _port_engine(m)
    for uid, p in enumerate(m["prompts"]):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    got = {r.uid: r.generated for r in eng.run_until_done()}
    assert got == m["mixed"]
    assert all(len(t) == MAX_NEW for t in got.values())


def test_reused_slot_starts_cold(served):
    m = served
    prompt = m["prompts"][0]
    eng = _port_engine(m)
    eng.submit(Request(uid=0, prompt=m["prompts"][1], max_new_tokens=3))
    eng.run_until_done()
    assert eng.cache["ssm"]["h"][:, 0].abs().sum() > 0     # dirty slot
    eng.assign(Request(uid=1, prompt=prompt, max_new_tokens=MAX_NEW), 0)
    assert eng.cache["ssm"]["h"][:, 0].abs().sum() == 0
    eng.run_until_done()
    assert eng.finished[-1].generated == m["mixed"][0]


def test_preempt_restore_is_bit_exact(served):
    m = served
    prompts = m["prompts"][:2]
    eng = _port_engine(m)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    eng.step()                     # prefill, first token, one decode
    ckpt = eng.preempt(0)
    assert ckpt.ssm is not None and ckpt.ssm["h"].device.type == "cpu"
    assert (ckpt.kv is not None) == ("kv" in eng.cache)
    eng.step()                     # slot 0 is free meanwhile
    eng.restore(ckpt, 0)
    eng.run_until_done()
    got = {r.uid: r.generated for r in eng.finished}
    assert got == {u: m["mixed"][u] for u in (0, 1)}
    assert eng.preempt_count == 1 and eng.restore_count == 1


def test_parked_slot_keeps_its_state(served):
    m = served
    eng = _port_engine(m)
    got = _parked(eng, lambda u, p: Request(uid=u, prompt=p,
                                            max_new_tokens=MAX_NEW),
                  [m["prompts"][0][:5], m["prompts"][0]], m["tpacked"])
    assert got == m["parked"]


def test_meta_token_rules(served):
    m = served
    eng = _port_engine(m)
    pre = m["cfg"].n_meta_tokens
    if pre:
        with pytest.raises(ValueError, match="meta-token"):
            eng.submit(Request(uid=0, prompt=np.array([3], np.int32)))
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(Request(uid=0, prompt=np.zeros(MAX_LEN - pre, np.int32)))
    eng.submit(Request(uid=1, prompt=m["prompts"][0], max_new_tokens=2))
    eng.step()
    assert eng.slot_pos[0] == pre + len(m["prompts"][0]) + 1


def test_interop_round_trip(served):
    """The JAX smoke tree, float and frozen, carries over leaf for leaf and
    back, dtypes included."""
    m = served
    params = jtfm.init_params(m["cfg"], jax.random.PRNGKey(0))
    for tree in (params, m["packed"]):
        np_tree = jax.tree_util.tree_map(np.asarray, tree)
        back = interop.params_to_numpy(interop.params_from_numpy(
            np_tree, m["tcfg"], device="cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(np_tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)
            assert flat_b[path].dtype == leaf.dtype


def test_init_params_has_the_reference_structure(served):
    """Same leaves, shapes and dtypes as the reference's init; A_log, D and
    dt_bias hold the reference's values."""
    m = served
    params = jtfm.init_params(m["cfg"], jax.random.PRNGKey(0))
    tparams = tfm.init_params(m["tcfg"], torch.Generator().manual_seed(0),
                              device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                  for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got_shapes = {jax.tree_util.keystr(p): (tuple(x.shape),
                                           str(x.dtype).replace("torch.", ""))
                  for p, x in jax.tree_util.tree_leaves_with_path(tparams)}
    assert got_shapes == ref_shapes
    for name in ("A_log", "D", "dt_bias"):
        np.testing.assert_array_equal(
            tparams["layers"]["ssm"][name].numpy(),
            np.asarray(params["layers"]["ssm"][name]))


# hymba's segmented_window_scan path (transformer.py:321-347) and its
# q-blocked windowed_attention (attention.py:99-141), within 1e-4 as the
# dense LM's parity tests

SEG_TOL = dict(rtol=1e-4, atol=1e-4)

@pytest.mark.parametrize("sq,bq,window", [
    # ragged S (windows 1, 16 and >= S), S < bq, S not a multiple of bq
    (37, 16, 1), (37, 16, 16), (37, 16, 64),
    (20, 512, 16), (20, 512, 20),
    (100, 32, 16), (100, 32, 5),
])
def test_windowed_attention_matches_jax(sq, bq, window):
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn

    rng = np.random.default_rng(sq + bq + window)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, sq, 16)).astype(np.float32)
            for _ in range(2))
    expect = jattn.windowed_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=window, bq=bq)
    got = attn.windowed_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window, bq=bq)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **SEG_TOL)


@pytest.fixture(scope="module")
def hymba():
    """hymba's smoke config (window 16, layer 0 global) with the flag set,
    its JAX params and the 8-bit frozen tree, each carried over."""
    cfg = get_config("hymba-1.5b").smoke().replace(
        segmented_window_scan=True)
    tcfg = tget("hymba-1.5b").smoke().replace(segmented_window_scan=True)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(4))
    packed = jfreeze(params, bits=8)
    trees = {None: (params, interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")),
        8: (packed, interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, packed), tcfg,
            device="cpu"))}
    return cfg, tcfg, trees


@pytest.mark.parametrize("bits,s", [(None, 40), (8, 40), (8, 9)])
def test_segmented_forward_matches_jax(hymba, bits, s):
    """Against JAX's segmented ``forward``: the window binds at 40 tokens
    (48 positions with the meta tokens), not at 9."""
    cfg, tcfg, trees = hymba
    jtree, ttree = trees[bits]
    assert tfm.segmented(tcfg)
    eng = None if bits is None else ENGINE
    toks = _tokens((2, s), seed=s)
    expect = jtfm.forward(jtree, jnp.asarray(toks), cfg, engine=eng)
    got = tfm.forward(ttree, torch.from_numpy(toks).long(), tcfg, engine=eng)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **SEG_TOL)


@pytest.mark.parametrize("bits", [None, 8])
def test_segmented_forward_equals_unsegmented(hymba, bits):
    """The same model without the flag: the windowed layers then see
    ``window=cfg.window`` through the flash kernel's plain version."""
    _cfg, tcfg, trees = hymba
    _, ttree = trees[bits]
    toks = torch.from_numpy(_tokens((2, 40), seed=8)).long()
    seg = tfm.forward(ttree, toks, tcfg, engine=ENGINE if bits else None)
    flat = tfm.forward(ttree, toks, tcfg.replace(segmented_window_scan=False),
                       engine=ENGINE if bits else None)
    np.testing.assert_allclose(seg.numpy(), flat.numpy(), **SEG_TOL)


def test_segmented_routes_by_device(hymba, monkeypatch):
    """On the CPU the sliding-window layer calls ``windowed_attention`` and
    the global layer the flash wrapper; ``step`` ignores the flag."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as attn

    _cfg, tcfg, trees = hymba
    _, ttree = trees[8]
    calls = []
    real_win, real_fa = attn.windowed_attention, kops.attention
    monkeypatch.setattr(attn, "windowed_attention", lambda *a, **k: (
        calls.append(("win", k["window"])) or real_win(*a, **k)))
    monkeypatch.setattr(kops, "attention", lambda *a, **k: (
        calls.append(("flash", k.get("window"))) or real_fa(*a, **k)))
    toks = torch.from_numpy(_tokens((1, 20), seed=9)).long()
    tfm.forward(ttree, toks, tcfg, engine=ENGINE)
    assert calls == [("flash", None), ("win", tcfg.window)]
    calls.clear()
    cache = tfm.init_serve_cache(tcfg, 1, 64, device="cpu")
    tfm.step(ttree, toks, cache, 0, tcfg, engine=ENGINE)
    assert calls == [("flash", 2 ** 30), ("flash", tcfg.window)]
