"""Port parity: the VLM family (llava-next-34b) through
``repro_torch.models.vlm`` / ``transformer``, ``launch.steps``, the serving
engine and the launcher, against the JAX package on the smoke config, with
the JAX weights carried over by ``repro_torch.interop``.

Logits and caches agree within 1e-4 (absolute and relative): both sides
compute in f32 and differ only in summation order.  Greedy tokens are
equal: through the serve steps with patches, and through the engine and the
launcher with text prompts, as the reference's engine serves the family
(plain, preempted, KV-paged)."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.placement import PlacementPlan as JPlan  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.placement import PlacementPlan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.serving import Request, Scheduler, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "llava-next-34b"


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(2))
    return cfg, tget(ARCH).smoke(), params


@pytest.fixture(scope="module")
def frozen(model):
    """{bits: (JAX packed tree, port packed tree)}."""
    cfg, tcfg, params = model
    out = {}
    for bits in (8, 4):
        packed = jfreeze(params, bits=bits)
        out[bits] = (packed, _carry(packed, tcfg))
    return out


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _patches(cfg, b, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.n_patches, cfg.d_model)) * 0.02
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _engine(bits):
    return None if bits is None else dict(scenario="l1mram", mode="xla",
                                          bits=bits)


def test_init_params_has_the_reference_structure(model):
    cfg, tcfg, params = model
    tparams = vlm.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    ref = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
           for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): (tuple(x.shape),
                                     str(x.dtype).replace("torch.", ""))
           for p, x in jax.tree_util.tree_leaves_with_path(tparams)}
    assert got == ref
    assert "lm_head" in tparams                    # untied head


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_forward_with_patches(model, frozen, bits):
    cfg, tcfg, params = model
    jtree, ttree = (params, _carry(params, tcfg)) if bits is None \
        else frozen[bits]
    toks, pat = _tokens((2, 10)), _patches(cfg, 2)
    expect = jvlm.forward(jtree, jnp.asarray(toks), jnp.asarray(pat), cfg,
                          engine=_engine(bits))
    got = vlm.forward(ttree, _t(toks).long(), _t(pat), tcfg,
                      engine=_engine(bits))
    assert got.shape == (2, cfg.n_patches + 10, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_prefill_then_decode_step(model, frozen, bits):
    """Patches + prompt prefill, then decode steps from n_patches +
    prompt_len: logits and the KV cache agree."""
    cfg, tcfg, _ = model
    jtree, ttree = frozen[bits]
    toks, pat = _tokens((2, 6)), _patches(cfg, 2)
    max_len = cfg.n_patches + 16
    jcache = jtfm.init_serve_cache(cfg, 2, max_len)
    tcache = tfm.init_serve_cache(tcfg, 2, max_len, device="cpu")
    eng = _engine(bits)
    jl, jcache = jvlm.prefill(jtree, jnp.asarray(toks), jnp.asarray(pat),
                              jcache, cfg, engine=eng)
    tl, tcache = vlm.prefill(ttree, _t(toks).long(), _t(pat), tcache, tcfg,
                             engine=eng)
    assert tl.shape == (2, 6, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = cfg.n_patches + 6
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jcache = jvlm.decode_step(jtree, jnp.asarray(nxt), jcache,
                                      jnp.int32(pos + i), cfg, engine=eng)
        tl, tcache = vlm.decode_step(ttree, _t(nxt).long(), tcache, pos + i,
                                     tcfg, engine=eng)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["kv"][name].numpy(),
                                   np.asarray(jcache["kv"][name]), **TOL)


def _greedy(prefill, decode, tree, first_args, cache, pos, n, to_host,
            as_tokens, as_pos):
    logits, cache = prefill(tree, *first_args, cache)
    out = []
    for i in range(n):
        nxt = to_host(logits[:, -1]).argmax(-1).astype(np.int32)[:, None]
        out.append(nxt[:, 0].tolist())
        logits, cache = decode(tree, as_tokens(nxt), cache, as_pos(pos + i))
    return out


def test_serve_steps_greedy_tokens(model, frozen):
    """``make_prefill_step`` on patches + prompt, then 8 greedy
    ``make_decode_step`` steps: the tokens equal JAX's."""
    cfg, tcfg, _ = model
    jtree, ttree = frozen[8]
    toks, pat = _tokens((2, 7), seed=4), _patches(cfg, 2, seed=5)
    max_len = cfg.n_patches + 7 + 8
    expect = _greedy(jsteps.make_prefill_step(cfg),
                     jsteps.make_decode_step(cfg), jtree,
                     (jnp.asarray(pat), jnp.asarray(toks)),
                     jtfm.init_serve_cache(cfg, 2, max_len),
                     cfg.n_patches + 7, 8, np.asarray, jnp.asarray,
                     jnp.int32)
    got = _greedy(steps.make_prefill_step(tcfg),
                  steps.make_decode_step(tcfg), ttree,
                  (_t(pat), _t(toks).long()),
                  tfm.init_serve_cache(tcfg, 2, max_len, device="cpu"),
                  cfg.n_patches + 7, 8, lambda t: t.numpy(),
                  lambda a: _t(a).long(), int)
    assert got == expect


def test_vlm_loss_is_refused(model):
    """No longer refused: ``vlm_loss`` trains, and equals the reference's
    on the same weights and batch (text positions scored, patches not)."""
    cfg, tcfg, params = model
    rng = np.random.default_rng(3)
    batch = dict(tokens=rng.integers(0, 256, (1, 4)).astype(np.int32),
                 labels=rng.integers(0, 256, (1, 4)).astype(np.int32),
                 patches=rng.normal(size=(1, tcfg.n_patches, tcfg.d_model)
                                    ).astype(np.float32))
    want = jvlm.vlm_loss(params, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg)
    got = vlm.vlm_loss(_carry(params, tcfg),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the serving engine, text prompts (the reference's own cases) ----------

def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _engine_tokens(port, cfg, tree, prompts, max_new, **kw):
    eng = (ServingEngine if port else JEngine)(
        cfg, tree, batch_slots=2, max_len=64, prefill_chunk=8,
        **(dict(device="cpu") if port else {}), **kw)
    for uid, p in enumerate(prompts):
        eng.submit((Request if port else JRequest)(uid=uid, prompt=p,
                                                   max_new_tokens=max_new))
    return {r.uid: r.generated for r in eng.run_until_done()}


@pytest.mark.parametrize("lengths", [(8, 8, 8), (3, 13, 22, 6)])
def test_engine_tokens_equal_jax(model, frozen, lengths):
    """Bucketed prefill as in the reference (pow2 buckets, chunks past 8)."""
    cfg, tcfg, _ = model
    jtree, ttree = frozen[8]
    prompts = _prompts(lengths)
    expect = _engine_tokens(False, cfg, jtree, prompts, 5)
    got = _engine_tokens(True, tcfg, ttree, prompts, 5)
    assert got == expect
    assert all(len(t) == 5 for t in got.values())


def _preempted(port, cfg, tree, prompts, max_new, *, warm_ticks,
               urgent_uid):
    """The reference's ``_serve_with_preempt``: one slot, the urgent
    request injected on a priority-2 stream after ``warm_ticks``."""
    eng = (ServingEngine if port else JEngine)(
        cfg, tree, batch_slots=1, max_len=64,
        plan=(PlacementPlan if port else JPlan).uniform(),
        **(dict(device="cpu") if port else {}))
    s = (Scheduler if port else JScheduler)(eng, prefill_chunk=8,
                                            preemptive=True)
    s.add_stream("urgent", priority=2)
    make = Request if port else JRequest
    reqs = [make(uid=u, prompt=p, max_new_tokens=n)
            for u, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        if r.uid != urgent_uid:
            s.submit(r)
    done = []
    for _ in range(warm_ticks):
        done += s.tick()
    s.submit(reqs[urgent_uid], stream="urgent")
    done += s.run_until_done()
    return {r.uid: r.generated for r in done}, eng


def test_engine_preempted_equals_jax(model, frozen):
    cfg, tcfg, _ = model
    jtree, ttree = frozen[8]
    prompts = _prompts((7, 5), seed=6)
    expect, jeng = _preempted(False, cfg, jtree, prompts, [8, 2],
                              warm_ticks=4, urgent_uid=1)
    got, eng = _preempted(True, tcfg, ttree, prompts, [8, 2], warm_ticks=4,
                          urgent_uid=1)
    assert got == expect
    assert eng.preempt_count == eng.restore_count == 1
    assert (jeng.preempt_count, jeng.restore_count) == (1, 1)


def test_engine_kv_paged_equals_jax(model, frozen):
    """KV paging with blocks of 4 rows, Scheduler-driven, as the
    reference's ``test_kv_paged_decode_bit_exact_vlm``."""
    cfg, tcfg, _ = model
    jtree, ttree = frozen[8]
    prompts = _prompts([4 + 5 * u for u in range(3)], seed=7)

    def run(port):
        eng = (ServingEngine if port else JEngine)(
            tcfg if port else cfg, ttree if port else jtree, batch_slots=2,
            max_len=64, **(dict(device="cpu") if port else {}))
        eng.attach_kv_paging(4)
        s = (Scheduler if port else JScheduler)(eng, prefill_chunk=8)
        for uid, p in enumerate(prompts):
            s.submit((Request if port else JRequest)(uid=uid, prompt=p,
                                                     max_new_tokens=6))
        done = {r.uid: r.generated for r in s.run_until_done()}
        swaps = eng.kv_table.swap_count
        eng.kv_table.close()
        return done, swaps

    expect, jswaps = run(False)
    got, swaps = run(True)
    assert got == expect
    assert swaps == jswaps > 0


# -- the launcher -----------------------------------------------------------

def test_launcher_serve_equals_reference(model):
    """Both launchers' ``_serve`` on one JAX-frozen llava tree (drawn with
    the reference's seed), KV-paged with preemption: equal tokens, ticks
    and KV counters."""
    cfg, tcfg, _ = model
    args = serve._parser().parse_args(["--smoke", "--device", "cpu"])
    vars(args).update(requests=4, max_new=4, max_len=64, prefill_chunk=8,
                      kv_block=4, token_budget=16, preemptive=True,
                      deadline_ms=20.0)
    packed = jfreeze(jtfm.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    done, sched, eng = serve._serve(tcfg, _carry(packed, tcfg),
                                    PlacementPlan.uniform("l1mram", bits=8),
                                    args, False, kv_paged=True)
    jdone, jsched, jeng = jserve._serve(cfg, packed,
                                        JPlan.uniform("l1mram", bits=8),
                                        args, False, kv_paged=True)
    assert {r.uid: r.generated for r in done} == {
        r.uid: r.generated for r in jdone}
    assert len(done) == 4 and sched.ticks == jsched.ticks
    assert eng.kv_table.swap_count == jeng.kv_table.swap_count > 0
    for e in (eng, jeng):
        e.kv_table.close()


def test_launcher_main_arch_verify_lines(capsys):
    done = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--max-new", "4",
                       "--budget-mb", "0.4", "--kv-paged", "--kv-block", "4",
                       "--preemptive", "--token-budget", "64"])
    out = capsys.readouterr().out
    assert len(done) == 4
    assert "verify: paged tokens BIT-EXACT vs resident plan" in out
    assert ("verify: async tokens BIT-EXACT vs sync streaming, counters "
            "unchanged by overlap") in out


def test_launcher_main_models_verify_lines(capsys):
    tenants = ("qwen3-0.6b", ARCH)
    serve.main(["--smoke", "--device", "cpu", "--models", ",".join(tenants),
                "--requests", "3", "--max-new", "3", "--kv-paged"])
    out = capsys.readouterr().out
    for arch in tenants:
        assert f"verify {arch}: tokens BIT-EXACT vs solo private pager" in out
    assert ("pool counters (incl. wire/raw bytes) MATCH the static "
            "kv_pass_counters prediction") in out
