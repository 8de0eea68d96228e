"""Port parity: the serving engine.  The quickstart's greedy requests
(``examples/quickstart.py:53-60``) served by the JAX engine and by the port's
engine on ``device="cpu"`` give the same tokens per uid; chunked prefill,
preemption and the device rule are checked on the port alone."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.paging import KVPageTable  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ARCH = "qwen3-0.6b"
ENGINE = dict(scenario="l1mram", mode="xla", bits=8)


@pytest.fixture(scope="module")
def served():
    cfg = get_config(ARCH).smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    packed = jfreeze(params, bits=8)
    tcfg = tget(ARCH).smoke()
    tpacked = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, packed), tcfg, device="cpu")
    return cfg, packed, tcfg, tpacked


def _prompts(n=6, lo=8, hi=9, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _serve_jax(cfg, packed, prompts, max_new=8, **kw):
    eng = JEngine(cfg, packed, batch_slots=4, max_len=128, engine=ENGINE, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=max_new))
    return {r.uid: r.generated for r in eng.run_until_done()}


def _serve_port(tcfg, tpacked, prompts, max_new=8, **kw):
    eng = ServingEngine(tcfg, tpacked, batch_slots=4, max_len=128,
                        engine=ENGINE, device="cpu", **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    return {r.uid: r.generated for r in eng.run_until_done()}


def test_quickstart_requests_same_tokens_per_uid(served):
    cfg, packed, tcfg, tpacked = served
    prompts = _prompts()
    expect = _serve_jax(cfg, packed, prompts)
    got = _serve_port(tcfg, tpacked, prompts)
    assert set(got) == set(range(6))
    assert got == expect
    assert all(len(t) == 8 for t in got.values())


def test_chunked_prefill_mixed_lengths_same_tokens(served):
    """Prompts longer than the prefill chunk go through several pow2
    buckets at per-row offsets and kv spans."""
    cfg, packed, tcfg, tpacked = served
    prompts = _prompts(n=5, lo=3, hi=23, seed=3)
    expect = _serve_jax(cfg, packed, prompts, max_new=5, prefill_chunk=4)
    got = _serve_port(tcfg, tpacked, prompts, max_new=5, prefill_chunk=4)
    assert got == expect


def test_preempt_restore_is_bit_exact(served):
    _cfg, _packed, tcfg, tpacked = served
    prompts = _prompts(n=2, lo=6, hi=12, seed=5)
    expect = _serve_port(tcfg, tpacked, prompts, max_new=6)
    eng = ServingEngine(tcfg, tpacked, batch_slots=4, max_len=128,
                        device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    eng.step()                       # prefill, first token, one decode
    eng.step()                       # a second decode
    ckpt = eng.preempt(0)
    # the prompt's rows and the rows of the two decoded inputs
    assert ckpt.valid == len(prompts[0]) + 2
    assert ckpt.kv["k"].device.type == "cpu"
    eng.step()                                   # slot 0 is free meanwhile
    eng.restore(ckpt, 3)
    eng.run_until_done()
    got = {r.uid: r.generated for r in eng.finished}
    assert got == expect
    assert eng.preempt_count == 1 and eng.restore_count == 1


def test_engine_without_a_card_raises(served, monkeypatch):
    _cfg, _packed, tcfg, tpacked = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, tpacked)
    eng = ServingEngine(tcfg, tpacked, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVPageTable(eng.cache["kv"])           # a table defaults to the card
    eng.attach_kv_paging()                     # the engine's device: the CPU
    assert eng.kv_table.device.type == "cpu"
    eng.kv_table.close()


def test_sampling_uses_the_explicit_generator(served):
    _cfg, _packed, tcfg, tpacked = served
    prompts = _prompts(n=2)

    def run(seed):
        eng = ServingEngine(tcfg, tpacked, batch_slots=2, max_len=64,
                            device="cpu", seed=seed)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6,
                               temperature=1.0))
        return {r.uid: r.generated for r in eng.run_until_done()}

    assert run(7) == run(7)
    assert all(0 <= t < tcfg.vocab_size for ts in run(7).values() for t in ts)
