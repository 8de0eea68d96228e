"""Port parity: the serving launcher (``repro_torch.launch.serve``) against
the reference's (``repro.launch.serve``).

Both packages' ``_serve`` / ``_serve_tenants`` are fed one JAX-frozen tree
(carried across with ``interop``) and one args namespace, and must give
equal tokens per uid, equal swap / miss (and KV) counters, equal ticks and
equal pool counters.  The port's ``main`` on the CPU must exit 0 with its
verify lines BIT-EXACT (``--mesh`` too), and refuse the encdec family.
The VLM family's launcher cases are in ``test_torch_vlm.py``."""

import argparse
import inspect
import json
import re
import zlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.paging import SharedPagePool as JPool  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.paging import SharedPagePool  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import validate  # noqa: E402

ARCH = "qwen3-0.6b"
TENANTS = ("qwen3-0.6b", "falcon-mamba-7b")


def _args(**kw):
    """The launcher's defaults, smoke-sized, with ``kw`` on top; the JAX
    launcher ignores ``device``."""
    ns = serve._parser().parse_args(["--smoke", "--device", "cpu"])
    vars(ns).update(requests=4, max_new=4, max_len=64, prefill_chunk=8,
                    kv_block=4,
                    **kw)
    return ns


@pytest.fixture(scope="module")
def trees():
    """{arch: (JAX cfg, JAX packed tree, port cfg, port tree)}, each drawn
    with the seed the reference's ``_build_model`` gives it."""
    out = {}
    for arch in TENANTS:
        jcfg, tcfg = jget(arch).smoke(), get_config(arch).smoke()
        seed = zlib.crc32(arch.encode()) % (1 << 31)
        packed = jfreeze(jtfm.init_params(jcfg, jax.random.PRNGKey(seed)),
                         bits=8)
        out[arch] = (jcfg, packed, tcfg, interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, packed), tcfg,
            device="cpu"))
    return out


def _plans(jtree, ttree, budget):
    sizes, jsizes = placement.packed_sizes(ttree), jplacement.packed_sizes(
        jtree)
    assert sizes == jsizes
    kw = dict(sizes_bits=8)
    plan = placement.plan_for_budget(
        sizes, budget, hot=placement.Placement("l1mram", 8, "resident"),
        cold=placement.Placement("l3flash", 8, "paged"), **kw)
    jplan = jplacement.plan_for_budget(
        jsizes, budget, hot=jplacement.Placement("l1mram", 8, "resident"),
        cold=jplacement.Placement("l3flash", 8, "paged"), **kw)
    assert [(n, p.residency) for n, p in plan.rules] == [
        (n, p.residency) for n, p in jplan.rules]
    return plan, jplan


def _tokens(done):
    return {r.uid: list(r.generated) for r in done}


def _close(eng):
    for part in (eng.pager, eng.kv_table):
        if part is not None:
            part.close()


@pytest.mark.parametrize("leg", ["resident", "paged-async", "kv-paged"])
def test_serve_equals_reference(trees, leg):
    jcfg, jtree, tcfg, ttree = trees[ARCH]
    args = _args(token_budget=16, preemptive=True, deadline_ms=20.0)
    if leg == "resident":
        plan = placement.PlacementPlan.uniform("l1mram", bits=8)
        jplan = jplacement.PlacementPlan.uniform("l1mram", bits=8)
        paged, kv = False, False
    else:
        total = sum(placement.packed_sizes(ttree).values())
        plan, jplan = _plans(jtree, ttree, total // 2)
        paged, kv = True, leg == "kv-paged"
    done, sched, eng = serve._serve(tcfg, ttree, plan, args, paged,
                                    kv_paged=kv)
    jdone, jsched, jeng = jserve._serve(jcfg, jtree, jplan, args, paged,
                                        kv_paged=kv)
    assert _tokens(done) == _tokens(jdone)
    assert len(done) == args.requests
    assert sched.ticks == jsched.ticks
    assert (eng.swap_count, eng.miss_count) == (jeng.swap_count,
                                                jeng.miss_count)
    if paged:
        assert eng.swap_count > 0
    pg, jpg = eng.paging_summary(), jeng.paging_summary()
    for k in ("kv_swaps", "kv_pool_hits", "kv_writebacks", "kv_dropped",
              "bytes_streamed_wire", "bytes_streamed_raw"):
        assert pg.get(k) == jpg.get(k), k
    if kv:
        assert pg["kv_swaps"] > 0
    summ = sched.metrics.summary()
    jsumm = jsched.metrics.summary()
    assert summ["scheduler"] == jsumm["scheduler"]
    assert summ["requests"]["tokens_out"] == jsumm["requests"]["tokens_out"]
    for e in (eng, jeng):
        _close(e)


@pytest.mark.parametrize("kv,io", [(False, "async"), (True, "sync")])
def test_serve_tenants_equal_reference(trees, kv, io):
    """Two tenants under one MultiScheduler and one pool.  With KV paging
    the pool's log is compared in sync mode: the reference drops a retired
    slot's pooled blocks on the calling thread while the fetch worker may
    still run another tenant's pass (ROADMAP C8)."""
    args = _args(kv_paged=kv, async_io=io == "async")
    models, jmodels = {}, {}
    for arch in TENANTS:
        jcfg, jtree, _tcfg, ttree = trees[arch]
        cfg, packed, plan = serve._build_model(arch, args, packed=ttree)
        _p, jplan = _plans(jtree, ttree,
                           sum(placement.packed_sizes(ttree).values()) // 2)
        assert cfg == trees[arch][2]
        assert [(n, p.residency) for n, p in plan.rules] == [
            (n, p.residency) for n, p in jplan.rules]
        models[arch] = (cfg, packed, plan)
        jmodels[arch] = (jcfg, jtree, jplan)
    cold = sum(p.paged_bytes(placement.packed_sizes(t))
               for _c, t, p in models.values())
    budget = max(int(cold * 0.6), 1)
    ms, done = serve._serve_tenants(models, args, SharedPagePool(budget))
    jms, jdone = jserve._serve_tenants(jmodels, args, JPool(budget))
    for arch in TENANTS:
        assert _tokens(done[arch]) == _tokens(jdone[arch]), arch
        assert ms.model(arch).ticks == jms.model(arch).ticks
        # and each tenant equals its solo run on a private pager
        cfg, packed, plan = models[arch]
        assert _tokens(done[arch]) == serve._serve_solo(
            arch, cfg, packed, plan, args, TENANTS.index(arch))
    assert ms.ticks == jms.ticks
    summ, jsumm = ms.pool.summary(), jms.pool.summary()
    counters = ("swaps", "misses", "pool_hits", "evicted",
                "bytes_streamed_wire", "bytes_streamed_raw")
    assert sorted(summ["models"]) == sorted(jsumm["models"])
    for m, c in summ["models"].items():     # weights and */kv members
        assert {k: c[k] for k in counters} == {
            k: jsumm["models"][m][k] for k in counters}, m
    assert summ["evictions"] == jsumm["evictions"] > 0
    ms.close()
    jms.close()


def test_main_bit_exact_on_cpu(capsys, tmp_path):
    metrics = tmp_path / "m.json"
    trace = tmp_path / "t.json"
    done = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--max-new", "6",
                       "--budget-mb", "0.4", "--kv-paged", "--kv-block", "4",
                       "--deadline-ms", "20", "--preemptive",
                       "--token-budget", "64", "--metrics-json",
                       str(metrics), "--trace-json", str(trace)])
    out = capsys.readouterr().out
    assert len(done) == 4
    assert "verify: paged tokens BIT-EXACT vs resident plan" in out
    assert ("verify: async tokens BIT-EXACT vs sync streaming, counters "
            "unchanged by overlap") in out
    assert "[W8, mixed:l3flash+l1mram]" in out
    doc = validate(json.loads(metrics.read_text()))
    assert doc["schema"] == "repro.serving.metrics/v9"
    assert doc["requests"]["count"] == 4
    assert doc["paging"]["kv_swaps"] > 0
    assert json.loads(trace.read_text())["traceEvents"]


def test_main_multi_bit_exact_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--models",
                ",".join(TENANTS), "--requests", "3", "--max-new", "3",
                "--kv-paged"])
    out = capsys.readouterr().out
    for arch in TENANTS:
        assert f"verify {arch}: tokens BIT-EXACT vs solo private pager" in out
    assert ("pool counters (incl. wire/raw bytes) MATCH the static "
            "kv_pass_counters prediction") in out


def test_mesh_serves(capsys):
    """``--mesh 2`` shards the paged store over two links and passes all
    three verify legs (the parity with the reference's launcher is in
    ``test_torch_mesh_paging.py``)."""
    serve.main(["--smoke", "--device", "cpu", "--budget-mb", "0.05",
                "--requests", "2", "--max-new", "3", "--mesh", "2"])
    out = capsys.readouterr().out
    assert "mesh 1x2: 2 links on cpu" in out
    assert ("verify: mesh tokens BIT-EXACT vs single-device paged run, "
            "byte ledger obeys the sharding algebra") in out
    with pytest.raises(SystemExit, match="N or DxM"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "2x2x2"])


@pytest.mark.parametrize("argv,names", [
    pytest.param(["--arch", "whisper-tiny"], "decoder-only",
                 id="argv1-decoder-only"),
])
def test_refusals_exit_non_zero(argv, names):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--smoke", "--device", "cpu"] + argv)
    assert exc.value.code not in (0, None)
    assert names in str(exc.value.code)


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def test_parser_takes_every_reference_flag():
    """Every flag of the reference's ``main`` parses in the port's."""
    flags = set(re.findall(r'"(--[a-z-]+)"', inspect.getsource(jserve.main)))
    port = {a for act in serve._parser()._actions
            for a in act.option_strings}
    assert flags and flags <= port, flags - port
    assert isinstance(_args(), argparse.Namespace)
