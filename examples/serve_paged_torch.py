"""Serving a model LARGER than the resident weight budget on the PyTorch
port: the paper's software-assisted virtual paging (§II-B2) at LM scale,
driven by a PlacementPlan (the counterpart of ``examples/serve_paged.py``).

``plan_for_budget`` splits the packed store against the resident budget:
the hottest parameters are pinned l1mram-resident, the rest are marked
paged/l3flash.  The plan-aware ``HostPagedStore`` then puts the hot set on
the device once and streams only the paged parameters host->device ahead
of use, synchronously via ``stream()`` or overlapped via ``begin_pass()``
/ ``fence()``, where only the *exposed* fence wait hits the critical path.
The mixed execution must be bit-identical to the fully resident one, and
the async schedule to the sync one; then the same machinery serves behind
the ``Scheduler``, with encoded (int8 / int4) cold pages and under a seeded
``FaultPlan``.

Run:  PYTHONPATH=src python examples/serve_paged_torch.py [--device cpu]

It runs on the CUDA card (the Hopper kernels) unless ``--device cpu`` asks
for the plain PyTorch path, and prints "serve_paged OK".
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.faults import FaultPlan
from repro_torch.core.paging import (HostPagedStore, StallModel, build_pages,
                                     packed_tree_store, page_roundtrip_param,
                                     thread_packed)
from repro_torch.core.placement import (PlacementPlan, packed_sizes,
                                        plan_for_budget)
from repro_torch.core.weight_store import (flatten_tree, freeze,
                                           uniform_policy)
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import freeze_for_serving
from repro_torch.serving import Request, Scheduler, ServingEngine


def expect(cond, what: str) -> None:
    """An assert that ``python -O`` keeps."""
    if not cond:
        raise AssertionError(what)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)          # raises without a card

    cfg = get_config("qwen2.5-3b").smoke().replace(n_layers=8)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12))
                              .astype(np.int32)).to(dev)
    engine = dict(scenario="l1mram", mode="xla", bits=8)

    # resident (reference) packed serving
    packed = freeze_for_serving(params, bits=8, device=dev)
    ref_logits = tfm.forward(packed, tokens, cfg, engine=engine)

    # paged: a LAYER-GRANULAR store built from the unstacked params (a page
    # holds whole layers, matching the deterministic access order)
    per_layer = {}
    for i in range(cfg.n_layers):
        for key, leaf in flatten_tree(params["layers"]).items():
            per_layer[f"layer{i:02d}/{key}"] = leaf[i]
    flat_store = freeze(per_layer, uniform_policy(8, min_size=256))

    # budget ~ half the model: plan_for_budget pins the hot half resident,
    # the cold half pages through two live slots
    budget = flat_store.packed_bytes // 2
    plan = plan_for_budget(flat_store, budget)
    layer_bytes = flat_store.packed_bytes // cfg.n_layers
    page_bytes = 2 * layer_bytes + 64
    pages = build_pages(flat_store, page_bytes, plan=plan)
    print(f"model: {flat_store.packed_bytes/1e6:.2f} MB packed; plan pins "
          f"{plan.resident_bytes(flat_store)/1e6:.2f} MB resident "
          f"(budget {budget/1e6:.2f} MB), pages "
          f"{plan.paged_bytes(flat_store)/1e6:.2f} MB across {len(pages)} "
          f"pages of <= {page_bytes/1e6:.2f} MB, device {dev}")
    expect(plan.fits(flat_store, budget), "the plan's resident set overruns "
           "the budget")

    paged = HostPagedStore(flat_store, page_bytes, plan=plan, device=dev)
    streamed = dict(paged.resident)      # hot set pinned at construction
    for _page, dev_params in paged.stream(resident_slots=2):
        streamed.update(dev_params)
    print(f"  swaps: {paged.swap_count}, demand misses: {paged.miss_count} "
          f"(proactive prefetch hid all but the cold start)")

    # the ASYNC version of the same pass: begin_pass() kicks the whole
    # fetch loop and returns at once; we "compute" (here: re-run the
    # reference forward) while the pages stream, then fence at first use
    apass = paged.begin_pass(resident_slots=2)
    again = tfm.forward(packed, tokens, cfg, engine=engine)
    overlapped = dict(paged.resident)
    overlapped.update(apass.fence())
    expect(torch.equal(again, ref_logits), "the forward is not repeatable")
    expect(all(torch.equal(overlapped[n].packed, streamed[n].packed)
               for n in flat_store.params),
           "async pass moved other bytes than the sync one")
    print(f"  async pass: {apass.swap_s*1e3:.2f} ms stream wall = "
          f"{apass.hidden_s*1e3:.2f} ms hidden behind compute + "
          f"{apass.exposed_s*1e3:.2f} ms exposed at the fence "
          f"({apass.hidden_s/max(apass.swap_s, 1e-12)*100:.0f}% overlapped)")

    # every leaf, pinned or streamed, is bit-identical to the reference
    drift = 0
    for name, p in flat_store.params.items():
        drift = max(drift, int((streamed[name].packed.to(torch.int32)
                                - p.packed.to(torch.int32)).abs().max()))
    print(f"  streamed-vs-resident packed drift: {drift} (must be 0)")
    expect(drift == 0, f"packed drift {drift}")
    paged.close()

    # stall model over the PAGED traffic only: what the plan's cold half
    # costs on the SoC (the hot half never swaps)
    sm = StallModel(swap_bandwidth_bytes_per_s=550e6)   # HyperBus
    compute = [0.8e-3] * len(pages)                     # per-page compute
    r = sm.run(pages, compute)
    print(f"  stall model: {r['stall_s']*1e3:.2f} ms stalls over "
          f"{r['total_s']*1e3:.2f} ms total "
          f"({r['stall_fraction']*100:.1f}% — the cost of exceeding "
          f"on-chip capacity, paper section II-B2)")

    # the SERVING consumption of the same machinery: the engine attaches a
    # HostPagedStore over its plan's cold parameter groups and re-streams
    # them between ticks (repro_torch.launch.serve --budget-mb drives the
    # same path behind the deadline-aware Scheduler)
    scfg = get_config("qwen3-0.6b").smoke()
    sparams = tfm.init_params(scfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    spacked = freeze_for_serving(sparams, bits=8, device=dev)
    sizes = packed_sizes(spacked)
    splan = plan_for_budget(sizes, sum(sizes.values()) // 2)

    prompts = [rng.integers(0, scfg.vocab_size, 6 + uid).astype(np.int32)
               for uid in range(4)]
    engines = []

    def serve(plan, paged, async_io=True, tree=None, faults=None):
        eng = ServingEngine(scfg, spacked if tree is None else tree,
                            batch_slots=2, max_len=64, plan=plan,
                            device=dev)
        if paged:
            eng.attach_paging(faults=faults)
            engines.append(eng)
        sched = Scheduler(eng, prefill_chunk=8, async_io=async_io)
        for uid, prompt in enumerate(prompts):
            sched.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
        sched.run_until_done()
        return {q.uid: q.generated for q in sched.finished}, eng, sched

    mixed, eng, sched = serve(splan, paged=True)           # overlapped
    syncd, seng, _ = serve(splan, paged=True, async_io=False)
    resident, _, _ = serve(PlacementPlan.uniform(), paged=False)
    # overlap changes WHEN pages move, never what anyone computes
    expect(mixed == syncd == resident, "paged tokens differ from resident")
    expect(eng.swap_count == seng.swap_count, "async swaps != sync swaps")
    pg = eng.paging_summary()
    print(f"  scheduler serve (async): {sched.ticks} ticks, "
          f"{eng.swap_count} live swaps over {len(eng.pager.pages)} pages, "
          f"{pg['exposed_s']*1e3:.1f} ms exposed + {pg['hidden_s']*1e3:.1f} "
          f"ms hidden ({pg['overlap_frac']*100:.0f}% of the stream rode "
          f"behind compute; sync path stalled "
          f"{seng.paging_stall_s*1e3:.1f} ms) — tokens bit-exact vs sync "
          f"and vs the fully resident plan")

    # ENCODED pages (launch.serve --page-bits): the same cold set streamed
    # as blockwise-quantized intN payload + scales, dequantized at fetch.
    # page_bits == store bits (int8 here) is the zero-decode identity
    q8, qeng, _ = serve(splan.with_page_bits(8), paged=True)
    expect(q8 == resident, "int8 pages changed the tokens")
    wire = qeng.pager.bytes_streamed_wire
    raw = qeng.pager.bytes_streamed_raw
    print(f"  encoded pages (int8 wire): {wire} B streamed for {raw} B "
          f"fp32-dense raw ({raw/max(wire,1):.1f}x compression), tokens "
          f"bit-exact vs resident")

    # a NARROWER wire encoding (int4 pages under an int8 store) is lossy
    # but deterministic: serving it equals serving a resident tree whose
    # cold weights took the same encode->decode round trip
    qplan4 = splan.with_page_bits(4)
    store4 = packed_tree_store(spacked, qplan4)
    rt = {n: page_roundtrip_param(p, 4) for n, p in store4.params.items()
          if qplan4.placement_for(n).paged}
    q4, _, _ = serve(qplan4, paged=True)
    want4, _, _ = serve(PlacementPlan.uniform(), paged=False,
                        tree=thread_packed(spacked, rt))
    expect(q4 == want4, "int4 pages differ from the round-tripped tree")
    print(f"  encoded pages (int4 wire, lossy): {len(rt)} cold params "
          f"round-tripped; tokens bit-exact vs the round-tripped "
          f"resident reference")

    # CHAOS (launch.serve --fault-seed): the same paged serve under a
    # seeded FaultPlan.  Faults cost retries, never tokens
    chaos, _ceng, csched = serve(
        splan, paged=True,
        faults=FaultPlan(seed=3, fail_rate=0.2, bitflip_rate=0.2))
    expect(chaos == resident, "faults changed the tokens")
    ft = csched.faults_summary()
    expect(ft["injected"] > 0 and ft["retries"] > 0, f"no faults: {ft}")
    expect(ft["checksum_failures"] == ft["refetches"],
           f"a corrupt page was installed: {ft}")
    print(f"  chaos serve (seed 3): {ft['injected']} faults injected, "
          f"{ft['retries']} retries, {ft['checksum_failures']} CRC misses "
          f"all re-fetched — tokens bit-exact vs resident")
    for e in engines:
        e.pager.close()
    print("serve_paged OK")


if __name__ == "__main__":
    main()
