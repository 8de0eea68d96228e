"""Port parity: the paged-serving and XR-pipeline examples
(``examples/serve_paged_torch.py``, ``examples/xr_pipeline_torch.py``)
against the reference's (``examples/serve_paged.py``,
``examples/xr_pipeline.py``).

The XR frame stage: the lens grid and the distortion index map equal the
reference's jitted ones (``torch.linspace`` differs from
``jnp.linspace`` in the last bits, which moves 2 pixels at 224 and none at
64, so both sizes are held); ``post_process``'s gestures are within
``GESTURE_RTOL`` (1e-5 relative) of the reference's; one seeded frame
through the correction and the int8 MobileNet-V2 (one frozen tree in both
packages) gives bit-equal logits.  The XR tenancy leg's decisions (ticks,
uids finished a tick, preemptions, the metrics document without its
host-clock readings, the shared pool's event log) equal the reference
example's ``main``'s.  Both examples run on the CPU and print their OK
lines, and raise without a card when not asked for the CPU."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import mobilenet_v2 as jmnv2  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.models import mobilenet_v2 as mnv2  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jxr = _load("xr_pipeline")
xr = _load("xr_pipeline_torch")
serve_paged = _load("serve_paged_torch")


@pytest.mark.parametrize("n", [2, 8, 17, 64, 100, 224, 256])
def test_lens_grid_equals_jax_linspace(n):
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1, 1, n))())
    np.testing.assert_array_equal(xr.lens_grid(n, "cpu").numpy(), want)


def test_torch_linspace_is_not_the_grid():
    """The trap the grid avoids: at 224 ``torch.linspace`` differs from
    ``jnp.linspace`` and moves pixels of the index map."""
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1, 1, 224))())
    assert (torch.linspace(-1, 1, 224).numpy() != want).sum() > 100


def _index_image(h, w):
    return np.arange(h * w, dtype=np.int32).reshape(h, w, 1)


@pytest.mark.parametrize("hw", [(64, 64), (224, 224), (96, 160), (31, 7)])
def test_distortion_map_equals_reference(hw):
    h, w = hw
    src = np.asarray(jxr.distortion_correct(jnp.asarray(_index_image(h, w))))
    ys, xs = xr.distortion_map(h, w, "cpu")
    np.testing.assert_array_equal(ys.numpy(), src[..., 0] // w)
    np.testing.assert_array_equal(xs.numpy(), src[..., 0] % w)


@pytest.mark.parametrize("img", [64, 224])
def test_distortion_correct_equals_reference(img):
    frame = np.random.default_rng(img).integers(0, 255, (img, img, 3)) \
        .astype(np.uint8)
    got = xr.distortion_correct(torch.from_numpy(frame))
    want = np.asarray(jxr.distortion_correct(jnp.asarray(frame)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_post_process_within_tolerance(seed):
    feats = np.random.default_rng(seed).integers(0, 256, 1000) \
        .astype(np.uint8)
    got = xr.post_process(torch.from_numpy(feats))
    want = np.asarray(jxr.post_process(jnp.asarray(feats)))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=xr.GESTURE_RTOL,
                               atol=0)


def test_frame_logits_bit_exact():
    """One seeded frame at 64 through the correction and MobileNet-V2: the
    port's frozen tree carried into the reference's jitted ``apply``."""
    frozen, frames = xr.frame_stage(64, torch.device("cpu"), 1)
    logits = mnv2.apply(frozen, xr.distortion_correct(frames[0]),
                        weight_bits=8, img=64)
    jtree = jax.tree_util.tree_map(jnp.asarray,
                                   interop.params_to_numpy(frozen))
    corrected = jxr.distortion_correct(jnp.asarray(frames[0].numpy()))
    want = np.asarray(jax.jit(lambda x: jmnv2.apply(
        jtree, x, weight_bits=8, mode="xla", img=64))(corrected))
    np.testing.assert_array_equal(logits.numpy(), want)
    np.testing.assert_allclose(
        xr.post_process(logits).numpy(),
        np.asarray(jxr.post_process(jnp.asarray(want))),
        rtol=xr.GESTURE_RTOL, atol=0)


def test_xr_pipeline_prints_ok(capsys, tmp_path):
    trace = tmp_path / "xr_trace.json"
    out = xr.main(["--device", "cpu", "--trace-json", str(trace)])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("xr_pipeline OK")
    assert "1 preemption(s) / 1 restore(s)" in text
    assert out["img"] == 64 and trace.exists()
    assert out["doc"]["totals"]["preemptions"] >= 1
    assert len(out["frame_ms"]) == len(out["tick_ms"]) == out["ticks"]


# the metrics document's readings of the host clock: the tick and request
# latencies, throughput, the I/O overlap and the deadline misses (deadlines
# of 10-20 ms against host-clock ticks)
WALL = ("throughput", "trace", "deadlines")
WALL_KEYS = ("exposed_s", "hidden_s", "overlap_frac", "stall_s",
             "kv_exposed_s", "kv_hidden_s", "ttft_ms", "latency_ms",
             "wall_s", "tok_per_s", "paging_exposed_ms", "paging_hidden_ms",
             "paging_exposed_s", "paging_hidden_s", "missed", "miss_rate",
             "decode_s", "crc_s", "copy_s", "p99_ttft_ms")


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in WALL and k not in WALL_KEYS}
    return doc


def _events(pool):
    return [tuple((kind, m, tuple(tuple(x) if isinstance(x, tuple) else x
                                  for x in rest[0])) if rest else
                  (kind, m)) for kind, m, *rest in pool.events]


def _capturing(monkeypatch, ms_home, pool_home):
    """Patch ``ms_home.MultiScheduler`` and ``pool_home.SharedPagePool``
    (where the example's ``main`` reads them) with subclasses that keep the
    instance, the last ``summary`` and the uids each tick finished."""
    seen = {"done": []}

    class MS(ms_home.MultiScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["ms"] = self

        def tick(self):
            out = super().tick()
            seen["done"].append({n: [r.uid for r in reqs]
                                 for n, reqs in out.items()})
            return out

        def summary(self):
            seen["doc"] = super().summary()
            return seen["doc"]

    class Pool(pool_home.SharedPagePool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["pool"] = self

    monkeypatch.setattr(ms_home, "MultiScheduler", MS)
    monkeypatch.setattr(pool_home, "SharedPagePool", Pool)
    return seen


def test_xr_tenancy_decisions_equal_reference(monkeypatch, tmp_path):
    """The tenancy leg of both examples' ``main`` on the smoke tenants:
    its traffic (token budget 24, 2 slots, stream priorities 1 / 2 / 3, the
    wake request at tick 2) decides ticks, admissions, preemptions and the
    shared pool's traffic independently of the weights, so the two runs
    give the same tick count, the same uids finished at each tick, the
    same metrics document once the host clock's readings are taken out
    (scheduler counters, per-member pool swaps / misses / pool hits /
    evictions and bytes, KV block traffic), and the same pool event log
    event for event.  The reference's MobileNet-V2 is stubbed out of its
    frame loop (the frame stage is held above): drawing and freezing it
    take ~45 s on the CPU."""
    import repro.core.paging as jpaging
    import repro.serving as jserving

    monkeypatch.chdir(tmp_path)          # the reference writes its trace here
    jseen = _capturing(monkeypatch, jserving, jpaging)
    stub = type(jmnv2)("mobilenet_v2_stub")
    stub.init_params = lambda key, **kw: {}
    stub.freeze_packed = lambda params, **kw: {
        "conv0": {"packed": np.zeros(1, np.uint8)}}
    stub.apply = lambda packed, x, **kw: jnp.zeros(1000, jnp.uint8)
    monkeypatch.setattr(jxr, "mnv2", stub)
    jxr.main()

    pseen = _capturing(monkeypatch, xr, xr)
    out = xr.main(["--device", "cpu", "--trace-json",
                   str(tmp_path / "port_trace.json")])

    assert pseen["ms"].ticks == jseen["ms"].ticks == out["ticks"]
    assert pseen["done"] == jseen["done"]
    assert _strip(out["doc"]) == _strip(jseen["doc"])
    tot = out["doc"]["totals"]
    assert tot["preemptions"] == tot["restores"] >= 1
    assert _events(pseen["pool"]) == _events(jseen["pool"])
    assert any(c["evicted"] for c in
               out["doc"]["shared_pool"]["models"].values())


def test_serve_paged_prints_ok(capsys):
    serve_paged.main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("serve_paged OK")


@pytest.mark.parametrize("example", ["xr", "serve_paged"])
def test_examples_raise_without_a_card(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"xr": xr, "serve_paged": serve_paged}[example].main([])
