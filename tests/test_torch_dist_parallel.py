"""Port parity: the placement of trees on a rank mesh
(``parallel/distributed``), the int8 compressed all-reduce
(``parallel/compress.py``) and the GPipe pipeline
(``parallel/pipeline.py``) against the JAX package on the CPU.

One group of 4 ``gloo`` ranks (``run_ranks``) runs every case of the
port; the reference's ``shard_map`` functions run in one subprocess of 4
forced host devices, as ``tests/test_multidevice.py`` runs them, started
beside the ranks.  The int32 totals and the compressed outputs (error
feedback's too) are held bit for bit: both packages do the same f32
operations in the same order.  The pipeline within 2e-4, the reference
test's tolerance.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.parallel import distributed as D  # noqa: E402
from repro_torch.parallel import pipeline as PP  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

from torch_dist_ranks import (COMPRESS_ROUNDS, PLACE_MESHES,  # noqa: E402
                              _ranks_parallel)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
PIPE_TOL = 2e-4
N_MICRO = 4

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_test_mesh
from repro.parallel.compress import (compressed_allreduce_mean,
                                     with_error_feedback)
from repro.parallel.pipeline import pipelined_apply

d = dict(np.load(sys.argv[1]))
g = jnp.asarray(d["g"])
mesh = make_test_mesh((4,), ("data",))
sm = lambda f, n_in, n_out: shard_map(
    f, mesh=mesh, in_specs=(P("data"),) * n_in,
    out_specs=(P("data"),) * n_out if n_out > 1 else P("data"),
    check_rep=False)

def totals(x):                        # compressed_allreduce_mean's psum
    absmax = jax.lax.pmax(jnp.max(jnp.abs(x)), "data")
    scale = jnp.maximum(absmax / 127.0, 1e-12)
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return jax.lax.psum(q.astype(jnp.int32), "data"), scale[None]

out = dict(mean=np.asarray(sm(lambda x: compressed_allreduce_mean(
    x, "data"), 1, 1)(g)))
t, s = sm(totals, 1, 2)(g)
out.update(total=np.asarray(t), scale=np.asarray(s))
ef = sm(lambda x, r: tuple(v["g"] for v in with_error_feedback(
    dict(g=x), dict(g=r), "data")), 2, 2)
r = jnp.zeros_like(g)
for i in range(int(d["rounds"])):
    new_g, r = ef(g, r)
    out[f"fb_g{i}"], out[f"fb_r{i}"] = np.asarray(new_g), np.asarray(r)

smesh = make_test_mesh((4,), ("stage",))
fn = pipelined_apply(lambda x, w: jnp.tanh(x @ w), smesh, "stage",
                     n_microbatches=int(d["n_micro"]))
with smesh:
    out["pipe"] = np.asarray(fn(jnp.asarray(d["x"]), jnp.asarray(d["ws"])))
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    g = rng.normal(size=(4, 64)).astype(np.float32)
    return g, ws, x


@pytest.fixture(scope="module")
def runs():
    g, ws, x = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.npz", Path(tmp) / "out.npz"
        np.savez(src, g=g, ws=ws, x=x, rounds=COMPRESS_ROUNDS,
                 n_micro=N_MICRO)
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        ref = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(src),
             str(dst)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            ranks = D.run_ranks(_ranks_parallel, 4, sorted(ARCHS), g, ws, x,
                                N_MICRO, device="cpu", timeout_s=TIMEOUT_S)
            stdout, stderr = ref.communicate(timeout=TIMEOUT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
        assert ref.returncode == 0, stderr[-3000:]
        want = dict(np.load(dst))
    return dict(ranks=ranks, want=want, g=g, ws=ws, x=x)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _expected_block(shape, spec, mesh):
    out = list(shape)
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for a in names:
            out[d] //= mesh.shape.get(a, 1)
    return tuple(out)


@pytest.mark.parametrize("mesh_shape,axes", PLACE_MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_blocks_follow_the_specs(runs, arch, mesh_shape, axes):
    """Every leaf of the full-width parameter tree (``meta``): each rank's
    block is the spec's division of the leaf, on (2, 2) and on
    (2, 2, 1) with "pod"."""
    mesh = tmesh.make_test_mesh(mesh_shape, axes, device="cpu")
    specs = steps.param_specs(ARCHS[arch])
    want = [_expected_block(tuple(leaf.shape), s, mesh) for leaf, s in zip(
        T.leaves(specs), shd.spec_leaves(specs, shd.param_shardings(specs,
                                                                  mesh)))]
    assert any(w != tuple(leaf.shape) for w, leaf in zip(
        want, T.leaves(specs)))
    for r in runs["ranks"]:
        assert r["blocks"][(mesh_shape, arch)] == want


@pytest.mark.parametrize("mesh_shape,axes", PLACE_MESHES)
def test_gather_of_shard_is_identity(runs, mesh_shape, axes):
    """``gather_tree(shard_tree(t))`` is ``t`` bit for bit, for every
    arch's smoke tree."""
    for r in runs["ranks"]:
        for arch in ARCHS:
            assert r["round_trip"][(mesh_shape, arch)], arch


def test_pod_and_data_shard_one_dim_pod_outermost(runs):
    """P(("pod", "data")) on (2, 2, 1): rank (p, d, 0) holds block 2p + d of
    the dim, as JAX lays a tuple of axes out."""
    for rank, r in enumerate(runs["ranks"]):
        p, d = divmod(rank, 2)
        first = 2 * (2 * p + d)
        assert r["pod_rows"] == [3.0 * first, 3.0 * (first + 1)]


def test_placements_refuse_axes_against_mesh_order():
    mesh = tmesh.make_test_mesh((2, 2, 1), ("pod", "data", "model"),
                                device="cpu")
    assert D.placements(shd.P(("pod", "data"), "model"), mesh) == (
        D.Shard(0), D.Shard(0), D.Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        D.placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        D.placements(shd.P("data", "data"), mesh)


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------

def test_int8_totals_equal_reference(runs):
    """The int32 sums of the levels, and the shared scale, on every rank
    equal the reference's ``psum`` / ``pmax`` inside ``shard_map``."""
    want = runs["want"]
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["total"], want["total"][0])
        np.testing.assert_array_equal(r["scale"], want["scale"][0])


def test_compressed_mean_equals_reference(runs):
    """``compressed_allreduce_mean`` bit for bit, and within absmax / 127
    of the exact mean (the reference test's bound)."""
    g = runs["g"]
    for i, r in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(r["mean"], runs["want"]["mean"][i])
        assert np.abs(r["mean"] - g.mean(0)).max() <= np.abs(g).max() / 127


def test_error_feedback_equals_reference(runs):
    """8 rounds of ``with_error_feedback``: every round's output and
    residual bit for bit, and the running mean's error does not grow."""
    want, g = runs["want"], runs["g"]
    for i, r in enumerate(runs["ranks"]):
        for k, (got_g, got_r) in enumerate(r["feedback"]):
            np.testing.assert_array_equal(got_g, want[f"fb_g{k}"][i])
            np.testing.assert_array_equal(got_r, want[f"fb_r{k}"][i])
    acc, errs = np.zeros(64), []
    for k, (got_g, _) in enumerate(runs["ranks"][0]["feedback"]):
        acc += got_g
        errs.append(np.abs(acc / (k + 1) - g.mean(0)).max())
    assert errs[-1] <= errs[0] + 1e-9


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["pipe", "pipe_dtensor"])
def test_pipeline_equals_sequential_and_reference(runs, key):
    """4 stages of ``tanh(x @ w)`` over 4 microbatches, the stage weights
    whole or a DTensor sharded over "stage": every rank's output equals the
    sequential layers and the reference's ``pipelined_apply`` within
    2e-4."""
    x, ws = runs["x"], runs["ws"]
    seq = torch.from_numpy(x)
    for i in range(4):
        seq = torch.tanh(seq @ torch.from_numpy(ws[i]))
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[key], seq.numpy(), rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(r[key], runs["want"]["pipe"],
                                   rtol=PIPE_TOL, atol=PIPE_TOL)


def test_bubble_fraction():
    assert PP.bubble_fraction(4, 4) == (4 - 1) / (4 - 1 + 4)
    assert PP.bubble_fraction(1, 8) == 0.0


def test_rank_mesh_needs_a_process_group():
    """``make_rank_mesh`` outside a process group raises; a link mesh has
    no process groups and no calling rank."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_rank_mesh((2, 2), ("data", "model"), device="cpu")
    links = tmesh.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="no process groups"):
        links.group("data")
    with pytest.raises(ValueError, match="no calling rank"):
        links.coordinate()
