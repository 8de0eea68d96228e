"""Port parity: the training substrate (``repro_torch.data``,
``.checkpoint``, ``.runtime``) against the JAX package on the CPU.

Batches equal the reference's bit for bit; a checkpoint written by either
package restores in the other with equal values (bf16 included) and the
same manifest; the port's ``CheckpointManager`` keeps the reference's
atomicity, keep-N, typed errors and async surfacing, and snapshots a tree
before ``save`` returns; the port's ``Trainer`` resumes a crashed run bit
for bit and gives up after ``max_restarts``.
"""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_pytree as jrestore  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    CheckpointRestoreError, restore_pytree,
                                    save_pytree)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMDataset, prefetch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import (FailureInjector, StragglerMonitor,  # noqa: E402
                                 Trainer, TrainerConfig)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=16, global_batch=4, seed=3),
    dict(vocab_size=151936, seq_len=64, global_batch=8, seed=0, n_hosts=2,
         host_id=1),
    dict(vocab_size=300, seq_len=8, global_batch=2, seed=5, family="encdec",
         d_model=12, n_frames=6),
    dict(vocab_size=300, seq_len=8, global_batch=2, seed=5, family="vlm",
         d_model=12, n_patches=4),
])
def test_batches_equal_reference_bit_for_bit(kw):
    ours, ref = SyntheticLMDataset(**kw), JData(**kw)
    for step in (0, 1, 7, 1000):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    it = prefetch(ours, start_step=3, depth=2)
    for step in (3, 4, 5):
        got = next(it)
        for k, v in ref.batch(step).items():
            np.testing.assert_array_equal(got[k], v)
    it.close()


def test_data_hosts_and_labels():
    d0 = SyntheticLMDataset(1000, 16, 8, n_hosts=2, host_id=0)
    d1 = SyntheticLMDataset(1000, 16, 8, n_hosts=2, host_id=1)
    assert d0.local_batch == 4
    assert not np.array_equal(d0.batch(0)["tokens"], d1.batch(0)["tokens"])
    b = d0.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError):
        SyntheticLMDataset(1000, 16, 3, n_hosts=2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _np_tree(rng):
    return dict(a=rng.normal(size=(4, 8)).astype(np.float32),
                nested=dict(b=rng.integers(0, 10, (3,)).astype(np.int32)),
                lst=[np.ones((2,), np.float32),
                     rng.normal(size=(5,)).astype(np.float32)],
                count=np.asarray(7, np.int32))


def _torch_tree(tree):
    out = T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    out["lst"][1] = out["lst"][1].to(torch.bfloat16)
    return out


def _jax_tree(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["lst"][1] = out["lst"][1].astype(jnp.bfloat16)
    return out


def _as_f32(x):
    x = np.asarray(x.float() if isinstance(x, torch.Tensor)
                   and x.dtype == torch.bfloat16 else x)
    return x.astype(np.float32) if x.dtype.kind not in "biu" else x


def test_checkpoints_cross_packages(tmp_path):
    """A tree with f32, int32, bf16, a list and a scalar, saved by each
    package, restores in the other with equal values and dtypes; both
    write the same manifest."""
    base = _np_tree(np.random.default_rng(0))
    jt, tt = _jax_tree(base), _torch_tree(base)
    jsave(jt, tmp_path / "jax")
    save_pytree(tt, tmp_path / "torch")
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("jax", "torch")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["lst/1"]["dtype"] == "bfloat16"
    got_t = restore_pytree(tt, tmp_path / "jax")
    got_j = jrestore(jt, tmp_path / "torch")
    for a, b, c in zip(T.leaves(got_t), jax.tree_util.tree_leaves(got_j),
                       T.leaves(tt)):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(_as_f32(a), _as_f32(b))
        np.testing.assert_array_equal(_as_f32(a), _as_f32(c))


def test_restore_to_a_device_and_refuse_shardings(tmp_path):
    tt = _torch_tree(_np_tree(np.random.default_rng(1)))
    save_pytree(tt, tmp_path / "ck")
    out = restore_pytree(tt, tmp_path / "ck", device="cpu")
    assert all(t.device.type == "cpu" for t in T.leaves(out))
    # a shardings tree must give every leaf its NamedSharding
    with pytest.raises(ValueError, match="shardings for"):
        restore_pytree(tt, tmp_path / "ck", shardings=dict(a=None))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(dict(tt, a=torch.zeros(5)), tmp_path / "ck")
    with pytest.raises(KeyError):
        restore_pytree(dict(tt, extra=torch.zeros(1)), tmp_path / "ck")


def test_atomicity_and_keep_n(tmp_path):
    tt = _torch_tree(_np_tree(np.random.default_rng(2)))
    save_pytree(tt, tmp_path / "ck")
    save_pytree(tt, tmp_path / "ck")                # overwrite is atomic too
    assert not (tmp_path / "ck.tmp").exists()
    mgr = CheckpointManager(tmp_path / "m", keep_n=2, async_save=False)
    for step in (5, 10, 15, 20):
        mgr.save(step, tt)
    assert mgr.all_steps() == [15, 20] and mgr.latest_step() == 20
    # a crashed writer's .tmp is not a checkpoint
    (tmp_path / "m" / "step_00000025.tmp").mkdir()
    assert mgr.latest_step() == 20
    assert mgr.restore(tt)[0] == 20


def test_restore_errors_are_typed_and_name_the_step(tmp_path):
    tt = _torch_tree(_np_tree(np.random.default_rng(3)))
    mgr = CheckpointManager(tmp_path, keep_n=3, async_save=False)
    with pytest.raises(CheckpointRestoreError, match="no checkpoints"):
        mgr.restore(tt)
    mgr.save(7, tt)
    os.remove(tmp_path / "step_00000007" / "manifest.json")
    with pytest.raises(CheckpointRestoreError, match="step 7") as ei:
        mgr.restore(tt)
    assert ei.value.step == 7
    with pytest.raises(CheckpointRestoreError) as ei:
        mgr.restore(tt, step=99)
    assert ei.value.step == 99


def test_failing_async_save_surfaces_on_next_call(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as mgr_mod
    tt = _torch_tree(_np_tree(np.random.default_rng(4)))
    mgr = CheckpointManager(tmp_path, keep_n=3, async_save=True)

    def failing_save(tree, directory):
        raise RuntimeError("disk on fire")
    monkeypatch.setattr(mgr_mod, "save_pytree", failing_save)
    mgr.save(1, tt)
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.wait()
    mgr.wait()                               # consumed once
    monkeypatch.undo()
    mgr.save(2, tt)
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_leaf_mutated_after_async_save_restores_its_saved_value(
        tmp_path, monkeypatch):
    """``save`` copies the tree before it returns: a leaf written in place
    while the (slowed) writer runs still restores as it was saved."""
    import repro_torch.checkpoint.manager as mgr_mod
    tt = _torch_tree(_np_tree(np.random.default_rng(5)))
    want = T.tree_map(lambda t: t.clone(), tt)
    real = mgr_mod.save_pytree

    def slow_save(tree, directory):
        time.sleep(0.2)
        real(tree, directory)
    monkeypatch.setattr(mgr_mod, "save_pytree", slow_save)
    mgr = CheckpointManager(tmp_path, keep_n=3, async_save=True)
    mgr.save(1, tt)
    for t in T.leaves(tt):
        t.add_(1)                             # in place, before the write
    mgr.wait()
    _, got = mgr.restore(tt)
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the fault-tolerant trainer
# ---------------------------------------------------------------------------

def _make_trainer(path, fail_at=(), total=8):
    cfg = get_config("qwen3-0.6b").smoke()
    opt = adamw()

    def init_state():
        p = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        return dict(params=p, opt_state=opt.init(p))

    return Trainer(TrainerConfig(total_steps=total, checkpoint_every=3,
                                 checkpoint_dir=str(path), log_every=100),
                   make_train_step(cfg, opt, lr=1e-3), init_state,
                   SyntheticLMDataset(cfg.vocab_size, 32, 2, seed=1),
                   failure_injector=FailureInjector(fail_at), device="cpu")


def test_trainer_restart_equivalence(tmp_path):
    """A run crashed at step 5 and resumed from its step-2 checkpoint ends
    on the same params as an uninterrupted run, bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        clean = _make_trainer(tmp_path / "clean").run()
        crashed = _make_trainer(tmp_path / "crash", fail_at=[5]).run()
    finally:
        torch.use_deterministic_algorithms(False)
    assert clean["restarts"] == 0 and crashed["restarts"] == 1
    assert [m["step"] for m in crashed["metrics"]] == [0, 1, 2, 3, 4, 3, 4,
                                                      5, 6, 7]
    for a, b in zip(T.leaves(clean["params"]), T.leaves(crashed["params"])):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(clean["opt_state"]),
                    T.leaves(crashed["opt_state"])):
        assert torch.equal(a, b)
    assert len(clean["metrics"]) == 8


def test_trainer_gives_up_after_max_restarts(tmp_path):
    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            raise RuntimeError("boom")

    t = _make_trainer(tmp_path, total=4)
    t.injector = AlwaysFail()
    t.cfg.max_restarts = 1
    with pytest.raises(RuntimeError, match="boom"):
        t.run()
    assert t.restarts == 2


def test_straggler_monitor_flags_outlier():
    m = StragglerMonitor(threshold=3.0, warmup=2)
    for i in range(6):
        m.step_start()
        time.sleep(0.02 if i != 4 else 0.2)
        assert m.step_end() == (i == 4)
    assert m.flagged == [4]
    m.tracer.validate()
    assert m.tracer.track_names == ["train"]
