"""Rank bodies of the port's multi-rank tests
(``test_torch_dist_train.py``, ``test_torch_dist_moe.py``,
``test_torch_dist_tp.py``, ``test_torch_dist_parallel.py``).

``parallel/distributed.run_ranks`` pickles a rank's function by module
and name, and each rank imports its module: these import no JAX, so a
rank starts in a few seconds.
"""

from pathlib import Path

import numpy as np
import torch

from repro_torch import interop, optim
from repro_torch.configs import get_config as tget
from repro_torch.core import tree as T
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import dist_steps as DS
from repro_torch.launch import steps
from repro_torch.parallel import distributed as D

ARCH, MOE_ARCH, CKPT_ARCH = "qwen3-0.6b", "qwen2-moe-a2.7b", "olmo-1b"
MOE_GROUPS = (2, 4)
# the dense step a layer at a time on these meshes, remat on and off, at
# LAYERED_DEPTH layers (so that "two layers alive" is a bound)
LAYER_MESHES = ((2, 2), (4, 1))
LAYERED_DEPTH = 4
# steps a case runs: after the first, the losses see the updates
N_STEPS = dict(adamw=3, adafactor=2, masked=3, moe=3)


def _cfg(get):
    return get(ARCH).smoke().replace(d_model=64, n_heads=4, n_kv_heads=2,
                                     head_dim=16, vocab_size=256)


def _moe_cfg(get, groups):
    return get(MOE_ARCH).smoke().replace(moe_groups=groups)


def _batch(masked: bool = False):
    """The reference's (4, 32) batch from seed 0; ``masked`` adds a
    loss_mask that keeps 5 of 32 tokens a row in the first data shard's
    rows and all of them in the second's."""
    rng = np.random.default_rng(0)
    b = dict(tokens=rng.integers(0, 256, (4, 32)),
             labels=rng.integers(0, 256, (4, 32)))
    if masked:
        mask = np.ones((4, 32), np.float32)
        mask[:2, 5:] = 0.0
        b["loss_mask"] = mask
    return b


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _sharded_run(cfg, opt, params, batch, mesh, n_steps, starts=False):
    """``n_steps`` of the sharded step from ``params`` (whole): losses,
    the global gradient norms, the bytes this rank holds against the
    specs', and the params gathered (numpy, rank 0); with ``starts`` also
    each step's starting params and optimizer state, gathered."""
    from repro_torch.parallel import sharding as shd

    state = opt.init(params)
    pspec = shd.param_shardings(params, mesh)
    ospec = shd.opt_state_shardings(state, mesh, params)
    sp, so = D.shard_tree(params, pspec, mesh), D.shard_tree(state, ospec,
                                                             mesh)
    want = D.spec_bytes(params, pspec, mesh) + D.spec_bytes(state, ospec,
                                                            mesh)
    step = DS.make_distributed_train_step(cfg, opt, mesh)
    losses, gnorms, comms, begun = [], [], [], []
    for _ in range(n_steps):
        if starts:
            begun.append(tuple(T.tree_map(
                lambda t: (t.float() if t.is_floating_point() else t).numpy(),
                D.gather_tree(x)) for x in (sp, so)))
        sp, so, met = step(sp, so, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        comms.append(met["comm"])
    held = D.held_bytes(sp) + D.held_bytes(so)
    whole = D.gather_tree(sp)
    return dict(losses=losses, grad_norms=gnorms, held=held, want=want,
                alive=max(m["layers_alive_max"] for m in comms),
                comm=comms[-1],
                starts=begun,
                gathers=[m["layer_gathers"] for m in comms],
                local=[leaf.to_local().shape for leaf in T.leaves(sp)],
                params=(interop.params_to_numpy(whole)
                        if torch.distributed.get_rank() == 0 else None))


def _ranks_4(params_np, layered_np, jax_ckpt, tmp):
    """Every 4-rank case: the steps on (2, 2), the restores, the Trainer
    restart."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    rank = torch.distributed.get_rank()
    cfg = _cfg(tget)
    mesh = tmesh.make_rank_mesh((2, 2), ("data", "model"), device="cpu")
    params = interop.params_from_numpy(params_np, cfg, device="cpu")
    # a layer at a time, with remat and without, on both meshes
    layered = {}
    lcfg = cfg.replace(n_layers=LAYERED_DEPTH)
    lparams = interop.params_from_numpy(layered_np, lcfg, device="cpu")
    for shape in LAYER_MESHES:
        m = mesh if shape == (2, 2) else tmesh.make_rank_mesh(
            shape, ("data", "model"), device="cpu")
        for remat in (True, False):
            layered[shape, remat] = _sharded_run(
                lcfg.replace(remat=remat), optim.adamw(), lparams,
                _tbatch(_batch()), m, N_STEPS["adamw"])
    out = dict(
        layered=layered,
        adamw=_sharded_run(cfg, optim.adamw(), params,
                           _tbatch(_batch()), mesh, N_STEPS["adamw"]),
        adafactor=_sharded_run(cfg, optim.adafactor(), params,
                               _tbatch(_batch()), mesh,
                               N_STEPS["adafactor"]),
        masked=_sharded_run(cfg, optim.adamw(), params,
                            _tbatch(_batch(masked=True)), mesh,
                            N_STEPS["masked"]),
        rows=[v.tolist() for v in D.local_rows(
            dict(r=torch.arange(4)), mesh).values()])

    # a JAX checkpoint onto (2, 2); that state saved from (2, 2), restored
    # onto (4, 1)
    ocfg = tget(CKPT_ARCH).smoke()
    tmpl = dict(params=steps.param_specs(ocfg))
    named = lambda m: dict(params=D.named_shardings(
        shd.param_shardings(tmpl["params"], m), tmpl["params"], m))
    step, st = CheckpointManager(jax_ckpt).restore(tmpl,
                                                   shardings=named(mesh))
    from_jax = D.gather_tree(st["params"])
    mgr = CheckpointManager(Path(tmp) / "port", async_save=False)
    mgr.save(step, st)
    mesh41 = tmesh.make_rank_mesh((4, 1), ("data", "model"), device="cpu")
    step41, st41 = mgr.restore(tmpl, shardings=named(mesh41))
    on41 = D.gather_tree(st41["params"])
    out["restore"] = dict(
        step=step, step41=step41,
        blocks=[leaf.to_local().shape for leaf in T.leaves(st["params"])],
        blocks41=[leaf.to_local().shape for leaf in T.leaves(st41["params"])],
        from_jax=(interop.params_to_numpy(from_jax) if rank == 0 else None),
        on41=interop.params_to_numpy(on41) if rank == 0 else None,
        port_dir=str(mgr.root / f"step_{step:08d}"))

    # Trainer(shardings=): a failure injected at step 2 against none
    opt = optim.adamw()

    def init_state():
        p = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        o = opt.init(p)
        return dict(params=D.shard_tree(p, shd.param_shardings(p, mesh),
                                        mesh),
                    opt_state=D.shard_tree(o, shd.opt_state_shardings(
                        o, mesh, p), mesh))

    st0 = init_state()
    shardings = dict(
        params=D.named_shardings(shd.param_shardings(st0["params"], mesh),
                                 st0["params"], mesh),
        opt_state=D.named_shardings(shd.opt_state_shardings(
            st0["opt_state"], mesh, st0["params"]), st0["opt_state"], mesh))
    runs = []
    for name, fail in (("clean", []), ("crashed", [2])):
        runs.append(Trainer(
            TrainerConfig(total_steps=4, checkpoint_every=1,
                          checkpoint_dir=str(Path(tmp) / name),
                          log_every=100),
            DS.make_distributed_train_step(cfg, opt, mesh), init_state,
            SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=0),
            failure_injector=FailureInjector(fail), device="cpu",
            shardings=shardings).run())
    a, b = (T.leaves(dict(p=r["params"], o=r["opt_state"])) for r in runs)
    out["trainer"] = dict(
        restarts=[r["restarts"] for r in runs],
        steps=[[m["step"] for m in r["metrics"]] for r in runs],
        sharded=all(isinstance(x, D.DTensor) for x in a + b),
        equal=all(torch.equal(x.to_local(), y.to_local())
                  for x, y in zip(a, b)), leaves=len(a))
    return out


def _ranks_moe(params_np):
    """The MoE step on (2, 1) at each of MOE_GROUPS."""
    mesh = tmesh.make_rank_mesh((2, 1), ("data", "model"), device="cpu")
    out = {}
    for groups in MOE_GROUPS:
        cfg = _moe_cfg(tget, groups)
        params = interop.params_from_numpy(params_np, cfg, device="cpu")
        out[groups] = _sharded_run(cfg, optim.adamw(), params,
                                   _tbatch(_batch()), mesh, N_STEPS["moe"])
    return out


# -- test_torch_dist_moe.py -------------------------------------------------

# name: (arch, moe_groups, config overrides, optimizer); the cases of a
# MoE on a (2, 1) mesh, "groups0" also on (2, 2).  The bf16 case keeps
# each step's starting state (a step of one rank is compared from it)
DIST_MOE = {
    "groups0": (MOE_ARCH, 0, {}, "adamw"),
    "groups1": (MOE_ARCH, 1, {}, "adamw"),
    "groups3": (MOE_ARCH, 3, {}, "adamw"),
    # capacity 16 of the batch's 128 tokens: drops fall where the other
    # data half's tokens filled an expert first
    "drops": (MOE_ARCH, 0, dict(capacity_factor=0.5), "adamw"),
    "arctic": ("arctic-480b", 0, {}, "adamw"),
    # the reference's train cell: bf16 weights, Adafactor, moe_groups 0
    "bf16": (MOE_ARCH, 0, dict(dtype="bfloat16"), "adafactor"),
}
DIST_MOE_22 = ("groups0",)


def dist_moe_cfg(get, name):
    arch, groups, over, _ = DIST_MOE[name]
    return get(arch).smoke().replace(moe_groups=groups, **over)


def dist_moe_params(params_np, cfg):
    """The case's weights (f32 numpy, a bf16 draw widened exactly) in
    ``cfg.dtype``."""
    p = interop.params_from_numpy(params_np, cfg, device="cpu")
    dt = getattr(torch, cfg.dtype)
    return T.tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, p)


def _ranks_dist_moe(params_np, shape, names):
    """Each of ``names``' steps of DIST_MOE on a ``shape`` mesh."""
    mesh = tmesh.make_rank_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for name in names:
        cfg = dist_moe_cfg(tget, name)
        opt = getattr(optim, DIST_MOE[name][3])()
        out[name] = _sharded_run(cfg, opt,
                                 dist_moe_params(params_np[name], cfg),
                                 _tbatch(_batch()), mesh,
                                 N_STEPS[DIST_MOE[name][3]],
                                 starts=cfg.dtype == "bfloat16")
    return out


# -- test_torch_dist_tp.py ---------------------------------------------------

# name: (arch, mesh, config overrides, optimizer): the compute split over
# "model".  The dense smoke config splits by heads on (2, 2) and (1, 2)
# (2 kv heads) and attends whole on (1, 4); the MoE's 8 experts split
# expert-parallel over "model", 5 split over F (TP-in-expert); moe_groups
# 2 routes a rank's own group, 0 the gathered batch (C22)
DIST_TP = {
    "dense": (ARCH, (2, 2), {}, "adamw"),
    "dense_remat": (ARCH, (2, 2), dict(remat=True), "adamw"),
    "dense_adafactor": (ARCH, (2, 2), {}, "adafactor"),
    "dense_untied": (ARCH, (2, 2), dict(tie_embeddings=False), "adamw"),
    "dense_1x4": (ARCH, (1, 4), {}, "adamw"),
    "moe_ep": (MOE_ARCH, (2, 2), dict(moe_groups=2), "adamw"),
    "moe_tp": (MOE_ARCH, (2, 2), dict(moe_groups=2, n_experts=5), "adamw"),
    "moe_c22": (MOE_ARCH, (2, 2), dict(moe_groups=0), "adamw"),
    "moe_tp_c22": (MOE_ARCH, (2, 2), dict(moe_groups=0, n_experts=5),
                   "adamw"),
    "ssm": ("falcon-mamba-7b", (2, 2), {}, "adamw"),
    "hybrid": ("hymba-1.5b", (2, 2), {}, "adamw"),
    "encdec": ("whisper-tiny", (2, 2), {}, "adamw"),
    "dense_1x2": (ARCH, (1, 2), {}, "adamw"),
}
TP_STEPS = 2


def tp_cfg(get, name):
    arch, _, over, _ = DIST_TP[name]
    base = _cfg(get) if arch == ARCH else get(arch).smoke()
    return base.replace(**over)


def tp_batch(cfg):
    """:func:`_batch`, with the encoder-decoder's (4, frames, D) stub
    frame embeddings from seed 1."""
    b = _batch()
    if cfg.family == "encdec":
        b["frames"] = np.random.default_rng(1).normal(
            size=(4, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return b


def _ranks_tp(params_np, names):
    """Each of ``names``' steps of DIST_TP on its mesh."""
    out = {}
    for name in names:
        _, shape, _, opt = DIST_TP[name]
        cfg = tp_cfg(tget, name)
        mesh = tmesh.make_rank_mesh(shape, ("data", "model"), device="cpu")
        params = interop.params_from_numpy(params_np[name], cfg, device="cpu")
        out[name] = _sharded_run(cfg, getattr(optim, opt)(), params,
                                 _tbatch(tp_batch(cfg)), mesh, TP_STEPS)
    return out


def _fail_on_rank_1():
    if torch.distributed.get_rank() == 1:
        raise ValueError("boom")
    torch.distributed.barrier()


def _sleep(s):
    import time
    time.sleep(s)


# -- test_torch_dist_parallel.py ---------------------------------------------

PLACE_MESHES = (((2, 2), ("data", "model")),
                ((2, 2, 1), ("pod", "data", "model")))
COMPRESS_ROUNDS = 8


def _ranks_parallel(archs, g, ws, x, n_micro):
    """Placement on both PLACE_MESHES, the int8 all-reduce and error
    feedback of ``g``'s rows (one a rank), the pipeline of ``ws`` over
    ``x``."""
    from repro_torch.models import encdec, transformer as tfm
    from repro_torch.parallel import compress as C
    from repro_torch.parallel import pipeline as PP
    from repro_torch.parallel import sharding as shd

    rank = torch.distributed.get_rank()
    out = dict(blocks={}, round_trip={}, pod_rows=None)
    for shape, axes in PLACE_MESHES:
        mesh = tmesh.make_rank_mesh(shape, axes, device="cpu")
        for arch in archs:
            specs = steps.param_specs(tget(arch))
            places = [D.placements(s, mesh) for s in shd.spec_leaves(
                specs, shd.param_shardings(specs, mesh))]
            out["blocks"][(shape, arch)] = [
                tuple(D.block_of(leaf, mesh.device_mesh, p).shape)
                for leaf, p in zip(T.leaves(specs), places)]
            cfg = tget(arch).smoke()
            init = (encdec.init_params if cfg.family == "encdec"
                    else tfm.init_params)
            t = init(cfg, torch.Generator().manual_seed(0), device="cpu")
            placed = D.shard_tree(t, shd.param_shardings(t, mesh), mesh)
            out["round_trip"][(shape, arch)] = all(
                torch.equal(a, b) for a, b in zip(
                    T.leaves(D.gather_tree(placed)), T.leaves(t)))
        if "pod" in axes:
            rows = D.shard(torch.arange(24.0).reshape(8, 3),
                           shd.P(("pod", "data"), None), mesh)
            out["pod_rows"] = rows.to_local()[:, 0].tolist()

    mesh = tmesh.make_rank_mesh((4,), ("data",), device="cpu")
    group = mesh.group("data")
    row = torch.from_numpy(g[rank])
    total, scale = C.int8_allreduce(row, group)
    out["total"], out["scale"] = total.numpy(), scale.numpy()
    out["mean"] = C.compressed_allreduce_mean(row, group).numpy()
    res = C.init_residual(dict(g=row))
    feedback = []
    for _ in range(COMPRESS_ROUNDS):
        new_g, res = C.with_error_feedback(dict(g=row), res, group)
        feedback.append((new_g["g"].numpy(), res["g"].numpy()))
    out["feedback"] = feedback

    mesh = tmesh.make_rank_mesh((4,), ("stage",), device="cpu")
    fn = PP.pipelined_apply(lambda x, w: torch.tanh(x @ w), mesh, "stage",
                            n_micro)
    wt = torch.from_numpy(ws)
    out["pipe"] = fn(torch.from_numpy(x), wt).numpy()
    out["pipe_dtensor"] = fn(torch.from_numpy(x),
                             D.shard(wt, shd.P("stage"), mesh)).numpy()
    return out


# the dry-run's train cell on a (2, 2) mesh (test_torch_dryrun.py): the
# smoke config of ARCH at the cell's bf16 dtype, 4 rows of 32 tokens
DRYRUN_CELL = dict(name="t", kind="train", seq_len=32, global_batch=4)


def _ranks_dryrun():
    """One train step of the dry-run's cell (``steps.build_cell``'s program:
    the cell's optimizer, params and state placed by their specs) on this
    rank's real tensors of a (2, 2) ``gloo`` mesh: the step's
    ``metrics["comm"]`` without its host seconds, and its FLOPs under
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.parallel import sharding as shd

    cfg = tget(ARCH).smoke().replace(dtype="bfloat16")
    cell = ShapeCell(**DRYRUN_CELL)
    mesh = tmesh.make_rank_mesh((2, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = steps._init_fn(cfg)(cfg, generator=gen, device="cpu")
    opt = steps.cell_optimizer(params, mesh)
    state = opt.init(params)
    sp = D.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    so = D.shard_tree(state, shd.opt_state_shardings(state, mesh, params),
                      mesh)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              dtype=torch.int32)
             for k, v in steps.train_batch_specs(cfg, cell, mesh).items()}
    fn = DS.make_distributed_train_step(cfg, opt, mesh)
    with FlopCounterMode(display=False) as fc:
        out = fn(sp, so, batch)
    comm = {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in out[2]["comm"].items() if not k.endswith("_s")}
    return comm, fc.get_total_flops()
