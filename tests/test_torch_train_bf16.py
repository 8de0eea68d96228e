"""Port parity: training at ``dtype="bfloat16"`` (ROADMAP A10), against
the JAX package on the CPU, for the smoke configs of the dense
(qwen3-0.6b), SSM (falcon-mamba-7b), hybrid (hymba-1.5b), MoE
(qwen2-moe-a2.7b) and VLM (llava-next-34b) families and whisper-tiny.

Both packages train bf16 weights with f32 optimizer state and no master
copy (``repro/optim/optimizers.py:59, 122``): the update is computed in f32
and rounded to the leaf's bf16.  The JAX side runs in one subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, so that XLA rounds
every bf16 op as the port does (under its default it keeps f32 inside
fusions, ``test_torch_bf16.py``): ``jax.value_and_grad`` of the
reference's loss, then 3 AdamW and 2 Adafactor steps of
``jax.jit(make_train_step)`` at the default lr 3e-4, keeping each step's
starting params and optimizer state.  The port takes each step from the
reference's state of that step, so that a step is held alone and
differences do not compound over the steps.

Tolerances, each with its reason:

- the loss within a relative 1e-4: every config but falcon-mamba-7b
  gives the reference's loss within 1e-7; its bf16 training scan within
  3.2e-5 (ROADMAP C23);
- each gradient leaf within BF16_GRAD_TOL (3e-2) of its largest element,
  ``test_torch_train.py``'s: bf16 gradients round in the two backward
  passes' orders (ROADMAP C13).  Since C20 (``layers.silu`` and
  ``gelu_tanh`` transpose as JAX's rules) the dense config's gradients are
  the reference's bit for bit but for 6 elements of 90,496; a bias's and
  the MoE gates' gradients, whose broadcast JAX transposes to a bf16
  reduce that XLA adds up one row at a time, stay a few ulps apart
  (ROADMAP C21);
- each step's global gradient norm within a relative 2e-3 (norms of
  bf16 gradients that part as above: 6.8e-4 at most, hymba-1.5b);
- each leaf after a step within rtol = atol = 2e-3, the mesh tests'
  leaf tolerance;
- each leaf's change over a step within 5 % of the reference's change, in
  norm, for qwen3-0.6b (1.3 % at most; Adafactor's steps bit-equal).  At
  lr 3e-4 a step moves a bf16 element by 1-3 ulps, so an element rounded
  one ulp the other way, or a gradient element near zero of the other
  sign, moves a leaf's change by several per cent: where the gradients
  are not bit-equal (the other five configs) the changes part by 4-24 %
  in norm, and 84-94 % at qwen2-moe's key bias, whose exact gradient is
  zero (a key bias adds a constant to each query's logits), so both
  packages step it on rounding noise.  That is printed, not asserted
  (ROADMAP C21).

Whisper-tiny reads ``dtype`` as the decoder-only families do (bf16 weights
and activations) and ignores ``attn_dtype`` (C14) in both packages.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

ARCHS = ("qwen3-0.6b", "falcon-mamba-7b", "hymba-1.5b", "qwen2-moe-a2.7b",
         "llava-next-34b", "whisper-tiny")
N_STEPS = {"adamw": 3, "adafactor": 2}
BF16_LOSS_RTOL = 1e-4
BF16_GRAD_TOL = 3e-2
BF16_GNORM_RTOL = 2e-3
LEAF_TOL = dict(rtol=2e-3, atol=2e-3)
DELTA_RTOL = 0.05
DELTA_HELD = ("qwen3-0.6b",)

_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import optim
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.launch.steps import _init_fn, _loss_fn, make_train_step

out = {}

def put(key, tree):
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        a = np.asarray(leaf)
        out[f"{key}/{i}"] = a.astype(np.float32) if a.dtype.kind == "V" or \\
            a.dtype.name == "bfloat16" else a

for arch in sys.argv[2:]:
    cfg = get_config(arch).smoke().replace(dtype="bfloat16")
    params = _init_fn(cfg)(cfg, jax.random.PRNGKey(0))
    b = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=0, family=cfg.family,
                           d_model=cfg.d_model, n_frames=cfg.n_audio_frames,
                           n_patches=cfg.n_patches).batch(0)
    for k, v in b.items():
        out[f"{arch}/batch/{k}"] = v
    b = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bb: _loss_fn(cfg)(p, bb, cfg)))(params, b)
    put(f"{arch}/params", params)
    out[f"{arch}/dtypes"] = np.array([str(x.dtype) for x in
                                      jax.tree_util.tree_leaves(params)])
    out[f"{arch}/loss"] = np.asarray(loss)
    put(f"{arch}/grads", grads)
    for name, n in (("adamw", 3), ("adafactor", 2)):
        opt = getattr(optim, name)()
        step = jax.jit(make_train_step(cfg, opt))
        p, s = params, opt.init(params)
        for k in range(n):
            put(f"{arch}/{name}/{k}/state", s)
            put(f"{arch}/{name}/{k}/params", p)
            p, s, met = step(p, s, b)
            out[f"{arch}/{name}/{k}/loss"] = np.asarray(met["loss"])
            out[f"{arch}/{name}/{k}/gnorm"] = np.asarray(met["grad_norm"])
        put(f"{arch}/{name}/{n}/params", p)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's values for every arch, from one subprocess with
    bf16 excess precision off."""
    path = tmp_path_factory.mktemp("bf16train") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _SCRIPT, str(path), *ARCHS],
                   env=env, check=True, timeout=900)
    return dict(np.load(path))


def _tree(ref, key, like):
    """The saved leaves ``key/i`` in the structure and dtypes of the port's
    tree ``like``."""
    flat = T.leaves(like)
    return T.unflatten(like, [torch.from_numpy(ref[f"{key}/{i}"]).to(
        x.dtype) for i, x in enumerate(flat)])


def _setup(ref, arch):
    cfg = tget(arch).smoke().replace(dtype="bfloat16")
    specs = steps.param_specs(cfg)
    assert [str(x.dtype).replace("torch.", "") for x in T.leaves(specs)] == \
        list(ref[f"{arch}/dtypes"])
    params = _tree(ref, f"{arch}/params", specs)
    batch = {k.rsplit("/", 1)[1]: torch.from_numpy(v)
             for k, v in ref.items() if k.startswith(f"{arch}/batch/")}
    return cfg, params, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_match_jax(ref, arch):
    cfg, params, batch = _setup(ref, arch)
    assert {x.dtype for x in T.leaves(params)} >= {torch.bfloat16}
    loss, grads = steps.loss_and_grads(params, batch, cfg)
    want = float(ref[f"{arch}/loss"])
    assert abs(float(loss) - want) <= BF16_LOSS_RTOL * abs(want)
    for i, (path, g) in enumerate(T.flatten_with_paths(grads)):
        assert g.dtype == T.leaves(params)[i].dtype, path
        b = ref[f"{arch}/grads/{i}"]
        a = g.float().numpy()
        assert np.abs(a - b).max() <= BF16_GRAD_TOL * max(np.abs(b).max(),
                                                          1e-30), path


@pytest.mark.parametrize("name", sorted(N_STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_steps_match_jax(ref, arch, name):
    """3 AdamW or 2 Adafactor steps of ``make_train_step``, each from the
    reference's state of that step."""
    cfg, params, batch = _setup(ref, arch)
    opt = getattr(optim, name)()
    step = steps.make_train_step(cfg, opt)
    worst = []
    for k in range(N_STEPS[name]):
        p0 = _tree(ref, f"{arch}/{name}/{k}/params", params)
        s0 = _tree(ref, f"{arch}/{name}/{k}/state", opt.init(params))
        p1, _, met = step(p0, s0, batch)
        want_loss = float(ref[f"{arch}/{name}/{k}/loss"])
        assert abs(float(met["loss"]) - want_loss) <= \
            BF16_LOSS_RTOL * abs(want_loss)
        want_gn = float(ref[f"{arch}/{name}/{k}/gnorm"])
        assert abs(float(met["grad_norm"]) - want_gn) <= \
            BF16_GNORM_RTOL * want_gn, (k, float(met["grad_norm"]), want_gn)
        for i, (path, a) in enumerate(T.flatten_with_paths(p1)):
            assert a.dtype == T.leaves(params)[i].dtype
            a = a.float().numpy()
            b = ref[f"{arch}/{name}/{k + 1}/params/{i}"]
            a0 = T.leaves(p0)[i].float().numpy()
            np.testing.assert_allclose(a, b, **LEAF_TOL, err_msg=str(path))
            moved = float(np.linalg.norm(b - a0))
            apart = float(np.linalg.norm(a - b))
            worst.append((apart / max(moved, 1e-30), k, "/".join(path)))
            if arch in DELTA_HELD:
                assert apart <= DELTA_RTOL * moved, (k, path, apart, moved)
    print(f"{arch} {name}: the largest change apart from the reference's, "
          f"in norm: {max(worst)}")


# --- the bf16 MoE serve (qwen2-moe-a2.7b at dtype="bfloat16", 8 bits) ---

MOE_ARCH = "qwen2-moe-a2.7b"
SERVE_LENS = (7, 12, 7, 12)
SERVE_NEW = 6
# the prefill's and first decode step's logits: both packages round every
# bf16 op in one order (excess precision off), so a few bf16 ulps of the
# largest logit, test_torch_bf16.py's STEP_ULPS
SERVE_ULPS = 8

_SERVE_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch import steps
from repro.models import transformer as tfm
from repro.parallel.sharding import freeze_for_serving
from repro.serving import Request, ServingEngine

cfg = get_config(sys.argv[2]).smoke().replace(dtype="bfloat16")
packed = freeze_for_serving(tfm.init_params(cfg, jax.random.PRNGKey(0)),
                            bits=8)
out = {}
flat = jax.tree_util.tree_leaves(packed)
for i, leaf in enumerate(flat):
    a = np.asarray(leaf)
    out[f"packed/{i}"] = a.astype(np.float32) if a.dtype.name == "bfloat16" \\
        else a
rng = np.random.default_rng(0)
prompts = [rng.integers(0, 256, n).astype(np.int32)
           for n in map(int, sys.argv[3].split(","))]
eng = ServingEngine(cfg, packed, batch_slots=4, max_len=64)
for uid, p in enumerate(prompts):
    out[f"prompt/{uid}"] = p
    eng.submit(Request(uid=uid, prompt=p, max_new_tokens=int(sys.argv[4])))
for r in eng.run_until_done():
    out[f"tokens/{r.uid}"] = np.asarray(r.generated, np.int32)
toks = jnp.asarray(np.stack([prompts[0], prompts[2]]))
logits, cache = steps.make_prefill_step(cfg)(
    packed, toks, tfm.init_serve_cache(cfg, 2, 32))
nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
dec, _ = steps.make_decode_step(cfg)(packed, nxt, cache,
                                     jnp.int32(toks.shape[1]))
out["prefill"] = np.asarray(logits, np.float32)
out["decode"] = np.asarray(dec, np.float32)
np.savez(sys.argv[1], **out)
"""


def test_bf16_moe_serve_matches_jax(tmp_path, monkeypatch):
    """qwen2-moe-a2.7b's smoke config at ``dtype="bfloat16"``, frozen at 8
    bits as the reference's dry-run builds its serve cells: the engine's
    greedy tokens equal the reference engine's per uid, every grouped
    expert matmul takes bf16 x, and ``make_prefill_step`` then one
    ``make_decode_step`` give the reference's logits within SERVE_ULPS bf16
    ulps of the largest."""
    from repro_torch.kernels import qmatmul as qmm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request, ServingEngine

    path = tmp_path / "serve.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _SERVE_SCRIPT, str(path), MOE_ARCH,
                    ",".join(map(str, SERVE_LENS)), str(SERVE_NEW)],
                   env=env, check=True, timeout=600)
    ref = dict(np.load(path))
    cfg = tget(MOE_ARCH).smoke().replace(dtype="bfloat16")
    specs = steps.serve_param_specs(cfg, bits=8)
    packed = T.unflatten(specs, [torch.from_numpy(ref[f"packed/{i}"]).to(
        x.dtype) for i, x in enumerate(T.leaves(specs))])
    seen, real = [], qmm.qmatmul_f32_grouped

    def grouped(x, *a, **kw):
        seen.append(x.dtype)
        return real(x, *a, **kw)
    monkeypatch.setattr(qmm, "qmatmul_f32_grouped", grouped)
    eng = ServingEngine(cfg, packed, batch_slots=4, max_len=64,
                        device="cpu")
    prompts = [ref[f"prompt/{i}"] for i in range(len(SERVE_LENS))]
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=SERVE_NEW))
    got = {r.uid: list(r.generated) for r in eng.run_until_done()}
    assert got == {u: ref[f"tokens/{u}"].tolist() for u in got}
    assert len(got) == len(SERVE_LENS)
    assert seen and set(seen) == {torch.bfloat16}

    toks = torch.from_numpy(np.stack([prompts[0], prompts[2]])).long()
    logits, cache = steps.make_prefill_step(cfg)(
        packed, toks, tfm.init_serve_cache(cfg, 2, 32, device="cpu"))
    nxt = logits[:, -1].float().argmax(-1, keepdim=True)
    dec, _ = steps.make_decode_step(cfg)(packed, nxt, cache, toks.shape[1])
    for a, b in ((logits, ref["prefill"]), (dec, ref["decode"])):
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - b).max()
        assert err <= SERVE_ULPS * np.abs(b).max() * 2.0 ** -8, err
