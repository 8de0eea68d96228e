"""The frozen draw: ``init_params(cfg, g, bits=b)`` packs each weight as it
is drawn, and gives ``freeze_for_serving(init_params(cfg, g), bits=b)`` bit
for bit, leaf for leaf, at the smoke config of every decoder family, while
it never holds more f32 weights than the largest one beside the packed
tree.  The launcher draws through it (``launch/serve._init_packed``)."""

import weakref

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

# one config of each decoder family, and the other dense archs
ARCHS = ("qwen3-0.6b", "gemma-7b", "qwen2.5-3b", "olmo-1b",
         "qwen2-moe-a2.7b", "falcon-mamba-7b", "hymba-1.5b",
         "llava-next-34b")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _assert_same_tree(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path
    assert not got.requires_grad, path


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_draw_equals_freezing_the_whole_draw(arch, bits):
    cfg = get_config(arch).smoke()
    want = sharding.freeze_for_serving(
        tfm.init_params(cfg, _gen(), device="cpu"), bits=bits, device="cpu")
    got = tfm.init_params(cfg, _gen(), device="cpu", bits=bits)
    _assert_same_tree(got, want)
    assert any(k.endswith("/packed") for k in _flat_keys(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_draw_holds_one_f32_weight_beside_the_packed_tree(arch,
                                                               monkeypatch):
    """A hook on ``freeze_leaf`` sees every drawn weight in f32 and keeps
    a weak reference to it.  At each draw the f32 weights still alive (the
    one just drawn, and the unpacked leaves the tree keeps, such as the
    embedding) stay within the largest weight's bytes plus the packed
    tree's, and no packed weight's f32 form outlives its packing."""
    cfg = get_config(arch).smoke()
    seen = []        # (name, weak reference, bytes)
    alive_at = []    # f32 bytes alive as each weight is frozen
    real = sharding.freeze_leaf

    def hook(name, leaf, bits, device=None):
        for n, ref, _b in seen:
            if n in sharding.PACKABLE and ref() is not None:
                raise AssertionError(f"{n}'s f32 form outlived its packing "
                                     f"when {name} was drawn")
        nbytes = leaf.numel() * leaf.element_size()
        alive_at.append(nbytes + sum(b for _n, ref, b in seen
                                     if ref() is not None))
        out = real(name, leaf, bits, device)
        # a leaf kept unpacked lives on in the tree as the tensor returned
        seen.append((name, weakref.ref(out if isinstance(out, torch.Tensor)
                                       else leaf), nbytes))
        return out

    monkeypatch.setattr(sharding, "freeze_leaf", hook)
    tree = tfm.init_params(cfg, _gen(), device="cpu", bits=8)
    assert {n for n, _r, _b in seen} >= {"embed"}
    largest = max(b for _n, _r, b in seen)
    assert max(alive_at) <= largest + _nbytes(tree)
    # the hook saw every packed leaf of the tree
    packed = sum(1 for k in _flat_keys(tree) if k.endswith("/packed"))
    assert sum(1 for n, _r, _b in seen if n in sharding.PACKABLE) == packed


def _flat_keys(tree, prefix=""):
    if not isinstance(tree, dict):
        return [prefix]
    return [k for key, v in tree.items()
            for k in _flat_keys(v, f"{prefix}/{key}")]


def test_the_launcher_draws_the_frozen_tree():
    """``_init_packed`` (``main``, ``_build_model`` and ``--models``) is the
    frozen draw of the launcher's seed and ``--bits``."""
    args = launch_serve._parser().parse_args(
        ["--arch", "gemma-7b", "--smoke", "--device", "cpu", "--bits", "4"])
    cfg = launch_serve._config(args)
    got = launch_serve._init_packed(cfg, 7, args)
    want = sharding.freeze_for_serving(
        tfm.init_params(cfg, torch.Generator("cpu").manual_seed(7),
                        device="cpu"), bits=4, device="cpu")
    _assert_same_tree(got, want)


def test_vlm_init_params_passes_bits_through():
    cfg = get_config("llava-next-34b").smoke()
    _assert_same_tree(vlm.init_params(cfg, _gen(3), "cpu", bits=2),
                      tfm.init_params(cfg, _gen(3), "cpu", bits=2))


def test_freeze_leaf_is_freeze_for_serving_on_one_leaf():
    w = torch.randn((3, 8, 40), generator=_gen(1))
    one = sharding.freeze_leaf("w_up", w, 4, "cpu")
    tree = sharding.freeze_for_serving({"mlp": {"w_up": w}}, bits=4,
                                       device="cpu")
    _assert_same_tree(one, tree["mlp"]["w_up"])
    assert one["packed"].shape == (3, 8, 20) and one["scale"].shape == (3, 8)
    # not PACKABLE, or a vector: kept as it is
    kept = sharding.freeze_leaf("router", w, 4, "cpu")
    assert torch.equal(kept, w) and kept.data_ptr() == w.data_ptr()
    v = torch.randn(8, generator=_gen(2))
    assert torch.equal(sharding.freeze_leaf("w_up", v, 4, "cpu"), v)
