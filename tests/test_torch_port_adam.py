"""Adam's update of every leaf in one launch (``ops/adam.py``,
``csrc/adam.cu``).

On the CPU: ``Adam.update`` runs the plain version and gives the values of
the per-leaf arithmetic it replaced, bitwise, and the wrapper's launch plan
(tables of leaves, 16-byte units and single values, grid, output offsets)
is the hand-counted one for the lego nets' 48 leaves and for more leaves
than one table holds. Tests marked ``cuda`` hold the kernel against the
plain version on the card, bitwise, at the same leaves; they skip without
a card. This file imports no JAX, so it also runs on a card's machine:
``python3 -m pytest --noconftest tests/test_torch_port_adam.py``
(``tests/conftest.py`` imports JAX)."""

import numpy as np
import pytest
import torch

from cvnerf_torch.ops import adam as fa
from cvnerf_torch.train.state import Adam, AdamState
from cvnerf_torch.utils.kernels import load_library

# The lego nets' leaves, one net in init_nerf_params order (l1-l9, alpha,
# l10, l11; w then b), and the two nets' counts.
NET_SHAPES = [(63, 256), (256,), (256, 256), (256,), (256, 256), (256,),
              (256, 256), (256,), (256, 256), (256,), (319, 256), (256,),
              (256, 256), (256,), (256, 256), (256,), (256, 256), (256,),
              (256, 1), (1,), (283, 128), (128,), (128, 3), (3,)]
LEGO_SHAPES = NET_SHAPES * 2
LEGO_VALUES = 1_191_688
COUNTS = [0, 1, 2, 499, 500]
KINDS = ["random", "zero", "large", "tiny"]
B1, B2, EPS = 0.9, 0.999, 1e-8


def _grads(kind: str, rng: np.random.Generator, shape) -> np.ndarray:
    """Gradients of one leaf: ``zero`` as the occupancy step's coarse net
    has them, ``large`` with squares near 1e30, ``tiny`` with squares
    below float32's normal range."""
    g = rng.standard_normal(shape)
    return {"random": 1e-3 * g, "zero": np.zeros(shape), "large": 1e15 * g,
            "tiny": 1e-30 * g}[kind]


def _leaves(kind: str, seed: int, device, shapes=LEGO_SHAPES) -> dict:
    """params, grads, mu, nu as lists of float32 leaves on ``device``."""
    rng = np.random.default_rng(seed)
    out = {"params": [], "grads": [], "mu": [], "nu": []}
    for shape in shapes:
        out["params"].append(0.05 * rng.standard_normal(shape))
        out["grads"].append(_grads(kind, rng, shape))
        out["mu"].append(1e-4 * rng.standard_normal(shape))
        out["nu"].append(1e-7 * np.abs(rng.standard_normal(shape)))
    return {k: [torch.tensor(np.asarray(x, np.float32), device=device)
                for x in v] for k, v in out.items()}


def _scalars(count: int, device) -> torch.Tensor:
    return torch.tensor(Adam(lr=5e-4, lr_decay=250).scalars(count),
                        device=device)


def _today(params, grads, mu, nu, scalars):
    """The per-leaf arithmetic ``Adam.update`` ran before the kernel."""
    step, bc1, bc2 = scalars.unbind(0)
    m = [(1 - B1) * g + B1 * x for g, x in zip(grads, mu)]
    v = [(1 - B2) * (g * g) + B2 * x for g, x in zip(grads, nu)]
    p = [x + step * ((a / bc1) / (torch.sqrt(b / bc2) + EPS))
         for x, a, b in zip(params, m, v)]
    return p, m, v


def _bits(ts) -> list:
    return [t.detach().cpu().view(torch.int32) for t in ts]


def _assert_bitwise(got, want):
    for a, b in zip(_bits(got), _bits(want)):
        assert torch.equal(a, b)


def _tree(leaves: list) -> dict:
    return {i: {"w": t} for i, t in enumerate(leaves)}


def _flat(tree: dict) -> list:
    return [tree[i]["w"] for i in sorted(tree)]


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("kind", KINDS)
def test_update_on_the_cpu_is_the_plain_version_bitwise(kind, count):
    """CPU leaves: ``Adam.update`` calls the plain version once, launches
    nothing, leaves its inputs as they were and gives the per-leaf
    arithmetic's values, bitwise."""
    x = _leaves(kind, 100 + count, "cpu")
    before = [t.clone() for k in x for t in x[k]]
    scalars = _scalars(count, "cpu")
    launches, calls = fa.fused_adam.launches, fa.adam_plain.calls
    state = AdamState(count=count, mu=_tree(x["mu"]), nu=_tree(x["nu"]))
    new, st = Adam(lr=5e-4, lr_decay=250).update(
        _tree(x["grads"]), state, _tree(x["params"]), scalars)
    assert fa.fused_adam.launches == launches
    assert fa.adam_plain.calls == calls + 1
    assert st.count == count + 1
    want = _today(x["params"], x["grads"], x["mu"], x["nu"], scalars)
    for got, exp in zip((_flat(new), _flat(st.mu), _flat(st.nu)), want):
        _assert_bitwise(got, exp)
    _assert_bitwise([t for k in x for t in x[k]], before)


def test_launch_plan_of_the_lego_leaves():
    """48 leaves, one table; aligned: every leaf in 16-byte units but the
    alpha bias (1 value) and the rgb bias (3); 297,928 units a launch, 528
    blocks on 132 SMs."""
    numels = [int(np.prod(s)) for s in LEGO_SHAPES]
    assert sum(numels) == LEGO_VALUES
    assert sum(n <= 384 for n in numels) == 28
    (table,) = fa.launch_plan(numels, [True] * 48)
    assert [e[0] for e in table] == list(range(48))
    singles = {i: e[2] for i, e in enumerate(table) if e[2]}
    assert singles == {19: 1, 23: 3, 43: 1, 47: 3}
    assert all(e[1] == 0 for i, e in enumerate(table) if i in singles)
    assert table[0] == (0, 4032, 0) and table[10] == (10, 20416, 0)
    assert table[22] == (22, 96, 0)
    units = sum(e[1] + e[2] for e in table)
    assert units == 2 * (148_960 + 4) == 297_928
    assert fa.grid_size(units, 132) == 528
    # No leaf aligned: one value a unit.
    (table,) = fa.launch_plan(numels, [False] * 48)
    assert all(e[1] == 0 for e in table)
    assert sum(e[2] for e in table) == LEGO_VALUES
    # One misaligned leaf goes one value a unit alone.
    (table,) = fa.launch_plan(numels, [i != 2 for i in range(48)])
    assert table[2] == (2, 0, 65_536) and table[4] == (4, 16_384, 0)


@pytest.mark.parametrize("leaves,tables", [(56, [56]), (57, [56, 1]),
                                           (120, [56, 56, 8])])
def test_more_leaves_than_a_table_take_a_launch_each(leaves, tables):
    numels = [i % 7 for i in range(leaves)]
    plan = fa.launch_plan(numels, [True] * leaves)
    assert fa.TABLE_LEAVES == 56
    assert [len(t) for t in plan] == tables
    entries = [e for t in plan for e in t]
    assert entries == [(i, n // 4, n % 4) for i, n in enumerate(numels)]


def test_grid_and_output_offsets():
    assert fa.grid_size(1, 132) == 1
    assert fa.grid_size(256, 132) == 1 and fa.grid_size(257, 132) == 2
    assert fa.grid_size(10 ** 9, 132) == 4 * 132
    assert fa.grid_size(10 ** 9, 78) == 4 * 78
    assert fa.out_offsets([1, 3, 384, 16128, 0, 5]) == [
        0, 4, 8, 392, 16520, 16520, 16528]
    assert fa.out_offsets([int(np.prod(s)) for s in LEGO_SHAPES])[-1] \
        == LEGO_VALUES + 2 * (3 + 1)


def test_the_checks_refuse_what_the_kernel_does_not_take():
    """The wrapper's checks (run before a launch): a bf16, a non-contiguous
    or a misshapen leaf, a leaf on another device than the scalars, and
    scalars that are not a float32 [3] raise."""
    x = _leaves("random", 3, "cpu", NET_SHAPES[:4])
    scalars = _scalars(0, "cpu")
    assert fa._check(x, scalars) == torch.device("cpu")
    bad = {"bf16": lambda t: t.bfloat16(),
           "strided": lambda t: t.t(),
           "shape": lambda t: t[:1]}
    for name, fn in bad.items():
        y = {**x, "mu": [fn(x["mu"][0]), *x["mu"][1:]]}
        with pytest.raises(ValueError):
            fa._check(y, scalars)
    with pytest.raises(ValueError):
        fa._check({**x, "nu": x["nu"][:-1]}, scalars)
    with pytest.raises(ValueError):
        fa._check(x, scalars.double())
    with pytest.raises(ValueError):
        fa._check(x, _scalars(0, "meta"))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_is_bitwise_the_plain_version_on_card(cuda_device, kind,
                                                     count):
    """The 48 lego leaves on the card: one launch, p, m and v bitwise the
    plain version's on the same card, inputs untouched."""
    x = _leaves(kind, 200 + count, cuda_device)
    before = [t.clone() for k in x for t in x[k]]
    scalars = _scalars(count, cuda_device)
    launches = fa.fused_adam.launches
    got = fa.fused_adam(*x.values(), scalars, B1, B2, EPS)
    assert fa.fused_adam.launches == launches + 1
    want = fa.adam_plain(*x.values(), scalars, B1, B2, EPS)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    _assert_bitwise([t for k in x for t in x[k]], before)
    state = AdamState(count=count, mu=_tree(x["mu"]), nu=_tree(x["nu"]))
    new, st = Adam(lr=5e-4, lr_decay=250).update(
        _tree(x["grads"]), state, _tree(x["params"]), scalars)
    assert fa.fused_adam.launches == launches + 2
    for g, w in zip((_flat(new), _flat(st.mu), _flat(st.nu)), want):
        _assert_bitwise(g, w)


@pytest.mark.cuda
def test_a_captured_update_reads_each_rows_scalars_on_card(cuda_device):
    """One launch captured in a CUDA graph, replayed over three rows: each
    replay is the plain version at that row's scalars."""
    x = _leaves("random", 7, cuda_device)
    row = _scalars(0, cuda_device)
    fa.fused_adam(*x.values(), row, B1, B2, EPS)        # builds, warms up
    torch.cuda.synchronize()
    launches = fa.fused_adam.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.fused_adam(*x.values(), row, B1, B2, EPS)
    assert fa.fused_adam.launches == launches + 1
    for count in (3, 499, 500):
        row.copy_(_scalars(count, cuda_device))
        graph.replay()
        want = fa.adam_plain(*x.values(), row, B1, B2, EPS)
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            _assert_bitwise(g, w)
    assert fa.fused_adam.launches == launches + 1


@pytest.mark.cuda
def test_misaligned_leaves_and_several_tables_on_card(cuda_device):
    """120 leaves of 0-70 values, every third one 4 bytes off a 16-byte
    boundary: three launches, bitwise the plain version."""
    assert load_library("adam", fa._bind).cvnerf_fused_adam_table_leaves() \
        == fa.TABLE_LEAVES
    rng = np.random.default_rng(11)
    x = {k: [] for k in ("params", "grads", "mu", "nu")}
    for i in range(120):
        n = int(rng.integers(0, 71))
        for k in x:
            vals = rng.standard_normal(n).astype(np.float32)
            if k == "nu":
                vals = np.abs(1e-6 * vals)
            t = torch.empty(n + 1, device=cuda_device)
            t = t[1:] if i % 3 == 0 else t[:n]
            x[k].append(t.copy_(torch.from_numpy(vals)))
    scalars = _scalars(5, cuda_device)
    launches = fa.fused_adam.launches
    got = fa.fused_adam(*x.values(), scalars, B1, B2, EPS)
    assert fa.fused_adam.launches == launches + 3
    want = fa.adam_plain(*x.values(), scalars, B1, B2, EPS)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


@pytest.mark.cuda
def test_the_wrapper_raises_and_does_not_fall_back_on_card(cuda_device):
    """A bf16, a non-contiguous or a cross-device leaf raises; nothing
    launches and the plain version is not called."""
    x = _leaves("random", 9, cuda_device, NET_SHAPES[:4])
    scalars = _scalars(0, cuda_device)
    launches, calls = fa.fused_adam.launches, fa.adam_plain.calls
    for fn in (lambda t: t.bfloat16(), lambda t: t.t(),
               lambda t: t.cpu()):
        y = {**x, "grads": [fn(x["grads"][0]), *x["grads"][1:]]}
        with pytest.raises(ValueError):
            fa.fused_adam(*y.values(), scalars, B1, B2, EPS)
    with pytest.raises(ValueError):
        fa.fused_adam(*x.values(), scalars.cpu(), B1, B2, EPS)
    assert fa.fused_adam.launches == launches
    assert fa.adam_plain.calls == calls
