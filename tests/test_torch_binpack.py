"""The port's pure-Python ``py`` packers (``repro_torch.core.binpack`` /
``.modified``, copies of the reference's) against ``repro.core``, and the
port's two backends against each other.

Held exactly: every ``py`` packer's assignment, loads, creation order and
bin count against the reference's ``py`` packer on the same instance
(mappings, sequences of pairs, previous assignments, oversized items,
string pids), and ``py`` against ``torch`` for all 12 registered packers
-- the port's counterpart of ``tests/test_jaxpack.py``'s cross-backend
property, with speeds quantized to k/1024 so that every load sum is
exact in float32.  The assignment helpers and the ``py`` policies' steps
equal the reference's too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.registry as jreg  # noqa: E402
from repro.core import assignment as ja  # noqa: E402
from repro.core import binpack as jb  # noqa: E402
from repro.core import modified as jm  # noqa: E402
from repro_torch import registry as treg  # noqa: E402
from repro_torch.core import assignment as ta  # noqa: E402
from repro_torch.core import binpack as tb  # noqa: E402
from repro_torch.core import modified as tm  # noqa: E402

PACKERS = treg.list_policies(family=treg.PACKER_FAMILIES, backend="py")
C = 1.0


def _instance(seed, n=14, oversized=False, quantized=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.01, 0.6, n)
    if oversized:
        w[::5] = rng.uniform(1.0, 1.6, len(w[::5]))
    if quantized:
        w = np.round(w * 1024) / 1024.0
    prev = rng.integers(-1, max(1, n // 2), n)
    return ({j: float(x) for j, x in enumerate(w)},
            {j: int(c) for j, c in enumerate(prev) if c >= 0})


def _same(a, b):
    assert a.pid_to_bin == b.pid_to_bin
    assert a.loads == b.loads
    assert a.creation_order == b.creation_order
    assert a.n_bins == b.n_bins
    assert a.bins() == b.bins()
    assert a.composition() == b.composition()


@pytest.mark.parametrize("case", ("fresh", "prev", "oversized", "pairs",
                                  "strings"))
@pytest.mark.parametrize("name", PACKERS)
def test_py_packers_equal_the_reference(name, case):
    speeds, prev = _instance(PACKERS.index(name), oversized=case == "oversized")
    if case == "fresh":
        prev = None
    elif case == "strings":
        speeds = {f"t-{j}": w for j, w in speeds.items()}
        prev = {f"t-{j}": c for j, c in prev.items()}
    items = list(speeds.items()) if case == "pairs" else speeds
    if name in jm.MODIFIED:
        # the modified family takes a mapping; pairs go through dict()
        items = dict(items)
    got = treg.packer_for(name, backend="py")(items, C, prev=prev)
    want = jreg.packer_for(name, backend="py")(items, C, prev=prev)
    _same(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", PACKERS)
def test_py_equals_torch(name, seed):
    """The same registered name on both of the port's backends: the same
    bin name per item, the same loads and bin count."""
    rows = []
    for r in range(4):
        rows.append(_instance(100 * seed + r, n=3 + 5 * r, quantized=True,
                              oversized=(seed % 3 == 2)))
    n = max(len(sp) for sp, _ in rows)
    speeds = np.zeros((4, n), np.float32)
    prev = np.full((4, n), -1, np.int64)
    active = np.zeros((4, n), bool)
    for r, (sp, pv) in enumerate(rows):
        speeds[r, :len(sp)] = list(sp.values())
        active[r, :len(sp)] = True
        for j, c in pv.items():
            prev[r, j] = c
    out = treg.packer_for(name)(torch.tensor(speeds), torch.tensor(prev), C,
                                active=torch.tensor(active))
    for r, (sp, pv) in enumerate(rows):
        ref = treg.packer_for(name, backend="py")(sp, C, prev=pv)
        k = int(out.n_bins[r])
        assert k == ref.n_bins, (name, r)
        bin_of = out.bin_of[r].numpy()
        for j, cid in ref.pid_to_bin.items():
            assert int(bin_of[j]) == cid, (name, r, j)
        assert (bin_of[len(sp):] < 0).all()
        names = out.names[r, :k].numpy()
        loads = out.loads[r, :k].numpy()
        got = {int(c): float(ld) for c, ld in zip(names, loads)}
        assert got == {c: float(np.float32(ld))
                       for c, ld in ref.loads.items()}, (name, r)


@pytest.mark.parametrize("sticky", (False, True))
@pytest.mark.parametrize("name", treg.list_policies(family="heuristic",
                                                    backend="py"))
def test_classical_sticky_override_equals_the_reference(name, sticky):
    spec = treg.get_spec(name, backend="py")
    speeds, prev = _instance(7, n=12)
    kw = dict(strategy=spec.hyperparams["strategy"],
              decreasing=spec.hyperparams["decreasing"], prev=prev,
              sticky=sticky)
    _same(tb.pack(speeds, C, **kw), jb.pack(speeds, C, **kw))


def test_errors_and_helpers_equal_the_reference():
    for call in (lambda m: m.pack({0: 0.1}, C, strategy="almost"),):
        with pytest.raises(ValueError) as want:
            call(jb)
        with pytest.raises(ValueError) as got:
            call(tb)
        assert str(got.value) == str(want.value)
    for kw in (dict(fit="first"), dict(sort_key="median")):
        with pytest.raises(ValueError) as want:
            jm.modified_any_fit({0: 0.1}, C, **kw)
        with pytest.raises(ValueError) as got:
            tm.modified_any_fit({0: 0.1}, C, **kw)
        assert str(got.value) == str(want.value)
    assert tb.FIT_STRATEGIES == jb.FIT_STRATEGIES
    assert tm.SORT_KEYS == jm.SORT_KEYS
    assert sorted(tb.CLASSICAL) == sorted(jb.CLASSICAL)
    assert sorted(tm.MODIFIED) == sorted(jm.MODIFIED)
    a = {"x": 1, 3: 0, "y": 1, 0: 2}
    assert ta.group_view(a) == ja.group_view(a)
    b = {3: 0, 1: 1, 2: 0}
    assert ta.group_view(b) == ja.group_view(b)
    assert ta.rebalanced_partitions(b, {3: 1, 1: 1, 9: 0}) == \
        ja.rebalanced_partitions(b, {3: 1, 1: 1, 9: 0})
    for ws in ([], [0.0], [0.4, 0.4, 0.4], [2.5]):
        assert (ta.capacity_lower_bound(ws, C)
                == ja.capacity_lower_bound(ws, C))
    assert ta.total_load({0: 0.25, 1: 0.5}) == ja.total_load({0: 0.25,
                                                             1: 0.5})


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("name", ("NF", "BFD", "WF", "MWF", "MBFP"))
def test_py_policy_steps_equal_the_reference(name, masked):
    """The ``py`` backend's Policy on one stream, step after step, with
    each step's assignment as the next one's ``prev``."""
    rng = np.random.default_rng(3)
    n = 9
    ours = treg.make_policy(name, n, C, backend="py")
    ref = jreg.make_policy(name, n, C, backend="py")
    assert ours.spec.backend == ref.spec.backend == "py"
    s_ours, s_ref = ours.init(n), ref.init(n)
    prev = np.full(n, -1, np.int32)
    for _ in range(6):
        speeds = rng.uniform(0.05, 0.7, n).astype(np.float32)
        act = rng.random(n) > 0.3 if masked else None
        a, k, s_ours = ours.step(speeds, None, prev, s_ours, act)
        b, kr, s_ref = ref.step(speeds, None, prev, s_ref, act)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert int(k) == int(kr)
        prev = a
