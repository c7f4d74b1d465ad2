"""The port's batched packers against the reference's per-row packers.

Every one of the 12 registered packers packs a batch of rows ``[R, N]``
in one call; each row must equal ``repro.core.jaxpack``'s one-shot pack
of that row (``pack_jax`` / ``modified_any_fit_jax``), masked and
unmasked: bin of every item, bin count and slot names exactly, slot
loads within ``atol = rtol = 1e-5`` (in practice equal: both add the
same items in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.registry import packer_for  # noqa: E402
from repro_torch.registry import get_spec, list_policies  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
PACKERS = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD",
           "MWF", "MBF", "MWFP", "MBFP")


def test_port_registers_all_twelve_packers():
    assert list_policies(family=("heuristic", "sticky")) == PACKERS


def _instances(seed, masked, rows=5, n=7):
    rng = np.random.default_rng(seed)
    speeds = rng.uniform(0, 1.0, (rows, n)).astype(np.float32)
    speeds[::2] = np.round(speeds[::2] * 4) / 4          # ties on some rows
    speeds[1, 0] = 1.3                                   # an oversized item
    prev = rng.integers(-1, 2 * n + 1, (rows, n)).astype(np.int32)
    act = (rng.random((rows, n)) > 0.3) if masked else None
    return speeds, prev, act


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("name", PACKERS)
def test_batched_packer_matches_reference_rows(name, masked):
    ref = packer_for(name, backend="jax")
    ours = get_spec(name).packer
    for seed in (0, 1):
        speeds, prev, act = _instances(seed, masked)
        got = ours(torch.tensor(speeds), torch.tensor(prev), 1.0,
                   active=None if act is None else torch.tensor(act))
        for r in range(speeds.shape[0]):
            want = ref(jnp.asarray(speeds[r]), jnp.asarray(prev[r]), 1.0,
                       active=None if act is None else jnp.asarray(act[r]))
            ctx = (name, seed, r)
            np.testing.assert_array_equal(got.bin_of[r].numpy(),
                                          np.asarray(want.bin_of), ctx)
            assert int(got.n_bins[r]) == int(want.n_bins), ctx
            np.testing.assert_array_equal(got.names[r].numpy(),
                                          np.asarray(want.names), ctx)
            np.testing.assert_allclose(got.loads[r].numpy(),
                                       np.asarray(want.loads), **TOL)
            if act is not None:
                assert (got.bin_of[r].numpy()[~act[r]] == -1).all(), ctx


def _wide_row(seed, n, masked):
    """One row of ``n`` items: speeds on a coarse grid (ties), some
    oversized items, a few large consumers, ``prev`` across ``-1`` and
    the whole name range ``[0, 2n + 2)``."""
    rng = np.random.default_rng(seed)
    speeds = (np.round(rng.uniform(0, 1.0, n) * 8) / 8).astype(np.float32)
    speeds[::17] = 1.3
    prev = rng.integers(-1, 2 * n + 2, n).astype(np.int32)
    prev[: n // 4] = rng.integers(0, 4, n // 4)
    act = (rng.random(n) > 0.25) if masked else None
    return speeds, prev, act


def _check_row(name, speeds, prev, act):
    ours = get_spec(name).packer
    got = ours(torch.tensor(speeds[None]), torch.tensor(prev[None]), 1.0,
               active=None if act is None else torch.tensor(act[None]))
    want = packer_for(name, backend="jax")(
        jnp.asarray(speeds), jnp.asarray(prev), 1.0,
        active=None if act is None else jnp.asarray(act))
    np.testing.assert_array_equal(got.bin_of[0].numpy(),
                                  np.asarray(want.bin_of), name)
    assert int(got.n_bins[0]) == int(want.n_bins), name
    np.testing.assert_array_equal(got.names[0].numpy(),
                                  np.asarray(want.names), name)
    np.testing.assert_allclose(got.loads[0].numpy(), np.asarray(want.loads),
                               **TOL)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("name", PACKERS)
def test_packer_matches_reference_at_n64(name, masked):
    _check_row(name, *_wide_row(64, 64, masked))


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("name", ("BFD", "MBF"))
def test_packer_matches_reference_at_n256(name, masked):
    """``api.optimize``'s width (one 256-partition topic)."""
    _check_row(name, *_wide_row(256, 256, masked))


def test_plain_packers_on_cpu_tensors_launch_nothing():
    from repro_torch.core.pack import modified_any_fit_plain, pack_plain
    from repro_torch.kernels import _build

    speeds, prev, act = _instances(3, True)
    args = (torch.tensor(speeds), torch.tensor(prev), 1.0)
    _build.reset_launches()
    for name in PACKERS:
        get_spec(name).packer(*args, active=torch.tensor(act))
    pack_plain(*args, strategy="best", decreasing=True)
    modified_any_fit_plain(*args, fit="worst", sort_key="max_partition")
    counts = _build.launch_counts()
    assert {"pack_rows", "select_slot_grid"} <= set(counts)
    assert not any(counts.values()), counts


def test_out_of_range_previous_names_count_as_none():
    """A previous name outside ``[0, 2n + 2)`` (or below -1) packs as an
    unassigned item does."""
    speeds, prev, _ = _instances(4, False)
    n = speeds.shape[1]
    bad = prev.copy()
    bad[:, ::2] = np.where(np.arange(bad.shape[0])[:, None] % 2 == 0,
                           2 * n + 2 + 3, -5)
    fixed = np.where((bad >= 0) & (bad < 2 * n + 2), bad, -1)
    for name in PACKERS:
        packer = get_spec(name).packer
        got = packer(torch.tensor(speeds), torch.tensor(bad), 1.0)
        want = packer(torch.tensor(speeds), torch.tensor(fixed), 1.0)
        for f in ("bin_of", "loads", "names", "n_bins"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (name, f)
