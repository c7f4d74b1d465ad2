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
