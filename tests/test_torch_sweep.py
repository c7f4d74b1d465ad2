"""The port's stream scans against ``repro.core.jaxpack``.

``sweep_streams`` runs every packer over a batch of streams, each step's
assignment feeding the next; the same numpy streams go through the
reference's ``sweep_streams`` / ``evaluate_stream_jax`` and the port's
(on the CPU: the plain packers).  Bins and migrations must be equal,
R-scores within ``1e-5``; with batch 1 the port's sweep equals its own
``evaluate_stream`` bit for bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import jaxpack as jp  # noqa: E402
from repro.registry import PACKER_FAMILIES, list_policies  # noqa: E402

# the batched submodule (the package-level ``pack`` is the py packer)
tp = importlib.import_module("repro_torch.core.pack")

ALGORITHMS = list_policies(family=PACKER_FAMILIES, backend="jax")
TOL = dict(atol=1e-5, rtol=0)
B, T, N = 3, 24, 9


def _streams(seed, masked):
    rng = np.random.default_rng(seed)
    sp = rng.uniform(0.0, 0.55, (B, T, N)).astype(np.float32)
    # a few oversized partitions and ties
    sp[:, ::7, 0] = 1.2
    sp[:, :, 1] = sp[:, :, 2]
    act = rng.uniform(size=(B, T, N)) < 0.8 if masked else None
    return sp, act


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_sweep_streams_equals_the_reference(algorithm, masked):
    sp, act = _streams(ALGORITHMS.index(algorithm), masked)
    ours = tp.sweep_streams((algorithm.lower(),), sp, 1.0, act,
                            device="cpu")
    ref = jp.sweep_streams((algorithm,), jnp.asarray(sp), 1.0,
                           None if act is None else jnp.asarray(act))
    assert ours.algorithms == ref.algorithms == (algorithm,)
    np.testing.assert_array_equal(ours.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(ours.migrations.numpy(),
                                  np.asarray(ref.migrations))
    np.testing.assert_allclose(ours.rscores.numpy(), np.asarray(ref.rscores),
                               **TOL)
    assert ours.bins.dtype == torch.int32 and ours.migrations.dtype == \
        torch.int32 and ours.rscores.dtype == torch.float32
    assert int(ours.migrations.sum()) > 0


@pytest.mark.parametrize("masked", (False, True))
def test_batch1_equals_evaluate_stream(masked):
    sp, act = _streams(40, masked)
    for a in ("NFD", "BF", "MBFP"):
        bins, rs = tp.evaluate_stream(sp[0], 1.0, algorithm=a,
                                      active=None if act is None else act[0],
                                      device="cpu")
        one = tp.sweep_streams((a,), sp[:1], 1.0,
                               None if act is None else act[:1],
                               device="cpu")
        assert torch.equal(one.bins[0, 0], bins)
        assert one.rscores[0, 0].numpy().tobytes() == rs.numpy().tobytes()
        w_bins, w_rs = jp.evaluate_stream_jax(
            jnp.asarray(sp[0]), 1.0, algorithm=a,
            active=None if act is None else jnp.asarray(act[0]))
        np.testing.assert_array_equal(bins.numpy(), np.asarray(w_bins))
        np.testing.assert_allclose(rs.numpy(), np.asarray(w_rs), **TOL)


def test_rows_equal_single_streams_and_lookup():
    sp, act = _streams(41, True)
    res = tp.sweep_streams(("mwf", "FFD"), sp, 1.0, act, device="cpu")
    assert res.bins.shape == res.rscores.shape == res.migrations.shape == \
        (2, B, T)
    for b in range(B):
        one = tp.sweep_streams(("MWF", "FFD"), sp[b:b + 1], 1.0,
                               act[b:b + 1], device="cpu")
        for f in ("bins", "rscores", "migrations"):
            assert torch.equal(getattr(res, f)[:, b], getattr(one, f)[:, 0])
    bins, rs, migs = res.for_algorithm("ffd")
    assert torch.equal(bins, res.bins[1]) and torch.equal(migs,
                                                          res.migrations[1])
    # a step with no move has R-score 0
    assert bool(((res.migrations == 0) <= (res.rscores == 0)).all())


def test_shape_errors_are_named():
    with pytest.raises(ValueError, match=r"f32\[B, T, N\]"):
        tp.sweep_streams(("BFD",), np.zeros((4, 3)), 1.0, device="cpu")
    with pytest.raises(ValueError, match="active mask has shape"):
        tp.sweep_streams(("BFD",), np.zeros((1, 4, 3)), 1.0,
                         np.ones((1, 4, 2), bool), device="cpu")
    with pytest.raises(ValueError, match=r"f32\[T, N\]"):
        tp.evaluate_stream(np.zeros((1, 4, 3)), 1.0, algorithm="BFD",
                           device="cpu")
    with pytest.raises(ValueError, match="no one-shot packer"):
        tp.sweep_streams(("KEDA_LAG",), np.zeros((1, 4, 3)), 1.0,
                         device="cpu")
