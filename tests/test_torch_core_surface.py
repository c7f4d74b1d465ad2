"""The package surfaces of ``repro_torch.core`` and ``repro_torch.lagsim``
against the reference's, and the paper's Sec. VI-B evaluation driver
(``run_stream``, Eq. 12's ``cardinal_bin_score``, Eq. 13's
``average_rscores``, ``evaluate_deltas``, ``recovery_iterations``) held
against ``repro.core`` on the same numpy streams.

Both sides run their ``py`` packers on the host.  Bins and bin counts
exact; R-scores, their averages and the cardinal bin scores within 1e-6
(the reference's own tolerance between its scan and its controller loop,
``tests/test_jaxpack.py``); ``recovery_iterations`` exact.  The cases
mirror ``tests/test_jaxpack.py::test_stream_evaluation_matches_reference``
and ``tests/test_masking.py::test_masked_sweep_matches_reference_run_stream``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.lagsim as jlagsim  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.lagsim as tlagsim  # noqa: E402
from repro.registry import PACKER_FAMILIES  # noqa: E402
from repro.registry import list_policies  # noqa: E402
from repro.registry import packer_for as j_packer_for  # noqa: E402
from repro_torch.registry import packer_for as t_packer_for  # noqa: E402

C = 1.0
PACKERS = list_policies(family=PACKER_FAMILIES, backend="py")
RTOL = 1e-6


def test_lagsim_all_equals_reference():
    assert tlagsim.__all__ == jlagsim.__all__
    for name in tlagsim.__all__:
        assert hasattr(tlagsim, name), name


@pytest.mark.parametrize("name", ["PACKING_POLICY_NAMES",
                                  "REACTIVE_BASELINE_NAMES",
                                  "OPTIMIZER_POLICY_NAMES"])
def test_lagsim_policy_tables_equal_reference(name):
    assert getattr(tlagsim, name) == getattr(jlagsim, name)
    assert isinstance(getattr(tlagsim, name), tuple)


def test_core_all_equals_reference():
    assert tcore.__all__ == jcore.__all__
    assert len(tcore.__all__) == 30
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


def test_core_pack_is_the_py_packer_and_the_submodule_stays_reachable():
    """Package-level ``pack`` is ``binpack.pack``'s counterpart, as in the
    reference; the batched submodule is reached by its full name."""
    from repro_torch.core import binpack

    assert tcore.pack is binpack.pack
    assert jcore.pack is jcore.binpack.pack
    sub = importlib.import_module("repro_torch.core.pack")
    assert callable(sub.sweep_streams) and callable(sub.evaluate_stream)
    assert tcore.evaluate_stream_jax is sub.evaluate_stream
    from repro_torch.core.pack import sweep_streams
    assert sweep_streams is tcore.sweep_streams
    speeds = {0: 0.5, 1: 0.4, 2: 0.3}
    got, want = tcore.pack(speeds, C), jcore.pack(speeds, C)
    assert got.pid_to_bin == want.pid_to_bin and got.n_bins == want.n_bins


def _stream(seed=7, n=10, t=40, delta=15):
    stream = jcore.generate_stream(n_partitions=n, n_measurements=t,
                                   delta=delta, capacity=C, seed=seed)
    return np.round(stream * 1024) / 1024.0


def _same_runs(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].name == want[name].name
        assert got[name].bins == want[name].bins, name
        np.testing.assert_allclose(got[name].rscores, want[name].rscores,
                                   rtol=0, atol=RTOL, err_msg=name)
        assert abs(got[name].average_rscore
                   - want[name].average_rscore) <= RTOL


@pytest.mark.parametrize("name", PACKERS)
def test_run_stream_matches_reference(name):
    stream = _stream()
    got = tcore.run_stream({name: t_packer_for(name, backend="py")},
                           stream, C)
    want = jcore.run_stream({name: j_packer_for(name, backend="py")},
                            stream, C)
    _same_runs(got, want)


@pytest.mark.parametrize("name", ["BFD", "MWFP", "MBF", "NF"])
def test_masked_run_stream_matches_reference(name):
    rng = np.random.default_rng(5)
    stream = np.round(rng.uniform(0, 1, (20, 7)) * 1024) / 1024.0
    active = rng.integers(0, 2, (20, 7)).astype(bool)
    got = tcore.run_stream({name: t_packer_for(name, backend="py")},
                           stream, C, active=active)
    want = jcore.run_stream({name: j_packer_for(name, backend="py")},
                            stream, C, active=active)
    _same_runs(got, want)


def test_run_stream_with_partition_ids_matches_reference():
    stream = _stream(seed=3, n=6, t=12)
    pids = [f"topic-{j}" for j in range(6)]
    names = ("BFD", "MBFP", "WF")
    got = tcore.run_stream({n: t_packer_for(n, backend="py") for n in names},
                           stream, C, partition_ids=pids)
    want = jcore.run_stream({n: j_packer_for(n, backend="py")
                             for n in names}, stream, C, partition_ids=pids)
    _same_runs(got, want)


def test_cardinal_bin_score_and_average_rscores_match_reference():
    stream = _stream(seed=11)
    got = tcore.run_stream({n: t_packer_for(n, backend="py")
                            for n in PACKERS}, stream, C)
    want = jcore.run_stream({n: j_packer_for(n, backend="py")
                             for n in PACKERS}, stream, C)
    cbs, jcbs = tcore.cardinal_bin_score(got), jcore.cardinal_bin_score(want)
    er, jer = tcore.average_rscores(got), jcore.average_rscores(want)
    assert list(cbs) == list(jcbs) == list(er) == list(jer) == list(PACKERS)
    for n in PACKERS:
        assert abs(cbs[n] - jcbs[n]) <= RTOL, n
        assert abs(er[n] - jer[n]) <= RTOL, n
    assert min(cbs.values()) >= 0.0
    # an empty run averages to 0, as in the reference
    assert tcore.StreamRun("x").average_rscore == 0.0


def test_evaluate_deltas_matches_reference():
    names = ("BFD", "MBF", "MWFP", "NF")
    streams = {d: _stream(seed=int(d), n=8, t=24, delta=d)
               for d in (5.0, 15.0, 35.0)}
    got = tcore.evaluate_deltas({n: t_packer_for(n, backend="py")
                                 for n in names}, streams, C)
    want = jcore.evaluate_deltas({n: j_packer_for(n, backend="py")
                                  for n in names}, streams, C)
    assert list(got) == list(want)
    for d in want:
        assert list(got[d]) == list(want[d])
        for n in names:
            np.testing.assert_allclose(got[d][n], want[d][n], rtol=0,
                                       atol=RTOL, err_msg=f"{d} {n}")


@pytest.mark.parametrize("r,seconds", [(0.0, 30.0), (1.25, 12.0),
                                       (3.7, 0.5), (0.3, 0.0)])
def test_recovery_iterations_is_exact(r, seconds):
    assert (tcore.recovery_iterations(r, seconds)
            == jcore.recovery_iterations(r, seconds))


@pytest.mark.parametrize("name", ["BFD", "MBF", "FF", "MWFP"])
def test_port_stream_scan_matches_port_run_stream(name):
    """The port's batched scan (``evaluate_stream_jax``, on the CPU the
    plain packers) against the port's own controller loop, as the
    reference's scan is held against its loop."""
    stream = _stream()
    runs = tcore.run_stream({name: t_packer_for(name, backend="py")},
                            stream, C)
    bins, rs = tcore.evaluate_stream_jax(
        torch.tensor(stream, dtype=torch.float32), C, algorithm=name,
        device="cpu")
    np.testing.assert_array_equal(np.asarray(bins), runs[name].bins)
    np.testing.assert_allclose(np.asarray(rs), runs[name].rscores,
                               rtol=0, atol=RTOL)
