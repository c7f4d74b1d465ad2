"""The port's lag twin against the port's object world, on the CPU: the
counterpart of ``tests/test_lagsim.py::test_golden_matches_python_simulation``
(the world synchronized out of its start-up transient, then both run the
same constant workload from the same backlog: consumer counts exact, lag
within ``4 * record_bytes * N``, no migration on either side), and path
J1's construction from ``chip_smoke.py`` at a small N: rates of whole 16
KiB records and a capacity of 140 records a second, so every speed the
monitor measures is the twin's rate exactly.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_world import PORT, REF, assert_same_world  # noqa: E402
from repro_torch.broker import TopicPartition  # noqa: E402
from repro_torch.lagsim import LagSimConfig, simulate_lag  # noqa: E402
from repro_torch.serving import AutoscaleSimulation  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def golden_world(pkg, t_sync):
    cap = 1.0e6
    rates = [0.3e6, 0.5e6, 0.4e6, 0.6e6, 0.2e6, 0.45e6]
    AS = pkg.serving.AutoscaleSimulation
    sim = AS(n_partitions=len(rates), rate_fn=AS.constant_rates(rates),
             capacity=cap, algorithm="BFD", record_bytes=64,
             monitor_interval=1.0)
    sim.replica_cfg.batch_bytes = int(cap)
    sim.manager.config.batch_bytes = int(cap)
    sim.run(seconds=t_sync, dt=1.0)
    return sim, rates, cap


@pytest.mark.parametrize("use_kernel", (False, True))
def test_golden_matches_python_simulation(use_kernel):
    n, t_sync, t_run, record_bytes = 6, 8, 60, 64
    sim, rates, cap = golden_world(PORT, t_sync)
    lag0 = np.array([sim.broker.lag("autoscaler", TopicPartition("sensors", i))
                     for i in range(n)], np.float32)
    m = sim.run(seconds=t_run, dt=1.0)
    py_lag = np.asarray(m.lag_bytes, float)[t_sync:]
    py_n = np.asarray(m.n_replicas)[t_sync:]

    trace = np.tile(np.asarray(rates, np.float32), (t_run, 1))
    r = simulate_lag(trace, policy="BFD",
                     cfg=LagSimConfig(capacity=cap, dt=1.0,
                                      use_kernel=use_kernel),
                     initial_lag=lag0, device="cpu")
    np.testing.assert_array_equal(py_n, r.consumers.numpy())
    tol = 4 * record_bytes * n
    diff = np.abs(py_lag - r.lag_total.double().numpy()).max()
    assert diff <= tol, f"lag divergence {diff:.0f} B > {tol} B"
    assert int(r.migrations.sum()) == 0


def test_golden_world_equals_the_reference():
    ref, _, _ = golden_world(REF, 8)
    port, _, _ = golden_world(PORT, 8)
    ref.run(seconds=60)
    port.run(seconds=60)
    assert_same_world(ref, port)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("seed", (0, 1))
def test_path_j1_construction_at_a_small_n(chip_smoke, seed):
    """``run_path_j1`` on the CPU at 8 partitions x 120 ticks: its checks
    (measured speeds equal to the rates, consumer counts equal at every
    step, no migration, lag within tolerance) pass; no kernel launches on
    the CPU."""
    launches = chip_smoke.run_path_j1(torch.device("cpu"), seed, n=8,
                                      ticks=120)
    assert launches == {"pack_rows": 0, "lag_update_batch": 0,
                        "select_slot_grid": 0}
    sim, rates, lag0 = chip_smoke.j1_world(8, seed)
    assert all(r % chip_smoke.J1_REC == 0 for r in rates)
    assert all(0.1 <= r / chip_smoke.J1_C <= 0.9 for r in rates)
    speeds = [sim.controller.speeds[tp] for tp in sorted(sim.controller.speeds)]
    assert speeds == rates
    assert lag0.dtype == np.float32 and (lag0 % chip_smoke.J1_REC == 0).all()


def test_path_j1_refuses_a_diverging_world(chip_smoke, monkeypatch):
    """The checks are live: a twin whose consumers drain 10% less than
    the world's fails path J1."""
    import repro_torch.lagsim as lagsim

    real = lagsim.simulate_lag

    def slower(trace, *, cfg, **kw):
        import dataclasses
        return real(trace, cfg=dataclasses.replace(
            cfg, capacity=cfg.capacity * 0.9), **kw)

    monkeypatch.setattr(lagsim, "simulate_lag", slower)
    with pytest.raises(chip_smoke.SmokeFailure, match="path J1"):
        chip_smoke.run_path_j1(torch.device("cpu"), 0, n=8, ticks=120)
