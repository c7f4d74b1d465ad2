"""The port's closed loop against the reference, scenario for scenario as
``tests/test_integration_autoscale.py`` (scale-up, scale-down, crash
recovery, straggler drain, controller SYNCHRONIZE recovery): equal event
logs and metrics in both packages, then the reference test's own
invariants on the port.  The churn walk of
``test_single_reader_invariant_under_migrations`` is in
``test_torch_churn.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_world import PORT, REF, assert_same_world  # noqa: E402

CAP = 1.0e6  # 1 MB/s replica capacity for readable numbers


def make_sim(pkg, rates, **kw):
    AS = pkg.serving.AutoscaleSimulation
    return AS(n_partitions=len(rates), rate_fn=AS.constant_rates(rates),
              capacity=CAP, monitor_interval=5.0, **kw)


def both(scenario):
    """``scenario(pkg)`` on the reference and on the port; the two worlds
    must be equal.  Returns the port's result."""
    ref, port = scenario(REF), scenario(PORT)
    assert_same_world(ref[0], port[0])
    assert ref[1:] == port[1:]
    return port


def test_scales_to_load_and_keeps_lag_bounded():
    def scenario(pkg):
        sim = make_sim(pkg, [0.55e6] * 4)
        sim.run(seconds=400, dt=1.0)
        return (sim,)

    sim, = both(scenario)
    m = sim.metrics
    n = np.asarray(m.n_replicas)
    lag = np.asarray(m.lag_bytes)
    assert n[-1] >= 3
    q = len(lag) // 4
    assert lag[-1] <= lag[-q] + 2 * CAP
    assert m.consumed and sum(m.consumed) >= 0.9 * sim.produced_bytes - 10 * CAP


def test_scales_down_when_load_drops():
    def scenario(pkg):
        sim = make_sim(pkg, [0.8e6] * 6)
        sim.run(seconds=200)
        high = sim.manager.n_alive()
        sim.rate_fn = pkg.serving.AutoscaleSimulation.constant_rates(
            [0.4e6 / 6] * 6)
        sim.run(seconds=400)
        return sim, high

    sim, high = both(scenario)
    assert high >= 5
    low = sim.manager.n_alive()
    assert low <= 2, f"did not scale down: {high} -> {low}"


def test_replica_crash_recovery():
    def scenario(pkg):
        sim = make_sim(pkg, [0.5e6] * 4, heartbeat_timeout=20.0)
        sim.run(seconds=120)
        alive = sim.manager.n_alive()
        victim_cid = next(iter(sim.manager.list()))
        victim = sim.manager.replicas[victim_cid]
        victim.crash()
        sim.run(seconds=200)
        return sim, alive, victim_cid, sim.manager.replicas.get(victim_cid) \
            is victim

    sim, alive, victim_cid, same = both(scenario)
    assert alive >= 2
    assert all(not r.crashed for r in sim.manager.replicas.values())
    assert not same
    assigned = set(sim.controller.assignment.keys())
    expected = {PORT.broker.TopicPartition("sensors", i) for i in range(4)}
    assert assigned == expected
    lag = np.asarray(sim.metrics.lag_bytes)
    assert lag[-1] <= lag[len(lag) // 2] + 30 * CAP


def test_straggler_is_drained():
    def scenario(pkg):
        sim = make_sim(pkg, [0.45e6] * 4)
        sim.run(seconds=150)
        victim = next(iter(sim.manager.list()))
        sim.manager.replicas[victim].rate_factor = 0.2
        found = []
        for _ in range(200):
            sim.tick(1.0)
            found.append(sorted(
                sim.controller.check_stragglers(rate_threshold=0.35)))
        return sim, victim, found, sorted(sim.controller.replica_stats.items())

    sim, victim, found, _ = both(scenario)
    assert [victim] in found
    assert victim not in sim.manager.list(), "straggler was not drained"
    assert set(sim.controller.assignment) == {
        PORT.broker.TopicPartition("sensors", i) for i in range(4)}


def test_controller_crash_synchronize_recovery():
    def scenario(pkg):
        ctl = pkg.controller
        sim = make_sim(pkg, [0.5e6] * 4, overload_factor=1.05)
        sim.run(seconds=150)
        old = dict(sim.controller.assignment)
        persisted = sim.controller.persisted_state()
        sim.controller = ctl.Controller.recover(
            sim.broker, sim.manager,
            ctl.ControllerConfig(capacity=CAP, algorithm="MBFP",
                                 overload_factor=1.05))
        fresh = sim.controller.state
        sim.run(seconds=60)
        return (sim, sorted((tuple(k), v) for k, v in old.items()),
                persisted, fresh.value)

    sim, old, _, fresh = both(scenario)
    assert old
    assert fresh == PORT.controller.ControllerState.SYNCHRONIZE.value
    assert sim.controller.state is not PORT.controller.ControllerState.SYNCHRONIZE
    assert sorted((tuple(k), v) for k, v in sim.controller.assignment.items()) \
        == old
    assert all(not rec.moved for rec in sim.controller.migrations)
