"""``tests/test_integration_autoscale.py::test_single_reader_invariant_under_migrations``
on the port: the broker raises if two group members ever read one
partition, and a churny workload with many reassignments must never
trigger it.  The reference's 600-tick walk runs on the port alone; its
first 200 ticks give the reference's event log (the reference's own test
takes ~55 s alone).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_world import PORT, REF, assert_same_world  # noqa: E402

CAP = 1.0e6


def walk(pkg):
    AS = pkg.serving.AutoscaleSimulation
    return AS(n_partitions=10,
              rate_fn=AS.random_walk_rates(10, CAP, delta=25, seed=3),
              capacity=CAP, monitor_interval=5.0)


def test_single_reader_invariant_under_migrations():
    sim = walk(PORT)
    sim.run(seconds=600)  # raises on violation
    assert len(sim.controller.migrations) >= 2
    for rec in sim.controller.migrations:
        assert rec.rscore >= 0.0
        if rec.moved:
            assert rec.rscore > 0.0


def test_churn_walk_event_log_equals_the_reference():
    ref, sim = walk(REF), walk(PORT)
    ref.run(seconds=200)
    sim.run(seconds=200)
    assert len(sim.controller.migrations) >= 2
    assert_same_world(ref, sim)
