"""The two-phase migration invariant (paper Sec. V-C / Fig. 5) on the
port, as ``tests/test_two_phase_migration.py`` checks it on the reference:
a partition's ``start`` is never sent before the previous owner's
``stop`` is acknowledged, checked at the controller's send boundary and
at every tick of a churny walk (the reference's 400 ticks, on the port
alone); the same walk over its first 150 ticks gives the reference's
event log; and the ``seed`` / ``rate_jitter`` contract of
``AutoscaleSimulation`` (the seed drives producer jitter and nothing
else), with the jittered world equal to the reference's draw for draw.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_world import PORT, REF, assert_same_world  # noqa: E402

CAP = 1.0e6


def churn(pkg, ticks):
    """The reference test's walk over ``ticks`` ticks with the ordering
    checked at every ``start`` send and every tick; returns (sim, number
    of starts checked, the start messages in order)."""
    AS = pkg.serving.AutoscaleSimulation
    sim = AS(n_partitions=10,
             rate_fn=AS.random_walk_rates(10, CAP, delta=25, seed=11),
             capacity=CAP, monitor_interval=5.0)
    ctl, broker = sim.controller, sim.broker
    group = ctl.cfg.group
    starts = []
    orig_send = ctl._send

    def checked_send(cid, msg):
        if msg.get("type") == "start":
            for t, p in msg["partitions"]:
                tp = pkg.broker.TopicPartition(t, int(p))
                holder = broker.reader_of(group, tp)
                assert holder is None or holder == f"consumer-{cid}", (
                    f"start for {tp} sent to consumer {cid} while "
                    f"{holder!r} still reads it")
                starts.append((cid, t, int(p), broker.clock.now()))
        orig_send(cid, msg)

    ctl._send = checked_send
    for _ in range(ticks):
        sim.tick(1.0)
        for tp, (phase, old, new) in ctl._inflight.items():
            holder = broker.reader_of(group, tp)
            if phase == "stop_sent":
                assert holder in (None, f"consumer-{old}"), (
                    f"{tp} read by {holder!r} while stop from {old} pending")
                assert holder != f"consumer-{new}"
    return sim, starts


def test_no_start_before_stop_ack_under_churn():
    """The reference's 400-tick churny walk on the port: every in-flight
    migration holds the stop->ack->start ordering at every tick."""
    sim, starts = churn(PORT, 400)
    assert starts
    assert any(rec.moved for rec in sim.controller.migrations), (
        "workload produced no migrations; invariant never exercised")


def test_churn_event_log_equals_the_reference():
    ref, ref_starts = churn(REF, 150)
    sim, starts = churn(PORT, 150)
    assert starts == ref_starts
    assert any(rec.moved for rec in sim.controller.migrations)
    assert_same_world(ref, sim)


def _jittered(pkg, seed, jitter):
    AS = pkg.serving.AutoscaleSimulation
    sim = AS(n_partitions=3,
             rate_fn=AS.constant_rates([0.3e6, 0.4e6, 0.2e6]),
             capacity=CAP, monitor_interval=5.0, seed=seed,
             rate_jitter=jitter)
    sim.run(seconds=60, dt=1.0)
    return sim


def test_constructor_seed_drives_only_producer_jitter():
    """Same seed + jitter => identical worlds; different seed => different
    production; with jitter off, the seed is inert."""
    a, b = _jittered(PORT, 1, 0.2), _jittered(PORT, 1, 0.2)
    assert a.produced_bytes == b.produced_bytes
    np.testing.assert_array_equal(np.asarray(a.metrics.lag_bytes),
                                  np.asarray(b.metrics.lag_bytes))
    c = _jittered(PORT, 2, 0.2)
    assert c.produced_bytes != a.produced_bytes
    d, e = _jittered(PORT, 3, 0.0), _jittered(PORT, 4, 0.0)
    assert d.produced_bytes == e.produced_bytes
    # the jitter is the reference's numpy draws, in its order
    for seed, jitter in ((1, 0.2), (2, 0.2), (3, 0.0)):
        assert_same_world(_jittered(REF, seed, jitter),
                          _jittered(PORT, seed, jitter))


def test_random_walk_rates_are_the_reference_draws():
    fns = [pkg.serving.AutoscaleSimulation.random_walk_rates(
        7, CAP, delta=15, seed=5, step_every=2.0) for pkg in (REF, PORT)]
    for t in (0.0, 1.5, 2.0, 7.9, 30.0):
        want = [fns[0](REF.broker.TopicPartition("s", i), t) for i in range(7)]
        got = [fns[1](PORT.broker.TopicPartition("s", i), t) for i in range(7)]
        assert got == want
