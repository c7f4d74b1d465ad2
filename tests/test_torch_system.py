"""The paper's system on the port (broker, monitor, controller, replicas,
``AutoscaleSimulation``) against the reference, scenario for scenario as
``tests/test_system.py``: each scenario runs through both packages and
the event logs must be equal (every record of ``consumer.metadata`` and
``monitor.writeSpeed``, ``SimMetrics``, every ``MigrationRecord`` field
with ``rscore`` exact, the final assignment, the manager's counts, the
sink's tables); the reference test's own invariants are then asserted on
the port.  The monitor's sliding window is in ``test_torch_broker.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_world import PORT, REF, assert_same_world, broker_log  # noqa: E402


def test_state_diff_encodes_all_four_transitions():
    """Sec. V-C: the diff encodes creates / stops / starts / deletes."""
    diffs = []
    for pkg in (REF, PORT):
        tp = lambda i: pkg.broker.TopicPartition("t", i)  # noqa: E731
        current = {tp(0): 0, tp(1): 0, tp(2): 1}
        desired = {tp(0): 0, tp(1): 2, tp(2): 2}
        diff = pkg.controller.state_diff(current, desired,
                                         live_consumers={0, 1})
        assert diff.to_create == [2]
        assert diff.to_stop == {0: [tp(1)], 1: [tp(2)]}
        assert diff.to_start == {2: [tp(1), tp(2)]}
        assert diff.to_delete == [1]
        assert not diff.is_empty
        assert pkg.controller.state_diff(current, current, {0, 1}).is_empty
        diffs.append(diff)
    assert vars(diffs[1]) == vars(diffs[0])


def test_mailbox_partition_mapping():
    """Fig. 3: partition 0 is the controller inbox; consumer N uses N+1."""
    ctl = PORT.controller
    assert ctl.CONTROLLER_INBOX.partition == 0
    assert ctl.consumer_mailbox(0).partition == 1
    assert ctl.consumer_mailbox(7).partition == 8
    for name in ("METADATA_TOPIC", "CONTROLLER_PARTITION"):
        assert getattr(ctl, name) == getattr(REF.controller, name)
    assert ([s.value for s in ctl.ControllerState]
            == [s.value for s in REF.controller.ControllerState])
    assert ctl.ControllerConfig(capacity=1.0) == ctl.ControllerConfig(
        **vars(REF.controller.ControllerConfig(capacity=1.0)))


def test_unknown_algorithm_is_refused_with_the_reference_text():
    msgs = []
    for pkg in (REF, PORT):
        broker = pkg.broker.Broker()
        mgr = pkg.serving.SimulatedReplicaManager(broker)
        with pytest.raises(ValueError) as err:
            pkg.controller.Controller(
                broker, mgr, pkg.controller.ControllerConfig(
                    capacity=1.0, algorithm="ANNEAL"))
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0] == "unknown algorithm 'ANNEAL'"


def _guarantee(pkg):
    rates = [0.4e6] * 6                              # 2.4 MB/s total
    sim = pkg.serving.AutoscaleSimulation(
        n_partitions=6,
        rate_fn=pkg.serving.AutoscaleSimulation.constant_rates(rates),
        capacity=1.0e6)
    sim.run(seconds=300)

    # static fleet of 1 consumer (no controller): lag grows linearly
    b = pkg.broker
    clock = b.SimClock()
    broker = b.Broker(clock)
    broker.create_topic("sensors", 6)
    broker.create_topic("consumer.metadata", 2)
    r = pkg.replica
    rep = r.Replica(0, broker, r.Sink(), r.ReplicaConfig(rate=1.0e6))
    for i in range(6):
        rep.handle.assign(b.TopicPartition("sensors", i))
    for _ in range(300):
        for i in range(6):
            for _ in range(int(0.4e6 // 4096)):
                broker.produce(b.TopicPartition("sensors", i), None,
                               nbytes=4096)
        clock.advance(1.0)
        rep.step(1.0)
    return sim, broker, rep


def test_consumption_rate_guarantee_vs_static_fleet():
    """The paper's headline: the autoscaler guarantees consumption >=
    production where a static undersized fleet cannot."""
    ref, ref_static, ref_rep = _guarantee(REF)
    sim, static, rep = _guarantee(PORT)
    assert_same_world(ref, sim)
    assert broker_log(static) == broker_log(ref_static)
    assert (rep.consumed_bytes, rep._carry, rep.last_rate, rep.backlog_hint,
            rep.sink.tables, rep.sink.records) == (
        ref_rep.consumed_bytes, ref_rep._carry, ref_rep.last_rate,
        ref_rep.backlog_hint, ref_rep.sink.tables, ref_rep.sink.records)
    lag = np.asarray(sim.metrics.lag_bytes, float)
    third = len(lag) // 3
    slope = (lag[-1] - lag[-third]) / third
    assert slope < 0.05e6, f"autoscaled lag still growing at {slope:.0f} B/s"
    assert sim.manager.n_alive() >= 3
    assert static.total_lag("autoscaler", "sensors") > 100e6


def _cost(pkg):
    AS = pkg.serving.AutoscaleSimulation
    sim = AS(n_partitions=8, rate_fn=AS.constant_rates([0.9e6] * 8),
             capacity=1.0e6)
    sim.run(seconds=200)
    peak = sim.manager.n_alive()
    sim.rate_fn = AS.constant_rates([0.1e6] * 8)
    sim.run(seconds=400)
    return sim, peak


def test_operational_cost_tracks_load():
    """Lower operational cost: fleet size follows total load down."""
    ref, ref_peak = _cost(REF)
    sim, peak = _cost(PORT)
    assert peak == ref_peak
    assert_same_world(ref, sim)
    assert peak >= 7
    assert sim.manager.n_alive() <= max(2, peak // 3)


def test_serving_exports_the_reference_names_and_the_shared_model():
    import repro.serving as jserving
    import repro_torch.serving as tserving

    assert tserving.__all__ == jserving.__all__ + ["SharedModel"]
    for name in tserving.__all__:
        assert getattr(tserving, name).__module__.startswith("repro_torch.")
