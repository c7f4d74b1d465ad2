"""Shared by the port's parity tests of the paper's system
(``test_torch_system.py``, ``test_torch_integration.py``,
``test_torch_migration.py``, ``test_torch_churn.py``,
``test_torch_llm_replica.py``): the reference's and the port's modules
side by side, and the event log of one world that those tests hold equal.
"""
from types import SimpleNamespace

import numpy as np

import repro.broker
import repro.core.controller
import repro.core.monitor
import repro.serving
import repro.serving.replica
import repro_torch.broker
import repro_torch.core.controller
import repro_torch.core.monitor
import repro_torch.serving
import repro_torch.serving.replica

REF = SimpleNamespace(name="repro", broker=repro.broker,
                      controller=repro.core.controller,
                      monitor=repro.core.monitor, serving=repro.serving,
                      replica=repro.serving.replica)
PORT = SimpleNamespace(name="repro_torch", broker=repro_torch.broker,
                       controller=repro_torch.core.controller,
                       monitor=repro_torch.core.monitor,
                       serving=repro_torch.serving,
                       replica=repro_torch.serving.replica)


def records(broker, topic):
    """(partition, offset, timestamp, key, value, nbytes) of every record
    of ``topic``."""
    if topic not in broker.topics:
        return []
    return [(i, r.offset, r.timestamp, r.key, r.value, r.nbytes)
            for i, p in enumerate(broker.topics[topic].partitions)
            for r in p._log]


def migrations(ctl):
    """Every ``MigrationRecord`` field of ``ctl``, ``moved`` sorted."""
    return [(m.iteration, m.started_at, m.rscore,
             sorted(tuple(tp) for tp in m.moved), m.n_bins, m.finished_at,
             m.duration) for m in ctl.migrations]


def broker_log(broker):
    """The broker's state: log sizes, committed offsets, readers, and
    every record of the metadata and monitor topics."""
    return {
        "metadata": records(broker, "consumer.metadata"),
        "write_speed": records(broker, "monitor.writeSpeed"),
        "log_dirs": sorted((tuple(k), v)
                           for k, v in broker.describe_log_dirs().items()),
        "offsets": sorted((g, tuple(tp), o)
                          for (g, tp), o in broker._offsets.items()),
        "readers": sorted((g, tuple(tp), m)
                          for (g, tp), m in broker._readers.items()),
    }


def world_log(sim):
    """Everything a parity test holds equal for an ``AutoscaleSimulation``:
    the broker's log, the controller's state and migration records, the
    replicas, the manager's counts and the sink's tables."""
    ctl, mgr = sim.controller, sim.manager
    log = broker_log(sim.broker)
    log.update(
        migrations=migrations(ctl),
        assignment=sorted((tuple(tp), c) for tp, c in ctl.assignment.items()),
        state=ctl.state.value,
        live=sorted(ctl.live),
        iteration=ctl.iteration,
        inflight=sorted((tuple(tp), v) for tp, v in ctl._inflight.items()),
        draining=sorted(ctl.draining),
        speeds=sorted((tuple(tp), s) for tp, s in ctl.speeds.items()),
        replicas=sorted((cid, r.alive, r.crashed, r.consumed_bytes, r._carry,
                         r.last_rate, r.backlog_hint, r.rate_factor,
                         sorted(tuple(tp) for tp in r.handle.assigned))
                        for cid, r in mgr.replicas.items()),
        created=mgr.created_total,
        deleted=mgr.deleted_total,
        sink=(sorted(sim.sink.tables.items()),
              sorted(sim.sink.records.items())),
        produced=sim.produced_bytes,
    )
    return log


def assert_same_world(ref, port):
    """The two simulations' event logs and ``SimMetrics`` are equal."""
    a, b = world_log(ref), world_log(port)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] != b[k] and isinstance(a[k], list):
            first = next(i for i, (x, y) in enumerate(zip(a[k], b[k]))
                         if x != y) if any(
                x != y for x, y in zip(a[k], b[k])) else min(len(a[k]),
                                                            len(b[k]))
            raise AssertionError(
                f"{k}: {len(a[k])} entries in the reference, {len(b[k])} in "
                f"the port; first difference at {first}: "
                f"{a[k][first:first + 1]} != {b[k][first:first + 1]}")
        assert a[k] == b[k], k
    ma, mb = ref.metrics.as_arrays(), port.metrics.as_arrays()
    assert ma.keys() == mb.keys()
    for k in ma:
        assert ma[k].dtype == mb[k].dtype, k
        np.testing.assert_array_equal(mb[k], ma[k], err_msg=k)
