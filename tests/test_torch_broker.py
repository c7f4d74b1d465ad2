"""The port's broker, clock and monitor against the reference's, operation
for operation: offsets, reads, commits, ``describe_log_dirs``, ``lag``,
``total_lag``, the single-reader rule and its error text, ``expel``; the
monitor's sliding window (``tests/test_system.py``'s scenario) with its
``monitor.writeSpeed`` records equal as JSON text; and, as a property
over random produce/read/commit sequences, the port's O(1)
``bytes_between`` equal to the reference's sum over the log.
"""
import pytest

torch = pytest.importorskip("torch")

from repro import broker as rbroker  # noqa: E402
from repro.core import monitor as rmonitor  # noqa: E402
from repro_torch import broker as tbroker  # noqa: E402
from repro_torch.core import monitor as tmonitor  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # property tests skip without hypothesis
    given = None

PACKAGES = ((rbroker, rmonitor), (tbroker, tmonitor))


def test_the_same_eight_names():
    assert tbroker.__all__ == rbroker.__all__
    for name in rbroker.__all__:
        assert getattr(tbroker, name).__module__.startswith("repro_torch.")


def test_clocks():
    for b, _ in PACKAGES:
        c = b.SimClock(2.5)
        assert c.now() == 2.5 and c.advance(1.25) == 3.75 == c.now()
        with pytest.raises(AssertionError):
            c.advance(-1.0)
        w = b.WallClock()
        assert w.now() <= w.now()
        with pytest.raises(NotImplementedError):
            b.Clock().now()


def _script(b):
    """One scripted session of every broker operation; returns its log."""
    clock = b.SimClock()
    br = b.Broker(clock)
    log = []
    tp = lambda t, i: b.TopicPartition(t, i)  # noqa: E731
    br.create_topic("t", 2)
    br.create_topic("t", 5)                      # exists: unchanged
    log.append(len(br.topics["t"].partitions))
    for i, (value, nbytes) in enumerate([(b"abc", None), ("hello", None),
                                         (None, None), (None, 1000),
                                         ({"x": 1}, 7), (b"", 0)]):
        clock.advance(0.5)
        log.append(br.produce(tp("t", i % 2), value, key=f"k{i}",
                              nbytes=nbytes))
    log.append(br.produce(tp("t", 4), b"grows", nbytes=3))   # ensure()
    part = br.partition(tp("t", 0))
    log.append([(r.offset, r.timestamp, r.key, r.value, r.nbytes)
                for r in part.read(0)])
    log.append([r.offset for r in part.read(1, max_records=1)])
    log.append([r.offset for r in part.read(0, max_bytes=4)])
    log.append([r.offset for r in part.read(0, max_bytes=1)])   # first fits
    log.append([r.offset for r in part.read(9)])
    log.append((part.end_offset, part.size_bytes))
    log.append([part.bytes_between(lo, hi) for lo in (-5, -1, 0, 1, 3, 7)
                for hi in (-9, -1, 0, 2, 3, 20)])
    log.append(sorted((tuple(k), v) for k, v in br.describe_log_dirs().items()))
    log.append(sorted((tuple(k), v)
                      for k, v in br.describe_log_dirs(["t"]).items()))
    log.append(br.describe_log_dirs(["nope"]))
    a, c = br.consumer("g", "a"), br.consumer("g", "c")
    a.assign(tp("t", 0))
    a.assign(tp("t", 0))                          # re-assign to itself
    with pytest.raises(RuntimeError) as err:
        c.assign(tp("t", 0))
    log.append(str(err.value))
    c.assign(tp("t", 1))
    log.append(br.reader_of("g", tp("t", 0)))
    log.append(br.reader_of("other", tp("t", 0)))
    got = a.poll(max_bytes=4)
    log.append({tuple(k): [r.offset for r in v] for k, v in got.items()})
    a.commit(tp("t", 0), 2)
    a.commit(tp("t", 0), 1)                       # commits never go back
    log.append(br.committed("g", tp("t", 0)))
    log.append([br.lag("g", tp("t", i)) for i in range(5)])
    log.append(br.total_lag("g", "t"))
    log.append({tuple(k): [r.offset for r in v]
                for k, v in c.poll(max_bytes=10_000).items()})
    log.append(c.poll(max_bytes=0))
    a.unassign(tp("t", 1))                        # not a's: no effect
    log.append(br.reader_of("g", tp("t", 1)))
    br.expel("g", "c")                            # coordinator eviction
    log.append((br.reader_of("g", tp("t", 1)), sorted(c.assigned)))
    c2 = br.consumer("g", "c2")
    c2.assign(tp("t", 1))
    a.close()
    log.append((a.closed, sorted(a.assigned), br.reader_of("g", tp("t", 0))))
    log.append(sorted((g, tuple(t), o) for (g, t), o in br._offsets.items()))
    log.append(sorted((g, tuple(t), m) for (g, t), m in br._readers.items()))
    return log


def test_broker_operation_for_operation():
    want, got = _script(rbroker), _script(tbroker)
    assert got == want
    errors = [x for x in got if isinstance(x, str) and "hand-off" in x]
    assert errors == ["partition TopicPartition(topic='t', partition=0) "
                      "already read by 'a' in group 'g'; 'c' must wait for "
                      "the stop->ack hand-off"]


def _window(b, m):
    """``test_system.py::test_monitor_sliding_window_write_speed`` on one
    package: 60 s at 1000 B/s, sampled every 5 s over a 30 s window."""
    clock = b.SimClock()
    broker = b.Broker(clock)
    broker.create_topic("t", 1)
    mon = m.Monitor(broker, ["t"], window_secs=30.0)
    tp = b.TopicPartition("t", 0)
    samples = []
    for _ in range(12):
        for _ in range(5):
            broker.produce(tp, None, nbytes=1000)
        clock.advance(5.0)
        samples.append(mon.sample())
    return broker, tp, samples


def test_monitor_sliding_window_write_speed():
    rb, rtp, rs = _window(rbroker, rmonitor)
    tb, ttp, ts = _window(tbroker, tmonitor)
    # the reference test's own invariants, on the port
    m = ts[-1]
    assert abs(m.speeds[ttp] - 1000.0) < 50.0
    m2 = tmonitor.read_latest_measurement(tb)
    assert m2 is not None and abs(m2.speeds[ttp] - m.speeds[ttp]) < 1e-9
    # every sample and every published record equal, as JSON text
    assert [s.to_record() for s in ts] == [s.to_record() for s in rs]
    rrecs = rb.partition(rbroker.TopicPartition(rmonitor.WRITE_SPEED_TOPIC, 0))
    trecs = tb.partition(tbroker.TopicPartition(tmonitor.WRITE_SPEED_TOPIC, 0))
    assert ([(r.offset, r.timestamp, r.value, r.nbytes) for r in trecs.read(0)]
            == [(r.offset, r.timestamp, r.value, r.nbytes)
                for r in rrecs.read(0)])
    r2 = rmonitor.read_latest_measurement(rb)
    assert m2.to_record() == r2.to_record()
    assert tmonitor.WRITE_SPEED_TOPIC == rmonitor.WRITE_SPEED_TOPIC
    assert tmonitor.DEFAULT_WINDOW_SECS == rmonitor.DEFAULT_WINDOW_SECS


def test_read_latest_measurement():
    for b, m in PACKAGES:
        broker = b.Broker(b.SimClock())
        assert m.read_latest_measurement(broker) is None   # no topic yet
        mon = m.Monitor(broker, ["t"], publish=True)
        assert m.read_latest_measurement(broker) is None   # nothing yet
        broker.create_topic("t", 2)
        first = mon.sample()
        broker.clock.advance(1.0)
        broker.produce(b.TopicPartition("t", 1), b"x" * 10)
        second = mon.sample()
        got = m.read_latest_measurement(broker, group="ctl")
        assert got.to_record() == second.to_record() != first.to_record()
        assert m.read_latest_measurement(broker, group="ctl") is None
        assert m.read_latest_measurement(broker).to_record() == \
            second.to_record()
        silent = m.Monitor(broker, ["t"], publish=False)
        silent.sample()
        end = broker.partition(b.TopicPartition(m.WRITE_SPEED_TOPIC, 0))
        assert end.end_offset == 2
    rt = rmonitor.Measurement(3.0, {rbroker.TopicPartition("a", 1): 2.5})
    tt = tmonitor.Measurement(3.0, {tbroker.TopicPartition("a", 1): 2.5})
    assert tt.to_record() == rt.to_record()
    back = tmonitor.Measurement.from_record(rt.to_record())
    assert back == tt and type(next(iter(back.speeds))) is \
        tbroker.TopicPartition


if given is not None:
    ops = st.lists(st.one_of(
        st.tuples(st.just("produce"), st.integers(0, 2),
                  st.integers(0, 5000)),
        st.tuples(st.just("read"), st.integers(0, 2), st.integers(0, 9000)),
        st.tuples(st.just("commit"), st.integers(0, 2),
                  st.integers(-3, 60)),
        st.tuples(st.just("between"), st.integers(-70, 70),
                  st.integers(-70, 70))), max_size=60)

    @settings(max_examples=200, deadline=None)
    @given(ops=ops)
    def test_bytes_between_equals_the_reference_sum(ops):
        """Random produce / poll-and-commit / commit / ``bytes_between``
        sequences: lag, total lag, every slice's bytes and every poll
        equal between the packages."""
        worlds = []
        for b in (rbroker, tbroker):
            br = b.Broker(b.SimClock())
            br.create_topic("t", 3)
            h = br.consumer("g", "m")
            for i in range(3):
                h.assign(b.TopicPartition("t", i))
            worlds.append((b, br, h))
        for op, x, y in ops:
            outs = []
            for b, br, h in worlds:
                if op == "produce":
                    out = br.produce(b.TopicPartition("t", x), None, nbytes=y)
                elif op == "read":
                    got = h.poll(max_bytes=y)
                    for tp, recs in got.items():
                        h.commit(tp, recs[-1].offset + 1)
                    out = {tuple(k): [r.offset for r in v]
                           for k, v in got.items()}
                elif op == "commit":
                    br.commit("g", b.TopicPartition("t", x), y)
                    out = None
                else:
                    out = [br.partition(b.TopicPartition("t", i))
                           .bytes_between(x, y) for i in range(3)]
                outs.append((out, [br.lag("g", b.TopicPartition("t", i))
                                   for i in range(3)],
                             br.total_lag("g", "t")))
            assert outs[1] == outs[0]
else:
    @pytest.mark.skip(reason="property tests need hypothesis")
    def test_bytes_between_equals_the_reference_sum():
        pass
