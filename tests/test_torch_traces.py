"""The port's trace engine (``repro_torch.scenarios.traces`` / ``.seeds``,
``api.replay``) against ``repro.scenarios``.

Held exactly: a trace written by either package loads in the other (both
formats; ``.json`` files byte for byte), resampling (identity, hold and
linear) equals the reference's on the same arrays, validation refuses
what the reference refuses with the same message, and ``api.replay`` of
a saved trace equals a direct ``api.simulate`` of the same arrays bit
for bit (``.npz`` and ``.json``, no resampling and both resampling
methods), with the trace's capacity driving the run unless the caller
overrides it.  The seed library's shapes equal the reference's; its
traces are deterministic per device type (the port's generators never
draw the reference's stream).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import scenarios as jsn  # noqa: E402
from repro.api import replay as j_replay  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import scenarios as tsn  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.fleet import FleetRunner  # noqa: E402
from repro_torch.lagsim import LagSimConfig  # noqa: E402


def _trace(seed=0, batch=2, iters=16, n=5, family="adversarial", **knobs):
    return tsn.trace_from_scenario(family, seed, batch, iters, n,
                                   capacity=1.0, name=f"t{seed}",
                                   device="cpu", **knobs)


def _ref_trace(seed=0, batch=2, iters=16, n=5, family="adversarial",
               **knobs):
    return jsn.trace_from_scenario(family, jax.random.PRNGKey(seed), batch,
                                   iters, n, capacity=1.0, name=f"r{seed}",
                                   **knobs)


def _same(a, b):
    assert a.rates.dtype == b.rates.dtype == np.float32
    assert a.active.dtype == b.active.dtype == np.bool_
    assert a.rates.tobytes() == b.rates.tobytes()
    assert a.active.tobytes() == b.active.tobytes()
    assert (a.capacity, a.name, a.source, a.meta, a.version) == (
        b.capacity, b.name, b.source, b.meta, b.version)


def test_format_constants_equal_the_reference():
    assert tsn.TRACE_VERSION == jsn.TRACE_VERSION
    from repro.scenarios import traces as jt
    from repro_torch.scenarios import traces as tt

    assert tt._KIND == jt._KIND
    assert sorted(tsn.__all__) == sorted(jsn.__all__)
    assert len(tsn.__all__) == 21
    assert tsn.SEED_SHAPES == jsn.SEED_SHAPES
    assert tsn.list_seeds() == jsn.list_seeds()


@pytest.mark.parametrize("ext", ("json", "npz"))
@pytest.mark.parametrize("writer", ("port", "ref"))
def test_trace_files_read_across_packages(tmp_path, ext, writer):
    """A file written by one package loads in the other to the same
    trace; the same trace saved by both as ``.json`` is the same
    bytes."""
    tr = _ref_trace(seed=3, family="churn")
    mine = tsn.Trace(rates=tr.rates.copy(), active=tr.active.copy(),
                     capacity=tr.capacity, name=tr.name, source=tr.source,
                     meta=json.loads(json.dumps(tr.meta)))
    p_ref, p_port = str(tmp_path / f"r.{ext}"), str(tmp_path / f"p.{ext}")
    jsn.save_trace(tr, p_ref)
    tsn.save_trace(mine, p_port)
    path = p_port if writer == "port" else p_ref
    _same(tsn.load_trace(path), jsn.load_trace(path))
    _same(tsn.load_trace(p_ref), tsn.load_trace(p_port))
    if ext == "json":
        with open(p_ref, "rb") as a, open(p_port, "rb") as b:
            assert a.read() == b.read()
    else:
        with np.load(p_port) as z:
            assert z["header"].shape == ()       # a 0-d JSON string
            assert json.loads(str(z["header"][()]))["kind"] == "repro.trace"


@pytest.mark.parametrize("iters", (16, 7, 40))
@pytest.mark.parametrize("method", ("hold", "linear"))
def test_resample_equals_the_reference(method, iters):
    tr = _ref_trace(seed=6, iters=16, lifecycle_frac=0.8, churn_p=0.05,
                    death_frac=0.7)
    mine = tsn.Trace(rates=tr.rates, active=tr.active, capacity=1.0,
                     name=tr.name, source=tr.source, meta=dict(tr.meta))
    got = tsn.resample_trace(mine, iters, method=method)
    want = jsn.resample_trace(tr, iters, method=method)
    if iters == tr.iters:
        assert got is mine and want is tr
    _same(got, want)
    tsn.validate_trace(got)


def test_resample_and_validate_refuse_like_the_reference():
    tr = _trace(seed=8)
    rates, active = tr.rates, tr.active
    bad_rates = rates.copy()
    bad_rates[0, 0, 0] = -0.5
    loud = rates.copy()
    loud[0, 0, 0] = 0.7
    silent = active.copy()
    silent[0, 0, 0] = False
    nan = rates.copy()
    nan[0, 1, 1] = np.nan
    cases = [dict(rates=rates, active=active, version=99),
             dict(rates=rates[0], active=active[0]),
             dict(rates=rates, active=active[:, :-1]),
             dict(rates=rates, active=active, capacity=0.0),
             dict(rates=nan, active=np.ones_like(active)),
             dict(rates=bad_rates, active=np.ones_like(active)),
             dict(rates=loud, active=silent)]
    for kw in cases:
        kw = {"capacity": 1.0, "name": "x", "source": "test", **kw}
        with pytest.raises(ValueError) as want:
            jsn.validate_trace(jsn.Trace(**kw))
        with pytest.raises(ValueError) as got:
            tsn.validate_trace(tsn.Trace(**kw))
        assert str(got.value) == str(want.value)
    for args in ((0,), (8, "cubic")):
        with pytest.raises(ValueError) as want:
            jsn.resample_trace(_ref_trace(), *args)
        with pytest.raises(ValueError) as got:
            tsn.resample_trace(tr, *args)
        assert str(got.value) == str(want.value)


def test_load_refuses_like_the_reference(tmp_path):
    trunc = str(tmp_path / "t.json")
    with open(trunc, "w") as f:
        f.write('{"kind": "repro.trace", "version": 1}')
    other = str(tmp_path / "o.json")
    with open(other, "w") as f:
        json.dump({"kind": "nope", "rates": [[[0.0]]], "active": [[[1]]]}, f)
    wrong = str(tmp_path / "w.npz")
    tsn.save_trace(_trace(seed=1), wrong)
    with np.load(wrong) as z:
        head = json.loads(str(z["header"][()]))
        head["shape"] = [9, 9, 9]
        np.savez_compressed(wrong, rates=z["rates"], active=z["active"],
                            header=np.array(json.dumps(head)))
    for path in (trunc, other, wrong, str(tmp_path / "t.csv")):
        with pytest.raises((ValueError, KeyError)) as want:
            jsn.load_trace(path)
        with pytest.raises(want.type) as got:
            tsn.load_trace(path)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown trace extension"):
        tsn.save_trace(_trace(), str(tmp_path / "t.csv"))


@pytest.mark.parametrize("family", ("adversarial", "churn", "bursty"))
def test_trace_from_scenario_is_the_family_generator(family):
    tr = _trace(seed=4, family=family)
    sp, act = tsc.generate_masked_scenario(family, 4, 2, 16, 5, device="cpu")
    assert tr.rates.tobytes() == sp.numpy().tobytes()
    assert tr.active.tobytes() == act.numpy().tobytes()
    assert tr.meta == {"family": family, "knobs": {}}
    assert (tr.source, tr.name) == (f"synthetic:{family}", "t4")
    knobbed = _trace(seed=4, churn_p=0.1, burst_amp=2.0)
    assert knobbed.meta["knobs"] == {"churn_p": 0.1, "burst_amp": 2.0}


def test_seed_library_is_deterministic_on_one_device():
    for name in tsn.list_seeds():
        a = tsn.seed_trace(name, batch=2, iters=32, n=6, device="cpu")
        b = tsn.seed_trace(name, batch=2, iters=32, n=6, device="cpu")
        assert a.rates.tobytes() == b.rates.tobytes()
        assert a.active.tobytes() == b.active.tobytes()
        ref = jsn.seed_trace(name, batch=2, iters=32, n=6)
        assert (a.source, a.name, a.meta["paper"], a.meta["description"],
                a.meta["knobs"]) == (ref.source, ref.name,
                                     ref.meta["paper"],
                                     ref.meta["description"],
                                     ref.meta["knobs"])
        assert a.rates.shape == ref.rates.shape == (2, 32, 6)
    shapes = [tsn.seed_trace(n, batch=1, iters=64, n=8, device="cpu").rates
              for n in tsn.list_seeds()]
    assert not any(np.array_equal(shapes[i], shapes[j])
                   for i in range(3) for j in range(i + 1, 3))
    explicit = tsn.seed_trace("kafka_partition_skew", 5, batch=1, iters=8,
                              n=4, device="cpu")
    assert not np.array_equal(explicit.rates, tsn.seed_trace(
        "kafka_partition_skew", batch=1, iters=8, n=4, device="cpu").rates)
    with pytest.raises(ValueError, match="unknown seed trace"):
        tsn.seed_trace("nope", device="cpu")


POLICIES = ("MBF", "BFD", "KEDA_LAG")


@pytest.mark.parametrize("ext", ("npz", "json"))
@pytest.mark.parametrize("iters,method", ((None, "hold"), (24, "hold"),
                                          (24, "linear"), (9, "linear")))
def test_replay_equals_direct_simulate(tmp_path, ext, iters, method):
    tr = _trace(seed=11, batch=3, iters=16, n=6, lifecycle_frac=0.5,
                churn_p=0.05)
    tr.capacity = 1.25
    path = str(tmp_path / f"t.{ext}")
    tsn.save_trace(tr, path)
    runner = FleetRunner()
    out = api.replay(path, policies=POLICIES, iters=iters, method=method,
                     fleet=runner, device="cpu")
    want = tr if iters is None else tsn.resample_trace(tr, iters, method)
    direct = api.simulate(want.rates, policies=POLICIES, active=want.active,
                          capacity=1.25, fleet=runner, device="cpu")
    assert out.resampled == (iters is not None)
    assert out.shape == want.rates.shape
    assert (out.trace_name, out.source) == ("t11", "synthetic:adversarial")
    assert out.policies == direct.policies == POLICIES
    for f in ("lag_total", "consumers", "migrations"):
        assert (getattr(out.result, f).tobytes()
                == getattr(direct, f).tobytes()), f
    for k, v in direct.metrics.items():
        assert out.metrics[k].tobytes() == v.tobytes(), k


def test_replay_capacity_follows_the_trace_unless_overridden():
    tr = _trace(seed=12, batch=2, iters=12, n=4, base_rate=0.6)
    tr.capacity = 0.5
    small = api.replay(tr, policies=("BFD",), device="cpu")
    direct = api.simulate(tr.rates, policies=("BFD",), active=tr.active,
                          capacity=0.5, device="cpu")
    assert small.metrics["consumer_seconds"].tobytes() == \
        direct.metrics["consumer_seconds"].tobytes()
    big = api.replay(tr, policies=("BFD",), capacity=4.0, device="cpu")
    assert (big.metrics["consumer_seconds"]
            < small.metrics["consumer_seconds"]).all()
    cfg = LagSimConfig(capacity=2.0)
    via_cfg = api.replay(tr, policies=("BFD",), config=cfg, device="cpu")
    direct2 = api.simulate(tr.rates, policies=("BFD",), active=tr.active,
                           config=cfg, device="cpu")
    assert via_cfg.metrics["consumer_seconds"].tobytes() == \
        direct2.metrics["consumer_seconds"].tobytes()


def test_replay_of_a_reference_file_equals_the_reference(tmp_path):
    """A reference-written trace replayed by both packages: integers
    exact, lag within 1e-5 (the lag twin's parity tolerance)."""
    tr = _ref_trace(seed=13, batch=2, iters=20, n=5, churn_p=0.05)
    path = str(tmp_path / "r.npz")
    jsn.save_trace(tr, path)
    ours = api.replay(path, policies=("MBF", "KEDA_LAG"), device="cpu")
    ref = j_replay(path, policies=("MBF", "KEDA_LAG"))
    assert (ours.trace_name, ours.source, ours.shape, ours.resampled) == (
        ref.trace_name, ref.source, ref.shape, ref.resampled)
    np.testing.assert_array_equal(ours.result.consumers,
                                  np.asarray(ref.result.consumers))
    np.testing.assert_array_equal(ours.result.migrations,
                                  np.asarray(ref.result.migrations))
    np.testing.assert_allclose(ours.result.lag_total,
                               np.asarray(ref.result.lag_total), atol=1e-5,
                               rtol=0)
