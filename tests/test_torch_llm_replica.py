"""The port's LLM replica, serving driver, capacity reader and serving
example against the reference's, on the CPU.

- ``LLMReplica`` on SMOKE qwen3-8b (float32 activations, so that greedy
  tokens cannot flip on a bf16 near-tie) with the reference's weights
  carried across by ``convert.params_from_numpy``, over 40 ticks of the
  serving example's traffic with its spike moved to 10-30 s: equal
  per-replica ``requests_served`` / ``generated_tokens``, sink tables,
  event logs and byte trajectories, and equal greedy tokens from every
  ``generate`` call (both sides wrapped to record them).
- ``launch.serve.main`` prints the reference's lines.
- ``serving.capacity.derived_replica_capacity`` on a synthetic
  ``dryrun_results.jsonl`` equals the reference's dict; a missing file
  raises ``FileNotFoundError`` naming the port's missing dry run.
- ``launch.shapes`` (its jax-free part) equals the reference's.
- The example, ``python -m repro_torch.examples.autoscale_serve --device
  cpu``, prints the reference example's lines over its 240 ticks (only
  the model line names the device), and path J2 of ``chip_smoke.py``
  runs its checks on the CPU at the SMOKE model.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_world import REF, assert_same_world  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.serving import capacity as jcapacity  # noqa: E402
from repro.serving import llm_replica as jllm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.examples import autoscale_serve as texample  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.serving import capacity as tcapacity  # noqa: E402
from repro_torch.serving import llm_replica as tllm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPIKE = (10, 30)
TICKS = 40


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager matmuls run fastest on one thread; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_f32(m):
    return dataclasses.replace(m.get("qwen3-8b", smoke=True),
                               dtype="float32", param_dtype="float32")


def recorded(model):
    """Wrap ``model.generate`` to record (prompts, gen, tokens) a call."""
    calls, generate = [], model.generate

    def wrapped(prompts, gen):
        out = generate(prompts, gen)
        calls.append(([list(p) for p in prompts], gen, np.asarray(out)))
        return out
    model.generate = wrapped
    return calls


def reference_world(model, cfg, seed=0):
    """``examples/autoscale_serve.py``'s world on the reference, its spike
    at ``SPIKE``."""
    from repro.broker import TopicPartition
    from repro.serving.replica import ReplicaConfig

    ex = texample

    def rate_fn(tp, t):
        base = 0.05e6 * (1 + tp.partition % 3)
        if SPIKE[0] <= t < SPIKE[1]:
            return base * (4 if tp.partition < 3 else 1)
        return base

    sim = REF.serving.AutoscaleSimulation(
        n_partitions=ex.N_STREAMS, rate_fn=rate_fn, capacity=ex.CAP,
        monitor_interval=5.0, record_bytes=ex.REC)
    sink, broker = sim.sink, sim.broker
    sim.manager._factory = lambda cid: jllm.LLMReplica(
        cid, broker, sink, ReplicaConfig(rate=ex.CAP), model)
    rng = np.random.default_rng(seed)

    def produce(dt):
        t = sim.clock.now()
        for i in range(ex.N_STREAMS):
            tp = TopicPartition(sim.topic, i)
            sim._accum[i] += max(0.0, rate_fn(tp, t)) * dt
            while sim._accum[i] >= sim.record_bytes:
                req = json.dumps({"prompt": rng.integers(
                    1, cfg.vocab_size, size=2).tolist(), "gen": 2})
                broker.produce(tp, req, nbytes=sim.record_bytes)
                sim._accum[i] -= sim.record_bytes
                sim.produced_bytes += sim.record_bytes
    sim._produce = produce
    return sim


def test_llm_replica_fleet_equals_the_reference():
    jcfg, tcfg = smoke_f32(jconfigs), smoke_f32(tconfigs)
    jmodel = jllm.SharedModel(jcfg, max_len=16, max_batch=8, seed=0)
    tmodel = tllm.SharedModel(
        tcfg, max_len=16, max_batch=8, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jmodel.params),
                                 tcfg, device="cpu"))
    jcalls, tcalls = recorded(jmodel), recorded(tmodel)
    ref = reference_world(jmodel, jcfg)
    sim = texample.make_world(tcfg.vocab_size, tmodel, spike=SPIKE)
    served = []
    for s in (ref, sim):
        for _ in range(TICKS):
            s.tick(1.0)
        served.append(sorted(
            (cid, r.requests_served, r.generated_tokens, type(r).__name__)
            for cid, r in s.manager.replicas.items()))
    assert served[1] == served[0]
    assert all(name == "LLMReplica" for *_, name in served[1])
    assert_same_world(ref, sim)
    assert sim.sink.tables["generations"] > 0
    assert len(tcalls) == len(jcalls) > TICKS
    for (jp, jg, jout), (tp, tg, tout) in zip(jcalls, tcalls):
        assert (tp, tg) == (jp, jg)
        np.testing.assert_array_equal(tout, jout)
    # the spike scaled the fleet up
    n = sim.metrics.n_replicas
    assert max(n[SPIKE[0]:SPIKE[1]]) > n[SPIKE[0] - 1]


def test_dropped_world_frees_its_model_without_the_cyclic_collector():
    """J2's world (``make_world`` with every replica an ``LLMReplica`` on one
    SMOKE ``SharedModel``), ticked through the spike and dropped: a weak
    reference to the model is dead at once, with the cyclic collector off
    and never run, so no reference cycle holds the model."""
    import gc
    import weakref

    tcfg = smoke_f32(tconfigs)
    was = gc.isenabled()
    gc.disable()
    try:
        model = tllm.SharedModel(tcfg, max_len=16, max_batch=8, seed=0,
                                 device="cpu")
        sim = texample.make_world(tcfg.vocab_size, model, spike=SPIKE)
        for _ in range(TICKS):
            sim.tick(1.0)
        assert any(type(r).__name__ == "LLMReplica"
                   for r in sim.manager.replicas.values())
        refs = weakref.ref(model), weakref.ref(sim)
        del model, sim
        assert [r() for r in refs] == [None, None]
    finally:
        if was:
            gc.enable()


def test_llm_replica_quirks():
    """Every chunk of a cycle generates the last request's ``gen``, chunks
    are ``max_batch`` wide, and the heartbeat carries ``tokens``."""
    from repro_torch.broker import Broker, TopicPartition
    from repro_torch.core.controller import CONTROLLER_INBOX
    from repro_torch.serving.replica import ReplicaConfig, Sink

    model = tllm.SharedModel(tconfigs.get("qwen3-8b", smoke=True),
                             max_len=16, max_batch=4, device="cpu")
    calls = recorded(model)
    broker = Broker()
    broker.create_topic("req", 1)
    tp = TopicPartition("req", 0)
    for i in range(6):
        broker.produce(tp, json.dumps({"prompt": [1 + i], "gen": 1 + i % 3}),
                       nbytes=100)
    sink = Sink()
    rep = tllm.LLMReplica(0, broker, sink, ReplicaConfig(rate=1e6), model)
    rep.handle.assign(tp)
    assert rep.step(1.0) == 600
    assert [(len(p), g) for p, g, _ in calls] == [(4, 3), (2, 3)]
    assert (rep.requests_served, rep.generated_tokens) == (6, 18)
    assert sink.tables == {"generations": 72} and sink.records == {
        "generations": 6}
    beat = json.loads(broker.partition(CONTROLLER_INBOX).read(0)[-1].value)
    assert beat == {"type": "heartbeat", "consumer": 0,
                    "stats": {"rate": 600.0, "backlog": 0, "tokens": 18}}


def test_serve_prints_the_reference_lines(capsys):
    argv = ["--capacity", "500", "--seconds", "60"]
    jserve.main(argv)
    want = capsys.readouterr().out
    tserve.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert "replica capacity C = 500 tokens/s [flag]" in got


def _results(tmp_path):
    rows = [
        {"arch": "qwen3-8b", "shape": "decode_32k", "mesh": "16x16",
         "roofline": {"t_compute_s": 0.01, "t_memory_s": 0.03,
                      "t_collective_s": 0.002, "bottleneck": "memory"}},
        {"arch": "qwen3-8b", "shape": "decode_32k", "mesh": "16x16",
         "rules": "tail256",
         "roofline": {"t_compute_s": 0.01, "t_memory_s": 0.02,
                      "t_collective_s": 0.004, "bottleneck": "memory"},
         "flush_amortized": {"t_memory_s": 0.001, "t_collective_s": 0.0005}},
        {"arch": "qwen3-8b", "shape": "decode_32k", "mesh": "16x16",
         "rules": "tail256"},                        # no roofline: skipped
    ]
    path = tmp_path / "dryrun_results.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows)
                    + "\nnot json\n")
    return str(path)


@pytest.mark.parametrize("rules", ("baseline", "tail256"))
def test_derived_capacity_equals_the_reference(tmp_path, rules):
    path = _results(tmp_path)
    kw = dict(rules=rules, results_path=path, bytes_per_token=2.0)
    want = jcapacity.derived_replica_capacity("qwen3-8b", "decode_32k", **kw)
    got = tcapacity.derived_replica_capacity("qwen3-8b", "decode_32k", **kw)
    assert got == want
    with pytest.raises(KeyError, match="no dry-run record"):
        tcapacity.derived_replica_capacity("qwen3-8b", "decode_32k",
                                           mesh="8x8", results_path=path)


def test_missing_results_raise_file_not_found(tmp_path):
    missing = tmp_path / "none.jsonl"
    with pytest.raises(FileNotFoundError,
                       match="repro_torch.launch.dryrun --arch qwen3-8b"):
        tcapacity.derived_replica_capacity("qwen3-8b",
                                           results_path=str(missing))
    assert (Path(tcapacity.DEFAULT_RESULTS)
            == ROOT / "dryrun_results_torch.jsonl")
    assert Path(tcapacity._REPO_ROOT) == ROOT


def test_shapes_equal_the_reference():
    assert tshapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for k, v in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[k]) == dataclasses.asdict(v)
    assert tshapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    for arch in ("qwen3-8b", "rwkv6-3b", "olmo-1b", "granite-3-8b"):
        for shape in jshapes.SHAPES:
            assert tshapes.applicable(tconfigs.get(arch), shape) == \
                jshapes.applicable(jconfigs.get(arch), shape)
    archs = ["qwen3-8b", "rwkv6-3b"]
    assert tshapes.cells(archs, tconfigs.get) == jshapes.cells(archs,
                                                                jconfigs.get)


def _load_reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_autoscale_serve", ROOT / "examples" / "autoscale_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_prints_the_reference_lines(capsys):
    _load_reference_example().main()
    want = capsys.readouterr().out.splitlines()
    texample.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] + " on cpu"
    assert got[1:] == want[1:]
    assert any("SPIKE" in line for line in got)


def test_chip_smoke_path_j2_on_the_cpu():
    """``chip_smoke.run_path_j2`` at SMOKE width on the CPU, over a
    40-tick timeline: its checks (the LLM world equal to the byte
    replicas' integer for integer, the fleet growing under the spike, the
    first chunk's tokens again) pass."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    launches = chip_smoke.run_path_j2(
        torch.device("cpu"), 0, cfg=tconfigs.get("qwen3-8b", smoke=True),
        ticks=TICKS, spike=SPIKE, marks=(5, 20, 35))
    assert launches == {"decode_attention_fwd": 0}
