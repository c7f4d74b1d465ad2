"""End-to-end LLM serving with the bin-packing autoscaler, on the port.

The counterpart of the reference's ``examples/autoscale_serve.py``.

Request streams (ordered partitions) feed replicas that run the serve
step of a small qwen3-family model on the card; the monitor measures each
stream's byte rate, and the controller sizes the fleet and assigns streams
with MBFP -- scaling up on a traffic spike and back down after, while the
broker enforces the single-reader invariant through every migration.

  PYTHONPATH=src python -m repro_torch.examples.autoscale_serve [--device cpu]

The world (producer, broker, monitor, controller, replicas) is host code;
only generation runs on ``--device`` (default: the CUDA card).
``make_world`` builds the same world for other callers: another model or
timeline, or plain byte replicas (``model=None``), whose byte-level world
is the same integer for integer.
"""
from __future__ import annotations

import argparse
import json
import weakref

import numpy as np

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.broker import TopicPartition
from repro_torch.serving import AutoscaleSimulation
from repro_torch.serving.llm_replica import LLMReplica, SharedModel
from repro_torch.serving.replica import ReplicaConfig

CAP = 0.25e6          # replica ingest capacity (bytes/s of request payload)
REC = 65536           # one request record (big payloads -> few real decodes)
N_STREAMS = 6
SPIKE = (80, 160)     # traffic spike on streams 0-2 (x4) over [80, 160) s
TICKS = 240
MARKS = {60: "steady", 140: "SPIKE", 230: "post-spike"}


def rate_fn(spike=SPIKE):
    """Stream p's byte rate: ``0.05e6 * (1 + p % 3)``, x4 on streams 0-2
    while ``spike[0] <= t < spike[1]``."""
    lo, hi = spike

    def fn(tp: TopicPartition, t: float) -> float:
        base = 0.05e6 * (1 + tp.partition % 3)
        if lo <= t < hi:
            return base * (4 if tp.partition < 3 else 1)
        return base
    return fn


def make_world(vocab_size: int, model=None, spike=SPIKE,
               seed: int = 0) -> AutoscaleSimulation:
    """The example's closed loop: ``N_STREAMS`` request streams of
    ``REC``-byte records ``{"prompt": 2 ids, "gen": 2}`` drawn from a
    numpy generator seeded ``seed``, replicas of capacity ``CAP`` behind
    MBFP.  ``model`` (a ``SharedModel``) makes every replica an
    ``LLMReplica``; ``None`` keeps the plain byte replicas."""
    fn = rate_fn(spike)
    sim = AutoscaleSimulation(n_partitions=N_STREAMS, rate_fn=fn,
                              capacity=CAP, monitor_interval=5.0,
                              record_bytes=REC)
    broker, sink = sim.broker, sim.sink
    if model is not None:
        # swap in LLM replicas (requests as payloads)
        sim.manager._factory = lambda cid: LLMReplica(
            cid, broker, sink, ReplicaConfig(rate=CAP), model)

    # produce actual request payloads instead of raw bytes; the producer
    # reaches the world through a weak reference, so that the world holds
    # no reference cycle (through it, the model): dropped, it and its
    # model are freed at once, without waiting for the cyclic collector
    rng = np.random.default_rng(seed)
    world = weakref.ref(sim)

    def produce(dt):
        sim = world()
        t = sim.clock.now()
        for i in range(N_STREAMS):
            tp = TopicPartition(sim.topic, i)
            sim._accum[i] += max(0.0, fn(tp, t)) * dt
            while sim._accum[i] >= sim.record_bytes:
                req = json.dumps({"prompt": rng.integers(
                    1, vocab_size, size=2).tolist(), "gen": 2})
                broker.produce(tp, req, nbytes=sim.record_bytes)
                sim._accum[i] -= sim.record_bytes
                sim.produced_bytes += sim.record_bytes
    sim._produce = produce
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the model generates (default: the CUDA "
                         "card; 'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get("qwen3-8b", smoke=True)
    model = SharedModel(cfg, max_len=16, max_batch=8, device=dev)
    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) on {dev}")
    sim = make_world(cfg.vocab_size, model)

    marks = dict(MARKS)
    for _ in range(TICKS):
        sim.tick(1.0)
        t = int(sim.clock.now())
        if t in marks:
            reps = sim.manager.replicas
            tokens = sum(getattr(r, "generated_tokens", 0) for r in reps.values())
            print(f"t={t:4d}s [{marks[t]:10s}] replicas={sim.manager.n_alive()} "
                  f"lag={sim.broker.total_lag('autoscaler', sim.topic)/1e3:.0f}KB "
                  f"tokens_generated={tokens}")
            del marks[t]

    n_mig = len(sim.controller.migrations)
    moved = sum(len(m.moved) for m in sim.controller.migrations)
    print(f"\nreassignments: {n_mig}, total stream migrations: {moved}, "
          f"mean Rscore: {np.mean([m.rscore for m in sim.controller.migrations]):.3f}")
    served = sum(getattr(r, "requests_served", 0)
                 for r in sim.manager.replicas.values())
    print(f"requests served by current fleet: {served}; "
          f"fleet size: {sim.manager.n_alive()}")
    assert sim.manager.n_alive() >= 1


if __name__ == "__main__":
    main()
