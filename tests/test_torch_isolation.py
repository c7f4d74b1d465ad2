"""The port stands alone: it imports nothing of JAX or the reference (every
subpackage, training's ``optim``, ``data`` and ``checkpoint`` included),
and it never drifts onto the CPU unasked."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import CudaUnavailableError, api, configs, opt  # noqa: E402
from repro_torch.broker import Broker  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from repro_torch.convert import opt_state_from_numpy  # noqa: E402
from repro_torch.examples import autoscale_serve  # noqa: E402
from repro_torch.examples import elastic_train  # noqa: E402
from repro_torch.examples import (lag_slo_sweep, live_dashboard,  # noqa: E402
                                  pareto_frontier, quickstart,
                                  scenario_sweep)
from repro_torch.fleet import FleetRunner  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.lagsim import simulate_lag, sweep_lag  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.models import init_decode_state, init_params  # noqa: E402
from repro_torch.models import mamba, moe  # noqa: E402,F401
from repro_torch.registry import make_policy  # noqa: E402
from repro_torch.scenarios import trace_from_scenario  # noqa: E402
from repro_torch.serving import SharedModel, Sink  # noqa: E402
from repro_torch.serving.llm_replica import LLMReplica  # noqa: E402

LLM = configs.get("qwen3-8b", smoke=True)
LLAMA4 = configs.get("llama4-scout-17b-a16e", smoke=True)
RWKV = configs.get("rwkv6-3b", smoke=True)
MOE = configs.get("qwen2-moe-a2.7b", smoke=True)
HYBRID = configs.get("jamba-v0.1-52b", smoke=True)
WHISPER = configs.get("whisper-large-v3", smoke=True)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_flax_or_repro():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_the_dry_run_and_the_last_example_stand_alone():
    """The dry run's modules and the adversarial report are among the files
    scanned above, and importing them loads neither JAX nor the
    reference."""
    import subprocess
    import sys

    mods = ("launch.shapes", "launch.mesh", "launch.cost_walk",
            "launch.dryrun", "examples.adversarial_report")
    files = set(_port_files())
    for m in mods:
        assert ROOT / "src" / "repro_torch" / (m.replace(".", "/") + ".py") \
            in files
    code = ("import sys\n"
            + "".join(f"import repro_torch.{m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'flax', 'repro')]\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})


@pytest.mark.parametrize("call", (
    lambda: api.simulate(np.zeros((1, 3, 2), np.float32), policies=("BFD",)),
    lambda: sweep_lag(("BFD",), np.zeros((1, 3, 2), np.float32)),
    lambda: simulate_lag(np.zeros((3, 2), np.float32), policy="BFD"),
    lambda: make_policy("BFD", 2),
    lambda: scenarios.generate_masked_scenario("bursty", 0, 1, 3, 2),
    lambda: api.optimize(np.full(3, 0.4), steps=2),
    lambda: opt.anneal_pack(np.full(3, 0.4), np.zeros(3, np.int32), 1.0,
                            np.zeros(2, np.float32), steps=2),
    lambda: opt.anneal_assign(np.full(3, 0.4), np.zeros(3, np.int32), 1.0,
                              chains=2, steps=2),
    lambda: opt.anneal_frontier(np.full(3, 0.4), np.zeros(3, np.int32), 1.0,
                                steps=2),
    lambda: make_prefill_step(LLM),
    lambda: make_serve_step(LLM),
    lambda: SharedModel(LLM),
    lambda: init_params(LLM),
    lambda: init_decode_state(LLM, 1, 4),
    lambda: params_from_numpy({}, LLM),
    lambda: make_prefill_step(RWKV),
    lambda: SharedModel(RWKV),
    lambda: init_decode_state(RWKV, 1, 4),
    lambda: api.pack(np.full(3, 0.4), 1.0, backend="torch"),
    lambda: api.sweep(np.zeros((1, 3, 2), np.float32), algorithms=("BFD",)),
    lambda: api.evaluate(n_partitions=3, n_measurements=4),
    lambda: FleetRunner().simulate(("BFD",), np.zeros((1, 3, 2), np.float32)),
    lambda: scenarios.generate_scenario("ramp", 0, 1, 3, 2),
    lambda: api.attack("NF", config=api.SearchConfig(pop_size=2,
                                                     generations=1, iters=3,
                                                     n=2)),
    lambda: api.replay(api.Trace(rates=np.zeros((1, 3, 2), np.float32),
                                 active=np.ones((1, 3, 2), bool)),
                       policies=("BFD",)),
    lambda: api.seed_trace("kafka_partition_skew", batch=1, iters=3, n=2),
    lambda: trace_from_scenario("bursty", 0, 1, 3, 2),
    lambda: LLMReplica(0, Broker(), Sink(), None, model=SharedModel(LLM)),
    lambda: autoscale_serve.main([]),
    lambda: make_train_step(LLM, AdamWConfig()),
    lambda: train(LLM, steps=1, batch=1, seq=4, ckpt_dir=None),
    lambda: elastic_train.main([]),
    lambda: opt_state_from_numpy({}, LLM),
    lambda: init_params(MOE),
    lambda: make_prefill_step(MOE),
    lambda: make_serve_step(MOE),
    lambda: SharedModel(MOE),
    lambda: init_params(HYBRID),
    lambda: make_prefill_step(HYBRID),
    lambda: SharedModel(HYBRID),
    lambda: init_decode_state(HYBRID, 1, 4),
    lambda: params_from_numpy({}, HYBRID),
    lambda: init_params(WHISPER),
    lambda: make_prefill_step(WHISPER),
    lambda: make_serve_step(WHISPER),
    lambda: make_train_step(WHISPER, AdamWConfig()),
    lambda: init_decode_state(WHISPER, 1, 4),
    lambda: params_from_numpy({}, WHISPER),
    lambda: make_train_step(MOE, AdamWConfig()),
    lambda: make_train_step(LLAMA4, AdamWConfig()),
    lambda: make_train_step(HYBRID, AdamWConfig()),
    lambda: quickstart.main([]),
    lambda: scenario_sweep.main([]),
    lambda: lag_slo_sweep.main(["--smoke"]),
    lambda: pareto_frontier.main([]),
    lambda: live_dashboard.main(["--smoke"]),
), ids=("api.simulate", "sweep_lag", "simulate_lag", "make_policy",
        "scenarios.generate", "api.optimize", "opt.anneal_pack",
        "opt.anneal_assign", "opt.anneal_frontier", "make_prefill_step",
        "make_serve_step", "SharedModel", "init_params",
        "init_decode_state", "params_from_numpy", "rwkv-make_prefill_step",
        "rwkv-SharedModel", "rwkv-init_decode_state", "api.pack",
        "api.sweep", "api.evaluate", "FleetRunner.simulate",
        "scenarios.generate_scenario", "api.attack", "api.replay",
        "seed_trace", "trace_from_scenario", "LLMReplica",
        "examples.autoscale_serve", "make_train_step", "launch.train",
        "examples.elastic_train", "opt_state_from_numpy", "moe-init_params",
        "moe-make_prefill_step", "moe-make_serve_step", "moe-SharedModel",
        "hybrid-init_params", "hybrid-make_prefill_step",
        "hybrid-SharedModel", "hybrid-init_decode_state",
        "hybrid-params_from_numpy", "whisper-init_params",
        "whisper-make_prefill_step", "whisper-make_serve_step",
        "whisper-make_train_step", "whisper-init_decode_state",
        "whisper-params_from_numpy", "moe-make_train_step",
        "llama4-make_train_step", "hybrid-make_train_step",
        "examples.quickstart", "examples.scenario_sweep",
        "examples.lag_slo_sweep", "examples.pareto_frontier",
        "examples.live_dashboard"))
def test_default_device_without_cuda_raises_named_error(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="device='cpu'"):
        call()


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    monkeypatch.setattr(_build, "BUILD_ROOT", Path("/nonexistent-build-root"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


#: the subpackages of the port: each must be present, import nothing of
#: JAX or the reference, and import without a card
SUBPACKAGES = ("broker", "checkpoint", "configs", "core", "data", "examples",
               "fleet", "kernels", "lagsim", "launch", "models", "opt",
               "optim", "registry", "scenarios", "serving", "telemetry")


def test_every_subpackage_is_covered_and_imports_without_a_card():
    import importlib

    pkg = ROOT / "src" / "repro_torch"
    found = sorted(p.parent.name for p in pkg.glob("*/__init__.py"))
    assert found == sorted(SUBPACKAGES)
    for name in SUBPACKAGES:
        importlib.import_module(f"repro_torch.{name}")
    files = {p.relative_to(pkg).parts[0] for p in _port_files()[:-1]}
    assert set(SUBPACKAGES) <= files
