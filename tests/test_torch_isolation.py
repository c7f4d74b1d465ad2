"""The port stands alone: it imports nothing of JAX or the reference, and
it never drifts onto the CPU unasked."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import CudaUnavailableError, api, configs, opt  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from repro_torch.fleet import FleetRunner  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.lagsim import simulate_lag, sweep_lag  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import init_decode_state, init_params  # noqa: E402
from repro_torch.registry import make_policy  # noqa: E402
from repro_torch.scenarios import trace_from_scenario  # noqa: E402
from repro_torch.serving import SharedModel  # noqa: E402

LLM = configs.get("qwen3-8b", smoke=True)
RWKV = configs.get("rwkv6-3b", smoke=True)

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
), ids=("api.simulate", "sweep_lag", "simulate_lag", "make_policy",
        "scenarios.generate", "api.optimize", "opt.anneal_pack",
        "opt.anneal_assign", "opt.anneal_frontier", "make_prefill_step",
        "make_serve_step", "SharedModel", "init_params",
        "init_decode_state", "params_from_numpy", "rwkv-make_prefill_step",
        "rwkv-SharedModel", "rwkv-init_decode_state", "api.pack",
        "api.sweep", "api.evaluate", "FleetRunner.simulate",
        "scenarios.generate_scenario", "api.attack", "api.replay",
        "seed_trace", "trace_from_scenario"))
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
