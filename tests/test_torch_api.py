"""The port's facade against the reference's: the same outcome fields, and
what the port does not carry yet refused by name before anything runs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.lagsim import NotPortedError  # noqa: E402


@pytest.mark.parametrize("outcome", ("SimulateOutcome", "OptimizeOutcome"))
def test_outcome_fields_equal_the_reference(outcome):
    ours = [(f.name, f.default) for f in
            dataclasses.fields(getattr(api, outcome))]
    ref = [(f.name, f.default) for f in
           dataclasses.fields(getattr(japi, outcome))]
    assert ours == ref


def test_simulate_outcome_telemetry_fields_stay_none():
    out = api.simulate(np.full((1, 3, 2), 0.3, np.float32),
                       policies=("BFD",), device="cpu")
    assert (out.telemetry, out.sketches, out.incidents) == (None, None, None)
    assert out.lag_total.shape == (1, 1, 3)


def test_simulate_refuses_fleet_before_anything_runs(monkeypatch):
    from repro_torch.lagsim import engine

    def boom(*a, **k):
        raise AssertionError("simulate ran before refusing fleet=")

    monkeypatch.setattr(api, "sweep_lag", boom)
    monkeypatch.setattr(engine, "sweep_lag", boom)
    with pytest.raises(NotPortedError, match="fleet"):
        api.simulate(np.zeros((1, 3, 2), np.float32), policies=("BFD",),
                     fleet=object(), device="cpu")
