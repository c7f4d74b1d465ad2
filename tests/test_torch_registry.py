"""The port's registry against the reference catalogue, and the reactive
scalers' step parity.

Names (in registration order), families, hyperparameters, paper sections
and summaries must equal ``repro.registry``'s ``jax`` backend, policy for
policy; the reactive scalers must give the same assignment, consumer
count and state as the reference's ``Policy.step`` on the same inputs,
step after step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.registry as jreg  # noqa: E402
import repro_torch.registry as treg  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402

PORTED = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD",
          "MWF", "MBF", "MWFP", "MBFP", "KEDA_LAG", "RATE_THRESHOLD",
          "KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG", "ANNEAL", "ANNEAL_STICKY")


def test_names_follow_reference_registration_order():
    assert treg.list_policies() == PORTED
    assert treg.list_policies() == jreg.list_policies(backend="jax")


@pytest.mark.parametrize("name", PORTED)
def test_family_and_hyperparams_equal_reference(name):
    ours, ref = treg.get_spec(name), jreg.get_spec(name, backend="jax")
    assert ours.family == ref.family
    assert dict(ours.hyperparams) == dict(ref.hyperparams)
    assert ours.paper_section == ref.paper_section
    assert ours.summary == ref.summary


def test_family_filter_and_errors():
    assert treg.list_policies(family="reactive") == (
        "KEDA_LAG", "RATE_THRESHOLD", "KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG")
    assert treg.list_policies(family="reactive") == jreg.list_policies(
        family="reactive", backend="jax")
    with pytest.raises(ValueError, match="unknown family"):
        treg.list_policies(family="bogus")
    with pytest.raises(ValueError, match="unknown policy"):
        treg.get_spec("KEDA_LAG_FAKE")
    with pytest.raises(ValueError, match="does not take hyperparams"):
        treg.make_policy("BFD", 4, device="cpu", gain=2.0)
    with pytest.raises(ValueError, match="already registered"):
        treg.register("BFD", family="heuristic")(lambda *a, **k: None)
    with pytest.raises(ValueError, match="does not take options"):
        treg.make_policy("BFD", 4, device="cpu", options={"noise": []})
    with pytest.raises(ValueError, match="has no one-shot packer"):
        treg.packer_for("ANNEAL")


@pytest.mark.parametrize("name", ("ANNEAL", "ANNEAL_STICKY"))
def test_fused_mode_refuses_optimizers_like_the_reference(name):
    from repro.lagsim import LagSimConfig as JConfig
    from repro.lagsim.fused import FusedPathError as JFusedPathError
    from repro.lagsim.fused import fused_mode as j_fused_mode
    from repro_torch.lagsim import FusedPathError, LagSimConfig, fused_mode

    with pytest.raises(JFusedPathError) as want:
        j_fused_mode(name, JConfig(fused_steps=4), 6)
    with pytest.raises(FusedPathError) as got:
        fused_mode(name, LagSimConfig(fused_steps=4), 6)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("name", ("KEDA_LAG", "RATE_THRESHOLD"))
def test_reactive_step_parity(name, masked):
    rng = np.random.default_rng(7)
    rows, n, steps = 4, 6, 12
    knobs = dict(lag_threshold=1.4, target_utilization=0.75,
                 max_consumers=5, scale_down_patience=2)
    ref = jreg.make_policy(name, n, jnp.float32(1.0), backend="jax",
                           **{k: (jnp.float32(v) if isinstance(v, float)
                                  else v) for k, v in knobs.items()})
    ours = treg.make_policy(name, n, 1.0, device="cpu", **knobs)
    ref_state = [ref.init(n) for _ in range(rows)]
    our_state = ours.init(n)
    for t in range(steps):
        # scaled so that totals cross several thresholds up and down
        speeds = (rng.uniform(0, 1.2, (rows, n)) * (1 + (t % 5))
                  ).astype(np.float32)
        lag = (rng.uniform(0, 2.5, (rows, n)) * (t % 3)).astype(np.float32)
        act = (rng.random((rows, n)) > 0.3) if masked else None
        st = state_from_numpy(lag, device="cpu")
        assign, n_cons, our_state = ours.step(
            torch.tensor(speeds), st.lag, st.prev_assign, our_state,
            None if act is None else torch.tensor(act))
        for r in range(rows):
            a, k, ref_state[r] = ref.step(
                jnp.asarray(speeds[r]), jnp.asarray(lag[r]),
                jnp.full(n, -1, jnp.int32), ref_state[r],
                None if act is None else jnp.asarray(act[r]))
            np.testing.assert_array_equal(assign[r].numpy(), np.asarray(a))
            assert int(n_cons[r]) == int(k), (t, r)
            assert int(our_state[1][r]) == int(ref_state[r][1]), (t, r)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
def test_backends_and_per_backend_lists_equal_the_reference():
    """``torch`` is the port's counterpart of the reference's ``jax``."""
    assert treg.BACKENDS == ("py", "torch")
    assert treg.list_policies(backend="torch") == jreg.list_policies(
        backend="jax")
    assert treg.list_policies(backend="py") == jreg.list_policies(
        backend="py")
    for fam in treg.FAMILIES + (treg.PACKER_FAMILIES,):
        assert treg.list_policies(family=fam, backend="py") == \
            jreg.list_policies(family=fam, backend="py")
        assert treg.list_policies(family=fam, backend="torch") == \
            jreg.list_policies(family=fam, backend="jax")
    assert treg.list_policies() == jreg.list_policies()


@pytest.mark.parametrize("name", jreg.list_policies(backend="py"))
def test_py_specs_equal_the_reference(name):
    ours, ref = treg.get_spec(name, backend="py"), jreg.get_spec(
        name, backend="py")
    assert (ours.name, ours.family, ours.backend) == (ref.name, ref.family,
                                                      "py")
    assert dict(ours.hyperparams) == dict(ref.hyperparams)
    assert (ours.paper_section, ours.summary) == (ref.paper_section,
                                                  ref.summary)
    # backend=None prefers torch, as the reference prefers jax
    assert treg.get_spec(name).backend == "torch"
    assert treg.packer_for(name, backend="py") is not treg.packer_for(name)


def test_backend_errors_name_the_backends():
    for call in (lambda: treg.list_policies(backend="jax"),
                 lambda: treg.get_spec("BFD", backend="jax"),
                 lambda: treg.make_policy("BFD", 4, backend="jax"),
                 lambda: treg.packer_for("BFD", backend="jax"),
                 lambda: treg.register("X", family="heuristic",
                                       backend="jax")):
        with pytest.raises(ValueError,
                           match=r"unknown backend 'jax'; have \('py', "
                                 r"'torch'\)"):
            call()
    with pytest.raises(ValueError, match="not registered for backend 'py'"):
        treg.get_spec("KEDA_LAG", backend="py")
    with pytest.raises(ValueError, match="unknown algorithm 'ANNEAL' for "
                                         "backend 'py'"):
        treg.packer_for("ANNEAL", backend="py")
    with pytest.raises(ValueError, match="already registered for backend "
                                         "'py'"):
        treg.register("BFD", family="heuristic", backend="py")(
            lambda *a, **k: None)


def test_py_policy_runs_on_the_host_without_a_device(monkeypatch):
    """A ``py`` policy takes no device: it builds on a host without
    CUDA at ``device=None``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pol = treg.make_policy("MBF", 3, backend="py")
    assign, k, _ = pol.step(np.array([0.6, 0.5, 0.2], np.float32), None,
                            np.full(3, -1, np.int32), pol.init(3))
    assert int(k) == 2 and assign.tolist() == [0, 1, 0]


# ---------------------------------------------------------------------------
# deprecation shims, each warning once per process, as the reference's
# tests/test_registry.py pins them
# ---------------------------------------------------------------------------
def _warned_access(fn):
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        value = fn()
    return value, [x for x in w if issubclass(x.category, DeprecationWarning)]


def _shims():
    from repro_torch.core import modified, pack
    from repro_torch.lagsim import policies

    return {
        "ALL_ALGORITHMS": (lambda: modified.ALL_ALGORITHMS,
                           treg.list_policies(family=treg.PACKER_FAMILIES,
                                              backend="py")),
        "ALL_ALGORITHM_NAMES": (lambda: pack.ALL_ALGORITHM_NAMES,
                                treg.list_policies(
                                    family=treg.PACKER_FAMILIES,
                                    backend="torch")),
        "ALL_POLICY_NAMES": (lambda: policies.ALL_POLICY_NAMES,
                             treg.list_policies(backend="torch")),
    }


@pytest.mark.parametrize("attr", ("ALL_ALGORITHMS", "ALL_ALGORITHM_NAMES",
                                  "ALL_POLICY_NAMES"))
def test_deprecated_table_warns_exactly_once(attr):
    from repro_torch.registry.compat import _reset_deprecation_warnings

    get, want = _shims()[attr]
    _reset_deprecation_warnings()
    value, warned = _warned_access(get)
    assert len(warned) == 1
    assert "repro_torch.registry" in str(warned[0].message)
    assert attr in str(warned[0].message)
    if attr == "ALL_ALGORITHMS":
        assert sorted(value) == sorted(want)
        assert all(value[n] is treg.packer_for(n, backend="py")
                   for n in want)
    else:
        assert value == want
    _, again = _warned_access(get)
    assert again == []                    # exactly once per process


def test_deprecated_reexports_forward():
    """The package-level re-exports (``repro_torch.core`` /
    ``repro_torch.lagsim``) forward to the same shims."""
    import warnings

    import repro_torch.core
    import repro_torch.lagsim
    from repro_torch.registry.compat import _reset_deprecation_warnings

    _reset_deprecation_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert sorted(repro_torch.core.ALL_ALGORITHMS) == sorted(
            treg.list_policies(family=treg.PACKER_FAMILIES, backend="py"))
        assert repro_torch.core.ALL_ALGORITHM_NAMES == treg.list_policies(
            family=treg.PACKER_FAMILIES, backend="torch")
        assert repro_torch.lagsim.ALL_POLICY_NAMES == treg.list_policies(
            backend="torch")
    with pytest.raises(AttributeError):
        repro_torch.core.NO_SUCH_TABLE
    with pytest.raises(AttributeError):
        repro_torch.lagsim.NO_SUCH_TABLE


def test_lagsim_policies_tables_and_make_policy_shim():
    from repro.lagsim import policies as jpol
    from repro_torch.lagsim import policies as tpol

    for table in ("PACKING_POLICY_NAMES", "REACTIVE_BASELINE_NAMES",
                  "OPTIMIZER_POLICY_NAMES", "ANNEAL_CHAINS", "ANNEAL_STEPS",
                  "ANNEAL_STICKY_LAMBDA"):
        assert getattr(tpol, table) == getattr(jpol, table), table
    init, step = tpol.make_policy(
        "KEDA_LAG", 4, 1.0, lag_threshold=2.0, target_utilization=0.75,
        max_consumers=4, scale_down_patience=3, device="cpu")
    speeds = torch.full((1, 4), 0.5)
    assign, k, _ = step(speeds, 10.0 * speeds,
                        torch.full((1, 4), -1, dtype=torch.long), init(4))
    want = jpol.make_policy(
        "KEDA_LAG", 4, 1.0, lag_threshold=2.0, target_utilization=0.75,
        max_consumers=4, scale_down_patience=3)
    w_assign, w_k, _ = want[1](jnp.full(4, 0.5), jnp.full(4, 5.0),
                               jnp.full(4, -1, jnp.int32), want[0](4))
    assert int(k[0]) == int(w_k)
    np.testing.assert_array_equal(assign[0].numpy(), np.asarray(w_assign))
