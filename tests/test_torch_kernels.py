"""Each kernel's plain PyTorch version against the JAX reference.

The port's kernel wrappers take their plain version for CPU tensors, so
these tests run the plain versions here; ``chip_smoke.py`` holds the CUDA
kernels against the same plain versions on the card.  Inputs are made
with numpy from a seed and fed to both packages.  Integers must match
exactly; floats within ``atol = rtol = 1e-5`` (sums run in another order
than XLA's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.binpack_select import select_slot_grid as j_select_grid  # noqa: E402
from repro.kernels.lag_update import lag_update_batch as j_lag_batch  # noqa: E402
from repro.kernels.lag_update import lag_update_reference as j_lag_ref  # noqa: E402
from repro.kernels.loop_fused import loop_fused_batch as j_loop_fused  # noqa: E402
from repro.lagsim import LagSimConfig as JConfig  # noqa: E402
from repro.lagsim.fused import sweep_fused as j_sweep_fused  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.binpack_select import (pack_rows,  # noqa: E402
                                                select_slot_batch,
                                                select_slot_grid)
from repro_torch.kernels.lag_update import (lag_update_batch,  # noqa: E402
                                            lag_update_single)
from repro_torch.kernels.loop_fused import loop_fused, loop_fused_batch  # noqa: E402
from repro_torch.lagsim import LagSimConfig  # noqa: E402
from repro_torch.lagsim.fused import sweep_fused  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HEURISTICS = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD")
STRATS = [("next", False), ("next", True), ("first", False), ("first", True),
          ("best", False), ("best", True), ("worst", False), ("worst", True)]


def _lag_inputs(seed, b=4, n=8, m=18):
    rng = np.random.default_rng(seed)
    return dict(
        lag=rng.uniform(0, 2, (b, n)).astype(np.float32),
        produced=rng.uniform(0, 1, (b, n)).astype(np.float32),
        assign=rng.integers(-1, 5, (b, n)).astype(np.int32),
        readable=(rng.random((b, n)) > 0.25).astype(np.int32),
        cap=rng.uniform(0.2, 2, (b, m)).astype(np.float32),
        active=(rng.random((b, n)) > 0.2).astype(np.int32))


@pytest.mark.parametrize("masked", (False, True))
def test_lag_update_matches_reference_and_interpret_kernel(masked):
    x = _lag_inputs(0)
    act = x["active"] if masked else None
    j_args = [jnp.asarray(x[k]) for k in ("lag", "produced", "assign",
                                          "readable", "cap")]
    want_ref = np.asarray(j_lag_ref(*j_args, m=18, active=None if act is None
                                    else jnp.asarray(act)))
    want_pallas = np.asarray(j_lag_batch(
        *j_args, active=None if act is None else jnp.asarray(act),
        interpret=True))
    t = {k: torch.tensor(v) for k, v in x.items()}
    got = lag_update_batch(t["lag"], t["produced"], t["assign"],
                           t["readable"], t["cap"],
                           active=t["active"] if masked else None).numpy()
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)
    if masked:
        assert (got[x["active"] == 0] == 0.0).all()   # exactly zero
    row = lag_update_single(t["lag"][1], t["produced"][1], t["assign"][1],
                            t["readable"][1], t["cap"][1],
                            active=t["active"][1] if masked else None)
    np.testing.assert_array_equal(row.numpy(), got[1])


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("assign_dtype", (torch.int32, torch.int64))
@pytest.mark.parametrize("mask_dtype", (torch.bool, torch.int32))
def test_lag_update_takes_the_engines_dtypes(mask_dtype, assign_dtype,
                                             masked):
    """Bool or int32 masks and int32 or int64 ``assign`` (the kernel reads
    each as it is held) give the reference's drain; out-of-range names
    and -1 included."""
    x = _lag_inputs(7, b=5, n=12, m=9)
    x["assign"] = np.random.default_rng(8).integers(-1, 12, (5, 12)).astype(
        np.int32)
    act = x["active"] if masked else None
    want = np.asarray(j_lag_ref(
        *(jnp.asarray(x[k]) for k in ("lag", "produced", "assign",
                                      "readable", "cap")),
        m=9, active=None if act is None else jnp.asarray(act)))
    t = {k: torch.tensor(v) for k, v in x.items()}
    got = lag_update_batch(
        t["lag"], t["produced"], t["assign"].to(assign_dtype),
        t["readable"].to(mask_dtype), t["cap"],
        active=t["active"].to(mask_dtype) if masked else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_tensors_run_the_plain_version_without_counting():
    x = {k: torch.tensor(v) for k, v in _lag_inputs(1).items()}
    before = lag_update_batch.launches
    lag_update_batch(x["lag"], x["produced"], x["assign"], x["readable"],
                     x["cap"])
    assert lag_update_batch.launches == before
    speeds = torch.rand((3, 6), generator=torch.Generator().manual_seed(1))
    prev = torch.full((3, 6), -1)
    before = pack_rows.launches
    for kw in (dict(strategy="best", decreasing=True),
               dict(strategy="worst", sort_key="cumulative")):
        pack_rows(speeds, prev, 1.0, **kw)
    assert pack_rows.launches == before
    assert set(_build.launch_counts()) >= {"lag_update_batch",
                                           "select_slot_grid", "pack_rows",
                                           "loop_fused"}


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("strategy", ("first", "best", "worst"))
def test_select_slot_matches_reference(strategy, masked):
    rng = np.random.default_rng(2)
    b, n, m = 3, 6, 9
    # a coarse load grid makes ties common (they break to the lowest slot)
    loads = (rng.integers(0, 9, (b, n, m)) / 8).astype(np.float32)
    w = (rng.integers(0, 5, (b, n)) / 8).astype(np.float32)
    k = rng.integers(0, m + 1, (b, n)).astype(np.int32)
    cap = np.ones((b, n), np.float32)
    act = (rng.random((b, n)) > 0.3) if masked else None
    want = np.asarray(j_select_grid(
        jnp.asarray(loads), jnp.asarray(w), jnp.asarray(k), jnp.asarray(cap),
        strategy=strategy, active=None if act is None else jnp.asarray(act),
        interpret=True))
    for i in range(b):
        ref = np.asarray(jref.select_slot_ref(
            jnp.asarray(loads[i]), jnp.asarray(w[i]), jnp.asarray(k[i]),
            jnp.asarray(cap[i]), strategy=strategy))
        if act is not None:
            ref = np.where(act[i], ref, -1)
        np.testing.assert_array_equal(want[i], ref)
    t = [torch.tensor(a) for a in (loads, w, k, cap)]
    tact = None if act is None else torch.tensor(act)
    got = select_slot_grid(*t, strategy=strategy, active=tact)
    np.testing.assert_array_equal(got.numpy(), want)
    one = select_slot_batch(*(a[0] for a in t), strategy=strategy,
                            active=None if tact is None else tact[0])
    np.testing.assert_array_equal(one.numpy(), want[0])


def _loop_inputs(seed, masked, b=3, t=21, n=6):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0, 1.2, (b, t, n)).astype(np.float32)
    if masked:
        rates = (np.round(rates * 4) / 4).astype(np.float32)   # ties
    act = (rng.random((b, t, n)) > 0.25) if masked else None
    lag0 = rng.uniform(0, 2, n).astype(np.float32)
    return rates, act, lag0


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("k", (4, 7))
def test_loop_fused_matches_interpret_megakernel(k, masked):
    rates, act, lag0 = _loop_inputs(3, masked)
    b, _, n = rates.shape
    lag0_b = np.tile(lag0, (b, 1))
    for strategy, dec in (("best", True), ("next", False)):
        want = j_loop_fused(
            jnp.asarray(rates), strategy=strategy, decreasing=dec,
            capacity=1.0, dt=0.7, migration_steps=3, fused_steps=k,
            active=None if act is None else jnp.asarray(act),
            initial_lag=jnp.asarray(lag0_b), interpret=True)
        got = loop_fused_batch(
            torch.tensor(rates), strategy=strategy, decreasing=dec,
            capacity=1.0, dt=0.7, migration_steps=3,
            active=None if act is None else torch.tensor(act),
            initial_lag=torch.tensor(lag0_b))
        for i, (g, w) in enumerate(zip(got, want)):
            if i < 2:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("k", (4, 7))
def test_loop_fused_all_heuristics_match_fused_engine(k, masked):
    rates, act, lag0 = _loop_inputs(4, masked)
    b = rates.shape[0]
    cfg = JConfig(capacity=1.0, dt=0.7, migration_steps=3, fused_steps=k)
    want = j_sweep_fused(HEURISTICS, jnp.asarray(rates), cfg,
                         active=None if act is None else jnp.asarray(act),
                         initial_lag=jnp.asarray(lag0), record_assign=True)
    got = loop_fused(torch.tensor(rates), strategies=[s for s, _ in STRATS],
                     decreasing=[d for _, d in STRATS], capacity=1.0, dt=0.7,
                     migration_steps=3,
                     active=None if act is None else torch.tensor(act),
                     initial_lag=torch.tensor(np.tile(lag0, (b, 1))),
                     record_assign=True)
    names = ("lag_total", "lag_max", "consumers", "migrations", "unreadable",
             "assigns")
    for p, pol in enumerate(HEURISTICS):
        for i, f in enumerate(names):
            w = np.asarray(want[pol][f])
            if i < 2:
                np.testing.assert_allclose(got[i][p].numpy(), w, **TOL)
            else:
                np.testing.assert_array_equal(got[i][p].numpy(), w, (pol, f))


def test_loop_fused_rejects_wide_instances_and_bad_k():
    with pytest.raises(ValueError, match="n <= 14"):
        loop_fused_batch(torch.zeros(1, 4, 15), strategy="best",
                         decreasing=True)
    # K is validated once, by the config, before any fused path runs
    with pytest.raises(ValueError, match="fused_steps must be >= 0"):
        LagSimConfig(fused_steps=-1).resolve(5)
    with pytest.raises(ValueError, match="requires fused_steps > 0"):
        LagSimConfig(fused_kernel=True).resolve(5)
    with pytest.raises(ValueError, match="strategy"):
        loop_fused_batch(torch.zeros(1, 4, 5), strategy="any",
                         decreasing=True)


def test_k_does_not_change_results():
    rates, act, lag0 = _loop_inputs(5, True)
    outs = [sweep_fused(("WFD", "NF"), torch.tensor(rates),
                        LagSimConfig(fused_steps=k, fused_kernel=True),
                        active=torch.tensor(act),
                        initial_lag=torch.tensor(np.tile(lag0, (3, 1))))
            for k in (1, 5, 64)]
    for other in outs[1:]:
        for pol, fields in other.items():
            for name, x in fields.items():
                assert torch.equal(x, outs[0][pol][name]), (pol, name)
