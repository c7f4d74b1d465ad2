"""The port's optimizer against ``repro.opt`` and the closed-loop annealer
policies against ``repro.lagsim``.

JAX and torch random streams never agree, so every anneal here takes the
reference's own draws: the Gumbel noise its key chain makes and its
``_temperature_schedule``, carried across by
``convert.anneal_noise_from_numpy``.  Assignments, bin counts, consumers,
migrations and unreadable counts must match exactly; R-scores, costs and
lag within ``atol = 1e-5``.  The pure-Python and numpy pieces (frontier
reductions, heuristic points, the exact oracle) must match exactly.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.opt as jopt  # noqa: E402
import repro.opt.anneal as janneal  # noqa: E402
from repro.lagsim import LagSimConfig as JConfig  # noqa: E402
from repro.lagsim import sweep_lag as j_sweep_lag  # noqa: E402
from repro.opt.anneal import _temperature_schedule as j_schedule  # noqa: E402
from repro_torch import api, opt  # noqa: E402
from repro_torch.convert import anneal_noise_from_numpy  # noqa: E402
from repro_torch.kernels.move_eval import (ChainState,  # noqa: E402
                                           anneal_step,
                                           anneal_step_reference,
                                           move_delta_reference)
from repro_torch.lagsim import LagSimConfig, sweep_lag  # noqa: E402
from repro_torch.registry import builtin, list_policies  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
OPTIMIZERS = ("ANNEAL", "ANNEAL_STICKY")
PACKERS = list_policies(family=("heuristic", "sticky"))


def _draws(key, steps, chains, n):
    """The reference's draws for one anneal under ``key``: ``split(key,
    steps)``, one ``[chains, N*M+1]`` Gumbel draw per step."""
    width = n * (2 * n + 2) + 1
    keys = jax.random.split(key, steps)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (chains, width),
                                             jnp.float32))(keys)
    return np.asarray(g), np.asarray(j_schedule(steps, 1.0, 0.02))


def _instance(seed, n=6):
    rng = np.random.default_rng(seed)
    speeds = rng.uniform(0, 1.2, n).astype(np.float32)
    speeds[0] = 1.1                                  # one oversized item
    prev = rng.integers(-1, n, n).astype(np.int32)
    return speeds, prev, rng.random(n) > 0.3


@pytest.mark.parametrize("masked", (False, True))
def test_anneal_pack_matches_reference(masked):
    speeds, prev, act = _instance(0)
    act = act if masked else None
    lam = np.repeat(np.float32([0.0, 0.5, 4.0]), 2)
    key = jax.random.key(11)
    want = jopt.anneal_pack(jnp.asarray(speeds), jnp.asarray(prev), 1.0,
                            jnp.asarray(lam), key, steps=40,
                            active=None if act is None else jnp.asarray(act))
    noise = anneal_noise_from_numpy(*_draws(key, 40, 6, 6), device="cpu")
    got = opt.anneal_pack(torch.tensor(speeds), torch.tensor(prev), 1.0,
                          torch.tensor(lam), steps=40, noise=noise,
                          active=None if act is None else torch.tensor(act),
                          device="cpu")
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(want.bins))
    np.testing.assert_allclose(got.rscore.numpy(), np.asarray(want.rscore),
                               **TOL)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), **TOL)
    np.testing.assert_array_equal(got.lam.numpy(), lam)


#: the step-by-step cases' Gumbel draws: the reference's own, rounded
#: to a coarse grid (moves tie in z), or all zero (the "stay" draw ties
#: the best move whenever no move lowers the cost)
DRAWS = {"reference": lambda g: g,
         "coarse": lambda g: jnp.round(g * 2) / 2,
         "zeros": jnp.zeros_like}


def _reference_steps(monkeypatch, speeds, prev, lam, act, steps, draw):
    """The reference annealer's scan body run one step at a time on its
    own inputs: its carry before the first step and after each one, its
    temperatures, and the Gumbel draws each step made (passed through
    ``draw``, which the step then uses)."""
    draws, carries = [], []
    real = jax.random.gumbel

    def gumbel(key, shape, dtype):
        g = draw(real(key, shape, dtype))
        draws.append(np.asarray(g))
        return g

    def scan(body, carry, xs):
        carries.append(carry)
        for t in range(xs[0].shape[0]):
            carry, _ = body(carry, (xs[0][t], xs[1][t]))
            carries.append(carry)
        return carry, None

    monkeypatch.setattr(jax.random, "gumbel", gumbel)
    monkeypatch.setattr(janneal, "lax", types.SimpleNamespace(scan=scan))
    janneal.anneal_chains(jnp.asarray(speeds), jnp.asarray(prev), 1.0,
                          jnp.asarray(lam), jax.random.key(5), steps=steps,
                          active=None if act is None else jnp.asarray(act))
    return (carries, np.asarray(j_schedule(steps, 1.0, 0.02)),
            np.stack(draws))


@pytest.mark.parametrize("draws", tuple(DRAWS))
@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("n", (7, 32))
def test_anneal_step_matches_reference_step_by_step(monkeypatch, n, masked,
                                                    draws):
    """``anneal_step_reference`` from the reference's own state, with its
    draws and temperatures, equals the reference's scan body after each of
    48 steps: assignment, loads, counts, cost, best cost and best
    assignment, bit for bit."""
    rng = np.random.default_rng(n + masked)
    speeds = rng.uniform(0, 0.7, n).astype(np.float32)
    if draws != "reference":
        speeds = (np.round(speeds * 8) / 8).astype(np.float32)
    speeds[0] = 1.1                                  # one oversized item
    prev = rng.integers(-1, n, n).astype(np.int32)
    act = rng.random(n) > 0.3 if masked else None
    lam = np.float32([0.0, 0.5, 4.0])
    steps = 48
    carries, temps, g = _reference_steps(monkeypatch, speeds, prev, lam, act,
                                         steps, DRAWS[draws])
    k, m = len(lam), 2 * n + 2
    sp = np.where(act, speeds, 0) if masked else speeds
    pv = np.where(act, prev, -1) if masked else prev
    rows = lambda x, dt: torch.tensor(np.broadcast_to(x, (k, n)), dtype=dt)  # noqa: E731
    speeds_k, prev_k = rows(sp, torch.float32), rows(pv, torch.int32)
    act_k = None if act is None else rows(act, torch.int32)
    cap = torch.ones(k)
    state = ChainState(*(torch.tensor(np.array(x)) for x in carries[0]))
    gt, tt = torch.tensor(g), torch.tensor(temps)
    ties = stay_ties = 0
    for t in range(steps):
        delta = move_delta_reference(state.loads, state.counts, state.assign,
                                     speeds_k, prev_k, torch.tensor(lam),
                                     cap, active=act_k).view(k, n * m)
        z = delta.neg().div_(tt[t]).add_(gt[t][:, :n * m])
        zmax = z.max(1).values
        ties += int(((z == zmax[:, None]).sum(1) > 1).sum())
        stay_ties += int((zmax == gt[t][:, n * m]).sum())
        anneal_step_reference(state, speeds_k, prev_k, torch.tensor(lam),
                              cap, gt[t], tt, t, active=act_k)
        for name, got, want in zip(ChainState._fields, state,
                                   carries[t + 1]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          f"step {t}: {name}")
    if draws == "coarse":
        assert ties > 0
    if draws == "zeros":
        assert ties > 0 and stay_ties > 0
    assert int(state.best_cost.lt(torch.tensor(np.asarray(
        carries[0][3]))).sum()) > 0                  # the chains improved


def test_anneal_step_on_cpu_tensors_runs_the_plain_version():
    """``anneal_step`` on CPU tensors is its plain version, uncounted."""
    n, k = 6, 4
    m = 2 * n + 2
    gen = torch.Generator().manual_seed(3)
    speeds = torch.rand((k, n), generator=gen)
    prev = torch.randint(-1, m, (k, n), generator=gen, dtype=torch.int32)
    assign = torch.arange(n, dtype=torch.int32).expand(k, n).contiguous()
    pad = lambda x: torch.cat([x, x.new_zeros(k, m - n)], 1)  # noqa: E731
    cost = torch.rand(k, generator=gen) + n

    def fresh():
        return ChainState(assign.clone(), pad(speeds),
                          pad(torch.ones((k, n), dtype=torch.int32)),
                          cost.clone(), cost.clone(), assign.clone())

    args = (speeds, prev, torch.full((k,), 0.5), torch.ones(k),
            torch.rand((k, n * m + 1), generator=gen), torch.ones(3))
    got, want = fresh(), fresh()
    before = anneal_step.launches
    for step in range(3):
        anneal_step(got, *args, step)
        anneal_step_reference(want, *args, step)
    assert anneal_step.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got.assign, assign)       # moves were made


def test_rows_share_noise_and_each_equals_its_own_reference():
    """Three rows in one call: each equals the reference's anneal of that
    row alone under the same key, so no row depends on its batch-mates."""
    rows = [_instance(s) for s in (1, 2, 3)]
    key = jax.random.key(4)
    noise = anneal_noise_from_numpy(*_draws(key, 30, 4, 6), device="cpu")
    got_a, got_b = opt.anneal_assign(
        torch.tensor(np.stack([r[0] for r in rows])),
        torch.tensor(np.stack([r[1] for r in rows])), 1.0, lam=4.0, chains=4,
        steps=30, noise=noise,
        active=torch.tensor(np.stack([r[2] for r in rows])), device="cpu")
    ref = jax.jit(lambda s, p, a: jopt.anneal_assign(
        s, p, 1.0, key, lam=4.0, chains=4, steps=30, active=a))
    for i, (speeds, prev, act) in enumerate(rows):
        a, b = ref(jnp.asarray(speeds), jnp.asarray(prev), jnp.asarray(act))
        np.testing.assert_array_equal(got_a[i].numpy(), np.asarray(a))
        assert int(got_b[i]) == int(b)


def test_anneal_frontier_matches_reference():
    speeds, prev, _ = _instance(5)
    key = jax.random.key(2)
    lambdas = (0.0, 1.0, 8.0)
    want = jopt.anneal_frontier(speeds, prev, 1.0, key, lambdas=lambdas,
                                restarts=2, steps=50)
    noise = anneal_noise_from_numpy(*_draws(key, 50, 6, 6), device="cpu")
    got = opt.anneal_frontier(speeds, prev, 1.0, lambdas=lambdas, restarts=2,
                              steps=50, noise=noise, device="cpu")
    assert got.lambdas == want.lambdas
    assert got.ref == want.ref
    for mine, theirs in ((got.per_lambda, want.per_lambda),
                         (got.front, want.front)):
        assert len(mine) == len(theirs)
        np.testing.assert_array_equal([p[0] for p in mine],
                                      [p[0] for p in theirs])
        np.testing.assert_allclose([p[1] for p in mine],
                                   [p[1] for p in theirs], **TOL)
    np.testing.assert_allclose(got.hypervolume, want.hypervolume, **TOL)


def _loop_traces(masked, b=3, t=8, n=5):
    rng = np.random.default_rng(9)
    tr = rng.uniform(0, 0.9, (b, t, n)).astype(np.float32)
    if not masked:
        return tr, None
    act = rng.random((b, t, n)) > 0.2
    return np.where(act, tr, 0).astype(np.float32), act


def _loop_noise(t, n):
    """The reference's per-decision draws in the closed loop: the policy's
    key starts at ``key(0x0A11EA1)``, each decision splits ``key, sub``,
    and the anneal splits ``sub`` into its steps."""
    key = jax.random.key(builtin.ANNEAL_SEED)
    out = []
    for _ in range(t):
        key, sub = jax.random.split(key)
        out.append(anneal_noise_from_numpy(
            *_draws(sub, builtin.ANNEAL_STEPS, builtin.ANNEAL_CHAINS, n),
            device="cpu"))
    return out


@pytest.fixture(scope="module")
def loop_reference():
    cfg = dict(capacity=1.0, dt=0.8, migration_steps=2)
    out = {}
    for masked in (False, True):
        tr, act = _loop_traces(masked)
        out[masked] = (tr, act, cfg, j_sweep_lag(OPTIMIZERS, tr,
                                                 JConfig(**cfg), active=act))
    return out


@pytest.mark.parametrize("masked", (False, True))
def test_closed_loop_matches_reference(loop_reference, masked):
    tr, act, cfg, want = loop_reference[masked]
    noise = _loop_noise(tr.shape[1], tr.shape[2])
    got = sweep_lag(OPTIMIZERS, torch.tensor(tr), LagSimConfig(**cfg),
                    active=None if act is None else torch.tensor(act),
                    device="cpu",
                    policy_options={p: {"noise": noise} for p in OPTIMIZERS})
    for f in ("consumers", "migrations", "unreadable"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("lag_total", "lag_max"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL)
    assert np.asarray(want.migrations).sum() > 0    # the anneal moved things


def test_default_noise_is_deterministic_per_run():
    tr, act = _loop_traces(True, b=2, t=4, n=4)
    runs = [sweep_lag(OPTIMIZERS, tr, LagSimConfig(), active=act,
                      device="cpu") for _ in range(2)]
    for f in ("lag_total", "consumers", "migrations"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f))
    # a stream's result does not depend on its batch-mates
    solo = sweep_lag(OPTIMIZERS, tr[:1], LagSimConfig(), active=act[:1],
                     device="cpu")
    assert torch.equal(solo.consumers[:, 0], runs[0].consumers[:, 0])


def test_drawn_noise_replays_the_default_draws():
    """``AnnealNoise.draw`` materializes exactly what the annealer draws
    from the same generator when given no noise."""
    speeds, prev, act = _instance(5)
    lam = torch.tensor([0.0, 4.0])
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    args = (torch.tensor(speeds), torch.tensor(prev), 1.0, lam)
    kw = dict(steps=12, active=torch.tensor(act), device="cpu")
    default = opt.anneal_chains(*args, generator=gen(), **kw)
    replay = opt.anneal_chains(
        *args, noise=opt.AnnealNoise.draw(12, 2, 6, generator=gen()), **kw)
    for f in ("assign", "bins", "rscore", "cost"):
        assert torch.equal(getattr(default, f), getattr(replay, f)), f


def test_too_little_noise_is_named():
    tr, _ = _loop_traces(False, b=1, t=3, n=4)
    with pytest.raises(ValueError, match="noise holds 2 decisions"):
        sweep_lag(("ANNEAL",), tr, LagSimConfig(), device="cpu",
                  policy_options={"ANNEAL": {"noise": _loop_noise(2, 4)}})


@pytest.mark.parametrize("name", PACKERS)
def test_heuristic_point_matches_reference(name):
    rng = np.random.default_rng(3)
    speeds = rng.uniform(0, 0.7, 6)
    prev = rng.integers(-1, 5, 6).astype(np.int32)
    assert (opt.heuristic_point(name, speeds, prev, 1.0, device="cpu")
            == jopt.heuristic_point(name, speeds, prev, 1.0))


def test_incumbent_assignment_matches_reference():
    rng = np.random.default_rng(4)
    trace = rng.uniform(0, 0.6, (5, 6)).astype(np.float32)
    for algo in ("BFD", "MWF"):
        np.testing.assert_array_equal(
            opt.incumbent_assignment(trace, 1.0, 4, algo, device="cpu"),
            jopt.incumbent_assignment(trace, 1.0, 4, algo))


def test_frontier_reductions_match_reference():
    rng = np.random.default_rng(6)
    pts = [(float(b), float(r)) for b, r in zip(
        rng.integers(2, 7, 20), np.round(rng.uniform(0, 2, 20), 2))]
    ref = (8.0, 3.0)
    assert opt.pareto_front(pts) == jopt.pareto_front(pts)
    front = opt.pareto_front(pts)
    for p in pts + [(1.0, 0.0), (9.0, 9.0)]:
        assert opt.dominated(p, front) == jopt.dominated(p, front)
    assert opt.hypervolume_2d(pts, ref) == jopt.hypervolume_2d(pts, ref)
    speeds = rng.uniform(0, 1, 7)
    prev = rng.integers(-1, 4, 7)
    assert (opt.reference_point(speeds, prev, 0.9)
            == jopt.reference_point(speeds, prev, 0.9))
    h, o = rng.integers(0, 9, 11), rng.integers(0, 9, 11)
    np.testing.assert_array_equal(opt.optimality_gap(h, o),
                                  jopt.optimality_gap(h, o))
    fr = opt.FrontierResult(lambdas=[0.0], per_lambda=front[:1], front=front,
                            ref=ref, hypervolume=opt.hypervolume_2d(front,
                                                                    ref))
    jfr = jopt.FrontierResult(**dataclasses.asdict(fr))
    for p in pts[:5]:
        assert fr.heuristic_metrics(p) == jfr.heuristic_metrics(p)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_exact_oracle_matches_reference(seed):
    rng = np.random.default_rng(seed)
    w = list(rng.uniform(0, 1.3, 7))
    ours = opt.branch_and_bound(w, 1.0)
    theirs = jopt.branch_and_bound(w, 1.0)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert opt.brute_force(w, 1.0) == jopt.brute_force(w, 1.0) == ours.n_bins
    assert opt.lower_bound_l1(w, 1.0) == jopt.lower_bound_l1(w, 1.0)
    assert opt.lower_bound_l2(w, 1.0) == jopt.lower_bound_l2(w, 1.0)


def test_optimize_scores_every_packer_against_its_frontier():
    rng = np.random.default_rng(8)
    speeds = rng.uniform(0, 0.6, 6)
    prev = opt.incumbent_assignment(rng.uniform(0, 0.6, (3, 6)), 1.0, 3,
                                    device="cpu")
    kw = dict(lambdas=(0.0, 4.0), restarts=2, steps=20, seed=3, device="cpu")
    out = api.optimize(speeds, prev, **kw)
    assert out == api.optimize(speeds, prev, **kw)        # seeded
    assert tuple(out.heuristics) == PACKERS
    fr = opt.anneal_frontier(speeds, prev, 1.0, lambdas=(0.0, 4.0),
                             restarts=2, steps=20, seed=3, device="cpu")
    assert (out.per_lambda, out.front) == (fr.per_lambda, fr.front)
    for name, metrics in out.heuristics.items():
        assert metrics == fr.heuristic_metrics(
            opt.heuristic_point(name, speeds, prev, 1.0, device="cpu"))
    assert out.schema_version == api.API_VERSION
