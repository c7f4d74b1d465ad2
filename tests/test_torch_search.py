"""The port's adversarial search (``repro_torch.scenarios.genome`` /
``.search``) against ``repro.scenarios``.

PRNG streams of JAX and PyTorch never agree, so the reference's draws --
its population uniforms, each generation's tournament, crossover and
mutation draws, and the ``adversarial`` family's draws under the search's
scenario key -- are replayed from its own key splits and injected into
the port (``SearchNoise``).  Held exactly: genome decode and repair,
``random_population`` from injected uniforms, one generation's evolution
from injected draws and a given fitness, the oracle's rows, fitness on a
fixed population (MBF and KEDA_LAG, with and without incidents), and a
whole injected-draw search generation by generation.  Within the port: a
fixed seed gives a bit-identical search, every genome's rows are the
family generator's under the search's one scenario seed, and ANNEAL's
fitness is deterministic.

The reference's evolution step runs with jit disabled, its operations
in their written order (``normal * mutation_scale * span``, then ``child
+ noise``): compiled on the CPU, XLA folds ``mutation_scale * span`` and
the normal's own constant into one and contracts the add into a fused
multiply-add, which moves ~10% of the children's genes by 1 ulp.  The
port computes the written order; against the compiled step, one
generation is held to 2 ulps of the larger of a gene and its mutation.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scenarios as jsc  # noqa: E402
from repro.fleet import FleetRunner as JRunner  # noqa: E402
from repro.lagsim import LagSimConfig as JConfig  # noqa: E402
from repro.scenarios import genome as jg  # noqa: E402
from repro.scenarios import search as js  # noqa: E402
from repro.telemetry import AlertConfig as JAlertConfig  # noqa: E402
from repro.telemetry import TelemetryConfig as JTelemetryConfig  # noqa: E402
from repro.telemetry import default_rules as j_default_rules  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.fleet import FleetRunner  # noqa: E402
from repro_torch.lagsim import LagSimConfig  # noqa: E402
from repro_torch.scenarios import genome as tg  # noqa: E402
from repro_torch.scenarios import search as ts  # noqa: E402
from repro_torch.telemetry import (AlertConfig, TelemetryConfig,  # noqa: E402
                                   default_rules)

FAM = "adversarial"
SPEC_J, SPEC_T = jsc.family_spec(FAM), tsc.family_spec(FAM)
K = len(SPEC_T.knobs)
#: the whole-search parity shape: pop 8, 3 generations
CFG = ts.SearchConfig(pop_size=8, generations=3, iters=48, n=6)
J_CFG = js.SearchConfig(pop_size=8, generations=3, iters=48, n=6)


def _t(x):
    return torch.tensor(np.asarray(x))


def _alerting(pkg):
    if pkg == "ref":
        return JConfig(telemetry=JTelemetryConfig(
            record_frames=False, alerts=JAlertConfig(rules=j_default_rules())))
    return LagSimConfig(telemetry=TelemetryConfig(
        record_frames=False, alerts=AlertConfig(rules=default_rules())))


def _raw_genomes(seed, p=12):
    """Genomes over and beyond the bounds, with death before birth."""
    rng = np.random.default_rng(seed)
    lo, hi = tg.genome_bounds(FAM)
    g = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo),
                    (p, K)).astype(np.float32)
    names = list(SPEC_T.knob_names)
    g[::2, names.index("birth_frac")] = 0.8
    g[::2, names.index("death_frac")] = 0.2
    return g


# ---------------------------------------------------------------------------
# genomes
# ---------------------------------------------------------------------------
def test_bounds_default_and_knobs_equal_the_reference():
    for a, b in zip(tg.genome_bounds(FAM), jg.genome_bounds(FAM)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tg.default_genome(FAM).tobytes() == jg.default_genome(FAM).tobytes()
    g = _raw_genomes(0)[3]
    assert tg.genome_knobs(FAM, g) == jg.genome_knobs(FAM, g)
    assert tg.genome_knobs(FAM, torch.tensor(g)) == jg.genome_knobs(FAM, g)
    dec_t, dec_j = tg.decode_genome(FAM, g), jg.decode_genome(FAM, g)
    assert list(dec_t) == list(dec_j)
    assert all(float(dec_t[k]) == float(dec_j[k]) for k in dec_j)
    for fn in (tg.decode_genome, tg.genome_knobs):
        with pytest.raises(ValueError, match="takes genomes of shape"):
            fn(FAM, np.zeros(K + 1, np.float32))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_repair_equals_the_reference(seed):
    raw = _raw_genomes(seed)
    got = tg.repair_genome(FAM, torch.tensor(raw))
    want = np.asarray(jg.repair_genome(FAM, jnp.asarray(raw)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # one genome, and the repair leaves its input as it was
    one = torch.tensor(raw[0])
    np.testing.assert_array_equal(tg.repair_genome(FAM, one).numpy(),
                                  want[0])
    np.testing.assert_array_equal(one.numpy(), raw[0])
    names = list(SPEC_T.knob_names)
    assert (got[:, names.index("death_frac")]
            >= got[:, names.index("birth_frac")]).all()


@pytest.mark.parametrize("seed", (0, 7))
def test_random_population_from_injected_uniforms(seed):
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (16, K))
    got = tg.random_population(FAM, None, 16, uniforms=_t(u))
    want = jg.random_population(FAM, key, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # from a generator: in bounds and deterministic
    a = tg.random_population(FAM, seed, 16, device="cpu")
    b = tg.random_population(FAM, seed, 16, device="cpu")
    lo, hi = tg.genome_bounds(FAM)
    assert torch.equal(a, b) and a.shape == (16, K)
    assert ((a >= torch.tensor(lo)) & (a <= torch.tensor(hi))).all()
    with pytest.raises(ValueError, match="takes uniforms of shape"):
        tg.random_population(FAM, None, 4, uniforms=torch.zeros(3, K))


def _evolve_draws(cfg, key, p):
    k_t, k_x, k_m = jax.random.split(key, 3)
    n_ch = p - cfg.n_elites
    return (_t(jax.random.randint(k_t, (n_ch, 2, 2), 0, p)).long(),
            _t(jax.random.bernoulli(k_x, cfg.crossover_p, (n_ch, K))),
            _t(jax.random.normal(k_m, (n_ch, K))))


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("pop_size,elite_frac", ((8, 0.25), (6, 0.5)))
def test_one_generation_equals_the_reference(seed, pop_size, elite_frac):
    """Fitness quantized to 1/8 so that ties are the rule, as
    ``violation_frac`` makes them: the stable sort keeps population order
    and the tournament's first candidate wins a tie, as in the
    reference."""
    cfg = ts.SearchConfig(pop_size=pop_size, elite_frac=elite_frac)
    jcfg = js.SearchConfig(pop_size=pop_size, elite_frac=elite_frac)
    key = jax.random.PRNGKey(seed)
    pop = jg.random_population(FAM, jax.random.fold_in(key, 99), pop_size)
    fit = (np.random.default_rng(seed).integers(0, 3, pop_size) / 8.0
           ).astype(np.float32)
    with jax.disable_jit():
        want = js._make_evolve(SPEC_J, jcfg)(pop, jnp.asarray(fit), key)
    got = ts._evolve(SPEC_T, cfg, _t(pop), torch.tensor(fit),
                     *_evolve_draws(cfg, key, pop_size))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("pop_size,elite_frac", ((8, 0.25), (6, 0.5)))
def test_one_generation_is_within_two_ulps_of_the_compiled_reference(
        seed, pop_size, elite_frac):
    """The reference's evolution step as its users run it, compiled: the
    elites exact, every child's gene within 2 ulps of the larger of the
    gene and its mutation (the compiled step rounds the mutation once
    less and fuses the add, see the module docstring; where the mutation
    all but cancels the parent's gene, that is many ulps of the small
    result)."""
    cfg = ts.SearchConfig(pop_size=pop_size, elite_frac=elite_frac)
    jcfg = js.SearchConfig(pop_size=pop_size, elite_frac=elite_frac)
    key = jax.random.PRNGKey(seed)
    pop = jg.random_population(FAM, jax.random.fold_in(key, 99), pop_size)
    fit = (np.random.default_rng(seed).integers(0, 3, pop_size) / 8.0
           ).astype(np.float32)
    want = np.asarray(js._make_evolve(SPEC_J, jcfg)(pop, jnp.asarray(fit),
                                                     key))
    draws = _evolve_draws(cfg, key, pop_size)
    got = ts._evolve(SPEC_T, cfg, _t(pop), torch.tensor(fit),
                     *draws).numpy()
    n_el = cfg.n_elites
    np.testing.assert_array_equal(got[:n_el], want[:n_el])
    lo, hi = tg.genome_bounds(FAM)
    mutation = (draws[2] * cfg.mutation_scale * torch.tensor(hi - lo)).numpy()
    ulp = np.maximum(np.spacing(np.abs(got[n_el:])),
                     np.spacing(np.abs(mutation)))
    assert (np.abs(got[n_el:] - want[n_el:]) <= 2 * ulp).all()


# ---------------------------------------------------------------------------
# the oracle and the fitness on a fixed population
# ---------------------------------------------------------------------------
def _scenario_draws(key, s, iters, n):
    """The ``adversarial`` family's draws under ``key``, with the churn
    flips as their uniforms (a genome's ``churn_p`` thresholds them)."""
    k_tail, k_churn, k_state, k_sel, k_noise = jax.random.split(key, 5)
    return dict(
        tail=_t(jax.random.normal(k_tail, (s, 1, n))),
        state0=_t(jax.random.bernoulli(k_state, 0.9, (s, n))),
        flips=_t(jax.random.uniform(k_churn, (iters, s, n))),
        select=_t(jax.random.uniform(k_sel, (s, 1, n))),
        jitter=_t(jax.random.uniform(k_noise, (s, iters, n), minval=-1.0,
                                     maxval=1.0)))


def _reference_scenario(key, cfg):
    """``knobs -> (rates, active)``: the port's transform fed the
    reference's draws under the search's scenario key."""
    draws = _scenario_draws(key, cfg.scenarios_per_genome, cfg.iters, cfg.n)

    def scenario(churn_p, **knobs):
        d = dict(draws, flips=draws["flips"] < churn_p)
        return tsc.adversarial_masked(d, capacity=cfg.capacity, **knobs)

    return scenario


def _reference_noise(cfg, seed, gens):
    """The draws the reference's search makes from ``seed``, as the port
    takes them."""
    k_pop, k_scen, k_evo = jax.random.split(jax.random.PRNGKey(seed), 3)
    per = [(*_evolve_draws(cfg, jax.random.fold_in(k_evo, g), cfg.pop_size),
            _t(jax.random.uniform(jax.random.fold_in(k_evo, g),
                                  (cfg.pop_size, K))))
           for g in range(1, gens)]
    return ts.SearchNoise(
        population=_t(jax.random.uniform(k_pop, (cfg.pop_size, K))),
        tournament=[d[0] for d in per], crossover=[d[1] for d in per],
        mutation=[d[2] for d in per], baseline=[d[3] for d in per],
        scenario=_reference_scenario(k_scen, cfg))


@pytest.mark.parametrize("s", (1, 2))
def test_oracle_rows_equal_the_reference(s):
    """Genome ``i``'s block of rows under the reference's draws: masks
    exact, rates within the scenario transforms' tolerance."""
    cfg = ts.SearchConfig(pop_size=6, scenarios_per_genome=s, iters=32, n=5)
    jcfg = js.SearchConfig(pop_size=6, scenarios_per_genome=s, iters=32,
                           n=5)
    key = jax.random.PRNGKey(11)
    pop = np.array(jg.repair_genome(FAM, jnp.asarray(_raw_genomes(3, 6))))
    pop[1, list(SPEC_T.knob_names).index("churn_p")] = 0.15
    w_sp, w_ac = js._scenario_oracle(SPEC_J, jcfg)(jnp.asarray(pop), key)
    noise = ts.SearchNoise(population=torch.zeros(6, K),
                           scenario=_reference_scenario(key, cfg))
    draws = ts._Draws(noise, 0, torch.device("cpu"), K, cfg)
    sp, ac = ts._scenario_oracle(SPEC_T, cfg, draws)(torch.tensor(pop))
    assert sp.shape == ac.shape == (6 * s, 32, 5)
    np.testing.assert_array_equal(ac.numpy(), np.asarray(w_ac))
    np.testing.assert_allclose(sp.numpy(), np.asarray(w_sp), atol=1e-5,
                               rtol=1e-5)
    assert not ac[s:2 * s].all()          # genome 1's churn flipped some


def test_oracle_rows_are_the_family_generator():
    """Without injected noise, every genome's rows are exactly
    ``generate_masked_scenario`` of its repaired knobs under the search's
    one scenario seed."""
    cfg = ts.SearchConfig(pop_size=5, scenarios_per_genome=2, iters=24, n=4)
    draws = ts._Draws(None, 3, torch.device("cpu"), K, cfg)
    pop = torch.tensor(_raw_genomes(5, 5))
    sp, ac = ts._scenario_oracle(SPEC_T, cfg, draws)(pop)
    fixed = tg.repair_genome(FAM, pop)
    for i in range(5):
        w_sp, w_ac = tsc.generate_masked_scenario(
            FAM, draws.scenario_seed, 2, 24, 4, device="cpu",
            **tg.genome_knobs(FAM, fixed[i]))
        assert torch.equal(sp[2 * i:2 * i + 2], w_sp)
        assert torch.equal(ac[2 * i:2 * i + 2], w_ac)


@pytest.mark.parametrize("weight", (0.0, 0.05))
@pytest.mark.parametrize("policy", ("MBF", "KEDA_LAG"))
def test_fitness_on_a_fixed_population_equals_the_reference(policy, weight):
    """Incidents exact; violation fraction and fitness equal."""
    cfg = ts.SearchConfig(pop_size=8, scenarios_per_genome=2, iters=40,
                          n=6, incident_weight=weight)
    jcfg = js.SearchConfig(pop_size=8, scenarios_per_genome=2, iters=40,
                           n=6, incident_weight=weight)
    key = jax.random.PRNGKey(21)
    pop = jg.random_population(FAM, jax.random.fold_in(key, 1), 8)
    alerts = bool(weight)
    want = js._evaluate(JRunner(), policy,
                        _alerting("ref") if alerts else JConfig(), jcfg,
                        js._scenario_oracle(SPEC_J, jcfg), pop, key)
    noise = ts.SearchNoise(population=torch.zeros(8, K),
                           scenario=_reference_scenario(key, cfg))
    oracle = ts._scenario_oracle(
        SPEC_T, cfg, ts._Draws(noise, 0, torch.device("cpu"), K, cfg))
    got = ts._evaluate(FleetRunner(), policy,
                       _alerting("port") if alerts else LagSimConfig(), cfg,
                       oracle, _t(pop), "cpu")
    for name, g, w in zip(("fitness", "violation_frac", "incidents"), got,
                          want):
        assert g.dtype == np.float32, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    if alerts:
        assert got[2].sum() > 0           # the incident term was exercised


def test_anneal_fitness_is_deterministic():
    """ANNEAL draws from its own seeded generator at each ``init``: its
    fitness is a function of the genome within the port."""
    cfg = ts.SearchConfig(pop_size=3, iters=12, n=4)
    pop = tg.random_population(FAM, 2, 3, device="cpu")
    runs = []
    for _ in range(2):
        oracle = ts._scenario_oracle(
            SPEC_T, cfg, ts._Draws(None, 5, torch.device("cpu"), K, cfg))
        runs.append(ts._evaluate(FleetRunner(), "ANNEAL", LagSimConfig(),
                                 cfg, oracle, pop, "cpu"))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# whole searches
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _eager_evolution():
    """The reference's search with its evolution step run with jit
    disabled (see the module docstring); its oracle and fleet stay
    compiled."""
    make = js._make_evolve

    def eager(spec, cfg):
        evolve = make(spec, cfg)

        def run(*args):
            with jax.disable_jit():
                return evolve(*args)
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "_make_evolve", eager)
        yield


@pytest.fixture(scope="module")
def reference_searches():
    """The reference's search and baseline, MBF, pop 8, 3 generations,
    seeds 0 and 1 (one run a module: its fleet compiles per shape)."""
    runner = JRunner()
    out = {}
    with _eager_evolution():
        for seed in (0, 1):
            ev = js.attack("MBF", config=J_CFG, seed=seed, runner=runner)
            rs = js.random_search("MBF", config=J_CFG, seed=seed,
                                  runner=runner, evals=ev.evals)
            out[seed] = (ev, rs)
    return out


def _same_search(got, want):
    assert got.history == want.history
    np.testing.assert_array_equal(got.best_genome, want.best_genome)
    assert got.best_genome.dtype == np.float32
    assert (got.evals, got.generations_run) == (want.evals,
                                                want.generations_run)
    assert got.best_knobs == want.best_knobs
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("seed", (0, 1))
def test_injected_attack_follows_the_reference(reference_searches, seed):
    ev, rs = reference_searches[seed]
    noise = _reference_noise(CFG, seed, CFG.generations)
    runner = FleetRunner()
    got = ts.attack("MBF", config=CFG, seed=seed, runner=runner, noise=noise,
                    device="cpu")
    _same_search(got, ev)
    base = ts.random_search("MBF", config=CFG, seed=seed, runner=runner,
                            evals=got.evals, noise=noise, device="cpu")
    _same_search(base, rs)
    # every generation of both runs hit the one cache entry
    st = runner.stats()
    assert (st["cache_misses"], st["cache_hits"]) == (
        1, got.generations_run + base.generations_run - 1)


def test_noise_too_short_raises_by_name():
    noise = _reference_noise(CFG, 0, 2)        # one generation's draws
    with pytest.raises(ValueError, match="SearchNoise.tournament holds 1"):
        ts.attack("MBF", config=CFG, seed=0, noise=noise, device="cpu",
                  runner=FleetRunner())


def test_fixed_seed_search_is_bit_identical():
    runner = FleetRunner()
    cfg = ts.SearchConfig(pop_size=6, generations=3, iters=32, n=5)
    a = ts.attack("NF", config=cfg, seed=3, runner=runner, device="cpu")
    b = ts.attack("NF", config=cfg, seed=3, runner=runner, device="cpu")
    _same_search(a, b)
    c = ts.attack("NF", config=cfg, seed=4, runner=runner, device="cpu")
    assert (not np.array_equal(a.best_genome, c.best_genome)
            or a.best_fitness != c.best_fitness)
    assert len(a.history) == a.generations_run
    assert a.evals == a.generations_run * 6


def test_early_stopping_bounds_evals():
    res = ts.attack("NF", config=ts.SearchConfig(
        pop_size=4, generations=64, iters=16, n=4, patience=2), seed=0,
        device="cpu")
    assert res.generations_run < 64
    assert res.evals == res.generations_run * 4
    assert len(res.history) == res.generations_run


def test_search_config_and_result_fields_equal_the_reference():
    import dataclasses

    for a, b in ((ts.SearchConfig, js.SearchConfig),
                 (ts.SearchResult, js.SearchResult)):
        assert ([(f.name, f.default) for f in dataclasses.fields(a)]
                == [(f.name, f.default) for f in dataclasses.fields(b)])
    assert CFG.n_elites == J_CFG.n_elites
    for bad in (dict(pop_size=1), dict(generations=0), dict(elite_frac=1.0),
                dict(scenarios_per_genome=0)):
        with pytest.raises(ValueError) as want:
            js.SearchConfig(**bad)
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            ts.SearchConfig(**bad)


def test_knobless_family_is_refused_by_name(monkeypatch):
    spec = tsc.FamilySpec("knobless", tsc.SCENARIO_FAMILIES["ramp"],
                          tsc.MASKED_SCENARIO_FAMILIES["ramp"])
    monkeypatch.setitem(tsc.FAMILY_SPECS, "knobless", spec)
    with pytest.raises(ValueError, match="registers no knobs"):
        ts.attack("NF", family="knobless", config=CFG, device="cpu")


def test_family_representatives_equal_the_reference():
    assert ts.family_representatives() == js.family_representatives()
    assert ts.family_representatives("py") == js.family_representatives("py")
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        ts.family_representatives("jax")

