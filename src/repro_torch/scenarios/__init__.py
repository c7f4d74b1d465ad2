"""Trace replay and adversarial search, on the card (the port of
``repro.scenarios``, exporting the same names).

Two engines, one contract -- the fleet pair of rates ``f32[B, T, N]``
and partition existence ``active: bool[B, T, N]``:

* ``scenarios.traces`` -- versioned on-disk traces (``.json`` /
  ``.npz``): save, load-with-validation, resample, and a padding-exact
  round trip through ``FleetRunner`` (a replayed trace reproduces the
  direct run bit for bit).
* ``scenarios.seeds``  -- the seed library: Kafka benchmark shapes
  (arXiv 2003.06452 insert plateaus, partition skew, lifecycle churn)
  materialized as deterministic traces.
* ``scenarios.genome`` -- genomes over the family registry's
  :class:`~repro_torch.core.scenarios.KnobSpec` bounds: decode, repair
  (bounds + ordered-pair constraints), random populations.
* ``scenarios.search`` -- the adversarial loop: evolutionary search
  (elites/tournament/crossover/mutation on f32 tensors) against
  ``FleetRunner.fitness`` to maximize ``violation_frac`` + burn-rate
  incidents, with a random baseline and fixed-seed determinism; its
  draws are injectable (``scenarios.search.SearchNoise``).

Everything resolves lazily, so ``import repro_torch.scenarios`` is
cheap.
"""
from __future__ import annotations

_TRACE_EXPORTS = (
    "TRACE_VERSION",
    "Trace",
    "load_trace",
    "resample_trace",
    "save_trace",
    "trace_from_scenario",
    "validate_trace",
)

_SEED_EXPORTS = (
    "SEED_SHAPES",
    "list_seeds",
    "seed_trace",
)

_GENOME_EXPORTS = (
    "decode_genome",
    "default_genome",
    "genome_bounds",
    "genome_knobs",
    "random_population",
    "repair_genome",
)

_SEARCH_EXPORTS = (
    "SearchConfig",
    "SearchResult",
    "attack",
    "family_representatives",
    "random_search",
)

__all__ = sorted(_TRACE_EXPORTS + _SEED_EXPORTS + _GENOME_EXPORTS
                 + _SEARCH_EXPORTS, key=str.lower)

_HOME = {name: "traces" for name in _TRACE_EXPORTS}
_HOME.update({name: "seeds" for name in _SEED_EXPORTS})
_HOME.update({name: "genome" for name in _GENOME_EXPORTS})
_HOME.update({name: "search" for name in _SEARCH_EXPORTS})


def __getattr__(name: str):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
