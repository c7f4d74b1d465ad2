"""Streaming metric sketches of the lag twin: whole-run summaries in O(1)
a step, batched over stream rows.

The reference's ``repro.telemetry.sketch`` carried over to the port's
per-step loop, one slot per telemetry channel and one state row per
stream:

* Welford mean / variance;
* running min / max;
* debiased EWMA windows at configurable half-lives;
* a fixed-bin histogram over selected channels, giving whole-run
  quantiles within one bin of resolution.

The update takes an optional ``valid`` (one flag a row) so that the fleet
layer's bucket padding stays exact: a padded step leaves a row's state
as it was.  Host-side, :class:`SketchSummary` finalizes one stream's
state and :func:`merge_summaries` combines summaries with Chan's
parallel-variance update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .record import _np, const, gate


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static sketch knobs (hashable: rides ``TelemetryConfig``).

    ``ewma_halflives`` are in *steps* (``alpha = 1 - 2**(-1/h)``).
    ``hist_channels`` selects the channels that get a fixed-bin histogram
    over ``[0, hist_max]`` (values clamp into the edge bins; ``None`` lets
    ``LagSimConfig.resolve`` default it to ``8 * capacity * dt * n``).
    Quantile estimates are exact to one bin width ``hist_max /
    hist_bins``.
    """

    ewma_halflives: Tuple[float, ...] = (8.0, 64.0)
    hist_bins: int = 64
    hist_channels: Tuple[str, ...] = ("lag_total",)
    hist_max: Optional[float] = None

    def __post_init__(self) -> None:
        for h in self.ewma_halflives:
            if not float(h) > 0.0:
                raise ValueError(
                    f"ewma_halflives entries must be > 0 steps, got {h!r}")
        if int(self.hist_bins) < 2:
            raise ValueError(
                f"hist_bins={self.hist_bins!r} must be >= 2 (one bin cannot "
                f"locate a quantile)")
        if self.hist_max is not None and not float(self.hist_max) > 0.0:
            raise ValueError(
                f"hist_max={self.hist_max!r} must be > 0 (or None to derive "
                f"a default from the lagsim config)")

    @property
    def alphas(self) -> Tuple[float, ...]:
        """Per-step EWMA decay rates derived from the half-lives."""
        return tuple(1.0 - 2.0 ** (-1.0 / float(h))
                     for h in self.ewma_halflives)

    @property
    def bin_width(self) -> float:
        """Histogram bin width -- the quantile resolution bound."""
        if self.hist_max is None:
            raise ValueError(
                "hist_max is unresolved (None); run through LagSimConfig."
                "resolve or set it explicitly")
        return float(self.hist_max) / int(self.hist_bins)


@dataclasses.dataclass
class SketchState:
    """The carried aggregator bundle (``K`` channels, ``H`` half-lives,
    ``C`` histogrammed channels x ``B`` bins), every leaf led by the batch
    shape (one row a stream; none for one stream)."""

    count: Any      # f32[...]        valid steps aggregated
    mean: Any       # f32[..., K]     Welford running mean
    m2: Any         # f32[..., K]     Welford sum of squared deviations
    vmin: Any       # f32[..., K]
    vmax: Any       # f32[..., K]
    ewma: Any       # f32[..., H, K]  biased EWMA (debias via ewma_w)
    ewma_w: Any     # f32[..., H]     accumulated EWMA weight
    hist: Any       # f32[..., C, B]  per-channel fixed-bin counts
    names: Tuple[str, ...]
    hist_names: Tuple[str, ...]


def _hist_indices(cfg: SketchConfig, names: Tuple[str, ...]
                  ) -> Tuple[int, ...]:
    idx = []
    for ch in cfg.hist_channels:
        if ch not in names:
            raise ValueError(
                f"SketchConfig.hist_channels names unknown channel {ch!r}; "
                f"this run records {names}")
        idx.append(names.index(ch))
    return tuple(idx)


def sketch_init(cfg: SketchConfig, names: Tuple[str, ...], *,
                batch: Tuple[int, ...] = (), device=None) -> SketchState:
    """Zero state for ``names`` (the run's full channel tuple, custom
    counters included), one row per ``batch`` entry.  Raises (named) if a
    ``hist_channels`` entry is not a recorded channel."""
    _hist_indices(cfg, names)           # fail fast on unknown channels
    batch = tuple(batch)
    k = len(names)
    h = len(cfg.ewma_halflives)
    c = len(cfg.hist_channels)
    z = lambda *s: torch.zeros(batch + s, device=device)  # noqa: E731
    return SketchState(
        count=z(), mean=z(k), m2=z(k),
        vmin=torch.full(batch + (k,), float("inf"), device=device),
        vmax=torch.full(batch + (k,), float("-inf"), device=device),
        ewma=z(h, k), ewma_w=z(h), hist=z(c, int(cfg.hist_bins)),
        names=tuple(names), hist_names=tuple(cfg.hist_channels))


def sketch_update(cfg: SketchConfig, state: SketchState, vec,
                  valid=None) -> SketchState:
    """One O(K) update with the step's channel vectors ``f32[..., K]``.

    ``valid`` (bool, the batch shape, optional) gates the update: a
    ``False`` row (fleet bucket padding) keeps every aggregate as it was.
    """
    dev = vec.device
    c1 = state.count + 1.0
    d = vec - state.mean
    mean = state.mean + d / c1[..., None]
    m2 = state.m2 + d * (vec - mean)
    vmin = torch.minimum(state.vmin, vec)
    vmax = torch.maximum(state.vmax, vec)
    al = const(cfg.alphas, dev)[:, None]                       # [H, 1]
    one_less = 1.0 - al
    ewma = one_less * state.ewma + al * vec[..., None, :]
    ewma_w = one_less[:, 0] * state.ewma_w + al[:, 0]
    hist = state.hist
    if state.hist_names:
        idx = _hist_indices(cfg, state.names)
        x = vec.index_select(-1, const(idx, dev, torch.long))    # [..., C]
        # a true divide (the reference's), truncated toward zero
        width = const((cfg.bin_width,) * len(idx), dev)
        bins = int(cfg.hist_bins)
        slot = torch.clamp((x / width).to(torch.int32), 0, bins - 1)
        hist = hist + (const(range(bins), dev, torch.int32)
                       == slot[..., None]).float()
    new = SketchState(count=c1, mean=mean, m2=m2, vmin=vmin, vmax=vmax,
                      ewma=ewma, ewma_w=ewma_w, hist=hist,
                      names=state.names, hist_names=state.hist_names)
    return gate(valid, new, state)


# ---------------------------------------------------------------------------
# host-side finalization + cross-bucket merging
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SketchSummary:
    """A finalized sketch: plain numpy, one row per channel.

    ``ewma`` maps half-life -> debiased window value per channel; ``hist``
    / ``edges`` back :meth:`quantile`; ``m2`` is kept so that
    :func:`merge_summaries` can combine summaries.
    """

    names: Tuple[str, ...]
    count: float
    mean: np.ndarray                    # f64[K]
    m2: np.ndarray                      # f64[K]
    vmin: np.ndarray                    # f64[K]
    vmax: np.ndarray                    # f64[K]
    ewma: Dict[float, np.ndarray]       # halflife -> f64[K] (debiased)
    hist: np.ndarray                    # f64[C, B]
    hist_names: Tuple[str, ...]
    edges: np.ndarray                   # f64[B + 1] shared bin edges

    @classmethod
    def from_state(cls, state: SketchState,
                   cfg: SketchConfig) -> "SketchSummary":
        """Finalize one stream's state (no leading batch axes -- index a
        batched state down to one stream first)."""
        count = _np(state.count).astype(np.float64)
        if count.ndim != 0:
            raise ValueError(
                f"from_state finalizes ONE stream; this state has leading "
                f"batch shape {count.shape} -- slice it (see "
                f"summaries_from_state) or merge_summaries the slices")
        w = _np(state.ewma_w).astype(np.float64)
        raw = _np(state.ewma).astype(np.float64)
        ewma = {
            float(h): (raw[i] / w[i] if w[i] > 0 else np.zeros(raw.shape[1]))
            for i, h in enumerate(cfg.ewma_halflives)
        }
        bins = int(cfg.hist_bins)
        f64 = lambda a: _np(a).astype(np.float64)  # noqa: E731
        return cls(
            names=state.names, count=float(count), mean=f64(state.mean),
            m2=f64(state.m2), vmin=f64(state.vmin), vmax=f64(state.vmax),
            ewma=ewma, hist=f64(state.hist), hist_names=state.hist_names,
            edges=np.linspace(0.0, float(cfg.hist_max), bins + 1))

    # -- derived views ------------------------------------------------------

    def channel_index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise ValueError(
                f"unknown channel {name!r}; this sketch covers {self.names}")

    def variance(self) -> np.ndarray:
        """Population variance per channel (0 where count < 2)."""
        if self.count < 2:
            return np.zeros_like(self.mean)
        return self.m2 / self.count

    def stddev(self) -> np.ndarray:
        return np.sqrt(np.maximum(self.variance(), 0.0))

    def quantile(self, q: float, channel: Optional[str] = None) -> float:
        """Histogram quantile estimate (bin-center of the bin holding the
        q-th observation; exact to one bin width)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q!r}")
        if channel is None:
            if len(self.hist_names) != 1:
                raise ValueError(
                    f"pass channel= explicitly; this sketch histograms "
                    f"{self.hist_names}")
            channel = self.hist_names[0]
        if channel not in self.hist_names:
            raise ValueError(
                f"channel {channel!r} has no histogram; sketched: "
                f"{self.hist_names} (add it to SketchConfig.hist_channels)")
        counts = self.hist[self.hist_names.index(channel)]
        total = counts.sum()
        if total <= 0:
            return 0.0
        cum = np.cumsum(counts)
        k = int(np.searchsorted(cum, q * total, side="left"))
        k = min(k, len(counts) - 1)
        return float(0.5 * (self.edges[k] + self.edges[k + 1]))

    def as_dict(self, quantiles: Sequence[float] = (0.5, 0.9, 0.99)
                ) -> Dict[str, Any]:
        """JSON-ready nested dict."""
        std = self.stddev()
        out: Dict[str, Any] = {"count": self.count, "channels": {}}
        for i, nm in enumerate(self.names):
            row = {
                "mean": float(self.mean[i]),
                "std": float(std[i]),
                "min": float(self.vmin[i]) if self.count else 0.0,
                "max": float(self.vmax[i]) if self.count else 0.0,
            }
            for h, v in sorted(self.ewma.items()):
                row[f"ewma_h{h:g}"] = float(v[i])
            out["channels"][nm] = row
        for ch in self.hist_names:
            out["channels"][ch].update({
                f"p{int(round(q * 100)):02d}": self.quantile(q, ch)
                for q in quantiles
            })
        return out


def summaries_from_state(state: SketchState, cfg: SketchConfig
                         ) -> List[Tuple[Tuple[int, ...], SketchSummary]]:
    """Finalize every stream of a batched state (any leading shape on
    ``count``) -> ``[(index, summary), ...]`` in ``np.ndindex`` order."""
    host = SketchState(**{f.name: (_np(getattr(state, f.name))
                                   if f.name not in ("names", "hist_names")
                                   else getattr(state, f.name))
                          for f in dataclasses.fields(state)})
    lead = host.count.shape
    out = []
    for index in (np.ndindex(*lead) if lead else [()]):
        one = dataclasses.replace(host, **{
            f: getattr(host, f)[index]
            for f in ("count", "mean", "m2", "vmin", "vmax", "ewma",
                      "ewma_w", "hist")})
        out.append((index, SketchSummary.from_state(one, cfg)))
    return out


def merge_summaries(summaries: Sequence[SketchSummary]) -> SketchSummary:
    """Combine per-bucket/per-scenario summaries into one, as if a single
    sketch had seen every (valid) step: exact for count / mean / variance
    (Chan's parallel update), min / max and the histogram; the EWMA
    windows merge as the count-weighted mean."""
    ss = list(summaries)
    if not ss:
        raise ValueError("merge_summaries needs at least one summary")
    first = ss[0]
    for s in ss[1:]:
        if s.names != first.names or s.hist_names != first.hist_names:
            raise ValueError(
                f"cannot merge sketches over different channel sets: "
                f"{s.names} vs {first.names}")
        if s.edges.shape != first.edges.shape or not np.allclose(
                s.edges, first.edges):
            raise ValueError(
                "cannot merge sketches with different histogram edges "
                "(hist_max/hist_bins must match across the fleet)")
    count = 0.0
    mean = np.zeros_like(first.mean)
    m2 = np.zeros_like(first.m2)
    vmin = np.full_like(first.vmin, np.inf)
    vmax = np.full_like(first.vmax, -np.inf)
    hist = np.zeros_like(first.hist)
    ew_num = {h: np.zeros_like(v) for h, v in first.ewma.items()}
    for s in ss:
        if s.count > 0:
            delta = s.mean - mean
            tot = count + s.count
            m2 = m2 + s.m2 + delta * delta * (count * s.count / tot)
            mean = mean + delta * (s.count / tot)
            count = tot
            vmin = np.minimum(vmin, s.vmin)
            vmax = np.maximum(vmax, s.vmax)
        hist = hist + s.hist
        for h, v in s.ewma.items():
            ew_num[h] = ew_num[h] + v * s.count
    ewma = {h: (num / count if count > 0 else num)
            for h, num in ew_num.items()}
    return SketchSummary(names=first.names, count=count, mean=mean, m2=m2,
                         vmin=vmin, vmax=vmax, ewma=ewma, hist=hist,
                         hist_names=first.hist_names, edges=first.edges)


__all__ = [
    "SketchConfig",
    "SketchState",
    "SketchSummary",
    "merge_summaries",
    "sketch_init",
    "sketch_update",
    "summaries_from_state",
]
