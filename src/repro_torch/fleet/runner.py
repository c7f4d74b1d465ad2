"""Fleet execution: shape-bucketed scenario runs on one card or several.

The mask contract (``active: bool[T, N]``, see ``core/pack.py`` and
``lagsim/engine.py``) makes padding exact: a padded partition is an
inactive one (packs to ``NEG``, produces no backlog, opens no bin) and a
padded step is sliced off the end of every trajectory.  This module turns
that into the execution layer of ``api.sweep`` / ``api.simulate``, field
for field and message for message the reference's ``repro.fleet.runner``:

* **Bucketing** -- scenarios of shape ``(T_i, N_i)`` are padded up to the
  next configured bucket ``(T_b, N_b)`` and grouped, so a fleet of
  thousands of ragged scenarios runs as a handful of batched calls, each
  a per-step loop over all of its scenarios at once.
* **Bounded run cache** -- one entry per (verb, policy tuple, bucket,
  mask, resolved config, batch, devices) key, kept in an LRU of
  ``max_compile_cache`` entries, with hit/miss/eviction counters global
  and per bucket (``FleetRunner.stats()``) equal to the reference's for
  the same calls.  The port compiles nothing per shape (its kernels are
  built once), so an entry holds only its bucket label, and every call
  runs ``sweep_streams`` / ``sweep_lag`` on its own arguments.  Where the
  reference spans its trace and compile on a miss (``fleet.trace_lower``,
  ``fleet.compile``), the port spans one ``fleet.build``, which has
  nothing to build.
* **Results stay on the card until read** -- a uniform batch's result
  fields are views of the batch on the device it ran on, copied to the
  host field by field on first read (``api.simulate`` reads three of
  the five trajectory fields, so the other two never leave the card).
* **Batch split** -- ``FleetConfig.devices``, a tuple of torch devices,
  splits each padded batch into equal contiguous chunks, one a device
  (all-inactive dummy scenarios fill the last); every scenario's loop is
  independent, so the split equals one device's result exactly.

A group is padded in a few batched operations, never one a scenario:
scenarios on the host are padded into one host array and copied to the
device once; scenarios on a device are gathered into the padded batch
with one indexed read for each storage they are views of (a fleet cut
from one big tensor on the card is one read).

Padding is exact for every deterministic policy (the 12 packers and both
reactive baselines): integers equal bit for bit, and lag within the
rounding of a longer sum.  The annealers draw over ``N``, so padding
changes their (still valid) trajectories.

``FleetLagResult``'s telemetry fields stay ``None`` until the port carries
the reference's in-loop telemetry (``LagSimConfig.telemetry`` raises
``NotPortedError``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from collections.abc import Sequence
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.pack import sweep_streams
from repro_torch.lagsim import LagSimConfig, slo_summary, sweep_lag
from repro_torch.telemetry.spans import instant as _instant
from repro_torch.telemetry.spans import span as _span


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Static knobs of a ``FleetRunner``.

    ``t_buckets`` / ``n_buckets``: ascending padded sizes; a scenario's
    ``T`` (``N``) is rounded up to the smallest bucket that holds it, or
    left exact when it exceeds every bucket (or when the tuple is empty
    -- the default, which never pads and buckets by exact shape).
    ``max_compile_cache``: LRU bound on live cache entries.
    ``shard``: split the batch axis across ``devices`` (``None``: the one
    device each verb resolves, the CUDA card unless it is given
    ``device="cpu"``); the batch is padded with all-inactive dummy
    scenarios up to a device multiple, then sliced back.
    """

    t_buckets: Tuple[int, ...] = ()
    n_buckets: Tuple[int, ...] = ()
    max_compile_cache: int = 16
    shard: bool = True
    devices: Optional[Tuple[Any, ...]] = None

    def __post_init__(self):
        if self.max_compile_cache < 1:
            raise ValueError(
                f"max_compile_cache must be >= 1, got {self.max_compile_cache}")
        for name in ("t_buckets", "n_buckets"):
            b = getattr(self, name)
            if tuple(sorted(b)) != tuple(b):
                raise ValueError(f"{name} must be ascending, got {b}")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class _BatchRows(Sequence):
    """The per-scenario rows ``[:, i]`` of one ``[A, B, T]`` result batch
    (a field of a uniform fleet's result).  The batch stays where it was
    made until a row or the whole batch is first read, then is copied to
    the host once."""

    def __init__(self, batch):
        self._batch = batch

    def host(self) -> np.ndarray:
        self._batch = _host(self._batch)
        return self._batch

    def __len__(self) -> int:
        return self._batch.shape[1]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(len(self))[i]]
        return self.host()[:, i]

    def __iter__(self):
        h = self.host()
        return (h[:, j] for j in range(h.shape[1]))


def _stack(rows) -> np.ndarray:
    """``[A, B, T]`` from per-scenario ``[A, T]`` rows: a uniform fleet's
    batch itself (no restack), else the rows stacked."""
    if isinstance(rows, _BatchRows):
        return rows.host()
    return np.stack(rows, axis=1)


@dataclasses.dataclass
class FleetSweepResult:
    """Per-scenario packing traces, in input order (arrays ``[A, T_i]``)."""

    algorithms: Tuple[str, ...]
    bins: List[np.ndarray]          # i32[A, T_i]
    rscores: List[np.ndarray]       # f32[A, T_i]
    migrations: List[np.ndarray]    # i32[A, T_i]

    def stacked(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stack a uniform-``T`` fleet into ``[A, B, T]`` arrays (the
        batch itself, not a copy, when one batch made the fleet)."""
        return (_stack(self.bins), _stack(self.rscores),
                _stack(self.migrations))


#: trajectory fields of ``FleetLagResult`` (the stackable [P, T_i] arrays)
_TRAJ_FIELDS = ("lag_total", "lag_max", "consumers", "migrations",
                "unreadable")
#: the fields an SLO summary reads
_SLO_FIELDS = ("lag_total", "consumers", "migrations")


@dataclasses.dataclass
class FleetLagResult:
    """Per-scenario closed-loop trajectories, in input order ([P, T_i])."""

    policies: Tuple[str, ...]
    lag_total: List[np.ndarray]     # f32[P, T_i]
    lag_max: List[np.ndarray]       # f32[P, T_i]
    consumers: List[np.ndarray]     # i32[P, T_i]
    migrations: List[np.ndarray]    # i32[P, T_i]
    unreadable: List[np.ndarray]    # i32[P, T_i]
    #: the reference's in-loop telemetry results (recorder frames, sketch
    #: states and configs, alert states and config); ``None`` until the
    #: port carries in-loop telemetry
    telemetry: Optional[List[Any]] = None
    sketch: Optional[List[Any]] = None
    sketch_configs: Optional[List[Any]] = None
    incidents: Optional[List[Any]] = None
    alert_config: Optional[Any] = None
    dt: float = 1.0

    def sketch_summaries(self, scenario: int):
        """Finalized sketch summaries of one scenario: this fleet run
        carried no sketches (the port has no in-loop telemetry yet)."""
        raise ValueError(
            "this fleet run carried no sketches; enable them via "
            "TelemetryConfig(sketch=SketchConfig(...))")

    def scenario_incidents(self, scenario: int):
        """Decoded incidents of one scenario: this fleet run carried no
        alerting (the port has no in-loop telemetry yet)."""
        raise ValueError(
            "this fleet run carried no alerting; enable it via "
            "TelemetryConfig(alerts=AlertConfig(rules=default_rules()))")

    def stacked(self, fields: Sequence[str] = _TRAJ_FIELDS
                ) -> Dict[str, np.ndarray]:
        """Stack a uniform-``T`` fleet into ``[P, B, T]`` arrays, one a
        name in ``fields`` (default all five; the batch itself, not a
        copy, when one batch made the fleet, and a field left out is not
        copied off the card)."""
        return {name: _stack(getattr(self, name)) for name in fields}

    def summarize(self, cfg: LagSimConfig,
                  stacked: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, np.ndarray]:
        """SLO summary of a uniform-``T`` fleet under ``cfg`` (arrays
        ``[P, B]``).  Pass a precomputed ``stacked()`` dict to avoid
        re-stacking."""
        st = (self.stacked(_SLO_FIELDS) if stacked is None else stacked)
        return slo_summary(st["lag_total"], st["consumers"],
                           st["migrations"],
                           slo_lag=cfg.slo_lag_or_default, dt=cfg.dt)


@dataclasses.dataclass
class FleetFitness:
    """One fitness-oracle evaluation (arrays ``[P, B]``: policy x
    scenario, in input order): ``fitness = violation_frac +
    incident_weight * incidents / T``."""

    policies: Tuple[str, ...]
    violation_frac: np.ndarray      # f32[P, B]
    incidents: np.ndarray           # f32[P, B] total incidents per stream
    fitness: np.ndarray             # f32[P, B]
    incident_weight: float = 0.0


@dataclasses.dataclass
class FleetProgress:
    """One live snapshot, handed to the ``progress`` callback of
    :meth:`FleetRunner.simulate` after each bucket group finishes.
    ``sketch`` stays ``None`` and ``incidents`` empty until the port
    carries in-loop telemetry."""

    done: int                           # scenarios finished so far
    total: int                          # scenarios in this call
    bucket: str                         # bucket label just finished
    sketch: Optional[Any] = None
    incidents: Dict[str, int] = dataclasses.field(default_factory=dict)


def _round_up(x: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if b >= x:
            return b
    return x


def _is_batch(scenarios) -> bool:
    return hasattr(scenarios, "ndim") and getattr(scenarios, "ndim") == 3


def _as(x, dtype):
    """``x`` as a tensor of ``dtype`` where it lies (a host array stays on
    the host; a device tensor is not moved)."""
    return torch.as_tensor(x).to(dtype)


def _inside(shapes, tb: int, nb: int, dev):
    """``bool[len(shapes), tb, nb]``, True on each ``(t, n)`` shape's
    top-left corner, and the step and partition iotas it compared."""
    tn = torch.tensor(shapes, dtype=torch.long).to(dev)
    t, n = tn[:, 0, None, None], tn[:, 1, None, None]
    r = torch.arange(tb, device=dev)[None, :, None]
    c = torch.arange(nb, device=dev)[None, None, :]
    return (r < t) & (c < n), r, c


def _gather_padded(xs: List[torch.Tensor], tb: int, nb: int
                   ) -> torch.Tensor:
    """``[len(xs), tb, nb]`` on ``xs``' device: each ``[t, n]`` view in
    its row's top-left corner, zero (False) elsewhere.  Every view must
    lie in one storage: the batch is one indexed read of it, whatever the
    number of views."""
    base = xs[0]
    dev = base.device
    storage = base.untyped_storage()
    flat = base.new_empty(0).set_(storage, 0,
                                  (storage.nbytes() // base.element_size(),),
                                  (1,))
    inside, r, c = _inside([tuple(x.shape) for x in xs], tb, nb, dev)
    geo = torch.tensor([[x.storage_offset(), x.stride(0), x.stride(1)]
                        for x in xs], dtype=torch.long).to(dev)
    off, s0, s1 = (g[:, None, None] for g in geo.T)
    idx = torch.where(inside, off + r * s0 + c * s1, 0)
    return torch.where(inside, flat[idx], torch.zeros((), dtype=base.dtype,
                                                      device=dev))


def _pad_stack(xs: List[Optional[torch.Tensor]], shapes, tb: int, nb: int,
               rows: int, dtype, dev) -> torch.Tensor:
    """``[rows, tb, nb]`` of ``dtype`` on ``dev``: ``xs[j]`` (shape
    ``shapes[j]``; ``None`` means all True) in row ``j``'s top-left
    corner, zero (False) elsewhere, rows past ``len(xs)`` all zero.  Host
    tensors are padded into one host batch and copied once; device
    tensors are gathered with one read a storage."""
    out = torch.zeros((rows, tb, nb), dtype=dtype, device=dev)
    ones, host, shared = [], [], {}
    for j, x in enumerate(xs):
        if x is None:
            ones.append(j)
        elif x.device.type == "cpu":
            host.append(j)
        else:
            key = (x.device, x.untyped_storage().data_ptr())
            shared.setdefault(key, []).append(j)
    if ones:
        out[ones] = _inside([shapes[j] for j in ones], tb, nb, dev)[0].to(
            dtype)
    if host:
        buf = torch.zeros((len(host), tb, nb), dtype=dtype)
        for k, j in enumerate(host):
            t, n = shapes[j]
            buf[k, :t, :n] = xs[j]
        out[host] = buf.to(dev)
    for rows_j in shared.values():
        out[rows_j] = _gather_padded([xs[j] for j in rows_j], tb,
                                     nb).to(device=dev, dtype=dtype)
    return out


class FleetRunner:
    """Bucketed, device-split executor for scenario fleets.

    One runner owns one bounded run cache; share it across calls (``api``
    keeps a module-level runner, ``default_fleet()``) so that repeated
    bucket shapes hit warm entries.  Each verb takes ``device=None`` (the
    CUDA card) when ``FleetConfig.devices`` is ``None``.
    """

    def __init__(self, config: FleetConfig = FleetConfig()):
        self.config = config
        # key -> bucket label; the label follows the entry so its
        # eviction is charged to the right bucket
        self._cache: "OrderedDict[Any, str]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._bucket_counts: Dict[Tuple[int, int], int] = {}
        self._per_bucket: Dict[str, Dict[str, int]] = {}
        self._dispatched: set = set()

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Snapshot: cache behaviour and scenarios executed per bucket.

        ``per_bucket`` breaks the global hit/miss/eviction counters down
        by padded bucket label (``"TxN"``); ``devices`` counts the
        configured devices (1 when each verb resolves its own).
        """
        return {
            "cache_entries": len(self._cache),
            "cache_hits": self._hits,
            "cache_misses": self._misses,
            "cache_evictions": self._evictions,
            "buckets": {f"{t}x{n}": c
                        for (t, n), c in sorted(self._bucket_counts.items())},
            "per_bucket": {b: dict(c)
                           for b, c in sorted(self._per_bucket.items())},
            "devices": (1 if self.config.devices is None
                        else len(self.config.devices)),
        }

    def reset(self) -> None:
        """Zero every counter (global and per-bucket) without dropping
        cache entries -- warm cache, fresh statistics.  Use before a
        measured region; ``clear()`` drops the entries too."""
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._bucket_counts.clear()
        self._per_bucket.clear()

    def clear(self) -> None:
        self._cache.clear()
        self._dispatched.clear()

    # -- internals ----------------------------------------------------------

    def _devices(self, device) -> Tuple[torch.device, ...]:
        """The devices a verb runs on: the configured tuple (``shard``
        off: its first), else the one ``device`` resolves to."""
        if self.config.devices is None:
            return (resolve_device(device),)
        devs = tuple(resolve_device(d) for d in self.config.devices)
        return devs if self.config.shard else devs[:1]

    def _bucket_stats(self, bucket: str) -> Dict[str, int]:
        return self._per_bucket.setdefault(
            bucket, {"hits": 0, "misses": 0, "evictions": 0})

    def _count(self, key: Any, bucket: str) -> None:
        """Count ``key``'s use as a cache hit, or as a miss (spanned
        ``fleet.build``, empty: the port has nothing to build a shape)
        that may evict the least recently used key past the bound."""
        if key in self._cache:
            self._hits += 1
            self._bucket_stats(bucket)["hits"] += 1
            _instant("fleet.cache_hit", bucket=bucket)
            self._cache.move_to_end(key)
            return
        self._misses += 1
        self._bucket_stats(bucket)["misses"] += 1
        _instant("fleet.cache_miss", bucket=bucket)
        with _span("fleet.build", bucket=bucket):
            pass
        while len(self._cache) >= self.config.max_compile_cache:
            _, gone = self._cache.popitem(last=False)
            self._evictions += 1
            self._bucket_stats(gone)["evictions"] += 1
            _instant("fleet.cache_evict", bucket=gone)
        self._cache[key] = bucket

    def _dispatch(self, key: Any, run: Callable, devices, speeds, act,
                  bucket: str) -> list:
        """``run(speeds, active, device)`` under a ``fleet.dispatch`` span
        (``first`` marks the key's first dispatch), one contiguous chunk
        of the batch a device.  One device: ``run``'s tensors as they
        are; several: each field's chunks joined on the host in order."""
        first = key not in self._dispatched
        self._dispatched.add(key)
        with _span("fleet.dispatch", bucket=bucket, first=first):
            size = speeds.shape[0] // len(devices)
            outs = []
            for i, dev in enumerate(devices):
                rows = slice(i * size, (i + 1) * size)
                outs.append(run(speeds[rows].to(dev),
                                None if act is None else act[rows].to(dev),
                                dev))
            if len(outs) == 1:
                return outs[0]
            return [np.concatenate([_host(o[f]) for o in outs], axis=1)
                    for f in range(len(outs[0]))]

    def _normalize(self, scenarios, active
                   ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """-> list of (speeds f32[T, N], active bool[T, N] | None), each
        where it lies (host or device)."""
        if _is_batch(scenarios):
            sp = _as(scenarios, torch.float32)
            if active is not None:
                ac = _as(active, torch.bool)
                if ac.shape != sp.shape:
                    raise ValueError(
                        f"active mask has shape {tuple(ac.shape)} but the "
                        f"scenario batch has shape {tuple(sp.shape)}")
                return [(sp[b], ac[b]) for b in range(sp.shape[0])]
            return [(sp[b], None) for b in range(sp.shape[0])]
        if active is not None:
            raise ValueError(
                "pass per-scenario masks as (speeds, active) pairs when "
                "scenarios is a sequence")
        items: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for s in scenarios:
            if isinstance(s, tuple):
                sp, ac = s
                sp = _as(sp, torch.float32)
                ac = None if ac is None else _as(ac, torch.bool)
                if ac is not None and ac.shape != sp.shape:
                    raise ValueError(
                        f"scenario mask shape {tuple(ac.shape)} != speeds "
                        f"shape {tuple(sp.shape)}")
            else:
                sp, ac = _as(s, torch.float32), None
            if sp.dim() != 2:
                raise ValueError(
                    f"each scenario must be f32[T, N]; got shape "
                    f"{tuple(sp.shape)}")
            items.append((sp, ac))
        return items

    def _group(self, items, extra_key=lambda sp, ac: ()):
        """Bucket scenarios: {(Tb, Nb, use_mask, *extra): [(idx, sp, ac)]}.

        ``use_mask`` is True as soon as any member needs padding or
        carries an explicit mask -- then every member gets one (all-True
        where absent), so the whole group runs as one masked batch.
        """
        groups: Dict[Any, List[Tuple[int, torch.Tensor,
                                     Optional[torch.Tensor]]]] = {}
        metas = []
        for idx, (sp, ac) in enumerate(items):
            t, n = sp.shape
            tb = _round_up(t, self.config.t_buckets)
            nb = _round_up(n, self.config.n_buckets)
            metas.append((idx, sp, ac, tb, nb))
        masked_buckets = {
            (tb, nb) for (_, sp, ac, tb, nb) in metas
            if ac is not None or (tb, nb) != tuple(sp.shape)
        }
        for idx, sp, ac, tb, nb in metas:
            use_mask = (tb, nb) in masked_buckets
            key = (tb, nb, use_mask) + tuple(extra_key(sp, ac))
            groups.setdefault(key, []).append((idx, sp, ac))
            self._bucket_counts[(tb, nb)] = (
                self._bucket_counts.get((tb, nb), 0) + 1)
        return groups

    def _pad_and_stack(self, members, tb: int, nb: int, use_mask: bool,
                       devices):
        """-> (speeds [Bp, tb, nb], active [Bp, tb, nb] | None) on the
        first device, ``Bp`` the member count rounded up to a multiple of
        the device count (the extra rows all-inactive dummies)."""
        dev = devices[0]
        rows = len(members) + (-len(members)) % len(devices)
        shapes = [tuple(sp.shape) for _, sp, _ in members]
        speeds = _pad_stack([sp for _, sp, _ in members], shapes, tb, nb,
                            rows, torch.float32, dev)
        active = None
        if use_mask:
            active = _pad_stack([ac for _, _, ac in members], shapes, tb, nb,
                                rows, torch.bool, dev)
        return speeds, active

    def _uniform_batch(self, scenarios, active, n_dev: int, dev):
        """Fast path: an already stacked ``f32[B, T, N]`` batch that needs
        no bucket padding and no batch padding (B a device multiple)
        passes straight through -- a tensor already on ``dev`` is used as
        it is, with no copy -- skipping the ragged path's unbatch, pad and
        restack.  This is the common case of ``api``."""
        if not _is_batch(scenarios):
            return None
        b, t, n = scenarios.shape
        if (_round_up(t, self.config.t_buckets) != t
                or _round_up(n, self.config.n_buckets) != n
                or b % n_dev):
            return None
        sp = torch.as_tensor(scenarios).to(device=dev, dtype=torch.float32)
        ac = None
        if active is not None:
            ac = torch.as_tensor(active).to(device=dev, dtype=torch.bool)
            if ac.shape != sp.shape:
                raise ValueError(
                    f"active mask has shape {tuple(ac.shape)} but the "
                    f"scenario batch has shape {tuple(sp.shape)}")
        self._bucket_counts[(t, n)] = self._bucket_counts.get((t, n), 0) + b
        return sp, ac

    # -- verbs --------------------------------------------------------------

    def _run_sweep(self, algorithms, speeds, act, capacity, tb: int,
                   nb: int, devices) -> list:
        """(bins, rscores, migrations) ``[A, Bp, tb]`` of one padded
        batch, where ``_dispatch`` leaves them."""
        key = ("sweep", algorithms, tb, nb, act is not None,
               speeds.shape[0], devices)
        bucket = f"{tb}x{nb}"
        self._count(key, bucket)

        def run(sp, ac, dev):
            res = sweep_streams(algorithms, sp, capacity, ac, device=dev)
            return [res.bins, res.rscores, res.migrations]

        return self._dispatch(key, run, devices, speeds, act, bucket)

    def sweep(self, algorithms: Sequence[str], scenarios, capacity: float = 1.0,
              *, active=None, device=None) -> FleetSweepResult:
        """Run every algorithm over a fleet of scenarios.

        ``scenarios``: f32[B, T, N] (optionally with ``active`` bool
        [B, T, N]) or a sequence of ``f32[T_i, N_i]`` / ``(speeds,
        active)`` entries of heterogeneous shape, as tensors (on the host
        or the device) or arrays.  Results come back sliced to each
        scenario's true ``(T_i,)`` length, in input order.
        """
        with _span("fleet.sweep", algorithms=len(algorithms)):
            return self._sweep(algorithms, scenarios, capacity, active,
                               device)

    def _sweep(self, algorithms, scenarios, capacity, active, device
               ) -> FleetSweepResult:
        algorithms = tuple(a.upper() for a in algorithms)
        devices = self._devices(device)
        fast = self._uniform_batch(scenarios, active, len(devices),
                                   devices[0])
        if fast is not None:
            speeds, act = fast
            b, t, n = speeds.shape
            bins, rs, migs = self._run_sweep(algorithms, speeds, act,
                                             capacity, t, n, devices)
            return FleetSweepResult(algorithms=algorithms,
                                    bins=_BatchRows(bins),
                                    rscores=_BatchRows(rs),
                                    migrations=_BatchRows(migs))
        items = self._normalize(scenarios, active)
        out_bins: List[Optional[np.ndarray]] = [None] * len(items)
        out_rs: List[Optional[np.ndarray]] = [None] * len(items)
        out_migs: List[Optional[np.ndarray]] = [None] * len(items)
        for (tb, nb, use_mask), members in self._group(items).items():
            speeds, act = self._pad_and_stack(members, tb, nb, use_mask,
                                              devices)
            bins, rs, migs = map(_host, self._run_sweep(
                algorithms, speeds, act, capacity, tb, nb, devices))
            for slot, (idx, sp, _) in enumerate(members):
                t = sp.shape[0]
                out_bins[idx] = bins[:, slot, :t]
                out_rs[idx] = rs[:, slot, :t]
                out_migs[idx] = migs[:, slot, :t]
        return FleetSweepResult(algorithms=algorithms, bins=out_bins,
                                rscores=out_rs, migrations=out_migs)

    def _run_sim(self, policies, speeds, act, rcfg, tb: int, nb: int,
                 devices) -> Dict[str, Any]:
        """The trajectory fields ``[P, Bp, tb]`` of one padded batch,
        where ``_dispatch`` leaves them."""
        key = ("simulate", policies, tb, nb, act is not None, rcfg,
               speeds.shape[0], devices)
        bucket = f"{tb}x{nb}"
        self._count(key, bucket)

        def run(sp, ac, dev):
            res = sweep_lag(policies, sp, rcfg, active=ac, device=dev)
            return [getattr(res, f) for f in _TRAJ_FIELDS]

        arrays = self._dispatch(key, run, devices, speeds, act, bucket)
        return dict(zip(_TRAJ_FIELDS, arrays))

    def simulate(self, policies: Sequence[str], scenarios,
                 cfg: LagSimConfig = LagSimConfig(), *,
                 active=None,
                 progress: Optional[Callable[[FleetProgress], None]] = None,
                 device=None) -> FleetLagResult:
        """Closed-loop lag twin over a fleet of scenarios (inputs as for
        :meth:`sweep`).

        The config is resolved at each scenario's *true* partition count
        (so e.g. the reactive ``max_consumers`` default clamps at the
        real N, not the padded bucket), which keeps padded runs exact.
        ``cfg.fused_steps`` / ``cfg.fused_kernel`` ride the same resolved
        config, so fused and per-step runs never share an entry; an
        N-padded bucket above ``FUSED_MAX_PARTITIONS`` runs the per-step
        loop, which is equally exact.

        ``progress`` (optional, host-side) is called after each bucket
        group with a :class:`FleetProgress` snapshot.
        """
        with _span("fleet.simulate", policies=len(policies)):
            return self._simulate(policies, scenarios, cfg, active, progress,
                                  device)

    def _simulate(self, policies, scenarios, cfg: LagSimConfig,
                  active, progress=None, device=None) -> FleetLagResult:
        policies = tuple(p.upper() for p in policies)
        devices = self._devices(device)
        fast = self._uniform_batch(scenarios, active, len(devices),
                                   devices[0])
        if fast is not None:
            speeds, act = fast
            b, t, n = speeds.shape
            arrays = self._run_sim(policies, speeds, act, cfg.resolve(n), t,
                                   n, devices)
            result = FleetLagResult(policies=policies, **{
                f: _BatchRows(arrays[f]) for f in _TRAJ_FIELDS}, dt=cfg.dt)
            if progress is not None:
                progress(FleetProgress(done=b, total=b, bucket=f"{t}x{n}"))
            return result
        items = self._normalize(scenarios, active)
        outs: Dict[str, List[Optional[np.ndarray]]] = {
            f: [None] * len(items) for f in _TRAJ_FIELDS}
        done = 0
        result = FleetLagResult(policies=policies, **outs, dt=cfg.dt)
        resolved: Dict[int, LagSimConfig] = {}

        def at_true_n(sp, ac):
            n = sp.shape[1]
            if n not in resolved:
                resolved[n] = cfg.resolve(n)
            return (resolved[n],)

        groups = self._group(items, extra_key=at_true_n)
        for (tb, nb, use_mask, rcfg), members in groups.items():
            speeds, act = self._pad_and_stack(members, tb, nb, use_mask,
                                              devices)
            arrays = {f: _host(x) for f, x in self._run_sim(
                policies, speeds, act, rcfg, tb, nb, devices).items()}
            for slot, (idx, sp, _) in enumerate(members):
                t = sp.shape[0]
                for f in _TRAJ_FIELDS:
                    outs[f][idx] = arrays[f][:, slot, :t]
            done += len(members)
            if progress is not None:
                progress(FleetProgress(done=done, total=len(items),
                                       bucket=f"{tb}x{nb}"))
        return result

    def fitness(self, policies: Sequence[str], scenarios,
                cfg: LagSimConfig = LagSimConfig(), *, active=None,
                incident_weight: float = 0.0, device=None) -> FleetFitness:
        """Fitness batch of a scenario search: one scenario batch ->
        per-(policy, scenario) SLO-violation fitness, arrays ``[P, B]``.
        Routes through :meth:`simulate`, so a search that keeps ``(B, T,
        N, cfg)`` constant across generations hits one warm cache entry.
        ``incident_weight > 0`` needs in-loop alerting, which the port
        does not carry yet: it raises the reference's ``ValueError``.
        """
        if incident_weight and getattr(cfg.telemetry, "alerts", None) is None:
            raise ValueError(
                "incident_weight > 0 needs alerting in the loop: pass a "
                "LagSimConfig with telemetry=TelemetryConfig(alerts="
                "AlertConfig(rules=default_rules()))")
        with _span("fleet.fitness", policies=len(policies)):
            res = self._simulate(tuple(p.upper() for p in policies),
                                 scenarios, cfg, active, device=device)
            summ = res.summarize(cfg)
            vf = np.asarray(summ["violation_frac"], np.float32)    # [P, B]
            # no incidents without in-loop alerting: fitness is the SLO's
            return FleetFitness(policies=res.policies, violation_frac=vf,
                                incidents=np.zeros_like(vf),
                                fitness=vf.copy(),
                                incident_weight=float(incident_weight))
