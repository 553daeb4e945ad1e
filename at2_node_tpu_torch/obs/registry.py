"""Typed metrics registry: counters, gauges, histograms.

Counterpart of ``at2_node_tpu/obs/registry.py`` (stdlib only). Three
instrument kinds:

* ``Counter``   — monotonic event count (``gossip_rx``, ``delivered``…)
* ``Gauge``     — point-in-time value, either set explicitly or read
                  through a callable at snapshot time (``slots_undelivered``)
* ``Histogram`` — log-bucketed latency distribution with exact
                  count/sum/max and estimated p50/p90/p99

All three are safe to bump from asyncio callbacks and from worker threads
(the verifier's prep/launch/finish stages): every mutation takes the
instrument's own ``threading.Lock``.

A ``Registry`` belongs to one component tree, not to the process: tests
run many nodes in one process, and a global registry would sum their
counters together. ``Broadcast`` creates a private registry when none is
passed. ``CounterGroup`` keeps the ``stats["key"] += 1`` call-site surface
of a stats dict while the storage lives on registry Counters.

The cross-process delta export of a histogram (``raw`` /
``merge_deltas``) comes with the process-mode plane shards.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Iterator, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "CounterGroup",
    "Registry",
    "DEFAULT_BOUNDS",
]

# Default histogram ladder: geometric, 100µs .. ~210s in ×2 steps.
# Covers everything this node times — sub-ms verifier stages up to
# multi-second catchup stalls — in 22 buckets (+1 overflow), cheap
# enough to keep one histogram per lifecycle stage always on.
DEFAULT_BOUNDS: tuple[float, ...] = tuple(1e-4 * 2.0**i for i in range(22))


class Counter:
    """Monotonic counter. ``set()`` exists only for the CounterGroup
    dict-compat path (``stats["k"] += 1`` desugars to a read+set); it
    still refuses to move backwards so the instrument stays monotonic."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    def set(self, value: int) -> None:
        with self._lock:
            if value < self._value:
                raise ValueError(
                    f"counter {self.name}: {value} < current {self._value}"
                )
            self._value = value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value. Either ``set()`` it, or construct with
    ``fn=`` and the registry reads it lazily at snapshot time (the idiom
    for values another object already owns, e.g. ``len(self._heap)``)."""

    __slots__ = ("name", "help", "_lock", "_value", "_fn")

    def __init__(
        self,
        name: str,
        help: str = "",
        fn: Callable[[], float] | None = None,
    ) -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        if self._fn is not None:
            raise RuntimeError(f"gauge {self.name} is callback-backed")
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                v = self._fn()
            except Exception:
                return 0.0
            # preserve int-ness: queue depths / commit counts read better
            # as integers in JSON snapshots than as 1.0
            return v if isinstance(v, (int, float)) else float(v)
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed latency histogram (values in SECONDS).

    count/sum/max are exact; percentiles are estimated as the upper
    bound of the bucket holding the target rank (clamped to the observed
    max), which for a ×2 ladder bounds the error at 2× — plenty to tell
    "100µs stage" from "10ms stage", which is what the operator view
    needs. Usable standalone (the verifier owns its stage histograms
    directly) or through ``Registry.histogram``.
    """

    __slots__ = ("name", "help", "bounds", "_lock", "_counts", "_sum",
                 "_count", "_max")

    def __init__(
        self,
        name: str,
        help: str = "",
        bounds: Sequence[float] | None = None,
    ) -> None:
        self.name = name
        self.help = help
        b = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram {name}: bounds must be increasing")
        self.bounds = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)  # last = overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, value: float) -> None:
        if value < 0 or math.isnan(value):
            return  # clock skew / bad input: never poison the histogram
        # bisect without importing: bounds are tiny (22), linear is fine
        # and avoids holding the lock during a function call
        idx = 0
        for bound in self.bounds:
            if value <= bound:
                break
            idx += 1
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value > self._max:
                self._max = value

    def _percentile_locked(self, q: float) -> float:
        """Caller holds the lock. Linear interpolation inside the bucket
        holding the target rank (Prometheus histogram_quantile's model),
        capped at the exact observed max — so p50 and p99 stay distinct
        even when they land in the same ×2 bucket."""
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self._max if i >= len(self.bounds) else min(
                    self.bounds[i], self._max
                )
                if hi <= lo:
                    return hi
                return lo + (hi - lo) * ((rank - prev_cum) / c)
        return self._max

    def snapshot(self) -> dict:
        """Exact count/sum/max + estimated percentiles, in milliseconds
        (the unit every stats() dict in this repo already reports)."""
        with self._lock:
            return {
                "count": self._count,
                "sum_ms": round(self._sum * 1e3, 3),
                "max_ms": round(self._max * 1e3, 3),
                "p50_ms": round(self._percentile_locked(0.50) * 1e3, 3),
                "p90_ms": round(self._percentile_locked(0.90) * 1e3, 3),
                "p99_ms": round(self._percentile_locked(0.99) * 1e3, 3),
            }

    def flat(self, prefix: str) -> dict:
        """snapshot() splayed into ``{prefix}_{key}`` form for merging
        into flat stats dicts (registry snapshots, verifier.stats)."""
        return {f"{prefix}_{k}": v for k, v in self.snapshot().items()}

    def buckets(self) -> tuple[list[tuple[float, int]], float, int]:
        """(cumulative (le, count) pairs incl +Inf, sum, count) — the
        exact shape Prometheus text exposition wants."""
        with self._lock:
            cum = 0
            out: list[tuple[float, int]] = []
            for bound, c in zip(self.bounds, self._counts):
                cum += c
                out.append((bound, cum))
            out.append((math.inf, self._count))
            return out, self._sum, self._count


class CounterGroup:
    """Dict-shaped facade over a fixed set of registry Counters.

    Keeps ``self.stats["delivered"] += 1`` call sites (and every test
    that reads ``stats["delivered"]``) working while the storage lives
    on registry Counters. The key set is fixed at construction: a typo'd
    key raises KeyError."""

    __slots__ = ("_counters",)

    def __init__(self, counters: dict[str, Counter]) -> None:
        self._counters = counters

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._counters[key].set(value)

    def __contains__(self, key: str) -> bool:
        return key in self._counters

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def keys(self):
        return self._counters.keys()

    def get(self, key: str, default=None):
        c = self._counters.get(key)
        return c.value if c is not None else default

    def items(self) -> Iterable[tuple[str, int]]:
        return [(k, c.value) for k, c in self._counters.items()]

    def as_dict(self) -> dict[str, int]:
        return dict(self.items())


def _sanitize(name: str) -> str:
    return "".join(
        ch if (ch.isalnum() or ch in "_:") else "_" for ch in name
    )


class Registry:
    """Ordered collection of instruments + lazy stat providers.

    Providers cover the components that already expose a ``stats()``
    dict and own their numbers (Mesh, the active Verifier): rather than
    double-count them into counters, the registry calls the provider at
    snapshot time and merges the result under a prefix.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._providers: list[tuple[str, Callable[[], dict]]] = []
        self._hist_providers: list[tuple[str, Callable[[], dict]]] = []

    # -- instrument construction (get-or-create, kind-checked) ----------

    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"instrument {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name, help))

    def gauge(
        self, name: str, help: str = "",
        fn: Callable[[], float] | None = None,
    ) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name, help, fn))

    def histogram(
        self, name: str, help: str = "",
        bounds: Sequence[float] | None = None,
    ) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(name, help, bounds)
        )

    def counter_group(
        self, names: Sequence[str], help: str = ""
    ) -> CounterGroup:
        return CounterGroup({n: self.counter(n, help) for n in names})

    def register_provider(
        self, prefix: str, fn: Callable[[], dict]
    ) -> None:
        with self._lock:
            self._providers.append((prefix, fn))

    def register_histogram_provider(
        self, prefix: str, fn: Callable[[], dict]
    ) -> None:
        """Expose EXTERNALLY-owned ``Histogram`` objects (``fn`` returns
        ``{suffix: Histogram}``) with the full Prometheus histogram
        convention — cumulative ``_bucket{le=...}`` series, ``_sum``,
        ``_count`` — instead of the spot-percentile gauges a plain stats
        provider would yield. The verifier's per-stage histograms are
        the motivating case: they are constructed by the verifier (which
        deliberately has no registry), yet external scrapers need real
        buckets to aggregate latency across nodes."""
        with self._lock:
            self._hist_providers.append((prefix, fn))

    # -- views -----------------------------------------------------------

    def snapshot(self) -> dict:
        """One flat dict: counters as ints, gauges as numbers,
        histograms splayed via flat(), providers merged under their
        prefix."""
        with self._lock:
            instruments = list(self._instruments.values())
            providers = list(self._providers)
            hist_providers = list(self._hist_providers)
        out: dict = {}
        for inst in instruments:
            if isinstance(inst, Histogram):
                out.update(inst.flat(inst.name))
            else:
                out[inst.name] = inst.value
        for prefix, fn in providers:
            try:
                extra = fn()
            except Exception:
                continue  # a dead provider must not take the snapshot down
            if extra:
                out.update({f"{prefix}{k}": v for k, v in extra.items()})
        for prefix, fn in hist_providers:
            try:
                hists = fn()
            except Exception:
                continue
            for suffix, h in sorted(hists.items()):
                out.update(h.flat(f"{prefix}{suffix}"))
        return out

    def render_prometheus(self, namespace: str = "at2") -> str:
        """Prometheus text exposition (version 0.0.4). Counters get the
        ``_total`` suffix, histograms the ``_seconds`` unit +
        bucket/sum/count triplet, provider values are exported as
        untyped gauges (they are point-in-time dict reads)."""
        with self._lock:
            instruments = list(self._instruments.values())
            providers = list(self._providers)
            hist_providers = list(self._hist_providers)
        lines: list[str] = []

        def emit_histogram(base: str, h: Histogram, help_text: str) -> None:
            fam = f"{base}_seconds"
            if help_text:
                lines.append(f"# HELP {fam} {help_text}")
            lines.append(f"# TYPE {fam} histogram")
            buckets, total, count = h.buckets()
            for bound, cum in buckets:
                le = "+Inf" if math.isinf(bound) else _fmt(bound)
                lines.append(f'{fam}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{fam}_sum {_fmt(total)}")
            lines.append(f"{fam}_count {count}")

        for inst in instruments:
            base = f"{namespace}_{_sanitize(inst.name)}"
            if isinstance(inst, Counter):
                fam = f"{base}_total"
                if inst.help:
                    lines.append(f"# HELP {fam} {inst.help}")
                lines.append(f"# TYPE {fam} counter")
                lines.append(f"{fam} {inst.value}")
            elif isinstance(inst, Gauge):
                if inst.help:
                    lines.append(f"# HELP {base} {inst.help}")
                lines.append(f"# TYPE {base} gauge")
                lines.append(f"{base} {_fmt(inst.value)}")
            else:
                emit_histogram(base, inst, inst.help)
        for prefix, fn in hist_providers:
            try:
                hists = fn()
            except Exception:
                continue
            for suffix, h in sorted(hists.items()):
                emit_histogram(
                    f"{namespace}_{_sanitize(prefix + suffix)}", h, h.help
                )
        for prefix, fn in providers:
            try:
                extra = fn()
            except Exception:
                continue
            for k, v in sorted(extra.items()):
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                name = f"{namespace}_{_sanitize(prefix + k)}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(v)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
