"""Counters, streaming percentile histograms, and a JSONL metrics sink.

The port's own copy of `repro.obs.metrics` (pure Python, no torch), so
that `repro_torch` imports nothing of the JAX package.

The perf story of this repo is tail-sensitive - a p99 tick-latency
regression with an unchanged mean is exactly the failure mode the paper's
arbiter comparison is about - so the benchmark layer records *streaming*
percentiles, not just best-of-N minima:

    hist = Histogram()
    for t in tick_wall_clocks_ms:
        hist.add(t)
    hist.summary()          # {"count", "mean", "min", "max", "p50", ...}

`Histogram` is a fixed-memory log-bucketed histogram (`bins_per_decade`
geometric buckets per decade over ``[lo, hi)``, out-of-range values
clamped into the edge buckets): adds are O(1), percentile queries
interpolate geometrically inside the winning bucket, and the relative
quantile error is bounded by one bucket width (~``10**(1/bins_per_decade)``,
<2% at the default 64/decade).  Exact percentiles over a small retained
sample are available as the module-level `percentiles` helper (used where
the sample is only repeat-count sized anyway).

`JsonlSink` appends one JSON object per line - the format
``python -m repro_torch.obs.report`` and external log shippers both consume.
"""

from __future__ import annotations

import json
import math
import threading


def percentiles(values, qs=(50, 95, 99)) -> dict:
    """Exact linear-interpolated percentiles of a small in-memory sample."""
    if not values:
        raise ValueError("percentiles of an empty sample are undefined")
    ordered = sorted(float(v) for v in values)
    n = len(ordered)
    out = {}
    for q in qs:
        if not 0 <= q <= 100:
            raise ValueError(f"percentile {q} outside [0, 100]")
        pos = (n - 1) * q / 100.0
        lo = math.floor(pos)
        hi = min(lo + 1, n - 1)
        out[f"p{q:g}"] = ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)
    return out


class Counter:
    """A named monotonic counter (thread-safe: the serving tier's pump
    thread and submitter threads increment concurrently)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-memory streaming histogram with geometric buckets.

    Values are expected positive (wall clocks, energies); values at or
    below zero land in the lowest bucket so `add` never raises mid-run.
    Non-finite values (NaN/±Inf) are counted in ``nonfinite`` and
    otherwise ignored - they enter no bucket and cannot poison
    ``min``/``max``/``mean``, so one bad measured duration never kills
    the serve path or skews its percentiles.
    """

    def __init__(
        self, name: str = "", lo: float = 1e-6, hi: float = 1e6, bins_per_decade: int = 64
    ):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.name = name
        self.lo = lo
        self.hi = hi
        self.bins_per_decade = bins_per_decade
        self._log_lo = math.log10(lo)
        self._nbins = max(1, math.ceil((math.log10(hi) - self._log_lo) * bins_per_decade))
        self._counts = [0] * self._nbins
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.nonfinite = 0
        self._lock = threading.Lock()

    def _bin(self, value: float) -> int:
        if value <= self.lo:
            return 0
        i = int((math.log10(value) - self._log_lo) * self.bins_per_decade)
        return min(i, self._nbins - 1)

    def _bin_edges(self, i: int) -> tuple:
        lo = 10.0 ** (self._log_lo + i / self.bins_per_decade)
        hi = 10.0 ** (self._log_lo + (i + 1) / self.bins_per_decade)
        return lo, hi

    def add(self, value: float) -> None:
        value = float(value)
        with self._lock:
            if not math.isfinite(value):
                self.nonfinite += 1
                return
            self._counts[self._bin(value)] += 1
            self.count += 1
            self.total += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        if self.count == 0:
            raise ValueError(f"histogram {self.name!r} is empty")
        return self.total / self.count

    def percentile(self, q: float) -> float:
        """Geometric interpolation inside the winning bucket; clamped to
        the observed [min, max] so tiny samples stay exact-ish."""
        if self.count == 0:
            raise ValueError(f"histogram {self.name!r} is empty")
        if not 0 <= q <= 100:
            raise ValueError(f"percentile {q} outside [0, 100]")
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo, hi = self._bin_edges(i)
                frac = (target - seen) / c
                value = lo * (hi / lo) ** frac
                return min(max(value, self.min), self.max)
            seen += c
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """New histogram equivalent to pooling both samples.

        Requires identical bucketing: merging is exact at the bucket
        level, so pooled percentiles match a histogram fed the combined
        sample stream (within the usual one-bucket resolution).  The
        serving tier uses this to roll per-tenant latency histograms into
        fleet-wide percentiles without retaining samples.
        """
        shape = (self.lo, self.hi, self.bins_per_decade)
        if shape != (other.lo, other.hi, other.bins_per_decade):
            raise ValueError(
                f"cannot merge histograms with different bucketing: "
                f"{shape} vs {(other.lo, other.hi, other.bins_per_decade)}"
            )
        out = Histogram(
            self.name or other.name, lo=self.lo, hi=self.hi, bins_per_decade=self.bins_per_decade
        )
        out._counts = [a + b for a, b in zip(self._counts, other._counts)]
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        out.nonfinite = self.nonfinite + other.nonfinite
        return out

    def summary(self, qs=(50, 95, 99)) -> dict:
        out = {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
        }
        for q in qs:
            out[f"p{q:g}"] = self.percentile(q)
        if self.nonfinite:
            out["nonfinite"] = self.nonfinite
        return out


class MetricsRegistry:
    """Get-or-create registry of counters and histograms.

    Get-or-create is locked: the serving tier's submit and pump threads
    may race to create the same metric, and both must get one object.
    """

    def __init__(self):
        self.counters: dict = {}
        self.histograms: dict = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self.counters:
                self.counters[name] = Counter(name)
            return self.counters[name]

    def histogram(self, name: str, **kwargs) -> Histogram:
        with self._lock:
            if name not in self.histograms:
                self.histograms[name] = Histogram(name, **kwargs)
            return self.histograms[name]

    def snapshot(self) -> dict:
        """Plain-dict view of every metric (JSONL-ready)."""
        out = {name: c.value for name, c in self.counters.items()}
        for name, h in self.histograms.items():
            if h.count:
                out[name] = h.summary()
        return out


class JsonlSink:
    """Append-one-JSON-object-per-line sink (the report CLI's input)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, record: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        json.dump(record, self._f)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["percentiles", "Counter", "Histogram", "MetricsRegistry", "JsonlSink"]
