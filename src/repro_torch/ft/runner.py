"""Step wall-time watchdog of the serving tier.

Port of `repro.ft.runner`'s `Watchdog`.  The training runner around it
(`run_training`, `run_with_restarts`, `FailureInjector`, checkpoint
resume) waits for the SNN training step (ROADMAP queue A item 11).
"""

from __future__ import annotations

from repro_torch.obs import metrics as obs_metrics


class Watchdog:
    """Flags steps slower than `straggler_factor` x the running median.

    Counters/histograms live on a `repro_torch.obs.metrics` registry (a
    private one by default): every observation lands in
    ``<prefix>.step_ms``, stragglers increment ``<prefix>.stragglers``.
    The registry is looked up per call, so an engine that clears its
    registry (warmup reset) keeps counting correctly.
    """

    def __init__(self, straggler_factor: float = 3.0,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 prefix: str = "ft"):
        self.times: list[float] = []
        self.factor = straggler_factor
        self.registry = registry or obs_metrics.MetricsRegistry()
        self.prefix = prefix

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        self.registry.histogram(f"{self.prefix}.step_ms").add(dt * 1e3)
        hist = sorted(self.times[-50:])
        median = hist[len(hist) // 2]
        is_straggler = len(self.times) > 5 and dt > self.factor * median
        if is_straggler:
            self.registry.counter(f"{self.prefix}.stragglers").inc()
        return is_straggler

    @property
    def stragglers(self) -> int:
        counter = self.registry.counters.get(f"{self.prefix}.stragglers")
        return int(counter.value) if counter is not None else 0


__all__ = ["Watchdog"]
