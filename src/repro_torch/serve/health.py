"""Per-lane health tracking and retry policy for the serving tier.

Port of `repro.serve.health` (pure Python; the port keeps its own copy).

Graceful degradation, not crash: when a tenant's lane faults (a
`ChaosInjector` lane event, or any caller-reported lane failure) the lane
walks a three-state machine —

    healthy ──fault──▶ degraded ──N consecutive faults──▶ quarantined
       ▲                  │  ▲                                │
       └───M successes────┘  └──────cooldown expires──────────┘

A *quarantined* lane is masked out of the shared ``run_batched`` (its
chunk rows are all-padding, so chunk shapes never change); its backlog
is retained and served once the lane recovers, so per-tenant accounting
still closes exactly.  After ``quarantine_rounds``
pumps the lane re-enters *degraded* on probation; the next successful
flush takes it back to *healthy* and records the episode's recovery time.

`RetryPolicy` bounds the engine's transient-fault retries (exponential
backoff, injectable sleep).  Both integrate with `repro_torch.obs.metrics`:
quarantine/recovery counters and a ``serve.recovery_ms`` histogram land
in the engine's registry and render through ``repro_torch.obs.report``.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable

from repro_torch.obs import metrics as obs_metrics


class LaneState(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    QUARANTINED = "quarantined"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient transfer/execute faults.

    max_retries:    retries after the first failure (0 = fail fast).
    backoff_base_s: sleep before the first retry.
    backoff_factor: multiplier applied per subsequent retry.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.01
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0:
            raise ValueError(f"backoff_base_s must be >= 0, got {self.backoff_base_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor must be >= 1, got {self.backoff_factor}")


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Thresholds of the lane health state machine.

    quarantine_after:  consecutive lane faults before quarantine.
    quarantine_rounds: pumps a quarantined lane sits out before probing.
    recover_after:     consecutive successful flushes (from degraded)
                       before the lane is healthy again.
    """

    quarantine_after: int = 3
    quarantine_rounds: int = 2
    recover_after: int = 1

    def __post_init__(self):
        for field in dataclasses.fields(self):
            if getattr(self, field.name) < 1:
                raise ValueError(
                    f"{field.name} must be >= 1, got {getattr(self, field.name)}"
                )


class HealthTracker:
    """The lane health state machine over every registered tenant."""

    def __init__(
        self,
        policy: HealthPolicy | None = None,
        registry: obs_metrics.MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or HealthPolicy()
        self.registry = registry or obs_metrics.MetricsRegistry()
        self.clock = clock
        self._states: dict = {}  # name -> LaneState
        self._fails: dict = {}  # name -> consecutive faults
        self._successes: dict = {}  # name -> consecutive successes (degraded)
        self._cooldown: dict = {}  # name -> pumps left in quarantine
        self._failed_at: dict = {}  # name -> episode start timestamp

    def add(self, name: str) -> None:
        self._states.setdefault(name, LaneState.HEALTHY)
        self._fails.setdefault(name, 0)
        self._successes.setdefault(name, 0)

    def remove(self, name: str) -> None:
        """Forget a deregistered lane (autoscale shrink path)."""
        for table in (self._states, self._fails, self._successes,
                      self._cooldown, self._failed_at):
            table.pop(name, None)

    def state(self, name: str) -> LaneState:
        return self._states[name]

    def usable(self, name: str) -> bool:
        """False while the lane must be masked out of the batched step."""
        return self._states[name] is not LaneState.QUARANTINED

    def quarantined(self) -> set:
        return {n for n, s in self._states.items() if s is LaneState.QUARANTINED}

    def snapshot(self) -> dict:
        """name -> state value, report-shaped."""
        return {n: s.value for n, s in sorted(self._states.items())}

    # ---- transitions ------------------------------------------------------

    def record_failure(self, name: str) -> LaneState:
        """One lane fault; returns the (possibly new) state."""
        self.add(name)
        self._fails[name] += 1
        self._successes[name] = 0
        if name not in self._failed_at:
            self._failed_at[name] = self.clock()
        state = self._states[name]
        if state is LaneState.HEALTHY:
            state = LaneState.DEGRADED
            self.registry.counter("serve.degraded").inc()
        if (
            state is LaneState.DEGRADED
            and self._fails[name] >= self.policy.quarantine_after
        ):
            state = LaneState.QUARANTINED
            self._cooldown[name] = self.policy.quarantine_rounds
            self.registry.counter("serve.quarantines").inc()
        self._states[name] = state
        return state

    def record_success(self, name: str) -> LaneState:
        """One successful served flush; may close a recovery episode."""
        self.add(name)
        state = self._states[name]
        if state is LaneState.QUARANTINED:
            return state  # masked lanes cannot really serve; ignore
        if state is LaneState.DEGRADED:
            self._successes[name] += 1
            if self._successes[name] >= self.policy.recover_after:
                state = LaneState.HEALTHY
                self._fails[name] = 0
                self._successes[name] = 0
                started = self._failed_at.pop(name, None)
                self.registry.counter("serve.recoveries").inc()
                if started is not None:
                    self.registry.histogram("serve.recovery_ms").add(
                        max(self.clock() - started, 0.0) * 1e3
                    )
        self._states[name] = state
        return state

    def advance(self) -> None:
        """One pump elapsed: age quarantine cooldowns; expired lanes probe."""
        for name in list(self._cooldown):
            self._cooldown[name] -= 1
            if self._cooldown[name] <= 0:
                del self._cooldown[name]
                self._states[name] = LaneState.DEGRADED
                self._fails[name] = 0
                self._successes[name] = 0
                self.registry.counter("serve.probes").inc()
