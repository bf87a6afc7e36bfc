"""Admission control: which tenants may enter, and onto which session.

Port of `repro.serve.admission` (pure Python and numpy; the port keeps
its own copy).

The engine's capacity axes are *groups* (each group owns one precompiled
`InterfaceSession` - compile time and device tables) and *lanes* (the
batched lane axis of that session's ``run_batched`` - device memory and
per-flush compute).  `AdmissionController` enforces both, plus a
per-request frame bound so one tenant cannot monopolize a flush, an
optional per-group pending-frame bound (queue overflow backpressure), and
an optional request deadline past which the engine sheds queued work.

Everything here raises *typed* errors before any device work happens:

    ServeError (RuntimeError)
    ├── AdmissionError            capacity exceeded at register/submit
    │   ├── QueueOverflowError    per-group pending-frame bound hit
    │   ├── DeadlineExceededError queued request aged past the shed
    │   │                         deadline (raised per shed, surfaced via
    │   │                         `ServeEngine.shed_errors()`)
    │   └── RateLimitedError      the tenant's token bucket is empty
    │                             (per-tenant ingress rate bound)
    └── FrameValidationError      malformed frames (also a ValueError,
                                  so legacy shape-mismatch handlers keep
                                  working)

Rate limiting (serving tier v2): ``AdmissionPolicy.rate_limit_per_s``
bounds each tenant's *sustained* ingress in tick frames per second via a
classic token bucket - the bucket refills continuously at the rate and
caps at ``rate_limit_burst`` tokens, so short bursts up to the burst size are
admitted instantly while the long-run average can never exceed the rate.
An empty bucket raises `RateLimitedError` *before* anything is queued, so
rate-limited work never enters the accounting identity.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Mapping

import numpy as np

from repro_torch.serve.tenant import TenantSpec, compat_key


class ServeError(RuntimeError):
    """Base of every typed serving-tier error."""


class AdmissionError(ServeError):
    """A tenant or request exceeds the configured serving capacity."""


class QueueOverflowError(AdmissionError):
    """A group's pending-frame bound is exhausted (backpressure signal)."""


class DeadlineExceededError(AdmissionError):
    """A queued request aged past the shed deadline and was dropped."""


class RateLimitedError(AdmissionError):
    """The tenant's token bucket is empty (ingress rate bound hit)."""


class FrameValidationError(ServeError, ValueError):
    """Submitted frames are malformed (shape/dtype/non-finite values)."""


def validate_frames(frames, shape: tuple | None = None, tenant: str = "?") -> np.ndarray:
    """Validate one submitted frame chunk before any device work.

    Rejects wrong rank, empty streams, wrong (cores, neurons) shape when
    ``shape`` is known, non-numeric dtypes, and non-finite float values
    (a NaN silently casts to True under ``astype(bool)``, which would
    poison the fabric inside the batched step where nothing can
    diagnose it).  Returns the frames as a host bool array.
    """
    arr = np.asarray(frames)
    if arr.dtype.kind not in "biuf":
        raise FrameValidationError(
            f"tenant {tenant!r}: frames dtype {arr.dtype} is not a bool/int/float "
            f"spike raster"
        )
    if arr.ndim != 3 or arr.shape[0] < 1:
        raise FrameValidationError(
            f"frames must be (ticks >= 1, cores, neurons_per_core), got shape {arr.shape}"
        )
    if shape is not None and arr.shape[1:] != tuple(shape):
        raise FrameValidationError(
            f"tenant {tenant!r}: frames shaped {arr.shape} do not match the group "
            f"fabric (ticks, {shape[0]}, {shape[1]})"
        )
    if arr.dtype.kind == "f" and not np.isfinite(arr).all():
        raise FrameValidationError(
            f"tenant {tenant!r}: frames contain non-finite values (NaN/Inf); "
            f"a NaN casts to True and would silently poison the fabric"
        )
    return arr.astype(bool)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Static capacity limits of one engine.

    max_tenants_per_group:  lanes per shared session (the batched lane
                            axis of the group's session).
    max_groups:             distinct (config, connectivity) sessions the
                            engine will precompile.
    max_frames_per_request: largest single `submit` chunk, in tick frames.
    max_pending_frames:     per-group bound on queued + backlogged tick
                            frames; `submit` raises `QueueOverflowError`
                            beyond it (None = unbounded, the legacy
                            behavior).
    shed_deadline_s:        max age of a queued request at flush time;
                            older requests are shed with
                            `DeadlineExceededError` instead of served
                            (None = never shed).
    rate_limit_per_s:       per-tenant sustained ingress bound in tick
                            frames per second; an empty token bucket
                            raises `RateLimitedError` at submit (None =
                            unlimited).
    rate_limit_burst:       token-bucket capacity - the largest burst a
                            full bucket admits at once (defaults to one
                            second's worth, i.e. ``rate_limit_per_s``).
    """

    max_tenants_per_group: int = 32
    max_groups: int = 4
    max_frames_per_request: int = 4096
    max_pending_frames: int | None = None
    shed_deadline_s: float | None = None
    rate_limit_per_s: float | None = None
    rate_limit_burst: float | None = None

    def __post_init__(self):
        for name in ("max_tenants_per_group", "max_groups", "max_frames_per_request"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.max_pending_frames is not None and self.max_pending_frames < 1:
            raise ValueError(
                f"max_pending_frames must be >= 1 or None, got {self.max_pending_frames}"
            )
        if self.shed_deadline_s is not None and self.shed_deadline_s < 0:
            raise ValueError(
                f"shed_deadline_s must be >= 0 or None, got {self.shed_deadline_s}"
            )
        if self.rate_limit_per_s is not None and self.rate_limit_per_s <= 0:
            raise ValueError(
                f"rate_limit_per_s must be > 0 or None, got {self.rate_limit_per_s}"
            )
        if self.rate_limit_burst is not None:
            if self.rate_limit_per_s is None:
                raise ValueError("rate_limit_burst is only meaningful with rate_limit_per_s")
            if self.rate_limit_burst < 1:
                raise ValueError(
                    f"rate_limit_burst must be >= 1 or None, got {self.rate_limit_burst}"
                )

    @property
    def burst(self) -> float | None:
        """Effective bucket capacity (burst, or one second's worth)."""
        if self.rate_limit_per_s is None:
            return None
        return self.rate_limit_burst or self.rate_limit_per_s


class TokenBucket:
    """One tenant's ingress token bucket (thread-safe).

    Starts full; refills continuously at ``rate`` tokens/sec up to
    ``capacity``.  `take` is all-or-nothing: a request either fits the
    current balance or is rejected whole - partial admission would split
    a validated frame stream.
    """

    def __init__(self, rate: float, capacity: float, clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or capacity <= 0:
            raise ValueError(f"need rate > 0 and capacity > 0, got {rate}, {capacity}")
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.clock = clock
        self._tokens = self.capacity
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        elapsed = max(now - self._last, 0.0)
        self._tokens = min(self.capacity, self._tokens + elapsed * self.rate)
        self._last = now

    def take(self, n: float) -> bool:
        """Admit ``n`` tokens if the refilled balance covers them."""
        with self._lock:
            self._refill_locked(self.clock())
            if n > self._tokens:
                return False
            self._tokens -= n
            return True

    def tokens(self) -> float:
        """Current (refilled) balance - diagnostics only."""
        with self._lock:
            self._refill_locked(self.clock())
            return self._tokens


class AdmissionController:
    """Capacity checks over the engine's group occupancy, plus the
    per-tenant rate-limit buckets (the only stateful part, and only when
    the policy sets ``rate_limit_per_s``)."""

    def __init__(
        self,
        policy: AdmissionPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or AdmissionPolicy()
        self.clock = clock
        self._buckets: dict = {}  # tenant name -> TokenBucket
        self._buckets_lock = threading.Lock()

    def rate_bucket(self, tenant: str) -> TokenBucket | None:
        """The tenant's token bucket (created full on first use), or None
        when the policy sets no rate limit."""
        if self.policy.rate_limit_per_s is None:
            return None
        with self._buckets_lock:
            if tenant not in self._buckets:
                self._buckets[tenant] = TokenBucket(
                    self.policy.rate_limit_per_s, self.policy.burst, clock=self.clock
                )
            return self._buckets[tenant]

    def check_rate(self, tenant: str, ticks: int) -> None:
        """Charge ``ticks`` against the tenant's bucket; typed rejection.

        Raises `RateLimitedError` when the bucket cannot cover the
        request - *before* anything is queued, so rate-limited work never
        enters the accounting ledger.
        """
        bucket = self.rate_bucket(tenant)
        if bucket is None or bucket.take(ticks):
            return
        if ticks > bucket.capacity:
            raise RateLimitedError(
                f"tenant {tenant!r} submitted {ticks} tick frames but the rate-limit "
                f"burst is {bucket.capacity:g}; a request larger than the burst can "
                f"never be admitted - split the stream or raise rate_limit_burst"
            )
        raise RateLimitedError(
            f"tenant {tenant!r} rate-limited: {ticks} tick frames exceed the current "
            f"token balance ({bucket.tokens():.1f} of {bucket.capacity:g}; refill "
            f"{bucket.rate:g}/s) - back off and retry"
        )

    def admit(self, spec: TenantSpec, occupancy: Mapping[tuple, int]) -> tuple:
        """Validate `spec` against current occupancy; return its group key.

        occupancy: group key -> current tenant count.  Raises
        `AdmissionError` when the target group is full, or when the spec
        needs a new group and the group budget is spent.
        """
        key = compat_key(spec)
        if key in occupancy:
            if occupancy[key] >= self.policy.max_tenants_per_group:
                raise AdmissionError(
                    f"tenant {spec.name!r} rejected: group for {spec.scenario!r}-compatible "
                    f"config is at capacity ({self.policy.max_tenants_per_group} lanes)"
                )
        elif len(occupancy) >= self.policy.max_groups:
            raise AdmissionError(
                f"tenant {spec.name!r} rejected: would need a new session group but the "
                f"engine already serves {len(occupancy)} "
                f"(max_groups={self.policy.max_groups}); reuse an existing "
                f"(config, connectivity_seed) to share a session"
            )
        return key

    def validate_request(self, tenant: str, ticks: int, pending_frames: int | None = None) -> None:
        """Bound one submit chunk (called before the queue accepts it).

        pending_frames: the target group's queued + backlogged tick
        frames; when given and `max_pending_frames` is set, a request
        that would overflow the bound raises `QueueOverflowError`.
        """
        if ticks > self.policy.max_frames_per_request:
            raise AdmissionError(
                f"tenant {tenant!r} submitted {ticks} tick frames in one request "
                f"(max_frames_per_request={self.policy.max_frames_per_request}); "
                f"split the stream into smaller chunks"
            )
        cap = self.policy.max_pending_frames
        if cap is not None and pending_frames is not None and pending_frames + ticks > cap:
            raise QueueOverflowError(
                f"tenant {tenant!r} rejected: group already holds {pending_frames} "
                f"pending tick frames and {ticks} more would exceed "
                f"max_pending_frames={cap}; pump the engine (or wait) and retry"
            )
