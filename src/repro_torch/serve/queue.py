"""Async ingest queue with size- or deadline-triggered micro-batching.

Port of `repro.serve.queue` (pure Python; the port keeps its own copy).

Tenants push tick frames (`submit`) from any thread; the engine polls
(`poll`) and receives either nothing - the batch is still filling and the
oldest request is inside its latency deadline - or every queued request at
once (a *flush*).  Two triggers end the filling phase:

  * **size**: at least ``flush_frames`` total tick frames are queued
    (enough work to fill the batched step), or
  * **deadline**: the oldest queued request has waited
    ``flush_deadline_s`` (tail-latency bound under trickle load).

``flush_deadline_s=0`` makes any non-empty queue ready - the synchronous
mode benchmarks use.  The clock is injectable so tests can drive the
deadline deterministically.

Robustness: `submit` validates frames up front - wrong
rank/shape, non-numeric dtype, and non-finite values raise a typed
`FrameValidationError` (also a ValueError) *before* anything reaches the
device; an optional ``max_pending_frames`` bound raises
`QueueOverflowError` instead of queueing unboundedly under backpressure.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable

from repro_torch.serve.admission import QueueOverflowError, validate_frames


@dataclasses.dataclass(frozen=True)
class TickRequest:
    """One tenant's submitted chunk of tick frames."""

    tenant: str
    frames: Any  # (T_i, cores, neurons_per_core) bool array
    enqueued_at: float

    @property
    def ticks(self) -> int:
        return int(self.frames.shape[0])


class IngestQueue:
    """Thread-safe FIFO of `TickRequest`s with micro-batch flush triggers."""

    def __init__(
        self,
        flush_frames: int = 64,
        flush_deadline_s: float = 0.005,
        clock: Callable[[], float] = time.monotonic,
        max_pending_frames: int | None = None,
        frame_shape: tuple | None = None,
    ):
        if flush_frames < 1:
            raise ValueError(f"flush_frames must be >= 1, got {flush_frames}")
        if flush_deadline_s < 0:
            raise ValueError(f"flush_deadline_s must be >= 0, got {flush_deadline_s}")
        if max_pending_frames is not None and max_pending_frames < 1:
            raise ValueError(
                f"max_pending_frames must be >= 1 or None, got {max_pending_frames}"
            )
        self.flush_frames = flush_frames
        self.flush_deadline_s = flush_deadline_s
        self.max_pending_frames = max_pending_frames
        self.frame_shape = tuple(frame_shape) if frame_shape is not None else None
        self.clock = clock
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque()
        self._frames = 0

    def submit(self, tenant: str, frames) -> TickRequest:
        """Enqueue one validated chunk of tick frames for a tenant.

        Raises `FrameValidationError` on malformed frames and
        `QueueOverflowError` when ``max_pending_frames`` would be
        exceeded - both *before* the request is queued or anything
        touches the device.
        """
        frames = validate_frames(frames, shape=self.frame_shape, tenant=tenant)
        req = TickRequest(tenant=tenant, frames=frames, enqueued_at=self.clock())
        with self._lock:
            if (
                self.max_pending_frames is not None
                and self._frames + req.ticks > self.max_pending_frames
            ):
                raise QueueOverflowError(
                    f"tenant {tenant!r} rejected: queue holds {self._frames} pending "
                    f"tick frames and {req.ticks} more would exceed "
                    f"max_pending_frames={self.max_pending_frames}"
                )
            self._items.append(req)
            self._frames += req.ticks
        return req

    def pending_by_tenant(self) -> dict:
        """tenant -> queued tick frames (accounting-closure bookkeeping)."""
        with self._lock:
            out: dict = {}
            for req in self._items:
                out[req.tenant] = out.get(req.tenant, 0) + req.ticks
            return out

    def depth(self) -> int:
        """Queued requests (the queue-depth metric the engine samples)."""
        with self._lock:
            return len(self._items)

    def pending_frames(self) -> int:
        """Total queued tick frames across all requests."""
        with self._lock:
            return self._frames

    def ready(self) -> bool:
        """True when a flush trigger (size or deadline) has fired."""
        with self._lock:
            return self._ready_locked()

    def _ready_locked(self) -> bool:
        if not self._items:
            return False
        if self._frames >= self.flush_frames:
            return True
        return self.clock() - self._items[0].enqueued_at >= self.flush_deadline_s

    def poll(self, force: bool = False) -> list:
        """All queued requests if a trigger fired (or ``force``), else []."""
        with self._lock:
            if not self._items or not (force or self._ready_locked()):
                return []
            out = list(self._items)
            self._items.clear()
            self._frames = 0
            return out

    def drain(self) -> list:
        """Unconditionally flush everything queued."""
        return self.poll(force=True)
