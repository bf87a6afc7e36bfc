"""`repro_torch.serve.engine`: multi-tenant streaming over the interface fabric.

Port of `repro.serve.engine`, on the port's sessions.  Many independent
tenants - each an `InterfaceConfig` plus a `repro_torch.traffic` tick
stream (`TenantSpec`) - are served concurrently through precompiled
`InterfaceSession`s instead of one offline ``session.run`` at a time.
The moving parts:

  admission   `AdmissionController` bounds groups/lanes/request size and
              assigns each tenant a session-compatibility key; frames are
              validated (shape/dtype/finite) before any device work.
  grouping    tenants sharing (config, connectivity, fault, shard) become
              *lanes* of a `TenantGroup`, which owns one precompiled
              session; the
              whole group steps as one masked ``run_batched`` call over
              the lane axis (under ``impl="pallas_sparse"`` one B1
              `sparse_run` launch a flush, under ``impl="pallas"`` one B3
              `hat_run` and ``flush_ticks`` B2 launches a flush).
  queueing    per-group `IngestQueue` with size-/deadline-triggered
              micro-batching (`repro_torch.serve.queue`).
  batching    flushed requests pack into fixed-shape (lanes, flush_ticks)
              chunks - ragged/short streams right-padded with an explicit
              mask, so every lane stays *bit-identical* to its solo
              ``session.run`` (currents and stats; the per-lane
              accumulator is the seed ``stats0`` of the next chunk).
  transfer    a chunk's frames and mask are copied to the serving device
              on the compute stream (chunk t+1's copy is issued after
              chunk t's step is launched, before it is waited on).  On the
              CPU the chunk is used where it lies.
  metrics     per-tenant `repro_torch.obs.metrics` histograms/counters
              (events/sec, tick-latency p50/p99, queue depth), fleet-wide
              percentiles via `Histogram.merge`, JSONL sink + records
              shaped for ``python -m repro_torch.obs.report``.

Graceful degradation, as in the JAX engine:

  faults      an optional `repro_torch.ft.chaos.ChaosInjector` fires a
              seeded `FaultPlan` at configured pump rounds, and tenants may
              compile a fabric-level `repro_torch.ft.faults.FaultModel`
              into their session (``TenantSpec.fault``); each lane keeps
              its fault stream's global tick offset across chunks.
  retries     transient transfer/execute faults retry under a bounded
              exponential-backoff `RetryPolicy`; the per-lane accumulator
              commits only after a successful step, so a replayed chunk
              can never double-count (the step's result is a fresh tensor;
              the seed it read is untouched), and `RetriesExhaustedError`
              restages unserved work back onto the backlog first - the
              accounting identity submitted == served + shed + pending
              holds through every failure.  Faults fire before the step's
              first launch, so a launch is never abandoned halfway.
  health      a per-lane `HealthTracker` walks healthy -> degraded ->
              quarantined; quarantined lanes are masked out of the shared
              batched step (mask rows, not shapes) and probe back in after
              a cooldown.
  shedding    queued requests older than ``AdmissionPolicy.shed_deadline_s``
              are dropped at flush time as typed `DeadlineExceededError`s
              (`shed_errors()`), and `QueueOverflowError` bounds pending
              work at submit time.
  watchdog    the `repro_torch.ft.runner.Watchdog` observes per-flush wall
              time on the engine registry (``serve.flush_ms`` /
              ``serve.stragglers``).

Minimal use:

    from repro_torch.serve import ServeEngine, TenantSpec

    engine = ServeEngine(flush_ticks=16)          # on the card by default
    engine.register(TenantSpec("t0", cfg, scenario="sparse_poisson"))
    engine.register(TenantSpec("t1", cfg, scenario="hotspot_core"))
    engine.submit_scenario("t0", ticks=64)   # or engine.submit(name, frames)
    engine.submit_scenario("t1", ticks=48)
    engine.drain()
    records = engine.serve_report()

Concurrency and scale:

  async pump  `start()`/`stop()` run the pump on background thread(s),
              draining the thread-safe `IngestQueue` off the caller's
              thread.  A pump thread launches on its default CUDA stream,
              as the caller's does: B1's whole-run launches share a
              finished-items counter per plan and must follow one another
              on one stream, and pump rounds are serialized under
              ``_pump_mutex``.  Shutdown is clean (signal + join), fatal
              pump errors surface on the next `submit`/`stop`, and
              `accounting()` serializes against the pump.
  autoscale   groups own a *capacity* (the padded lane axis) grown and
              shrunk by `AutoscalePolicy`; resizes preserve every
              occupied lane's `StepStats` accumulator row exactly, and the
              chunk shapes a group steps (`TenantGroup.jit_cache_entries`)
              stay bounded by the set of capacities seen.  `deregister`
              frees a lane with swap-with-last compaction.
  rate limit  `AdmissionPolicy.rate_limit_per_s` token buckets bound
              each tenant's ingress; rejected submits raise the typed
              `RateLimitedError` before anything is queued and count in
              ``serve.rate_limited`` / ``serve.rate_limited_ticks``.

  sharding    tenants with ``TenantSpec(shard="chips")`` land in groups
              whose masked batched step runs the session's per-chip
              sharded tick (one device: the chips axis is a batch axis).

The LM serving loop is `repro_torch.serve.lm_engine`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.ft.chaos import RetriesExhaustedError, TransientFaultError
from repro_torch.ft.runner import Watchdog
from repro_torch.interface.session import Interface
from repro_torch.interface.stats import StepStats
from repro_torch.interface.types import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
    DeadlineExceededError,
    RateLimitedError,
    ServeError,
    validate_frames,
)
from repro_torch.serve.health import HealthPolicy, HealthTracker, RetryPolicy
from repro_torch.serve.queue import IngestQueue
from repro_torch.serve.tenant import TenantSpec, default_connectivity
from repro_torch.serve.tenant import compat_key as _compat_key


@dataclasses.dataclass
class _Chunk:
    """One fixed-shape batched step: left-aligned frames plus lane mask."""

    spikes: np.ndarray  # (capacity, flush_ticks, cores, neurons_per_core) bool
    mask: np.ndarray  # (capacity, flush_ticks) bool
    took: np.ndarray  # (capacity,) int: live ticks packed into each lane


@dataclasses.dataclass
class _Staged:
    """Backlogged frames plus the submit timestamp their deadline ages from."""

    frames: np.ndarray  # (T_i, cores, neurons_per_core) bool
    enqueued_at: float


class _OnDevice(NamedTuple):
    """A chunk's frames and mask on the serving device."""

    spikes: torch.Tensor  # (capacity, flush_ticks, cores, neurons_per_core)
    mask: torch.Tensor  # (capacity, flush_ticks) bool


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """How a group's lane *capacity* tracks its tenant occupancy.

    Capacity is the padded lane axis of the batched step: chunks are
    shaped ``(capacity, flush_ticks, ...)`` with free lanes all-masked,
    so each distinct capacity is one chunk shape.

    min_lanes:    capacity floor (headroom for tenants yet to arrive).
    grow_factor:  1.0 (default) is exact fit - capacity ==
                  max(occupancy, min_lanes), zero padded compute.
                  > 1.0 grows geometrically (fewer resizes under churn,
                  padded lanes as the cost) and shrinks by the same
                  factor.
    shrink_at:    utilization at or below which a grown capacity steps
                  back down (hysteresis; only meaningful with
                  ``grow_factor > 1``).
    """

    min_lanes: int = 1
    grow_factor: float = 1.0
    shrink_at: float = 0.5

    def __post_init__(self):
        if self.min_lanes < 1:
            raise ValueError(f"min_lanes must be >= 1, got {self.min_lanes}")
        if self.grow_factor < 1.0:
            raise ValueError(f"grow_factor must be >= 1, got {self.grow_factor}")
        if not 0.0 < self.shrink_at <= 1.0:
            raise ValueError(f"shrink_at must be in (0, 1], got {self.shrink_at}")

    def target(self, occupancy: int, capacity: int) -> int:
        """The capacity this policy wants for ``occupancy`` tenants."""
        floor = max(self.min_lanes, occupancy, 1)
        if self.grow_factor <= 1.0:
            return floor
        cap = max(capacity, 1)
        while cap < occupancy:
            cap = max(cap + 1, math.ceil(cap * self.grow_factor))
        while cap > floor:
            if occupancy > cap * self.shrink_at:
                break
            cap = max(floor, math.ceil(cap / self.grow_factor))
        return cap


class TenantGroup:
    """Tenants sharing one precompiled session, stepped as batched lanes.

    Lanes are *dense*: occupied lane indices are always ``0..len(lanes)-1``
    (`remove` compacts with swap-with-last), and ``capacity >= len(lanes)``
    is the padded batch axis the chunks and the per-lane accumulator are
    shaped to.  Resizes preserve occupied accumulator rows exactly.  The
    accumulator lives on the group's device as `StepStats` of
    (capacity,) float32 tensors.
    """

    def __init__(self, key, config, params, queue: IngestQueue, fault=None,
                 shard=None, autoscale: AutoscalePolicy | None = None,
                 device=None):
        """Compile the shared session for ``key`` = (config, connectivity,
        fault, shard) on ``device`` (None: the card) and start with zero
        lanes; tenants join via `add`."""
        self.key = key
        self.config = config
        self.params = params
        self.queue = queue
        self.fault = fault
        self.shard = shard
        self.autoscale = autoscale or AutoscalePolicy()
        with obs_trace.span("serve.group_compile", cores=config.cores):
            self.session = Interface(config).compile(params, device=device,
                                                     fault=fault)
        self.device = self.session.device
        self.specs: dict = {}  # name -> TenantSpec
        self.lanes: dict = {}  # name -> lane index (dense, < capacity)
        self._backlog: dict = {}  # name -> deque of _Staged entries
        self._acc = None  # per-lane StepStats carry ((capacity,) leaves)
        self.capacity = 0  # padded lane axis of chunks + accumulator
        self.capacities_seen: set = set()  # one chunk shape each
        self.shapes_stepped: set = set()  # chunk shapes run_batched took
        # per-lane global tick offset of the compiled fault's drop stream
        self._lane_ticks = np.zeros((0,), np.int64)

    def add(self, spec: TenantSpec) -> int:
        """Assign ``spec`` the lowest free lane index and return it.

        Occupancy beyond the current capacity triggers an autoscale grow
        (the accumulator pads with zero rows - running totals of every
        existing lane are preserved); reusing a previously freed slot
        restarts that slot's carry at zero.
        """
        lane = len(self.lanes)
        self.specs[spec.name] = spec
        self.lanes[spec.name] = lane
        self._backlog[spec.name] = collections.deque()
        if lane >= self.capacity:
            self.resize(self.autoscale.target(lane + 1, self.capacity))
        else:
            # reusing a freed slot: its carry restarts from zero
            self._lane_ticks[lane] = 0
            if self._acc is not None:
                self._acc = StepStats(*(_set_row(x, lane, 0.0)
                                        for x in self._acc))
        return lane

    def remove(self, name: str) -> None:
        """Free a lane with swap-with-last compaction, then maybe shrink.

        The tenant occupying the highest lane moves into the freed slot -
        its accumulator row moves with it, so every surviving tenant's
        running stats (and fault-tick offset) stay bit-identical across
        the removal.  Lanes stay dense, which is what lets a shrink
        truncate only free trailing rows.
        """
        lane = self.lanes.pop(name)
        self.specs.pop(name)
        self._backlog.pop(name)
        last = len(self.lanes)  # index the ex-last tenant held before the pop
        if lane != last:
            mover = next(n for n, i in self.lanes.items() if i == last)
            self.lanes[mover] = lane
            self._lane_ticks[lane] = self._lane_ticks[last]
            if self._acc is not None:
                self._acc = StepStats(*(_set_row(x, lane, x[last])
                                        for x in self._acc))
        self._lane_ticks[last] = 0
        self.resize(self.autoscale.target(len(self.lanes), self.capacity))

    def resize(self, new_capacity: int) -> None:
        """Re-pad the lane axis to ``new_capacity``, preserving rows.

        Occupied rows (always the leading ones - lanes are dense) carry
        over exactly; growth pads zero rows, shrink truncates free
        trailing rows.  A no-op at the current capacity, so the chunk
        shapes grow only with the set of distinct capacities seen.
        """
        if new_capacity == self.capacity:
            return
        if new_capacity < len(self.lanes):
            raise ValueError(
                f"cannot resize to {new_capacity} lanes below occupancy {len(self.lanes)}"
            )
        keep = min(self.capacity, new_capacity)
        lane_ticks = np.zeros((new_capacity,), np.int64)
        lane_ticks[:keep] = self._lane_ticks[:keep]
        self._lane_ticks = lane_ticks
        if self._acc is not None:
            def fit_rows(x):
                out = x.new_zeros((new_capacity,))
                out[:keep] = x[:keep]
                return out
            self._acc = StepStats(*(fit_rows(x) for x in self._acc))
        self.capacity = new_capacity
        self.capacities_seen.add(new_capacity)

    def jit_cache_entries(self) -> int:
        """Distinct chunk shapes this group's masked batched step has run
        (the JAX engine's compiled-entry count: bounded by
        ``capacities_seen``)."""
        return len(self.shapes_stepped)

    def lane_names(self) -> list:
        """Tenant names in lane order (index 0 first)."""
        return sorted(self.lanes, key=self.lanes.get)

    def lane_stats(self) -> StepStats:
        """Per-lane cumulative `StepStats` carry ((capacity,) tensors on
        the group's device)."""
        if self._acc is None:
            self._acc = StepStats.zeros((self.capacity,), device=self.device)
        return self._acc

    def fault_tick0(self) -> np.ndarray:
        """(capacity,) global tick offsets for the compiled fault stream."""
        return self._lane_ticks

    def advance_fault_ticks(self, flush_ticks: int) -> None:
        """One chunk executed: every lane's fault window moved forward."""
        self._lane_ticks = self._lane_ticks + flush_ticks

    def stage(self, requests) -> None:
        """Append flushed requests to the per-lane host backlog.

        Each entry keeps its request's submit timestamp, so backlogged
        frames stay age-checkable against the shed deadline (a slow pump
        must not let staged work escape its deadline).
        """
        cfg = self.config
        for req in requests:
            frames = np.asarray(req.frames)
            if frames.shape[1:] != (cfg.cores, cfg.neurons_per_core):
                raise ValueError(
                    f"tenant {req.tenant!r} frames shaped {frames.shape[1:]} do not match the "
                    f"group fabric ({cfg.cores}, {cfg.neurons_per_core})"
                )
            self._backlog[req.tenant].append(
                _Staged(frames.astype(bool), enqueued_at=req.enqueued_at)
            )

    def backlog_ticks(self) -> int:
        """Staged-but-unserved ticks across every lane of this group."""
        return sum(s.frames.shape[0] for q in self._backlog.values() for s in q)

    def backlog_ticks_of(self, name: str) -> int:
        """Staged-but-unserved ticks for one tenant."""
        return sum(s.frames.shape[0] for s in self._backlog[name])

    def take_chunk(self, flush_ticks: int, skip=frozenset()) -> _Chunk | None:
        """Pack up to ``flush_ticks`` backlog ticks per lane, left-aligned.

        Shapes are fixed at (capacity, flush_ticks, ...) regardless of
        how much backlog exists, so the batched step sees one shape per
        capacity - partial chunks ride the mask, not a new shape, and
        free lanes stay all-False padding.

        skip: lane names (quarantined tenants) left out of this chunk -
        their backlog is retained untouched and their mask row stays
        all-False, so degradation never changes shapes.
        """
        b = self.capacity
        cfg = self.config
        took = np.zeros((b,), np.int64)
        spikes = np.zeros((b, flush_ticks, cfg.cores, cfg.neurons_per_core), bool)
        mask = np.zeros((b, flush_ticks), bool)
        for name, lane in self.lanes.items():
            if name in skip:
                continue
            queue = self._backlog[name]
            t = 0
            while queue and t < flush_ticks:
                staged = queue.popleft()
                frames = staged.frames
                take = min(frames.shape[0], flush_ticks - t)
                spikes[lane, t : t + take] = frames[:take]
                t += take
                if take < frames.shape[0]:
                    queue.appendleft(
                        _Staged(frames[take:], enqueued_at=staged.enqueued_at)
                    )
            mask[lane, :t] = True
            took[lane] = t
        if not took.any():
            return None
        return _Chunk(spikes=spikes, mask=mask, took=took)


def _set_row(x: torch.Tensor, lane: int, value) -> torch.Tensor:
    """A copy of the (capacity,) accumulator field ``x`` with row ``lane``
    set to ``value`` (a number, or another row of ``x``)."""
    out = x.clone()
    out[lane] = value
    return out


class ServeEngine:
    """Multi-tenant streaming engine over precompiled interface sessions.

    flush_ticks:       time extent of one batched step; also the ingest
                       queue's size trigger (in tick frames).  Fixed, so
                       chunk shapes stay stable.
    flush_deadline_s:  max age of the oldest queued request before a
                       partial batch flushes anyway (0 = always ready).
    policy:            `AdmissionPolicy` capacity limits (now including
                       ``max_pending_frames`` backpressure and the
                       ``shed_deadline_s`` shed bound).
    registry:          `MetricsRegistry` receiving per-tenant counters and
                       histograms (a private one by default).
    sink:              optional `JsonlSink`; `emit_report()` appends one
                       record per tenant plus the fleet record.
    keep_currents:     retain every served tick's currents per tenant
                       (tests/benchmarks; unbounded memory under real
                       sustained load, so off by default).
    clock:             injectable monotonic clock (deadline tests).
    chaos:             optional `repro_torch.ft.chaos.ChaosInjector` firing a
                       seeded `FaultPlan` at this engine's pump rounds.
    retry:             `RetryPolicy` for transient transfer/execute
                       faults (bounded exponential backoff).
    health:            `HealthPolicy` thresholds of the per-lane state
                       machine (quarantine/probe/recover).
    watchdog:          optional `repro_torch.ft.runner.Watchdog`; by default
                       one is created on this engine's registry with the
                       ``serve`` prefix (flush wall-time histogram +
                       straggler counter).
    sleep:             injectable backoff sleep (fake-clock tests).
    autoscale:         `AutoscalePolicy` governing every group's lane
                       capacity (exact fit by default).
    device:            where every group's session, accumulators and
                       staged chunks live: None means the CUDA device
                       (raising without one); tests pass ``"cpu"``.

    Threading (v2): the engine is safe to drive from producer threads
    concurrent with a background pump.  Two locks, always taken in this
    order:

      _pump_mutex   serializes whole pump iterations (and accounting /
                    register / deregister against them), so the ledger
                    is never observed with a chunk's ticks in flight.
      _state_lock   guards the ledger dicts, queue polls, and backlog
                    mutation; `submit` takes only this one, so producers
                    never block behind a full pump iteration.
    """

    def __init__(
        self,
        *,
        flush_ticks: int = 16,
        flush_deadline_s: float = 0.005,
        policy: AdmissionPolicy | None = None,
        registry: obs_metrics.MetricsRegistry | None = None,
        sink: obs_metrics.JsonlSink | None = None,
        keep_currents: bool = False,
        clock: Callable[[], float] = time.monotonic,
        chaos=None,
        retry: RetryPolicy | None = None,
        health: HealthPolicy | None = None,
        watchdog: Watchdog | None = None,
        sleep: Callable[[float], None] = time.sleep,
        autoscale: AutoscalePolicy | None = None,
        device=None,
    ):
        if flush_ticks < 1:
            raise ValueError(f"flush_ticks must be >= 1, got {flush_ticks}")
        self.device = resolve_device(device)
        self.flush_ticks = flush_ticks
        self.flush_deadline_s = flush_deadline_s
        self.admission = AdmissionController(policy, clock=clock)
        self.registry = registry or obs_metrics.MetricsRegistry()
        self.sink = sink
        self.keep_currents = keep_currents
        self.clock = clock
        self.chaos = chaos
        self.retry = retry or RetryPolicy()
        self.health = HealthTracker(health, registry=self.registry, clock=clock)
        self.watchdog = watchdog or Watchdog(registry=self.registry, prefix="serve")
        self._sleep = sleep
        self.autoscale = autoscale or AutoscalePolicy()
        self.groups: dict = {}  # compat key -> TenantGroup
        self._tenant_group: dict = {}  # tenant name -> TenantGroup
        self._rounds: dict = {}  # tenant name -> scenario round counter
        self._served: dict = {}  # tenant name -> ticks served
        self._submitted: dict = {}  # tenant name -> ticks submitted
        self._shed: dict = {}  # tenant name -> ticks shed past deadline
        self._events_seen: dict = {}  # tenant name -> cumulative events read
        self._currents: dict = {}  # tenant name -> list of (t_i, C, N) arrays
        self._retired: set = set()  # deregistered tenants (ledger retained)
        self._shed_log: collections.deque = collections.deque(maxlen=256)
        self._round = 0  # pump round counter (the chaos plan's time axis)
        self._faulted_this_round: set = set()  # lanes faulted in this pump
        self._busy_s = 0.0
        self._ticks = 0
        self._events = 0.0
        # -- threading (see class docstring for the lock order) --
        self._pump_mutex = threading.RLock()
        self._state_lock = threading.RLock()
        self._pump_threads: list = []
        self._stop_event = threading.Event()
        self._pump_fatal: BaseException | None = None
        self._pump_error_log: collections.deque = collections.deque(maxlen=64)

    # ---- registration / ingest -------------------------------------------

    def register(self, spec: TenantSpec, params=None) -> TenantSpec:
        """Admit a tenant; compile its group's session on first use.

        params: optional explicit fabric connectivity for a *new* group,
        an `InterfaceParams` on any device (e.g. the JAX package's, carried
        by `params_from_numpy`; defaults to `default_connectivity(
        spec.config, spec.connectivity_seed)`).  Ignored for an existing
        group - the
        compatibility key pins connectivity to the seed, so passing a
        conflicting params object for an occupied key is an error.
        """
        with self._pump_mutex, self._state_lock:
            if spec.name in self._tenant_group:
                raise ValueError(f"tenant {spec.name!r} is already registered")
            occupancy = {k: len(g.lanes) for k, g in self.groups.items()}
            key = self.admission.admit(spec, occupancy)
            group = self.groups.get(key)
            if group is None:
                if params is None:
                    params = default_connectivity(spec.config, spec.connectivity_seed)
                queue = IngestQueue(
                    flush_frames=self.flush_ticks,
                    flush_deadline_s=self.flush_deadline_s,
                    clock=self.clock,
                    frame_shape=(spec.config.cores, spec.config.neurons_per_core),
                )
                group = TenantGroup(key, spec.config, params, queue,
                                    fault=spec.fault, shard=spec.shard,
                                    autoscale=self.autoscale,
                                    device=self.device)
                self.groups[key] = group
            elif params is not None:
                raise ValueError(
                    f"tenant {spec.name!r}: explicit params conflict with the already-compiled "
                    f"group for this (config, connectivity_seed); omit params to join it"
                )
            before = group.capacity
            group.add(spec)
            self._note_resize(before, group.capacity)
            self._tenant_group[spec.name] = group
            self._retired.discard(spec.name)
            self._rounds[spec.name] = 0
            self._served[spec.name] = 0
            self._submitted[spec.name] = 0
            self._shed[spec.name] = 0
            self._events_seen[spec.name] = 0.0
            self._currents[spec.name] = []
            self.health.add(spec.name)
            return spec

    def deregister(self, tenant: str) -> None:
        """Retire a tenant, freeing its lane (autoscale may shrink).

        Requires the tenant to be fully drained - deregistering with
        pending work raises `ServeError` (serve or shed it first, the
        ledger must close).  The tenant's submitted/served/shed columns
        are retained so `accounting()` keeps closing fleet-wide; its
        group is torn down when the last lane leaves.
        """
        with self._pump_mutex, self._state_lock:
            group = self._group_of(tenant)
            pending = group.queue.pending_by_tenant().get(tenant, 0)
            pending += group.backlog_ticks_of(tenant)
            if pending:
                raise ServeError(
                    f"tenant {tenant!r} still has {pending} pending ticks; "
                    f"drain or shed before deregistering"
                )
            before = group.capacity
            group.remove(tenant)
            self._note_resize(before, group.capacity)
            del self._tenant_group[tenant]
            self._retired.add(tenant)
            self.health.remove(tenant)
            if not group.lanes:
                del self.groups[group.key]

    def _note_resize(self, before: int, after: int) -> None:
        """Count a group capacity change on the autoscale counters."""
        if after > before:
            self.registry.counter("serve.autoscale.grow").inc()
        elif after < before:
            self.registry.counter("serve.autoscale.shrink").inc()

    def submit(self, tenant: str, frames) -> None:
        """Enqueue a spike stream for one tenant.

        Args:
          tenant: a name previously passed to `register` (KeyError with
            the registered names otherwise).
          frames: a (ticks, cores, neurons_per_core) bool spike stream;
            anything array-like is accepted and validated host-side.

        Nothing runs yet - frames sit in the tenant's micro-batch queue
        until the next `pump` / `drain` flushes them through the group's
        shared `InterfaceSession`.

        Raises:
          FrameValidationError: wrong shape/dtype or non-finite values
            (nothing malformed ever reaches the batched step).
          AdmissionError: the request exceeds the tenant's per-request
            or in-flight tick budget.
          RateLimitedError: the tenant's token bucket is empty
            (``AdmissionPolicy.rate_limit_per_s``); nothing is queued.
          QueueOverflowError: the group's bounded queue is full.
          ServeError: a background pump thread died; the original
            exception is chained (`start`/`stop`).
        """
        self._raise_pump_fatal()
        group = self._group_of(tenant)
        cfg = group.config
        frames = validate_frames(
            frames, shape=(cfg.cores, cfg.neurons_per_core), tenant=tenant
        )
        ticks = int(frames.shape[0])
        with self._state_lock:
            self.admission.validate_request(
                tenant,
                ticks,
                pending_frames=group.queue.pending_frames() + group.backlog_ticks(),
            )
            try:
                self.admission.check_rate(tenant, ticks)
            except RateLimitedError:
                self.registry.counter("serve.rate_limited").inc()
                self.registry.counter("serve.rate_limited_ticks").inc(ticks)
                raise
            group.queue.submit(tenant, frames)
            self._submitted[tenant] += ticks

    def submit_scenario(self, tenant: str, ticks: int) -> None:
        """Generate and enqueue one round of the tenant's traffic scenario."""
        spec = self._group_of(tenant).specs[tenant]
        frames = spec.stream(ticks, round=self._rounds[tenant]).numpy()
        self._rounds[tenant] += 1
        self.submit(tenant, frames)

    def _group_of(self, tenant: str) -> TenantGroup:
        try:
            return self._tenant_group[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}; registered: "
                f"{', '.join(sorted(self._tenant_group)) or '(none)'}"
            ) from None

    # ---- serving loop -----------------------------------------------------

    def pump(self, force: bool = False) -> int:
        """One engine iteration: flush ready queues, step their groups.

        Returns the number of live ticks served.  ``force`` flushes
        regardless of the micro-batch triggers (drain semantics).

        Each pump is one *round* of the chaos clock: quarantine cooldowns
        age first, then this round's scheduled lane faults land, then
        expired requests are shed (from the queue *and* the staged
        backlog), and finally every group steps with its quarantined
        lanes masked out.

        Thread-safe: the whole iteration holds ``_pump_mutex``, so pumps
        (foreground or background) never interleave, and `accounting()`
        never observes a chunk's ticks in flight.
        """
        with self._pump_mutex:
            self._round += 1
            self.health.advance()
            self._faulted_this_round.clear()
            if self.chaos is not None:
                for ev in self.chaos.lane_faults(self._round):
                    self._lane_fault(ev)
            ticks_done = 0
            depth_hist = self.registry.histogram("serve.queue_depth")
            for group in list(self.groups.values()):
                with self._state_lock:
                    depth_hist.add(group.queue.depth())
                    group.stage(self._shed_expired(group.queue.poll(force=force)))
                    self._shed_backlog(group)
                    skip = {n for n in group.lanes if not self.health.usable(n)}
                    chunks = []
                    while True:
                        chunk = group.take_chunk(self.flush_ticks, skip=skip)
                        if chunk is None:
                            break
                        chunks.append(chunk)
                ticks_done += self._execute(group, chunks)
            return ticks_done

    def drain(self) -> int:
        """Serve until every queue and backlog is empty; returns ticks.

        Quarantined lanes hold their backlog, so a drain keeps pumping -
        aging cooldowns - until every lane has recovered and served; it
        terminates because quarantine is always finite.
        """
        total = 0
        while True:
            served = self.pump(force=True)
            total += served
            with self._state_lock:
                idle = not any(
                    g.queue.depth() or g.backlog_ticks() for g in self.groups.values()
                )
            if served == 0 and idle:
                return total

    # ---- background pump (v2) --------------------------------------------

    def start(self, poll_interval_s: float = 0.001, threads: int = 1) -> None:
        """Run the pump on background daemon thread(s).

        Producers keep calling `submit`/`submit_scenario` from any
        thread; the pump drains the queues concurrently.  With several
        threads, whole pump iterations still serialize on
        ``_pump_mutex`` - extra threads buy responsiveness when one
        thread is sleeping, not parallel device work.

        A `RetriesExhaustedError` inside a background pump is survivable
        by design (the failed work was restaged): it lands in
        `pump_errors()` and the loop continues.  Any other exception is
        fatal - the thread stops and the error re-raises (wrapped in
        `ServeError`) from the next `submit`/`stop`.
        """
        if poll_interval_s <= 0:
            raise ValueError(f"poll_interval_s must be > 0, got {poll_interval_s}")
        if threads < 1:
            raise ValueError(f"threads must be >= 1, got {threads}")
        if self._pump_threads:
            raise ServeError("pump threads already running; call stop() first")
        self._raise_pump_fatal()
        self._stop_event.clear()
        for i in range(threads):
            t = threading.Thread(
                target=self._pump_loop,
                args=(poll_interval_s,),
                name=f"serve-pump-{i}",
                daemon=True,
            )
            t.start()
            self._pump_threads.append(t)

    def stop(self, drain: bool = False) -> None:
        """Stop the background pump; join every thread; surface fatals.

        drain: serve everything still queued (on the caller's thread)
        after the pump threads exit.  Idempotent when nothing runs.
        """
        self._stop_event.set()
        for t in self._pump_threads:
            t.join()
        self._pump_threads.clear()
        if drain:
            self.drain()
        self._raise_pump_fatal()

    @property
    def running(self) -> bool:
        """True while background pump threads are live."""
        return any(t.is_alive() for t in self._pump_threads)

    def pump_errors(self) -> list:
        """Recent survivable background-pump errors (bounded, oldest first)."""
        return list(self._pump_error_log)

    def __enter__(self) -> "ServeEngine":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight exception with a drain that may re-raise
        self.stop(drain=exc_type is None)

    def _pump_loop(self, poll_interval_s: float) -> None:
        """Body of one background pump thread."""
        while not self._stop_event.is_set():
            try:
                served = self.pump(force=True)
            except RetriesExhaustedError as e:
                # unserved work was restaged by _execute; record and go on
                self._pump_error_log.append(e)
                served = 0
            except BaseException as e:  # noqa: BLE001 - surfaced via _raise_pump_fatal
                self._pump_fatal = e
                self.registry.counter("serve.pump.fatal").inc()
                return
            if served == 0:
                self._stop_event.wait(poll_interval_s)

    def _raise_pump_fatal(self) -> None:
        """Re-raise a background pump thread's fatal error, chained."""
        fatal = self._pump_fatal
        if fatal is not None:
            self._pump_fatal = None
            raise ServeError(
                f"background pump thread died: {type(fatal).__name__}: {fatal}"
            ) from fatal

    def _shed_expired(self, requests) -> list:
        """Drop queued requests older than the policy's shed deadline.

        Each shed is recorded as a typed `DeadlineExceededError` (see
        `shed_errors`) and counted - shed ticks stay part of the
        accounting identity, they just move to the ``shed`` column.
        """
        limit = self.admission.policy.shed_deadline_s
        if limit is None or not requests:
            return requests
        now = self.clock()
        kept = []
        for req in requests:
            age = now - req.enqueued_at
            if age <= limit:
                kept.append(req)
                continue
            err = DeadlineExceededError(
                f"tenant {req.tenant!r}: request aged {age:.4f}s in queue "
                f"(shed_deadline_s={limit}); {req.ticks} tick frames shed"
            )
            self._shed_log.append(err)
            self._shed[req.tenant] = self._shed.get(req.tenant, 0) + req.ticks
            self.registry.counter("serve.shed").inc()
            self.registry.counter("serve.shed_ticks").inc(req.ticks)
        return kept

    def _shed_backlog(self, group: TenantGroup) -> None:
        """Shed staged backlog frames older than the policy deadline.

        `_shed_expired` only ages requests still in the ingest queue;
        this is the other half - frames already staged on the backlog
        (a slow pump, a quarantined lane) age against the same
        ``shed_deadline_s`` from their submit time, so the deadline
        means what it says regardless of where the work waits.
        """
        limit = self.admission.policy.shed_deadline_s
        if limit is None:
            return
        now = self.clock()
        for name, queue in group._backlog.items():
            if not queue:
                continue
            kept: collections.deque = collections.deque()
            shed_ticks = 0
            for staged in queue:
                age = now - staged.enqueued_at
                if age <= limit:
                    kept.append(staged)
                    continue
                ticks = int(staged.frames.shape[0])
                shed_ticks += ticks
                self._shed_log.append(DeadlineExceededError(
                    f"tenant {name!r}: staged frames aged {age:.4f}s in backlog "
                    f"(shed_deadline_s={limit}); {ticks} tick frames shed"
                ))
                self.registry.counter("serve.shed").inc()
                self.registry.counter("serve.shed_ticks").inc(ticks)
            if shed_ticks:
                self._shed[name] = self._shed.get(name, 0) + shed_ticks
                group._backlog[name] = kept

    def _lane_fault(self, ev) -> None:
        """One injected lane fault: advance the tenant's health machine."""
        if ev.tenant not in self._tenant_group:
            self.registry.counter("serve.faults.unknown_lane").inc()
            return
        self.registry.counter("serve.faults").inc()
        self._faulted_this_round.add(ev.tenant)
        self.health.record_failure(ev.tenant)

    def _with_retries(self, what: str, fn):
        """Run ``fn`` with bounded exponential backoff on transient faults.

        Only `TransientFaultError`s are retried; anything else (a real
        bug) propagates immediately.  After the budget is spent a
        `RetriesExhaustedError` chains the last fault.  A successful
        retry records the episode in ``serve.recovery_ms``, measured
        from when the *first attempt began* - the failed attempt's own
        wall time is part of the outage, not free.
        """
        policy = self.retry
        delay = policy.backoff_base_s
        t_start = self.clock()
        failed = False
        for attempt in range(policy.max_retries + 1):
            try:
                out = fn()
            except TransientFaultError as e:
                self.registry.counter("serve.faults").inc()
                self.registry.counter("serve.retries").inc()
                self.registry.counter(f"serve.retries.{what}").inc()
                failed = True
                if attempt >= policy.max_retries:
                    self.registry.counter("serve.retries_exhausted").inc()
                    raise RetriesExhaustedError(
                        f"{what} still failing after {policy.max_retries} "
                        f"retries (backoff from {policy.backoff_base_s}s)"
                    ) from e
                self._sleep(delay)
                delay *= policy.backoff_factor
                continue
            if failed:
                self.registry.counter("serve.retry_recoveries").inc()
                self.registry.histogram("serve.recovery_ms").add(
                    max(self.clock() - t_start, 0.0) * 1e3
                )
            return out
        raise AssertionError("unreachable")  # loop always returns or raises

    def _restage(self, group: TenantGroup, chunks: list) -> None:
        """Return unserved chunks to the front of the backlog, in order.

        Called before a `RetriesExhaustedError` propagates: the ticks a
        failed chunk carried go back to ``pending``, keeping
        submitted == served + shed + pending true even across hard
        failures (and letting a later pump serve them).  Restaged frames
        take a fresh submit timestamp - a chunk packs frames from many
        requests, so the original per-request ages are gone; the shed
        deadline restarts rather than guessing.
        """
        now = self.clock()
        with self._state_lock:
            for chunk in reversed(chunks):
                for name, lane in group.lanes.items():
                    took = int(chunk.took[lane])
                    if took:
                        group._backlog[name].appendleft(_Staged(
                            np.asarray(chunk.spikes[lane, :took]), enqueued_at=now
                        ))

    def _step(self, group: TenantGroup, staged: _OnDevice):
        """One batched masked step (the unit a retry replays).

        A chaos fault fires before the step's first launch.  A group with
        a spike-perturbing `FaultModel` passes each lane's fault-tick
        offset.
        """
        if self.chaos is not None:
            self.chaos.on_execute(self._round)
        kw = {}
        fault = group.session.fault
        if fault is not None and fault.perturbs_spikes:
            kw["fault_tick0"] = group.fault_tick0()
        spikes, mask = staged
        out = group.session.run_batched(spikes, mask=mask,
                                        stats0=group.lane_stats(),
                                        shard=group.shard, **kw)
        group.shapes_stepped.add(tuple(spikes.shape))
        return out

    def _wait(self) -> None:
        """Block until the step's launches have finished: a synchronize
        on an event recorded on the compute stream (nothing on the CPU)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    def _execute(self, group: TenantGroup, chunks: list) -> int:
        """Step one group through its chunks.

        Chunk t+1's copy is issued after chunk t's batched step is
        launched, on the same stream, before the step is waited on.

        Fault handling: every transfer and step runs under
        `_with_retries`; the group accumulator commits only *after* a
        successful step (a replayed chunk can never double-count), and on
        `RetriesExhaustedError` the unserved chunks are restaged before
        the error propagates.
        """
        if not chunks:
            return 0
        ticks_done = 0
        try:
            staged = self._with_retries("transfer", lambda: self._transfer(chunks[0]))
        except RetriesExhaustedError:
            self._restage(group, chunks)
            raise
        for i, chunk in enumerate(chunks):
            on_device = staged
            t0 = self.clock()
            transfer_err = None
            with obs_trace.span("serve.step", lanes=len(group.lanes)):
                try:
                    currents, acc = self._with_retries(
                        "execute", lambda: self._step(group, on_device)
                    )
                except RetriesExhaustedError:
                    self._restage(group, chunks[i:])
                    raise
                if i + 1 < len(chunks):
                    try:
                        staged = self._with_retries(
                            "transfer", lambda: self._transfer(chunks[i + 1])
                        )
                    except RetriesExhaustedError as e:
                        transfer_err = e
                self._wait()
            wall_s = self.clock() - t0
            group._acc = acc
            group.advance_fault_ticks(self.flush_ticks)
            self.watchdog.observe(wall_s)
            self._record(group, chunk, currents, acc, wall_s)
            ticks_done += int(chunk.took.sum())
            if transfer_err is not None:
                # chunk i is fully recorded; only i+1.. go back to pending
                self._restage(group, chunks[i + 1 :])
                raise transfer_err
        return ticks_done

    def _transfer(self, chunk: _Chunk) -> _OnDevice:
        """Copy one chunk to the serving device, on the compute stream."""
        if self.chaos is not None:
            self.chaos.on_transfer(self._round)
        with obs_trace.span("serve.device_transfer"):
            return _OnDevice(torch.from_numpy(chunk.spikes).to(self.device),
                             torch.from_numpy(chunk.mask).to(self.device))

    # ---- metrics ----------------------------------------------------------

    def _record(self, group, chunk: _Chunk, currents, acc, wall_s: float) -> None:
        with self._state_lock:
            self._record_locked(group, chunk, currents, acc, wall_s)

    def _record_locked(self, group, chunk: _Chunk, currents, acc, wall_s: float) -> None:
        tick_ms = wall_s * 1e3 / self.flush_ticks
        fleet_events = 0.0
        events_now = acc.events.cpu().numpy()
        host_currents = (currents[: len(group.lanes)].cpu().numpy()
                         if self.keep_currents else None)
        for name, lane in group.lanes.items():
            took = int(chunk.took[lane])
            if took == 0:
                continue
            self._served[name] += took
            delta = float(events_now[lane]) - self._events_seen[name]
            self._events_seen[name] = float(events_now[lane])
            fleet_events += delta
            self.registry.counter(f"tenant.{name}.events").inc(delta)
            self.registry.histogram(f"tenant.{name}.tick_ms").add(tick_ms)
            if name not in self._faulted_this_round:
                # a lane that faulted *this* round doesn't get recovery
                # credit for also serving in it - its streak must survive
                # a clean round first
                self.health.record_success(name)
            if self.keep_currents:
                self._currents[name].append(host_currents[lane, :took])
        self.registry.counter("serve.flushes").inc()
        self.registry.counter("serve.ticks").inc(int(chunk.took.sum()))
        self._busy_s += wall_s
        self._ticks += int(chunk.took.sum())
        self._events += fleet_events

    def reset_metrics(self) -> None:
        """Zero served-work counters/histograms (warmup-then-measure).

        Benchmarks warm up with a throwaway round (kernel builds, first
        allocations), then reset so set-up never lands in the latency
        percentiles.  The per-lane device accumulators are NOT reset - they carry the
        bit-identity contract - only the host-side bookkeeping is.
        Accounting columns (submitted/shed) reset together with served,
        so the closure identity restarts from zero; reset with pending
        work still queued and it will read as over-served until drained.
        """
        with self._pump_mutex, self._state_lock:
            self.registry.counters.clear()
            self.registry.histograms.clear()
            for name in self._served:
                self._served[name] = 0
                self._submitted[name] = 0
                self._shed[name] = 0
            for chunks in self._currents.values():
                chunks.clear()
            self._shed_log.clear()
            self._pump_error_log.clear()
            self._busy_s = 0.0
            self._ticks = 0
            self._events = 0.0

    def queue_depth(self) -> int:
        """Requests currently queued across all groups."""
        return sum(g.queue.depth() for g in self.groups.values())

    def ticks_served(self, tenant: str | None = None) -> int:
        """Ticks served for ``tenant``, or live (fabric) ticks fleet-wide."""
        if tenant is not None:
            return self._served[tenant]
        return self._ticks

    def ticks_submitted(self, tenant: str | None = None) -> int:
        """Ticks submitted by ``tenant``, or summed across all tenants."""
        if tenant is not None:
            return self._submitted[tenant]
        return sum(self._submitted.values())

    def ticks_shed(self, tenant: str | None = None) -> int:
        """Ticks shed (deadline-expired) for ``tenant``, or fleet total."""
        if tenant is not None:
            return self._shed.get(tenant, 0)
        return sum(self._shed.values())

    def shed_errors(self) -> list:
        """The typed `DeadlineExceededError`s of recent sheds (bounded)."""
        return list(self._shed_log)

    def lane_health(self, tenant: str) -> str:
        """The tenant's health state (``healthy``/``degraded``/``quarantined``)."""
        self._group_of(tenant)  # raise the canonical unknown-tenant error
        return self.health.state(tenant).value

    def accounting(self) -> dict:
        """Per-tenant work ledger and whether it closes exactly.

        For every tenant, ``submitted == served + shed + pending`` must
        hold at any quiescent point - through retries, quarantines, and
        sheds.  The chaos soak asserts ``closes`` after every drain.

        Thread-safe against a running background pump: both engine locks
        are held, so the ledger is read between pump iterations - a
        chunk's ticks are never observed mid-flight between backlog and
        served.  Retired (deregistered) tenants keep their closed rows
        with ``pending == 0``.
        """
        with self._pump_mutex, self._state_lock:
            per: dict = {}
            for name in self._retired:
                per[name] = {
                    "submitted": self._submitted.get(name, 0),
                    "served": self._served.get(name, 0),
                    "shed": self._shed.get(name, 0),
                    "pending": 0,
                }
            for group in self.groups.values():
                queued = group.queue.pending_by_tenant()
                for name in group.lanes:
                    pending = queued.get(name, 0) + group.backlog_ticks_of(name)
                    per[name] = {
                        "submitted": self._submitted[name],
                        "served": self._served[name],
                        "shed": self._shed.get(name, 0),
                        "pending": int(pending),
                    }
            closes = all(
                v["submitted"] == v["served"] + v["shed"] + v["pending"]
                for v in per.values()
            )
            return {"tenants": per, "closes": closes}

    def events_per_sec(self) -> float:
        """Sustained routed events/sec over engine step wall clock."""
        return self._events / max(self._busy_s, 1e-12)

    def currents(self, tenant: str) -> np.ndarray:
        """(ticks_served, cores, neurons_per_core) currents (keep_currents)."""
        if not self.keep_currents:
            raise ValueError("construct ServeEngine(keep_currents=True) to retain currents")
        cfg = self._group_of(tenant).config
        chunks = self._currents[tenant]
        if not chunks:
            return np.zeros((0, cfg.cores, cfg.neurons_per_core), np.float32)
        return np.concatenate(chunks, axis=0)

    def tenant_stats(self, tenant: str) -> StepStats:
        """Cumulative `StepStats` for one tenant (0-d numpy float32
        fields, on the host like `currents`)."""
        group = self._group_of(tenant)
        lane = group.lanes[tenant]
        return StepStats(*(x[lane].cpu().numpy() for x in group.lane_stats()))

    def _fault_summary(self) -> dict:
        """Non-zero fault/degradation counters, report-shaped."""
        names = {
            "injected": "serve.faults",
            "retries": "serve.retries",
            "retries_exhausted": "serve.retries_exhausted",
            "retry_recoveries": "serve.retry_recoveries",
            "shed_requests": "serve.shed",
            "shed_ticks": "serve.shed_ticks",
            "degraded": "serve.degraded",
            "quarantines": "serve.quarantines",
            "probes": "serve.probes",
            "recoveries": "serve.recoveries",
            "stragglers": "serve.stragglers",
            "rate_limited": "serve.rate_limited",
            "rate_limited_ticks": "serve.rate_limited_ticks",
            "autoscale_grow": "serve.autoscale.grow",
            "autoscale_shrink": "serve.autoscale.shrink",
            "pump_fatal": "serve.pump.fatal",
        }
        out = {}
        for label, counter in names.items():
            c = self.registry.counters.get(counter)
            if c is not None and c.value:
                out[label] = int(c.value)
        if self.chaos is not None:
            for kind, n in sorted(self.chaos.injected.items()):
                out[f"chaos_{kind}"] = int(n)
        return out

    def serve_report(self) -> list:
        """Per-tenant records plus one fleet record, report-CLI shaped.

        Tenant records carry ``stats_per_tick`` (so ``python -m
        repro_torch.obs.report`` renders the per-tier breakdown per tenant) and
        tick-latency percentiles; the fleet record merges every tenant's
        latency histogram (`Histogram.merge`), reports sustained
        ``events_per_sec``, and - when any fault machinery fired - a
        ``faults`` counter dict plus recovery-time percentiles.
        """
        records = []
        fleet_hist = None
        for name in sorted(self._tenant_group):
            group = self._tenant_group[name]
            spec = group.specs[name]
            served = self._served[name]
            rec = {
                "tenant": name,
                "scenario": spec.scenario,
                "cores": group.config.cores,
                "neurons_per_core": group.config.neurons_per_core,
                "ticks": served,
                "submitted": self._submitted[name],
                "shed_ticks": self._shed.get(name, 0),
                "health": self.health.state(name).value,
                "events": self._events_seen[name],
                "queue_depth": group.queue.depth(),
            }
            if spec.fault is not None:
                rec["fault"] = spec.fault.describe()
            hist = self.registry.histograms.get(f"tenant.{name}.tick_ms")
            if hist is not None and hist.count:
                summary = hist.summary()
                rec.update(
                    tick_ms_p50=summary["p50"],
                    tick_ms_p95=summary["p95"],
                    tick_ms_p99=summary["p99"],
                )
                fleet_hist = hist if fleet_hist is None else fleet_hist.merge(hist)
            if served:
                stats = self.tenant_stats(name)._asdict()
                rec["stats_per_tick"] = {k: float(v) / served for k, v in stats.items()}
            records.append(rec)
        fleet = {
            "tenant": "__fleet__",
            "tenants": len(self._tenant_group),
            "groups": len(self.groups),
            "lane_capacity": sum(g.capacity for g in self.groups.values()),
            "ticks": self._ticks,
            "events": self._events,
            "events_per_sec": self.events_per_sec(),
            "busy_s": self._busy_s,
        }
        if fleet_hist is not None and fleet_hist.count:
            summary = fleet_hist.summary()
            fleet.update(
                tick_ms_p50=summary["p50"],
                tick_ms_p95=summary["p95"],
                tick_ms_p99=summary["p99"],
            )
        faults = self._fault_summary()
        if faults:
            fleet["faults"] = faults
        recovery = self.registry.histograms.get("serve.recovery_ms")
        if recovery is not None and recovery.count:
            summary = recovery.summary()
            fleet.update(
                recovery_ms_p50=summary["p50"],
                recovery_ms_p99=summary["p99"],
            )
        records.append(fleet)
        return records

    def emit_report(self) -> list:
        """`serve_report()`, appended to the JSONL sink when one is set."""
        records = self.serve_report()
        if self.sink is not None:
            for rec in records:
                self.sink.write(rec)
        return records


def group_key(spec: TenantSpec) -> tuple:
    """Public alias of the tenant session-compatibility key."""
    return _compat_key(spec)
