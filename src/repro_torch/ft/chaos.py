"""`repro_torch.ft.chaos`: host-layer fault plans and the chaos injector.

The port's own copy of `repro.ft.chaos` (pure Python: the plans draw
from `random`, so a seed gives the JAX package's plan exactly).  Where
the fabric-level `repro_torch.ft.faults.FaultModel` perturbs the
compiled step, this module perturbs the *host serving loop* around it:
transfer failures, slow devices, and per-tenant lane faults, all
scheduled by pump round so a chaos run is exactly reproducible.

  `FaultEvent`     one scheduled fault: a kind, the pump round it arms
                   at, how many times it fires (consecutive charges — the
                   knob retry-bound tests turn), and for ``slow_device``
                   a stall duration / for ``lane_fault`` a target tenant.
  `FaultPlan`      an immutable set of events; `FaultPlan.mixed` builds
                   the deterministic mixed plan of the chaos soak.
  `ChaosInjector`  consumes the plan from inside the
                   `repro_torch.serve.ServeEngine` hooks:
                   ``on_transfer``/``on_execute`` raise typed transient
                   errors (or sleep) while charges remain,
                   ``lane_faults`` reports which tenants fault this
                   round.  Every charge fires exactly once; ``exhausted``
                   is the soak's "all faults delivered" check.

The typed error ladder mirrors what the hardened engine handles:
`TransientFaultError` subclasses are retried with backoff;
`RetriesExhaustedError` is what the engine raises once the retry budget
is spent (the caller's signal to intervene).
"""

from __future__ import annotations

import dataclasses
import random as _random
import time
from typing import Callable

FAULT_KINDS = ("transfer_fail", "execute_fail", "slow_device", "lane_fault")


class ChaosError(RuntimeError):
    """Base of every injected-fault error."""


class TransientFaultError(ChaosError):
    """A fault the engine may retry (transfer/execute hiccups)."""


class TransferFault(TransientFaultError):
    """Host->device transfer failed for one chunk."""


class ExecuteFault(TransientFaultError):
    """The batched device step failed for one chunk."""


class RetriesExhaustedError(ChaosError):
    """A transient fault outlived the engine's retry budget."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    round:   first pump round at which the event is armed (charges that
             cannot fire that round — e.g. nothing to transfer — stay
             armed and fire at the next opportunity).
    kind:    one of `FAULT_KINDS`.
    tenant:  target lane, required for (and only for) ``lane_fault``.
    times:   consecutive charges; a transfer_fail with ``times=2`` makes
             the first two transfer attempts of its round fail, then
             heals — which is how tests exercise the retry bound.
    delay_s: stall injected per ``slow_device`` charge.
    """

    round: int
    kind: str
    tenant: str | None = None
    times: int = 1
    delay_s: float = 0.02

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{', '.join(FAULT_KINDS)}"
            )
        if self.round < 1:
            raise ValueError(f"round must be >= 1, got {self.round}")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        if (self.kind == "lane_fault") != (self.tenant is not None):
            raise ValueError("tenant is required for lane_fault events (and only those)")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, fully deterministic schedule of `FaultEvent`s."""

    events: tuple = ()

    def __post_init__(self):
        events = tuple(self.events)
        for ev in events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"FaultPlan events must be FaultEvent, got {type(ev)}")
        object.__setattr__(self, "events", events)

    def __len__(self) -> int:
        return len(self.events)

    def total_charges(self) -> int:
        return sum(ev.times for ev in self.events)

    def kinds(self) -> dict:
        out: dict = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + ev.times
        return out

    @classmethod
    def mixed(
        cls,
        tenants,
        rounds: int,
        seed: int = 0,
        intensity: float = 0.3,
        max_times: int = 2,
        start_round: int = 2,
        delay_s: float = 0.01,
    ) -> "FaultPlan":
        """The default mixed plan: every kind, spread over ``rounds``.

        Deterministic in (tenants, rounds, seed).  ``max_times`` is kept
        at or below the engine's default retry budget so a mixed soak is
        guaranteed recoverable; one event of every kind is always
        included even at low intensity.
        """
        tenants = list(tenants)
        if not tenants:
            raise ValueError("mixed plan needs at least one tenant for lane faults")
        if rounds < len(FAULT_KINDS):
            raise ValueError(f"need rounds >= {len(FAULT_KINDS)}, got {rounds}")
        start_round = min(start_round, rounds)
        rng = _random.Random(seed)
        events = []
        seen_kinds = set()
        # every event lands inside [start_round, rounds]: a caller that
        # pumps `rounds` times with work present sees the full plan fire
        for r in range(start_round, rounds + 1):
            if rng.random() >= intensity:
                continue
            kind = rng.choice(FAULT_KINDS)
            seen_kinds.add(kind)
            events.append(
                FaultEvent(
                    round=r,
                    kind=kind,
                    tenant=rng.choice(tenants) if kind == "lane_fault" else None,
                    times=rng.randint(1, max_times),
                    delay_s=delay_s,
                )
            )
        # guarantee full kind coverage at deterministic in-range rounds
        for i, kind in enumerate(FAULT_KINDS):
            if kind not in seen_kinds:
                events.append(
                    FaultEvent(
                        round=min(start_round + i, rounds),
                        kind=kind,
                        tenant=tenants[i % len(tenants)] if kind == "lane_fault" else None,
                        times=1,
                        delay_s=delay_s,
                    )
                )
        events.sort(key=lambda ev: (ev.round, FAULT_KINDS.index(ev.kind)))
        return cls(events=tuple(events))


class ChaosInjector:
    """Consumes a `FaultPlan` from inside the serving loop's hooks.

    Each event carries ``times`` charges; a charge fires at most once and
    only at/after its event's round, so a full run delivers exactly
    ``plan.total_charges()`` faults regardless of retry interleaving.

    sleep: injectable stall (tests pass a fake that advances their fake
    clock instead of blocking the suite).
    """

    def __init__(self, plan: FaultPlan, sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self.sleep = sleep
        self._charges = [ev.times for ev in plan.events]
        self.injected: dict = {}  # kind -> charges fired

    # ---- bookkeeping ------------------------------------------------------

    def _armed(self, round_: int, kind: str):
        for i, ev in enumerate(self.plan.events):
            if ev.kind == kind and self._charges[i] > 0 and round_ >= ev.round:
                return i, ev
        return None

    def _fire(self, i: int, ev: FaultEvent) -> None:
        self._charges[i] -= 1
        self.injected[ev.kind] = self.injected.get(ev.kind, 0) + 1

    def exhausted(self) -> bool:
        """True once every scheduled charge has fired."""
        return not any(self._charges)

    def injected_total(self) -> int:
        return sum(self.injected.values())

    # ---- engine hooks -----------------------------------------------------

    def on_transfer(self, round_: int) -> None:
        """Called before each host->device transfer; may raise."""
        hit = self._armed(round_, "transfer_fail")
        if hit is not None:
            i, ev = hit
            self._fire(i, ev)
            raise TransferFault(
                f"injected transfer failure (round {ev.round}, "
                f"{self._charges[i]} charge(s) left)"
            )

    def on_execute(self, round_: int) -> None:
        """Called before each batched device step; may raise or stall."""
        hit = self._armed(round_, "execute_fail")
        if hit is not None:
            i, ev = hit
            self._fire(i, ev)
            raise ExecuteFault(
                f"injected execute failure (round {ev.round}, "
                f"{self._charges[i]} charge(s) left)"
            )
        hit = self._armed(round_, "slow_device")
        if hit is not None:
            i, ev = hit
            self._fire(i, ev)
            self.sleep(ev.delay_s)

    def lane_faults(self, round_: int) -> list:
        """Lane-fault events firing this round (one charge each per pump)."""
        out = []
        for i, ev in enumerate(self.plan.events):
            if ev.kind == "lane_fault" and self._charges[i] > 0 and round_ >= ev.round:
                self._fire(i, ev)
                out.append(ev)
        return out
