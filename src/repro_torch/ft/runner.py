"""Fault-tolerant training runner: watchdog, auto-resume, failure drills.

Port of `repro.ft.runner`:

  * every step is a pure function of (state, step_index) - the pipeline
    regenerates any batch from its step, so a restart resumes bit-exactly
    from the last checkpoint (on the card too: the SNN train step sums in
    a fixed order, `repro_torch.models.snn.routing_matrix`);
  * `CheckpointManager` writes atomically; a crash mid-save never corrupts
    the resume point;
  * the `Watchdog` tracks per-step wall time and flags stragglers (steps
    slower than `straggler_factor` x the running median), on a
    `repro_torch.obs.metrics` registry shared with the serving tier;
  * `FailureInjector` deterministically raises at configured steps so the
    resume path is tested, not just designed.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.ckpt.manager import CheckpointManager, tree_leaves
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class FailureInjector:
    """Raises once at each configured step; counts onto `obs.metrics`.

    registry/prefix: optional `MetricsRegistry` receiving a
    ``<prefix>.injected_failures`` counter, so training-time fault drills
    share one telemetry substrate with the serving tier.
    """

    fail_at_steps: tuple = ()
    registry: obs_metrics.MetricsRegistry | None = None
    prefix: str = "ft"
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            if self.registry is not None:
                self.registry.counter(f"{self.prefix}.injected_failures").inc()
            raise RuntimeError(f"injected failure at step {step}")


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


def _device_of(state) -> torch.device:
    """Where the state's tensors lie (its first tensor leaf's device)."""
    for leaf in tree_leaves(state):
        if torch.is_tensor(leaf):
            return leaf.device
    raise ValueError("the training state holds no tensor")


def run_training(train_step, state, pipeline, *, num_steps: int,
                 manager: CheckpointManager, injector: FailureInjector | None
                 = None, watchdog: Watchdog | None = None,
                 log_every: int = 10, logger=print):
    """Drive training with checkpoint/resume.  Returns (state, history).

    ``train_step(state, batch) -> (state, metrics)`` with a ``"loss"``
    metric; ``pipeline.batch(step)`` regenerates any step's batch.  A
    resumed state lands on the device of ``state``'s tensors.  On any
    exception the caller can re-invoke with a fresh ``state`` template;
    we auto-resume from the manager's latest checkpoint.
    """
    watchdog = watchdog or Watchdog()
    restored, meta = manager.restore_latest(state, device=_device_of(state))
    start = 0
    if restored is not None:
        state = restored
        start = int(meta["step"]) if meta else 0
        logger(f"[ft] resumed from step {start}")

    history = []
    for step in range(start, num_steps):
        if injector is not None:
            injector.check(step)
        t0 = time.perf_counter()
        batch = pipeline.batch(step)
        state, metrics = train_step(state, batch)
        if metrics["loss"].is_cuda:
            torch.cuda.synchronize(metrics["loss"].device)
        dt = time.perf_counter() - t0
        if watchdog.observe(dt):
            logger(f"[ft] straggler step {step}: {dt:.3f}s")
        history.append({k: float(v) for k, v in metrics.items()})
        if step % log_every == 0:
            logger(f"step {step}: loss={history[-1]['loss']:.4f} "
                   f"({dt*1000:.0f} ms)")
        manager.maybe_save(step + 1, state, extra={"data_step": step + 1})
    manager.maybe_save(num_steps, state, force=True,
                       extra={"data_step": num_steps})
    manager.wait()
    return state, history


def run_with_restarts(make_state, train_step, pipeline, *, num_steps: int,
                      manager: CheckpointManager, injector: FailureInjector,
                      max_restarts: int = 5, logger=print):
    """Crash-loop harness: restart after injected/real failures."""
    attempts = 0
    while True:
        try:
            state = make_state()
            return run_training(train_step, state, pipeline,
                                num_steps=num_steps, manager=manager,
                                injector=injector, logger=logger)
        except RuntimeError as e:
            attempts += 1
            logger(f"[ft] failure ({e}); restart {attempts}")
            if attempts > max_restarts:
                raise


__all__ = ["FailureInjector", "Watchdog", "run_training", "run_with_restarts"]
