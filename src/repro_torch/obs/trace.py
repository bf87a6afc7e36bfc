"""Host-side span tracing with Chrome-trace (Perfetto) JSON output.

Port of `repro.obs.trace`: `torch.profiler.record_function` takes the
place of `jax.profiler.TraceAnnotation`, so a span shows on a
`torch.profiler` timeline under its own name.

A `Tracer` collects *complete* events (``ph: "X"``) from context-manager
spans and serialises them in the Chrome trace-event format, so a run can
be dropped straight into ``chrome://tracing`` / https://ui.perfetto.dev
and read next to a device profile:

    from repro_torch.obs import trace

    tracer = trace.Tracer()
    with tracer:                               # activates the tracer
        with trace.span("run"):
            out = session.run(spikes)
        with trace.span("synchronize"):
            torch.cuda.synchronize()
    tracer.save("trace.json")

``trace.span(...)`` is the module-level entry point the instrumented code
paths use (`repro_torch.serve.ServeEngine`'s ``serve.step``,
``serve.device_transfer`` and ``serve.group_compile``): it records into
the innermost *active* tracer, and is a no-op when none is active -
instrumentation can stay in library code permanently.  While a tracer is
active every span also opens a `torch.profiler.record_function`, so when
a `torch.profiler.profile` is capturing, the host spans show up on its
timeline under the same names and the two traces align.

Spans nest: each event records its depth so stack-track UIs lay them out;
`Tracer.instant` adds zero-duration marker events.  Timestamps are
microseconds from the tracer's creation (the Chrome format's native
unit).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

_STACK: list = []  # innermost active tracer last; module-level by design


def active_tracer():
    """The innermost active `Tracer`, or None."""
    return _STACK[-1] if _STACK else None


class Tracer:
    """Collects span events; context-manager activation; Chrome JSON out."""

    def __init__(self, process_name: str = "repro_torch"):
        self.process_name = process_name
        self.events: list = []
        self._origin_ns = time.perf_counter_ns()
        self._depth = 0

    # ---- activation ------------------------------------------------------

    def __enter__(self) -> "Tracer":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        # remove this tracer even if spans misnested around activation
        for i in range(len(_STACK) - 1, -1, -1):
            if _STACK[i] is self:
                del _STACK[i]
                break

    # ---- recording -------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._origin_ns) / 1e3

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete event around the body (plus a profiler range)."""
        start = self._now_us()
        self._depth += 1
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            self._depth -= 1
            self.events.append(
                {
                    "name": name,
                    "ph": "X",
                    "ts": start,
                    "dur": self._now_us() - start,
                    "pid": os.getpid(),
                    "tid": threading.get_ident(),
                    "args": {**args, "depth": self._depth},
                }
            )

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        self.events.append(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": self._now_us(),
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    # ---- output ----------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """The full payload in Chrome trace-event format."""
        meta = {
            "name": "process_name",
            "ph": "M",
            "pid": os.getpid(),
            "tid": 0,
            "args": {"name": self.process_name},
        }
        # ts-sorted: Perfetto tolerates disorder but diffing the JSON is nicer
        events = sorted(self.events, key=lambda e: e["ts"])
        return {"traceEvents": [meta, *events], "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path


@contextlib.contextmanager
def span(name: str, **args):
    """Span on the active tracer; exact no-op when tracing is inactive."""
    tracer = active_tracer()
    if tracer is None:
        yield None
        return
    with tracer.span(name, **args) as t:
        yield t


__all__ = ["Tracer", "span", "active_tracer"]
