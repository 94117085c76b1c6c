"""Execution tracing -> Chrome trace / Perfetto JSON (port of
``vortex_rt_tpu/utils/trace.py``; host-only Python).

A ``Tracer`` collects trace events in the Chrome trace event format
("X" complete spans, "i" instants, "C" counters), loadable in
ui.perfetto.dev or chrome://tracing.  ``maybe_span`` records a span on
the tracer that ``enable_tracing`` installed and does nothing while
tracing is off; it never waits for the device, so a span around device
work measures the host's enqueue, not the device's run.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Tracer:
    """Chrome-trace event collector (trace event format, "X" phases)."""

    def __init__(self) -> None:
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args: Any):
        ts = self._now_us()
        try:
            yield self
        finally:
            self._events.append({
                "name": name, "ph": "X", "ts": ts,
                "dur": self._now_us() - ts,
                "pid": 0, "tid": 0, "args": args,
            })

    def instant(self, name: str, **args: Any) -> None:
        self._events.append({
            "name": name, "ph": "i", "ts": self._now_us(),
            "pid": 0, "tid": 0, "s": "g", "args": args,
        })

    def counter(self, name: str, **values: float) -> None:
        self._events.append({
            "name": name, "ph": "C", "ts": self._now_us(),
            "pid": 0, "tid": 0, "args": values,
        })

    # -- explicit-timeline events: a frame's measured stage budget laid
    # out on a synthetic timeline (``WavefrontRenderer.scope_trace``)
    def complete_at(self, name: str, ts_us: float, dur_us: float,
                    tid: int = 0, **args: Any) -> None:
        self._events.append({
            "name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
            "pid": 0, "tid": tid, "args": args,
        })

    def counter_at(self, name: str, ts_us: float,
                   **values: float) -> None:
        self._events.append({
            "name": name, "ph": "C", "ts": ts_us,
            "pid": 0, "tid": 0, "args": values,
        })

    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms"}, f)


_GLOBAL: Optional[Tracer] = None


def global_tracer() -> Optional[Tracer]:
    return _GLOBAL


def enable_tracing() -> Tracer:
    global _GLOBAL
    _GLOBAL = Tracer()
    return _GLOBAL


def disable_tracing() -> None:
    global _GLOBAL
    _GLOBAL = None


@contextmanager
def maybe_span(name: str, **args: Any):
    t = _GLOBAL
    if t is None:
        yield None
    else:
        with t.span(name, **args):
            yield t
