"""Span-based tracing (cockroach_tpu/utils/tracing.py; the analogue of
pkg/util/tracing).

A Tracer hands out nested spans with wall-clock durations and tags;
the active span propagates through a thread-local, so any layer can
child_span() without plumbing (the reference threads a Context
instead; a thread-local matches this engine's one-statement-per-thread
execution model). A capture() scope collects the finished span tree —
that recording is what EXPLAIN ANALYZE renders, like the reference's
WithRecording(trace) statement diagnostics.

Distributed recordings: the active-span stack lives in MODULE-level
thread-local state shared by every Tracer instance, so spans opened
by the RPC fabric, DistSender, or DistSQL nodes nest into whatever
recording the statement opened — no tracer needs plumbing through the
stack. `trace_context()` exports the active (trace_id, span_id) pair
for an RPC frame; the serving side runs its handler under its own
`capture()` and ships the finished subtree back with
`span_to_wire()`; the caller grafts it with `attach_remote()`. This
mirrors CockroachDB's span "recording" payloads piggybacked on
BatchResponse / SetupFlow (pkg/util/tracing/crdbspan.go).
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

# One process-wide active-span stack per thread (see module doc).
_tls = threading.local()
_ids = itertools.count(1)


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    tags: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)
    span_id: int = 0
    trace_id: int = 0

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def tree_lines(self, indent: int = 0) -> list[str]:
        tag_s = "".join(f" {k}={v}" for k, v in self.tags.items())
        out = [f"{'  ' * indent}{self.name}: "
               f"{self.duration_ms:.2f}ms{tag_s}"]
        for c in self.children:
            out.extend(c.tree_lines(indent + 1))
        return out

    def find(self, name: str) -> Optional["Span"]:
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def find_all(self, name: str) -> list["Span"]:
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find_all(name))
        return out


def current_span() -> Optional[Span]:
    return getattr(_tls, "span", None)


def recording_requested() -> bool:
    """True when the active capture asked remote participants to
    record too (SET tracing = cluster, EXPLAIN ANALYZE, slow-statement
    sampling). False when nothing records here, or when the capture
    was opened with record_request=False (SET tracing = on: gateway-
    local recording, remote nodes stay dark)."""
    return current_span() is not None and \
        bool(getattr(_tls, "rec_req", True))


def trace_context() -> Optional[dict]:
    """The active trace context as a JSON-safe dict for an RPC frame
    (`{"tid": trace_id, "sid": span_id}` plus `"rec": 1` when the
    capture requests remote recording), or None when nothing is
    recording on this thread."""
    s = current_span()
    if s is None:
        return None
    tc = {"tid": s.trace_id, "sid": s.span_id}
    if getattr(_tls, "rec_req", True):
        tc["rec"] = 1
    return tc


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) \
        else str(v)


def span_to_wire(s: Span) -> dict:
    """Encode a finished span subtree as JSON-safe primitives (the
    trace-frame wire format documented in OBSERVABILITY.md)."""
    return {
        "n": s.name,
        "b": s.start_ns,
        "e": s.end_ns,
        "t": {str(k): _jsonable(v) for k, v in s.tags.items()},
        "c": [span_to_wire(c) for c in s.children],
        "sid": s.span_id,
        "tid": s.trace_id,
    }


def span_from_wire(d: dict) -> Span:
    return Span(
        name=d.get("n", "?"),
        start_ns=int(d.get("b", 0)),
        end_ns=int(d.get("e", 0)),
        tags=dict(d.get("t", {})),
        children=[span_from_wire(c) for c in d.get("c", [])],
        span_id=int(d.get("sid", 0)),
        trace_id=int(d.get("tid", 0)),
    )


def attach_remote(wire: dict) -> Optional[Span]:
    """Graft a remote recording (wire dict from span_to_wire) under
    the active span. No-op when nothing is recording here."""
    parent = current_span()
    if parent is None or not wire:
        return None
    s = span_from_wire(wire)
    parent.children.append(s)
    return s


@contextmanager
def span(name: str, **tags):
    """Module-level child span on the shared stack (open a child of
    whatever is recording; cheap no-op nesting otherwise)."""
    parent = current_span()
    s = Span(name, time.monotonic_ns(), tags=dict(tags),
             span_id=next(_ids),
             trace_id=parent.trace_id if parent is not None else 0)
    if parent is not None:
        parent.children.append(s)
    _tls.span = s
    try:
        yield s
    finally:
        s.end_ns = time.monotonic_ns()
        _tls.span = parent


def event(name: str, **tags) -> Optional[Span]:
    """Zero-duration marker under the active span (breaker-skip,
    cache-evict, ...). Returns None when nothing is recording."""
    parent = current_span()
    if parent is None:
        return None
    now = time.monotonic_ns()
    s = Span(name, now, now, tags=dict(tags), span_id=next(_ids),
             trace_id=parent.trace_id)
    parent.children.append(s)
    return s


@contextmanager
def capture(name: str = "trace", remote_ctx: Optional[dict] = None,
            record_request: Optional[bool] = None, **tags):
    """Collect a full recording rooted at `name` on this thread.

    `remote_ctx` is the {"tid","sid","rec"?} dict from an inbound RPC
    frame: the new root adopts the caller's trace_id and tags the
    parent span id, so stitched recordings stay correlated across
    nodes.

    `record_request` is the per-statement remote-recording bit (the
    pgwire `SET tracing` analogue): True asks every RPC/flow this
    capture touches to record remotely and ship spans back; False
    keeps the recording gateway-local. Default: inherit the inbound
    frame's bit when remote_ctx is given, else True (every existing
    capture — EXPLAIN ANALYZE, slow sampling, tests — wants the
    stitched tree)."""
    prev = current_span()
    prev_req = getattr(_tls, "rec_req", True)
    root = Span(name, time.monotonic_ns(), tags=dict(tags),
                span_id=next(_ids))
    if remote_ctx:
        root.trace_id = int(remote_ctx.get("tid", 0))
        psid = int(remote_ctx.get("sid", 0))
        if psid:
            root.tags.setdefault("parent_sid", psid)
        if record_request is None:
            record_request = bool(remote_ctx.get("rec"))
    else:
        root.trace_id = next(_ids)
    _tls.span = root
    _tls.rec_req = True if record_request is None else bool(record_request)
    try:
        yield root
    finally:
        root.end_ns = time.monotonic_ns()
        _tls.span = prev
        _tls.rec_req = prev_req


def tag(**tags) -> None:
    s = current_span()
    if s is not None:
        s.tags.update(tags)


class Tracer:
    """Back-compat facade over the module-level span stack: every
    Tracer shares the same per-thread recording, which is what lets
    fabric/KV/DistSQL spans land inside the engine's capture."""

    def _cur(self) -> Optional[Span]:
        return current_span()

    def span(self, name: str, **tags):
        return span(name, **tags)

    def capture(self, name: str = "trace",
                record_request: Optional[bool] = None, **tags):
        return capture(name, record_request=record_request, **tags)

    def tag(self, **tags) -> None:
        tag(**tags)
