"""Per-operator execution profiles (cockroach_tpu/exec/profile.py; the
statement diagnostics substrate).

The reference attributes execution statistics to individual processors
via execinfrapb.ComponentStats collected by the execstatscollector and
stitched into the statement bundle (``pkg/sql/execstats/
traceanalyzer.go``). Two planes, as in the reference:

- **coarse plane (on by default, ``sql.stmt_profile.enabled``)**: every
  statement activates a ``ProfileSink`` on a thread-local
  (``profile.active``). The data-movement sites that already meter
  bytes (the resident table upload, the stream page loop, the spill
  join's partitions and the spill sort's runs) note their bytes and
  stalls into the current sink. Overhead is a thread-local read and a
  dict update per event; the compiled plan never sees the sink.
- **fine plane (EXPLAIN ANALYZE, diagnostics)**: while a sink is active
  with ``fine=True``, ``compile_plan``'s wrapper opens ``sink.op(node)``
  around every operator. The card runs asynchronously, so a host clock
  around an operator measures its launches only: on a CUDA batch the
  span is a pair of CUDA events on the current stream, and the rows
  are a device count, both read by ``resolve()`` after one sync at the
  end. On the CPU the operators run synchronously and a host clock pair
  is the device time. Self time is the inclusive time less the
  children's, so the operators' times add up to the root's inclusive
  time. Without a fine sink the wrapper calls the operator and nothing
  else: no event, no sync.

Concurrency: one lock around the op table, per-statement sinks on a
thread-local (never a shared global). Statements of two sessions under
the shared side of the statement gate each note into their own
thread's sink.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch

FIELDS = ("rows", "batches", "device_seconds", "bytes_uploaded",
          "bytes_shuffled", "bytes_spilled", "stall_seconds")


@dataclass
class OpProfile:
    """One operator's accumulated execution statistics."""
    rows: int = 0
    batches: int = 0
    device_seconds: float = 0.0
    bytes_uploaded: int = 0
    bytes_shuffled: int = 0
    bytes_spilled: int = 0
    stall_seconds: float = 0.0

    def add(self, **deltas) -> None:
        for k, v in deltas.items():
            setattr(self, k, getattr(self, k) + v)

    def to_wire(self) -> dict:
        return {k: getattr(self, k) for k in FIELDS}

    @property
    def bytes_moved(self) -> int:
        return (self.bytes_uploaded + self.bytes_shuffled
                + self.bytes_spilled)


class _OpFrame:
    """Mutable holder yielded by ``ProfileSink.op``: the caller sets the
    operator's output rows (an int, or a device count resolved later)
    and a scan's uploaded bytes after the operator ran."""
    __slots__ = ("rows", "bytes_uploaded")

    def __init__(self):
        self.rows = 0
        self.bytes_uploaded = 0


class _Span:
    """One operator span of the fine plane, resolved after the run."""
    __slots__ = ("node", "frame", "start", "end", "children", "seconds")

    def __init__(self, node, frame, start):
        self.node = node
        self.frame = frame
        self.start = start
        self.end = None
        self.children: list = []
        self.seconds = 0.0


def op_label(node) -> str:
    """Stable human-readable label for a plan node (collision-suffixed
    per sink: two bare Filters become ``filter`` and ``filter#2``)."""
    kind = type(node).__name__.lower()
    detail = None
    for attr in ("table", "alias"):
        v = getattr(node, attr, None)
        if isinstance(v, str) and v and not v.startswith("__"):
            detail = v
            break
    return f"{kind}:{detail}" if detail else kind


class ProfileSink:
    """Thread-safe per-statement operator profile accumulator.

    Entries are keyed by label; entries stitched from a remote DistSQL
    flow (``merge_wire``) carry their node as ``label@n<node>``. The
    plan-node -> label mapping is kept so EXPLAIN ANALYZE can annotate
    the rendered tree by node object identity."""

    def __init__(self, device=None):
        # the fine plane's spans are CUDA events on a CUDA device
        self.device = device
        self._mu = threading.Lock()
        self._ops: dict[str, OpProfile] = {}
        self._node_labels: dict[int, str] = {}   # id(plan node) -> label
        self._label_counts: dict[str, int] = {}
        self._tls = threading.local()
        # fine-plane spans not yet resolved (root spans first-closed
        # last); resolve() reads their events and rows
        self._pending: list[_Span] = []
        # the fine plane's measured wall of the profiled region
        self.wall_s = 0.0
        # [(node, device_time_s)] of remote flows stitched at a DistSQL
        # gateway (distsql/node.py _pump_and_union)
        self.remote_walls: list = []

    # -- labeling --------------------------------------------------
    def _label_for(self, plan_node) -> str:
        key = id(plan_node)
        lbl = self._node_labels.get(key)
        if lbl is None:
            base = op_label(plan_node)
            n = self._label_counts.get(base, 0) + 1
            self._label_counts[base] = n
            lbl = base if n == 1 else f"{base}#{n}"
            self._node_labels[key] = lbl
        return lbl

    # -- recording -------------------------------------------------
    def note(self, label: str, **deltas) -> None:
        with self._mu:
            ent = self._ops.get(label)
            if ent is None:
                ent = self._ops[label] = OpProfile()
            ent.add(**deltas)

    def note_op(self, plan_node, **deltas) -> None:
        with self._mu:
            lbl = self._label_for(plan_node)
        self.note(lbl, **deltas)

    @contextmanager
    def op(self, plan_node):
        """One operator span: CUDA events on the current stream when
        the sink's device is a CUDA device, else a host clock pair.
        Spans nest per thread; ``resolve()`` turns them into self
        device time."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        cuda = getattr(self.device, "type", "") == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        frame = _OpFrame()
        sp = _Span(plan_node, frame, start)
        if stack:
            stack[-1].children.append(sp)
        stack.append(sp)
        try:
            yield frame
        finally:
            stack.pop()
            if cuda:
                sp.end = torch.cuda.Event(enable_timing=True)
                sp.end.record()
            else:
                sp.seconds = time.perf_counter() - start
            if not stack:
                with self._mu:
                    self._pending.append(sp)

    def resolve(self) -> None:
        """Read the fine plane's pending spans: one sync, then each
        operator's inclusive time from its events, its self time (less
        its children's), its rows and its bytes into the op table."""
        with self._mu:
            roots, self._pending = self._pending, []
        if not roots:
            return
        if any(r.end is not None for r in roots):
            torch.cuda.synchronize()

        def inclusive(sp: _Span) -> float:
            if sp.end is not None:
                sp.seconds = sp.start.elapsed_time(sp.end) / 1e3
            for c in sp.children:
                inclusive(c)
            return sp.seconds

        def record(sp: _Span) -> None:
            self_s = sp.seconds - sum(c.seconds for c in sp.children)
            rows = sp.frame.rows
            self.note_op(sp.node, rows=int(rows), batches=1,
                         device_seconds=max(0.0, self_s),
                         bytes_uploaded=int(sp.frame.bytes_uploaded))
            for c in sp.children:
                record(c)

        for r in roots:
            self.wall_s += inclusive(r)
            record(r)

    # -- reading ---------------------------------------------------
    def op_entry(self, plan_node) -> OpProfile | None:
        with self._mu:
            lbl = self._node_labels.get(id(plan_node))
            return None if lbl is None else self._ops.get(lbl)

    def entries(self) -> list[tuple]:
        """[(label, OpProfile)] snapshot, by label."""
        with self._mu:
            return sorted((lbl, OpProfile(**ent.to_wire()))
                          for lbl, ent in self._ops.items())

    def total_device_seconds(self) -> float:
        with self._mu:
            return sum(e.device_seconds for e in self._ops.values())

    def total_bytes_moved(self) -> int:
        with self._mu:
            return sum(e.bytes_moved for e in self._ops.values())

    def total_stall_seconds(self) -> float:
        with self._mu:
            return sum(e.stall_seconds for e in self._ops.values())

    def summary(self, top: int = 3) -> dict:
        """Digest: the top-N operators by device_seconds and the
        statement's total bytes moved."""
        ents = self.entries()
        ranked = sorted(ents, key=lambda e: -e[1].device_seconds)[:top]
        return {
            "top_ops": [{"op": lbl,
                         "device_seconds": round(e.device_seconds, 6),
                         "rows": e.rows, "bytes_moved": e.bytes_moved}
                        for lbl, e in ranked],
            "bytes_moved": sum(e.bytes_moved for _, e in ents),
            "device_seconds": round(
                sum(e.device_seconds for _, e in ents), 6),
        }

    def to_wire(self, node=None) -> list[dict]:
        """The op table as JSON-safe dicts (the diagnostics bundle's
        profile, a flow_profile frame). With ``node`` every entry is
        tagged with it, unless it carries a remote node's tag."""
        out = []
        for lbl, e in self.entries():
            d = dict(op=lbl, **e.to_wire())
            if node is not None:
                base, sep, tag = lbl.rpartition("@n")
                if sep and tag.lstrip("-").isdigit():
                    d.update(op=base, node=int(tag))
                else:
                    d["node"] = node
            out.append(d)
        return out

    def merge_wire(self, wire: list[dict], node=None) -> None:
        """Add a remote flow's op table, each entry under
        ``label@n<node>`` (its own tag, else ``node``)."""
        for d in wire:
            tag = d.get("node", node)
            lbl = d.get("op", "?")
            if tag is not None:
                lbl = f"{lbl}@n{tag}"
            self.note(lbl, **{k: d.get(k, 0) for k in FIELDS})


# -- thread-local active sink (per-statement, never a global) -------
_active = threading.local()


def current() -> ProfileSink | None:
    """The executing statement's sink, if any (None off-statement)."""
    return getattr(_active, "sink", None)


def requested() -> bool:
    """True when the statement wants fine per-operator profiles
    (EXPLAIN ANALYZE, an armed diagnostics capture)."""
    return bool(getattr(_active, "fine", False))


def fine_sink() -> ProfileSink | None:
    """The current sink when it asks for the fine plane, else None."""
    return current() if requested() else None


@contextmanager
def active(sink: ProfileSink | None, fine: bool = False):
    """Install ``sink`` as the thread's current statement sink. Nested
    activations restore the outer sink on exit (internal statements
    run by an outer one must not pollute its profile)."""
    prev = getattr(_active, "sink", None)
    prev_fine = getattr(_active, "fine", False)
    _active.sink = sink
    _active.fine = fine
    try:
        yield sink
    finally:
        _active.sink = prev
        _active.fine = prev_fine


def note(label: str, **deltas) -> None:
    """Record into the current statement's sink when one is active,
    else drop (never raises)."""
    s = current()
    if s is not None:
        s.note(label, **deltas)
