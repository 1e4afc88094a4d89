"""Structured logging plane: channels, severities, sinks, redaction.

The analogue of the reference's pkg/util/log (31K LoC there; the
essentials here): every log entry carries a CHANNEL (what subsystem
family it belongs to — pkg/util/log/logpb/log.proto's Channel enum),
a SEVERITY, and a message whose interpolated arguments are treated as
POTENTIALLY SENSITIVE and wrapped in redaction markers, so a sink
configured with redact=True can strip user data while keeping the
log's shape (pkg/util/log/redact.go's redactable strings). Sinks
(stderr, file, in-memory for tests) subscribe to channel sets above a
severity threshold (pkg/util/log/log_channels.go, sinks in
pkg/util/log/flags.go). Structured events — typed payloads like the
reference's eventpb protos — ride the same pipe as JSON.

Design departures from the reference, on purpose:
- No background flusher/buffering: entries are delivered
  synchronously; callers that need throughput log little (the hot
  path is device-compiled SQL, which does not log per row).
- Markers are the actual Unicode ‹› pair the reference uses in
  redactable logs; redaction replaces the span with the fixed mask
  string the reference uses ("×××").

The port's copy of cockroach_tpu/utils/log.py: the node and pgwire
session events ride it.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field

# -- channels (pkg/util/log/logpb: Channel) --------------------------------
DEV = "DEV"                  # uncategorized developer logging
OPS = "OPS"                  # node lifecycle, process events
HEALTH = "HEALTH"            # liveness, heartbeats, breakers
STORAGE = "STORAGE"          # LSM / ranges / raft
SESSIONS = "SESSIONS"        # client connections, auth
SQL_SCHEMA = "SQL_SCHEMA"    # DDL / descriptor changes
SQL_EXEC = "SQL_EXEC"        # statement execution events
USER_ADMIN = "USER_ADMIN"    # users/privileges admin ops
JOBS = "JOBS"                # jobs lifecycle (reference logs these to OPS/DEV)

CHANNELS = (DEV, OPS, HEALTH, STORAGE, SESSIONS, SQL_SCHEMA, SQL_EXEC,
            USER_ADMIN, JOBS)

# -- severities ------------------------------------------------------------
INFO, WARNING, ERROR, FATAL = "I", "W", "E", "F"
_SEV_ORDER = {INFO: 0, WARNING: 1, ERROR: 2, FATAL: 3}

_OPEN, _CLOSE, _MASK = "‹", "›", "×××"


def redact(msg: str) -> str:
    """Strip ‹sensitive› spans, leaving the fixed mask."""
    out = []
    i = 0
    while True:
        j = msg.find(_OPEN, i)
        if j < 0:
            out.append(msg[i:])
            return "".join(out)
        k = msg.find(_CLOSE, j + 1)
        if k < 0:
            out.append(msg[i:])
            return "".join(out)
        out.append(msg[i:j])
        out.append(_MASK)
        i = k + 1


def strip_markers(msg: str) -> str:
    return msg.replace(_OPEN, "").replace(_CLOSE, "")


@dataclass
class Entry:
    channel: str
    severity: str
    msg: str            # redactable: args wrapped in ‹›
    ts: float
    event: dict | None = None   # structured payload (eventpb analogue)

    def render(self, redacted: bool) -> str:
        body = redact(self.msg) if redacted else strip_markers(self.msg)
        t = time.strftime("%y%m%d %H:%M:%S", time.gmtime(self.ts))
        line = f"{self.severity}{t} [{self.channel}] {body}"
        if self.event is not None:
            ev = dict(self.event)
            if redacted:
                ev = {k: (redact(v) if isinstance(v, str) else v)
                      for k, v in ev.items()}
            else:
                ev = {k: (strip_markers(v) if isinstance(v, str) else v)
                      for k, v in ev.items()}
            line += " " + json.dumps(ev, sort_keys=True, default=str)
        return line


class Sink:
    """Base sink: channel filter + severity threshold + redaction."""

    def __init__(self, channels=None, threshold: str = INFO,
                 redacted: bool = False):
        self.channels = set(channels) if channels else None
        self.threshold = threshold
        self.redacted = redacted

    def accepts(self, e: Entry) -> bool:
        if self.channels is not None and e.channel not in self.channels:
            return False
        return _SEV_ORDER[e.severity] >= _SEV_ORDER[self.threshold]

    def emit(self, e: Entry) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class StderrSink(Sink):
    def __init__(self, threshold: str = WARNING, **kw):
        super().__init__(threshold=threshold, **kw)

    def emit(self, e: Entry) -> None:
        print(e.render(self.redacted), file=sys.stderr)


class FileSink(Sink):
    """One log file; format="json" writes one JSON object per line
    (the reference's json file format, util/log/format_json.go)."""

    def __init__(self, path: str, format: str = "crdb", **kw):
        super().__init__(**kw)
        self.path = path
        self.format = format
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def emit(self, e: Entry) -> None:
        if self.format == "json":
            msg = redact(e.msg) if self.redacted else strip_markers(e.msg)
            obj = {"channel": e.channel, "severity": e.severity,
                   "timestamp": e.ts, "message": msg}
            if e.event is not None:
                obj["event"] = e.event
            self._f.write(json.dumps(obj, sort_keys=True, default=str)
                          + "\n")
        else:
            self._f.write(e.render(self.redacted) + "\n")

    def close(self) -> None:
        self._f.close()


class MemorySink(Sink):
    """Capture sink for tests (the reference's log scopes)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.entries: list[Entry] = []

    def emit(self, e: Entry) -> None:
        self.entries.append(e)

    def lines(self) -> list[str]:
        return [e.render(self.redacted) for e in self.entries]


class Logger:
    """Process-wide logger: fan entries out to sinks. Call sites use
    the module-level helpers; tests swap sinks via `scope()`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sinks: list[Sink] = [StderrSink()]

    def log(self, channel: str, severity: str, fmt: str, *args,
            event: dict | None = None) -> None:
        # interpolated args are sensitive by default -> wrap in markers
        if args:
            msg = fmt % tuple(f"{_OPEN}{a}{_CLOSE}" for a in args)
        else:
            msg = fmt
        e = Entry(channel, severity, msg, time.time(), event)
        with self._lock:
            for s in self.sinks:
                if s.accepts(e):
                    s.emit(e)

    def structured(self, channel: str, event_type: str, **fields) -> None:
        """Typed event (eventpb analogue): fields are sensitive."""
        ev = {"type": event_type}
        for k, v in fields.items():
            ev[k] = f"{_OPEN}{v}{_CLOSE}" if isinstance(v, str) else v
        self.log(channel, INFO, f"event:{event_type}", event=ev)


_logger = Logger()


def configure(sinks: list[Sink]) -> None:
    _logger.sinks = list(sinks)


def get_sinks() -> list[Sink]:
    return list(_logger.sinks)


class scope:
    """Context manager: swap in a capture sink (tests)."""

    def __init__(self, *sinks: Sink):
        self.sinks = list(sinks) or [MemorySink()]

    def __enter__(self):
        self._saved = _logger.sinks
        _logger.sinks = self.sinks
        return self.sinks[0]

    def __exit__(self, *exc):
        _logger.sinks = self._saved
        return False


def info(channel: str, fmt: str, *args, **kw) -> None:
    _logger.log(channel, INFO, fmt, *args, **kw)


def warning(channel: str, fmt: str, *args, **kw) -> None:
    _logger.log(channel, WARNING, fmt, *args, **kw)


def error(channel: str, fmt: str, *args, **kw) -> None:
    _logger.log(channel, ERROR, fmt, *args, **kw)


def fatal(channel: str, fmt: str, *args, **kw) -> None:
    _logger.log(channel, FATAL, fmt, *args, **kw)
    raise SystemExit(f"F [{channel}] {strip_markers(fmt % args if args else fmt)}")


def structured(channel: str, event_type: str, **fields) -> None:
    _logger.structured(channel, event_type, **fields)
