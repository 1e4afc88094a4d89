"""reactor-discipline: nothing blocking on the pgwire event loop.

The reactor front end (server/pgfront.py) parks 10K sessions behind
ONE thread; a single blocking call in the loop's callback path stalls
every connected session at once — the whole point of the design is
that the loop only ever does non-blocking socket work, frame parsing,
and handoffs. This rule walks the call closure of every ``_loop``
method on a ``*Reactor*`` class in ``cockroach_tpu_torch/server/`` and
flags blocking call sites reachable from it:

- ``.result()`` / ``.wait()`` / ``.acquire()`` / ``.join()`` — future
  and lock waits (loop-side critical sections use ``with lock:``
  over a few instructions, the sanctioned idiom; a bare ``acquire``
  can park arbitrarily long).
- ``.sendall()`` — a full kernel socket buffer blocks the loop for a
  slow client; workers own reply flushing through the select-backed
  ``_nb_sendall``. A single ``.send()`` of a 1-byte startup reply is
  allowed by convention (it cannot meaningfully block and anything
  short-written retires the conn).
- ``.recv()`` outside a readiness callback — reads belong in
  functions named ``*readable*``/``*ready*``, where the selector has
  certified the fd will not block.
- ``.lease()`` / ``.execute()`` and the card's waits and copies
  (core.device_wait: ``synchronize``, ``.cpu()``, ``.cuda(...)``,
  ``.to(...)`` given a device or ``non_blocking``) — HBM admission, SQL
  execution and device sync are statement work; statements run on the
  worker pool, never the loop.

Expansion follows resolvable package callees breadth-first (visited-
guarded, small fan-outs only) so "the loop calls a helper that calls
``engine.execute``" is still a finding — at the blocking site, with
the seed loop named.
"""

from __future__ import annotations

import ast

from .core import PACKAGE, Finding, device_wait, direct_nodes

SCOPE_PREFIX = f"{PACKAGE}/server/"

# host waits; the card's waits are core.device_wait
REACTOR_BLOCKING = {"result", "wait", "acquire", "join", "sendall",
                    "lease", "execute"}

# readiness-callback naming convention: the selector certified the fd
READY_FN_MARKERS = ("readable", "ready")

_MAX_FANOUT = 2
_MAX_DEPTH = 6


def _loop_seeds(index):
    """(FunctionInfo, module) event-loop entry points: ``_loop`` /
    ``loop`` methods of ``*Reactor*`` classes in server/ modules."""
    for rel, m in index.modules.items():
        if not rel.startswith(SCOPE_PREFIX):
            continue
        for fi in m.functions.values():
            if fi.cls and "Reactor" in fi.cls \
                    and fi.name in ("_loop", "loop"):
                yield fi, m


def _blocking_sites(fi):
    """(attr, lineno) blocking call sites lexically in ``fi``."""
    out = []
    for n in direct_nodes(fi.node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        attr = (f.attr if isinstance(f, ast.Attribute)
                else f.id if isinstance(f, ast.Name) else None)
        if attr is None:
            continue
        if attr in REACTOR_BLOCKING or device_wait(n) is not None:
            out.append((attr, n.lineno, n.end_lineno))
        elif attr in ("recv", "recv_into") and not any(
                mk in fi.name.lower() for mk in READY_FN_MARKERS):
            out.append((attr, n.lineno, n.end_lineno))
    return out


def check_reactor_discipline(index) -> list[Finding]:
    rule = "reactor-discipline"
    out = []
    reported: set[tuple] = set()
    for seed, _sm in _loop_seeds(index):
        # BFS over the loop's call closure; every visited function's
        # blocking sites are findings attributed to this seed
        queue = [(seed, 0)]
        visited = {seed.qualname}
        while queue:
            fi, depth = queue.pop(0)
            m = index.modules[fi.relpath]
            for attr, line, end in _blocking_sites(fi):
                key = (fi.relpath, line, attr)
                if key in reported:
                    continue
                reported.add(key)
                reason = m.waiver_for(rule, line, end)
                via = ("" if fi.qualname == seed.qualname
                       else f" (in {fi.dotted})")
                out.append(Finding(
                    rule, fi.relpath, line,
                    f".{attr}() reachable from the event loop "
                    f"{seed.dotted}{via}: a blocking call on the "
                    f"reactor stalls every parked session — hand the "
                    f"work to the executor pool or use the "
                    f"non-blocking primitive",
                    waived=reason is not None,
                    waiver_reason=reason or ""))
            if depth >= _MAX_DEPTH:
                continue
            for desc in fi.calls:
                # submit()/Thread(target=...) arguments are worker
                # entry points, not loop calls — _call_descriptor only
                # yields actual call expressions, so they are skipped
                # naturally
                callees = index.resolve_call(fi, desc)
                if not callees or len(callees) > _MAX_FANOUT:
                    continue  # unresolvable or mixin fan-out: too
                    # noisy to expand
                for callee in callees:
                    if callee.qualname in visited:
                        continue
                    visited.add(callee.qualname)
                    queue.append((callee, depth + 1))
    return out
