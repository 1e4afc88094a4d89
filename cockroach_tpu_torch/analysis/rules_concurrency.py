"""Concurrency rules: racy module globals and blocking under a lock.

racy-global
    Module-level mutable state mutated without a lock races as soon as
    two thread roles reach it (pgwire session threads, the shard
    threads of a distributed run, mesh-dispatcher threads, page
    prefetch workers and maintenance loops all run engine code
    concurrently). A wrapper instance that holds its own lock (the
    ``Tally`` of utils/metric.py, threading primitives, registries) is
    the sanctioned pattern, and module globals bound to one are exempt
    here. What the rule flags: augmented assignment to a global
    (``SECONDS[0] += dt``, ``mod.COUNT += 1``), subscript stores, and
    mutating method calls (append/update/...) that are not inside a
    ``with <lock>`` block. Plain rebinding (``X = v``) is exempt — a
    single store is atomic under the GIL and the lazy-rebind idiom
    (``if X is None: X = build()``) is benign.

    The port's first run found ops/hashtable.py's ``ROUNDS`` dict,
    written by every build and probe and read into a plan's route right
    after its build: the shard threads of a mesh and concurrent sessions
    share it, so one statement's route could report another thread's
    count. The build and probe now return their round counts.

blocking-under-lock
    A blocking call reachable while holding a lock turns that lock
    into a convoy (every session serializes behind one upload) or a
    deadlock edge (a wait on capacity that only a lock-holder can
    release). Flags the host waits ``.wait``/``.acquire``/``.result``/
    ``.lease``, and the calls that wait on the card or copy to or from
    it (core.device_wait: ``synchronize``, ``.cpu()``, ``.cuda(...)``,
    ``.to(...)`` given a device or ``non_blocking``) lexically inside a
    ``with <lock-like>`` block, expanding one call level into
    same-package callees. ``.item()``, ``.tolist()`` and ``.numpy()``
    are not matched by name: numpy arrays share those names, and a
    name-only scan flagged host numpy work under ColumnStore's lock.
    Condition-variable blocks (``with self._cv:``) are the sanctioned
    wait pattern and are not lock-like here; ``soft_lease`` never
    blocks and is not matched.
"""

from __future__ import annotations

import ast

from .core import (PACKAGE, Finding, _call_descriptor, device_wait,
                   direct_nodes)

SCOPE_PREFIXES = tuple(
    f"{PACKAGE}/{d}/" for d in ("exec", "storage", "distsql", "parallel",
                                "ops", "utils", "server", "kv",
                                "kvserver", "rpc", "sql"))

MUTATORS = {"append", "add", "update", "pop", "extend", "insert",
            "setdefault", "clear", "remove", "discard", "popleft",
            "appendleft"}

# module-level bindings whose mutation is thread-safe by construction
SAFE_WRAPPER_CALLEES = {"local", "Lock", "RLock", "Condition", "Event",
                        "Semaphore", "BoundedSemaphore", "Queue",
                        "MetricRegistry", "count"}

# the host waits; the card's waits are core.device_wait
BLOCKING_ATTRS = {"wait", "acquire", "result", "lease"}


def _lockish_name(expr) -> str | None:
    """The lock's display name if `expr` names a plain lock (not a
    condition variable, whose with-block IS the wait pattern)."""
    if isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Attribute):
        name = expr.attr
    else:
        return None
    low = name.lower()
    if "cv" in low or "cond" in low:
        return None
    if "lock" in low or "mutex" in low or low.endswith("_mu") or low == "_mu":
        return name
    return None


def _safe_wrapper_binding(value) -> bool:
    """True when a module-global's bound value is an instance of a
    thread-safe wrapper (its own lock inside: Tally & friends,
    threading primitives, registries)."""
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")
    return (name in SAFE_WRAPPER_CALLEES or "Tally" in name
            or "Registry" in name)


def _held_lock_lines(fn_node) -> list[tuple[int, int, str]]:
    """(start, end, lockname) spans of `with <lock>` blocks in the
    function, nested defs excluded."""
    spans = []
    for n in direct_nodes(fn_node):
        if not isinstance(n, (ast.With, ast.AsyncWith)):
            continue
        for item in n.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                continue  # e.g. gate.window("x"), pool.acquire(...)
            lock = _lockish_name(ctx)
            if lock is not None:
                spans.append((n.lineno, n.end_lineno or n.lineno, lock))
    return spans


def check_racy_global(index) -> list[Finding]:
    rule = "racy-global"
    out = []
    for rel, m in index.modules.items():
        if not rel.startswith(SCOPE_PREFIXES):
            continue
        safe_names = {n for n, v in m.global_assigns.items()
                      if _safe_wrapper_binding(v)}
        lock_names = {n for n, v in m.global_assigns.items()
                      if isinstance(v, ast.Call)
                      and isinstance(v.func, ast.Attribute)
                      and v.func.attr in ("Lock", "RLock", "Condition")}
        global_names = set(m.global_assigns) - safe_names
        for fi in m.functions.values():
            lock_spans = _held_lock_lines(fi.node)
            # also accept non-"lock"-named module lock globals
            for n in direct_nodes(fi.node):
                if isinstance(n, (ast.With, ast.AsyncWith)):
                    for item in n.items:
                        c = item.context_expr
                        if isinstance(c, ast.Name) and c.id in lock_names:
                            lock_spans.append(
                                (n.lineno, n.end_lineno or n.lineno, c.id))

            def _locked(line: int) -> bool:
                return any(a <= line <= b for a, b, _ in lock_spans)

            for n in direct_nodes(fi.node):
                hit = None
                if isinstance(n, ast.AugAssign):
                    t = n.target
                    if isinstance(t, ast.Name) and t.id in global_names \
                            and _is_global_in(fi.node, t.id):
                        hit = f"augmented assignment to global {t.id}"
                    elif (isinstance(t, ast.Subscript)
                          and isinstance(t.value, ast.Name)
                          and t.value.id in global_names):
                        hit = (f"augmented store into global "
                               f"{t.value.id}[...]")
                    elif (isinstance(t, ast.Attribute)
                          and isinstance(t.value, ast.Name)):
                        tgt = _imported_module_global(index, m, t.value.id,
                                                     t.attr)
                        if tgt:
                            hit = (f"augmented assignment to "
                                   f"{t.value.id}.{t.attr} "
                                   f"(module global of {tgt})")
                elif isinstance(n, ast.Assign):
                    for t in n.targets:
                        if (isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Name)
                                and t.value.id in global_names):
                            hit = f"store into global {t.value.id}[...]"
                elif (isinstance(n, ast.Call)
                      and isinstance(n.func, ast.Attribute)
                      and n.func.attr in MUTATORS
                      and isinstance(n.func.value, ast.Name)
                      and n.func.value.id in global_names):
                    hit = (f"mutating call "
                           f"{n.func.value.id}.{n.func.attr}() on a "
                           f"module global")
                if hit is None or _locked(n.lineno):
                    continue
                roles = sorted(index.roles_of(fi.qualname))
                role_txt = (f"; reachable from thread roles "
                            f"{', '.join(roles)}" if roles else
                            "; engine entry points run on concurrent "
                            "session threads")
                reason = m.waiver_for(rule, n.lineno, n.end_lineno)
                out.append(Finding(
                    rule, rel, n.lineno,
                    f"{hit} without holding a lock — use a "
                    f"Tally-style wrapper or a with-lock block"
                    f"{role_txt}",
                    waived=reason is not None,
                    waiver_reason=reason or ""))
    return out


def _is_global_in(fn_node, name: str) -> bool:
    """AugAssign to a bare Name only touches the module global when the
    function declares it `global` (otherwise it's an unbound-local
    bug, not a race)."""
    for n in direct_nodes(fn_node):
        if isinstance(n, ast.Global) and name in n.names:
            return True
    return False


def _imported_module_global(index, module, alias: str,
                            attr: str) -> str | None:
    """Resolve `alias.attr += ...` to a module-level global of an
    imported package module (cross-module racy bump)."""
    dotted = module.imports.get(alias)
    if dotted is None and alias in module.from_imports:
        base, orig = module.from_imports[alias]
        dotted = f"{base}.{orig}" if base else orig
    if not dotted or not dotted.startswith(PACKAGE):
        return None
    tm = index._module_for_dotted(dotted)
    if tm is not None and attr in tm.global_assigns:
        return tm.relpath
    return None


def check_blocking_under_lock(index) -> list[Finding]:
    rule = "blocking-under-lock"
    out = []
    for rel, m in index.modules.items():
        if not rel.startswith(SCOPE_PREFIXES):
            continue
        for fi in m.functions.values():
            for n in direct_nodes(fi.node):
                if not isinstance(n, (ast.With, ast.AsyncWith)):
                    continue
                locks = [(_lockish_name(item.context_expr))
                         for item in n.items
                         if not isinstance(item.context_expr, ast.Call)]
                locks = [x for x in locks if x]
                if not locks:
                    continue
                for found in _blocking_in_block(index, m, fi, n):
                    attr, line, via = found
                    reason = (m.waiver_for(rule, line)
                              or m.waiver_for(rule, n.lineno))
                    via_txt = f" (via {via})" if via else ""
                    out.append(Finding(
                        rule, rel, line,
                        f".{attr}() reachable while holding "
                        f"{locks[0]}{via_txt}: blocking under a lock "
                        "convoys every session behind it (or "
                        "deadlocks if the release needs the lock)",
                        waived=reason is not None,
                        waiver_reason=reason or ""))
    return out


def _blocking_in_block(index, m, fi, with_node):
    """(attr, lineno, via) blocking call sites lexically inside the
    with-block, expanding one level into resolvable package callees
    (reported at the call site inside the block)."""
    hits = []
    sub_nodes = []
    stack = list(with_node.body)
    while stack:
        sn = stack.pop()
        if isinstance(sn, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)):
            continue  # nested defs run later, not under this lock
        sub_nodes.append(sn)
        stack.extend(ast.iter_child_nodes(sn))
    seen_calls = []
    for sn in sub_nodes:
        if not isinstance(sn, ast.Call):
            continue
        f = sn.func
        attr = _blocking_name(sn)
        if attr is not None:
            hits.append((attr, sn.lineno, ""))
        else:
            seen_calls.append(sn)
    # one-level expansion: a call in the block whose package callee
    # itself blocks still holds the lock while blocked
    for c in seen_calls:
        desc = _call_descriptor(c)
        if desc is None:
            continue
        callees = index.resolve_call(fi, desc)
        if len(callees) != 1:
            continue  # ambiguous mixin fan-out: too noisy to expand
        callee = callees[0]
        for cn in direct_nodes(callee.node):
            if isinstance(cn, ast.Call):
                cattr = _blocking_name(cn)
                if cattr is not None:
                    hits.append((cattr, c.lineno,
                                 f"{callee.dotted}:{cn.lineno}"))
    return hits


def _blocking_name(call: ast.Call) -> str | None:
    """The call's name when it is a host wait (BLOCKING_ATTRS) or waits
    on the card (core.device_wait)."""
    f = call.func
    attr = (f.attr if isinstance(f, ast.Attribute)
            else f.id if isinstance(f, ast.Name) else None)
    if attr in BLOCKING_ATTRS:
        return attr
    return device_wait(call)
