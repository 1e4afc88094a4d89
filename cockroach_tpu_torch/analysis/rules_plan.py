"""plan-key-completeness: session vars read during plan compilation
must be in the plan-cache key or a documented whitelist.

The compiled-plan cache (exec/engine.py ``_prepare_select``) hands a
previously built plan to any statement whose key matches. A
session var that changes what gets compiled but is missing from the
key silently serves a plan compiled under someone else's settings —
exactly the class of bug the cold-start PR chased when the prewarm
replayed journal entries without the plan-key-changing vars (engine's
``_on_exec_miss`` journal is the runtime shadow of this rule).

Statically: every literal ``session.vars.get("X")`` read reachable
from ``_prepare_select`` (through resolvable package callees, and the
callbacks it hands on as lambdas, such as the exec cache's ``miss=``)
must either flow into the ``key = (...)`` tuple via a traced local
assignment, or fill a field of ``ExecParams`` that enters the key as
``params.<field>`` (``_exec_params`` builds the parameters the key
takes), or appear in WHITELIST below with the argument for why the
built plan is identical across the var's values ("bit-identical by
construction", the ``pallas_autotune`` launch-point precedent: launch
points change speed, never results, so two sessions differing only in
autotune mode can share one plan).

The whitelist is itself checked: an entry whose var is no longer read
anywhere in the prepare closure is reported as drift, so stale
justifications can't accumulate.
"""

from __future__ import annotations

import ast

from .core import PACKAGE, Finding, _call_descriptor, direct_nodes

PREPARE_MODULE = f"{PACKAGE}/exec/engine.py"
PREPARE_FUNC = "_prepare_select"
KEY_NAME = "key"
# the plan parameters' class: a read that fills one of its fields
# counts as keyed when the key takes that field
PARAMS_CLASS = "ExecParams"
# where plan building lives: the closure stays inside these trees
CLOSURE_PREFIXES = (f"{PACKAGE}/exec/", f"{PACKAGE}/distsql/")

# var -> why the compiled program is correct without this var in the
# key. Every entry must keep being read somewhere in the prepare
# closure or the rule reports it as drift.
WHITELIST = {
    "streaming": (
        "the stream verdict object produced from it IS a key element "
        "(`stream`); the raw var adds nothing the verdict misses"),
    "streaming_page_rows": (
        "folded into the stream verdict's page bucket, which is a key "
        "element"),
    "spill": (
        "the spill verdict object produced from it is a key element"),
    "distsql": (
        "the distributed `decision` is keyed as `decision is not "
        "None`; shard programs key separately per worker"),
    "optimizer": (
        "plan-shaping: a different memo verdict yields a structurally "
        "different plan, captured by the plan_fingerprint / "
        "hash(repr(node)) key element"),
    "optimizer_rules": (
        "plan-shaping like `optimizer`: structural change is captured "
        "by the plan fingerprint key element"),
    "optimizer_sketch_stats": (
        "plan-shaping like `optimizer`: sketch-fed join orders change "
        "the plan tree, captured by the plan fingerprint"),
    "pallas_autotune": (
        "tile parameters are perf-only and bit-identical by "
        "construction across the candidate grid (the documented "
        "precedent this whitelist generalizes)"),
    "plan_shape_cache": (
        "selects which keytext/psig FORM the key takes; both forms "
        "are self-consistent key elements, so entries cannot collide "
        "across modes"),
}


def _vars_get_name(node: ast.Call) -> str | None:
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr == "get"
            and isinstance(f.value, ast.Attribute)
            and f.value.attr == "vars"):
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value
    return None


def _params_fields(fn_node, call: ast.Call, targets: list) -> set:
    """The PARAMS_CLASS fields a read fills in this function: keyword
    arguments of a ``PARAMS_CLASS(...)`` call whose value holds the
    read itself or a name it was assigned to."""
    fields = set()
    for n in direct_nodes(fn_node):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == PARAMS_CLASS):
            continue
        for kw in n.keywords:
            if kw.arg is None:
                continue
            for sub in ast.walk(kw.value):
                if sub is call or (isinstance(sub, ast.Name)
                                   and sub.id in targets):
                    fields.add(kw.arg)
                    break
    return fields


def _reads_in(fn_node):
    """(var, assigned-target-names, params fields, lineno) for every
    literal session var read lexically in the function."""
    out = []
    assigned_ids = set()
    for n in direct_nodes(fn_node):
        if isinstance(n, ast.Assign):
            targets = [t.id for t in n.targets if isinstance(t, ast.Name)]
            for c in ast.walk(n.value):
                if not isinstance(c, ast.Call):
                    continue
                assigned_ids.add(id(c))
                v = _vars_get_name(c)
                if v is not None:
                    out.append((v, targets,
                                _params_fields(fn_node, c, targets),
                                n.lineno))
    # reads not captured by a simple assignment (conditions, call args)
    for c in direct_nodes(fn_node):
        if isinstance(c, ast.Call) and id(c) not in assigned_ids:
            v = _vars_get_name(c)
            if v is not None:
                out.append((v, [], _params_fields(fn_node, c, []),
                            c.lineno))
    return out


def _key_tuple(fn_node):
    """(bare names, ``x.field`` attribute names) in the function's
    ``key = (...)`` tuple."""
    names: set[str] = set()
    fields: set[str] = set()
    for n in direct_nodes(fn_node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and n.targets[0].id == KEY_NAME \
                and isinstance(n.value, ast.Tuple):
            for sub in ast.walk(n.value):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
                elif isinstance(sub, ast.Attribute) \
                        and isinstance(sub.value, ast.Name):
                    fields.add(sub.attr)
    return names, fields


def _anchor(index):
    """The _prepare_select FunctionInfo(s) — methods index under their
    class's dotted name, so match by bare name."""
    m = index.modules.get(PREPARE_MODULE)
    if m is None:
        return []
    return [fi for fi in m.functions.values() if fi.name == PREPARE_FUNC]


def _lambda_callees(index, fi):
    """Package functions called inside the lambdas lexically in ``fi``
    (callbacks such as the exec cache's ``miss=``, which run inside the
    call they are handed to)."""
    out = []
    lambdas = []
    stack = list(ast.iter_child_nodes(fi.node))
    while stack:   # fi's own lambdas: nested defs have their own
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(n, ast.Lambda):
            lambdas.append(n)
        stack.extend(ast.iter_child_nodes(n))
    for lam in lambdas:
        for c in ast.walk(lam.body):
            if isinstance(c, ast.Call):
                desc = _call_descriptor(c)
                if desc is not None:
                    out.extend(index.resolve_call(fi, desc))
    return out


def _prepare_closure(index):
    """FunctionInfos reachable from _prepare_select through resolvable
    package callees and lambda callbacks (bounded depth; exec/ and
    distsql/ only, where plan building lives)."""
    roots = _anchor(index)
    if not roots:
        return []
    seen = {r.qualname for r in roots}
    frontier = list(roots)
    out = list(roots)
    for _ in range(4):
        nxt = []
        for fi in frontier:
            callees = [index.functions[q]
                       for q in sorted(index.call_graph.get(fi.qualname,
                                                            ()))]
            for callee in callees + _lambda_callees(index, fi):
                if callee.qualname in seen:
                    continue
                seen.add(callee.qualname)
                if callee.relpath.startswith(CLOSURE_PREFIXES):
                    nxt.append(callee)
                    out.append(callee)
        frontier = nxt
    return out


def check_plan_key_completeness(index) -> list[Finding]:
    rule = "plan-key-completeness"
    out: list[Finding] = []
    if index.modules.get(PREPARE_MODULE) is None:
        return out  # fixture scan without the engine: nothing to check
    anchors = _anchor(index)
    if not anchors:
        # the rule must never silently no-op on a rename: losing the
        # anchor IS a finding
        out.append(Finding(
            rule, PREPARE_MODULE, 1,
            f"anchor function {PREPARE_FUNC!r} not found in "
            f"{PREPARE_MODULE}: plan-key-completeness cannot verify "
            "the plan cache — update rules_plan.PREPARE_FUNC"))
        return out
    closure = _prepare_closure(index)
    # the key tuple may live in a helper of the anchor (today it is in
    # _prepare_select itself); find it inside the closure
    key_fn, key_names, key_fields = None, set(), set()
    for fi in closure:
        if fi.relpath != PREPARE_MODULE:
            continue
        names, fields = _key_tuple(fi.node)
        if names or fields:
            key_fn, key_names, key_fields = fi, names, fields
            break
    if key_fn is None:
        out.append(Finding(
            rule, PREPARE_MODULE, anchors[0].node.lineno,
            f"could not locate the `{KEY_NAME} = (...)` plan-cache "
            f"key tuple in the {PREPARE_FUNC} closure; the rule "
            "cannot verify key completeness"))
        return out
    read_anywhere: set[str] = set()
    for fi in closure:
        fm = index.modules[fi.relpath]
        direct = fi.qualname == key_fn.qualname
        for var, targets, fields, lineno in _reads_in(fi.node):
            read_anywhere.add(var)
            if direct and any(t in key_names for t in targets):
                continue  # traced into the key tuple
            if fields & key_fields:
                continue  # fills a plan parameter the key takes
            if var in WHITELIST:
                continue
            reason = fm.waiver_for(rule, lineno)
            out.append(Finding(
                rule, fi.relpath, lineno,
                f"session var {var!r} is read during plan "
                f"compilation ({fi.dotted}) but neither flows into "
                "the plan-cache key tuple (nor fills a "
                f"{PARAMS_CLASS} field the key takes) nor appears in the "
                "bit-identical whitelist (rules_plan.WHITELIST): a "
                "cached plan compiled under a different setting "
                "would be served silently",
                waived=reason is not None,
                waiver_reason=reason or ""))
    for var in sorted(set(WHITELIST) - read_anywhere):
        out.append(Finding(
            rule, PREPARE_MODULE, anchors[0].node.lineno,
            f"whitelist drift: {var!r} has a bit-identical "
            "justification in rules_plan.WHITELIST but is no longer "
            "read anywhere in the prepare closure — delete the entry "
            "or re-wire the read"))
    return out
