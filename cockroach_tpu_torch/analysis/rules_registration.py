"""registration-drift: metrics, settings, session vars, endpoints.

One scanning core for "is this name registered AND documented", read
against the port's own doc, cockroach_tpu_torch/OBSERVABILITY.md:

- **metric names**: every ``.counter/.gauge/.histogram/.func_counter/
  .func_gauge`` registration with a literal (or f-string) name must be
  lowercase dotted, must not be registered under two different metric
  kinds (a counter in one file and a gauge in another renders a
  nonsense /_status/vars), and must appear in the doc's
  metric-families table. An f-string keeps its holes (``kernel.{}.
  launches``): it is documented by a ``fam.*`` prefix its static head
  falls under, by brace alternatives it matches (``kernel.{groupagg_
  large,groupagg}.launches``) or by the same placeholder shape
  (``{prefix}.trips``) — never as a ``0``.
- **HTTP endpoints**: every route literal served by server/node.py
  must appear in the doc's endpoint table.
- **cluster settings**: every ``Settings.register(...)`` call must
  carry a non-empty description (the reference refuses undocumented
  settings the same way) and a lowercase dotted name.
- **session vars**: every literal ``vars.get("x")`` / ``vars.set("x")``
  in the package must name a var registered in the SessionVars
  defaults dict — an unregistered read silently returns its local
  fallback forever, invisible to SHOW and to the prewarm journal.

  The port's first run found three: ``index_scan``,
  ``index_lookup_limit`` and ``oltp_batch`` were read with local
  fallbacks but never registered, so ``SHOW`` of each raised. They are
  now in the SessionVars defaults with the reference's values.
"""

from __future__ import annotations

import ast
import pathlib
import re

from .core import PACKAGE, PLACEHOLDER, Finding, const_str

METRIC_METHODS = {"counter": "counter", "gauge": "gauge",
                  "histogram": "histogram", "func_counter": "counter",
                  "func_gauge": "gauge"}

NAME_SHAPE = re.compile(r"[a-z0-9._]+")
_CODE_SPAN = re.compile(r"`([^`]+)`")

OBSERVABILITY = f"{PACKAGE}/OBSERVABILITY.md"
SETTINGS_MODULE = f"{PACKAGE}/utils/settings.py"
NODE_MODULE = f"{PACKAGE}/server/node.py"
ENDPOINT_SHAPE = re.compile(r"/[a-zA-Z_][a-zA-Z0-9_/]*")
# what a placeholder stands for when a name is matched against one
_HOLE = "[a-z0-9_.]+"


# -- scans (shared with tests/test_torch_metric_lint.py) ---------------------

def metric_registrations(index):
    """(relpath, kind-family, normalized name, lineno) for every
    literal metric registration in the package."""
    out = []
    for rel, m in sorted(index.modules.items()):
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in METRIC_METHODS
                    and node.args):
                continue
            name = const_str(node.args[0], PLACEHOLDER)
            if name is None:
                continue
            out.append((rel, METRIC_METHODS[node.func.attr], name,
                        node.lineno))
    return out


def name_shape_ok(name: str) -> bool:
    """Lowercase dotted, placeholders aside."""
    return NAME_SHAPE.fullmatch(name.replace(PLACEHOLDER, "x")) is not None


def expand_brace_alts(s: str) -> list[str]:
    """`a.{x,y}.b` -> [a.x.b, a.y.b] (recursive cartesian product)."""
    m = re.search(r"\{([^{}]*,[^{}]*)\}", s)
    if not m:
        return [s]
    out = []
    for alt in m.group(1).split(","):
        out.extend(expand_brace_alts(
            s[:m.start()] + alt.strip() + s[m.end():]))
    return out


def documented_families(observability_text: str):
    """(names, prefix wildcards) from the doc's code spans, normalized
    like metric_registrations normalizes f-strings: `{a,b}` alternation
    expands, a leftover `{x}` placeholder becomes PLACEHOLDER, `fam.*`
    is a prefix wildcard."""
    exact, prefixes = set(), []
    for span in _CODE_SPAN.findall(observability_text):
        span = span.strip()
        if not re.fullmatch(r"[a-z0-9._{},* ]+", span):
            continue
        for name in expand_brace_alts(span):
            name = re.sub(r"\{[^}]*\}", PLACEHOLDER, name).strip()
            if name.endswith(".*"):
                prefixes.append(name[:-1])      # keep the dot
            elif name_shape_ok(name):
                exact.add(name)
    return exact, prefixes


def _pattern(name: str):
    return re.compile(_HOLE.join(re.escape(p)
                                 for p in name.split(PLACEHOLDER)))


def is_documented(name: str, exact: set, prefixes) -> bool:
    """A registered name (holes as PLACEHOLDER) against the doc: equal
    to a documented name or shape, under a ``fam.*`` prefix (an
    f-string by its static head), matching a documented placeholder, or
    an f-string matching a documented name (brace alternatives)."""
    if name in exact:
        return True
    head = name.split(PLACEHOLDER, 1)[0]
    if any(head.startswith(p) for p in prefixes):
        return True
    if PLACEHOLDER in name:
        pat = _pattern(name)
        return any(pat.fullmatch(d) for d in exact if PLACEHOLDER not in d)
    return any(_pattern(d).fullmatch(name) for d in exact
               if PLACEHOLDER in d)


def served_endpoints(index):
    """(path literal, lineno) route strings served by server/node.py."""
    m = index.modules.get(NODE_MODULE)
    if m is None:
        return []
    out = []
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ENDPOINT_SHAPE.fullmatch(node.value):
            out.append((node.value, node.lineno))
    return out


def documented_endpoints(observability_text: str) -> set:
    return {s.split("?")[0] for s in _CODE_SPAN.findall(observability_text)
            if s.startswith("/")}


def cluster_setting_registrations(index):
    """(name, lineno, description) per Settings.register(...) call."""
    m = index.modules.get(SETTINGS_MODULE)
    if m is None:
        return []
    out = []
    for node in ast.walk(m.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "register" and node.args):
            continue
        name = const_str(node.args[0])
        if name is None:
            continue
        desc = None
        if len(node.args) >= 4:
            desc = const_str(node.args[3])
        for kw in node.keywords:
            if kw.arg == "description":
                desc = const_str(kw.value)
        out.append((name, node.lineno, desc or ""))
    return out


def registered_session_vars(index) -> set:
    """Keys of the SessionVars defaults dict, parsed statically."""
    m = index.modules.get(SETTINGS_MODULE)
    if m is None:
        return set()
    for node in ast.walk(m.tree):
        if isinstance(node, ast.ClassDef) and node.name == "SessionVars":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    keys = {const_str(k) for k in sub.keys
                            if k is not None}
                    keys.discard(None)
                    if keys:
                        return keys
    return set()


def session_var_uses(index):
    """(relpath, var, lineno) for literal vars.get/vars.set sites."""
    out = []
    for rel, m in sorted(index.modules.items()):
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "set")
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr == "vars"
                    and node.args):
                continue
            name = node.args[0]
            if isinstance(name, ast.Constant) and isinstance(name.value,
                                                             str):
                out.append((rel, name.value, node.lineno))
    return out


# -- the rule -----------------------------------------------------------------

def check_registration_drift(index) -> list[Finding]:
    rule = "registration-drift"
    out: list[Finding] = []
    obs_path = index.root / OBSERVABILITY
    obs = obs_path.read_text() if obs_path.exists() else ""

    def emit(rel, lineno, msg):
        m = index.modules.get(rel)
        reason = m.waiver_for(rule, lineno) if m is not None else None
        out.append(Finding(rule, rel, lineno, msg,
                           waived=reason is not None,
                           waiver_reason=reason or ""))

    regs = metric_registrations(index)
    kinds: dict[str, dict[str, tuple]] = {}
    for rel, family, name, lineno in regs:
        if not name_shape_ok(name):
            emit(rel, lineno,
                 f"metric name {name!r} is not lowercase dotted "
                 "([a-z0-9._]+)")
        kinds.setdefault(name, {})[family] = (rel, lineno)
    for name, fams in kinds.items():
        if len(fams) > 1:
            rel, lineno = sorted(fams.values())[0]
            emit(rel, lineno,
                 f"metric {name!r} registered under multiple kinds "
                 f"{sorted(fams)}: /_status/vars would emit nonsense")
    exact, prefixes = documented_families(obs)
    for rel, _family, name, lineno in regs:
        if is_documented(name, exact, prefixes):
            continue
        emit(rel, lineno,
             f"metric family {name!r} is registered in code but "
             f"missing from the {OBSERVABILITY} metric-families table")

    doc_eps = documented_endpoints(obs)
    for path, lineno in served_endpoints(index):
        if path not in doc_eps:
            emit(NODE_MODULE, lineno,
                 f"HTTP endpoint {path!r} is served by server/node.py "
                 f"but missing from the {OBSERVABILITY} endpoint table")

    for name, lineno, desc in cluster_setting_registrations(index):
        if not desc.strip():
            emit(SETTINGS_MODULE, lineno,
                 f"cluster setting {name!r} registered without a "
                 "description")
        if not NAME_SHAPE.fullmatch(name):
            emit(SETTINGS_MODULE, lineno,
                 f"cluster setting name {name!r} is not lowercase "
                 "dotted")

    registered = registered_session_vars(index)
    if index.modules.get(SETTINGS_MODULE) is None:
        pass  # fixture/partial scan without the settings module
    elif registered:
        for rel, var, lineno in session_var_uses(index):
            if var not in registered:
                emit(rel, lineno,
                     f"session var {var!r} is read/set with a literal "
                     "name but not registered in the SessionVars "
                     "defaults (invisible to SHOW and the prewarm "
                     "journal)")
    else:
        out.append(Finding(
            rule, SETTINGS_MODULE, 1,
            "could not parse the SessionVars defaults dict; the "
            "session-var registration check cannot run"))
    return out


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent.parent
