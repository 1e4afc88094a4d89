"""Shared analysis core: module index, call graph, thread roles.

The port's copy of cockroach_tpu/analysis/core.py, scanning
``cockroach_tpu_torch/``.

Every rule works off one ``ModuleIndex`` built from a single ``ast``
parse per file. The index records, per module: the parse tree, raw
source lines, waiver comments (``# graftlint: waive[rule] reason`` —
``ast`` drops comments, so these are recovered from the raw lines),
import aliases, module-level global bindings, and every function /
method (nested functions included) with its outgoing call sites.

On top of that the index derives:

- a best-effort **call graph** (module-level names, ``from``-imports,
  ``self.`` methods with package-wide mixin resolution — Engine is
  assembled from mixins across exec/ modules, so ``self.X`` must
  resolve across files);
- a **thread-role map**: every ``threading.Thread(target=...)`` spawn
  site seeds its target function with a role (the thread's ``name=``
  kwarg when it is a literal), as does the function handed to
  ``run_sharded`` (it runs on the shard threads), plus a hard seed for
  the pgwire per-connection handler
  (spawned by ``ThreadingTCPServer``, which a spawn-site scan cannot
  see). Roles propagate along call-graph edges, so "which threads can
  reach this function" is a lookup.
"""

from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass, field

PACKAGE = "cockroach_tpu_torch"

WAIVER_RE = re.compile(r"#\s*graftlint:\s*waive\[([a-z0-9_-]+)\]\s*(.*)$")

# thread-role seeds the spawn-site scan cannot discover mechanically:
# pgwire sessions are spawned by socketserver.ThreadingTCPServer, not
# by a threading.Thread(target=...) call in this package.
HARD_ROLE_SEEDS = {
    (f"{PACKAGE}/server/pgwire.py", "serve", "_Conn"): "pgwire-session",
}

# calls that run a function argument on threads of their own:
# name -> (positional index, keyword, role); the shard threads of
# parallel/collective.py run ``fn`` once a slot
THREAD_RUNNERS = {"run_sharded": (1, "fn", "shard")}


@dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str          # repo-relative, e.g. cockroach_tpu_torch/exec/x.py
    line: int
    message: str
    waived: bool = False
    waiver_reason: str = ""

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "waived": self.waived,
            "waiver_reason": self.waiver_reason,
        }

    def format(self) -> str:
        tag = f" [waived: {self.waiver_reason}]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


@dataclass
class FunctionInfo:
    """One function or method (nested defs get their own entry)."""

    qualname: str            # relpath::dotted  (CPython-style <locals>)
    name: str                # bare name
    dotted: str              # e.g. _MeshDispatcher._loop
    relpath: str
    node: object             # ast.FunctionDef | ast.AsyncFunctionDef
    cls: str | None          # innermost enclosing class name, if any
    # outgoing call sites, nested defs excluded:
    #   ("name", fname, lineno)       bare-name call
    #   ("self", meth, lineno)        self.meth(...)
    #   ("mod", alias, attr, lineno)  alias.attr(...)
    #   ("attr", attr, lineno)        <anything-deeper>.attr(...)
    calls: list = field(default_factory=list)


def _parse_waivers(lines: list[str]) -> dict[int, list[tuple[str, str]]]:
    """Map effective source line -> [(rule, reason)].

    A waiver on a code line covers that line; a waiver on a
    comment-only line covers the next non-blank, non-comment line
    (so long reasons can sit above the statement they waive), and its
    reason runs on over the comment lines between (up to another
    waiver).
    """
    out: dict[int, list[tuple[str, str]]] = {}
    for i, raw in enumerate(lines, start=1):
        m = WAIVER_RE.search(raw)
        if not m:
            continue
        eff = i
        reason = [m.group(2).strip()]
        if raw[:m.start()].strip() == "":  # comment-only line
            j = i
            more = True
            while j < len(lines):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    eff = j + 1
                    break
                more = more and not WAIVER_RE.search(nxt)
                if more and nxt:
                    reason.append(nxt.lstrip("#").strip())
                j += 1
        out.setdefault(eff, []).append(
            (m.group(1), " ".join(r for r in reason if r)))
    return out


def _call_descriptor(node: ast.Call):
    f = node.func
    if isinstance(f, ast.Name):
        return ("name", f.id, node.lineno)
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name):
            if v.id == "self":
                return ("self", f.attr, node.lineno)
            return ("mod", v.id, f.attr, node.lineno)
        return ("attr", f.attr, node.lineno)
    return None


class Module:
    def __init__(self, relpath: str, path: pathlib.Path, source: str):
        self.relpath = relpath
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.waivers = _parse_waivers(self.lines)
        # alias -> dotted module name (absolute within the package)
        self.imports: dict[str, str] = {}
        # local name -> (dotted module, original name)
        self.from_imports: dict[str, tuple[str, str]] = {}
        self.functions: dict[str, FunctionInfo] = {}   # dotted -> info
        # module-level simple assignments: name -> value expr node
        self.global_assigns: dict[str, ast.AST] = {}
        self._index()

    # -- waiver lookup --------------------------------------------------------
    def waiver_for(self, rule: str, lineno: int,
                   end_lineno: int | None = None) -> str | None:
        """Reason string if the rule is waived anywhere on the span of
        the smallest statement containing the finding, else None — so
        a waiver above (or trailing anywhere in) a multi-line
        statement covers calls on its continuation lines."""
        start, end = self._stmt_span(lineno, end_lineno or lineno)
        for ln in range(start, end + 1):
            for r, reason in self.waivers.get(ln, ()):
                if r == rule:
                    return reason
        return None

    def _stmt_span(self, lineno: int, end_lineno: int) -> tuple[int, int]:
        if not hasattr(self, "_spans"):
            self._spans = sorted(
                ((n.lineno, n.end_lineno or n.lineno)
                 for n in ast.walk(self.tree) if isinstance(n, ast.stmt)
                 and not isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef))),
                key=lambda s: (s[1] - s[0]))
        for a, b in self._spans:
            if a <= lineno and end_lineno <= b:
                return a, b
        return lineno, end_lineno

    # -- indexing -------------------------------------------------------------
    def _dotted_package(self) -> str:
        # cockroach_tpu_torch/exec/engine.py -> cockroach_tpu_torch.exec
        parts = self.relpath[:-3].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts[:-1])

    def _resolve_relative(self, level: int, module: str | None) -> str:
        base = self._dotted_package().split(".")
        if level > 1:
            base = base[: len(base) - (level - 1)]
        return ".".join(base + ([module] if module else []))

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                mod = (self._resolve_relative(node.level, node.module)
                       if node.level else (node.module or ""))
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.from_imports[a.asname or a.name] = (mod, a.name)
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.global_assigns.setdefault(t.id, stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    self.global_assigns.setdefault(stmt.target.id, stmt.value)
        self._walk_defs(self.tree.body, prefix="", cls=None)

    def _walk_defs(self, body, prefix: str, cls: str | None) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                dotted = prefix + stmt.name
                fi = FunctionInfo(
                    qualname=f"{self.relpath}::{dotted}", name=stmt.name,
                    dotted=dotted, relpath=self.relpath, node=stmt, cls=cls)
                fi.calls = [
                    d for n in direct_nodes(stmt)
                    if isinstance(n, ast.Call)
                    and (d := _call_descriptor(n)) is not None]
                self.functions[dotted] = fi
                self._walk_defs(stmt.body,
                                prefix=dotted + ".<locals>.", cls=cls)
            elif isinstance(stmt, ast.ClassDef):
                self._walk_defs(stmt.body, prefix=prefix + stmt.name + ".",
                                cls=stmt.name)
            elif hasattr(stmt, "body"):
                self._walk_defs(getattr(stmt, "body", []), prefix, cls)
                for attr in ("orelse", "finalbody", "handlers"):
                    sub = getattr(stmt, attr, [])
                    for s in sub:
                        if isinstance(s, ast.excepthandler):
                            self._walk_defs(s.body, prefix, cls)
                    if sub and not isinstance(sub[0], ast.excepthandler):
                        self._walk_defs(sub, prefix, cls)


def direct_nodes(fn_node):
    """All AST nodes lexically in `fn_node`, nested function/class
    defs excluded (their bodies belong to their own FunctionInfo).
    Every rule walks the same functions, so the list is kept on the
    node after its first walk: callers must not change it."""
    memo = getattr(fn_node, "_graftlint_direct", None)
    if memo is not None:
        return memo
    out = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    fn_node._graftlint_direct = out
    return out


def const_str(node, hole: str = "0") -> str | None:
    """The literal value of a str Constant or JoinedStr, each formatted
    value replaced by ``hole`` ('0' for thread labels; metric names pass
    PLACEHOLDER so a dynamic name keeps its holes)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append(hole)
        return "".join(parts)
    return None


# the hole an f-string's formatted value leaves in a metric name
PLACEHOLDER = "{}"

# the device argument of a .to(...) call: a literal device string or a
# name that says device
_DEVICE_STR = re.compile(r"(cpu|cuda|meta)(:\d+)?")


def _names_a_device(node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _DEVICE_STR.fullmatch(node.value) is not None
    if isinstance(node, ast.Call):
        f = node.func
        return isinstance(f, ast.Attribute) and f.attr == "device"
    name = (node.id if isinstance(node, ast.Name) else
            node.attr if isinstance(node, ast.Attribute) else "")
    return "dev" in name.lower()


def device_wait(call: ast.Call) -> str | None:
    """The name of a call that waits on the card or copies to or from
    it, by a name only torch gives such calls: ``synchronize`` (on
    torch.cuda, an event or a stream), ``.cpu()``, ``.cuda(...)``, and
    ``.to(...)`` given a device or ``non_blocking``. ``.item()``,
    ``.tolist()`` and ``.numpy()`` are not matched: numpy arrays share
    those names."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in ("synchronize", "cpu", "cuda"):
        return f.attr
    if f.attr == "to":
        if any(kw.arg in ("device", "non_blocking")
               for kw in call.keywords):
            return "to"
        if call.args and _names_a_device(call.args[0]):
            return "to"
    return None


class ModuleIndex:
    """The shared core every rule consumes."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.modules: dict[str, Module] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.methods: dict[str, list[FunctionInfo]] = {}
        self.call_graph: dict[str, set[str]] = {}
        self.thread_roles: dict[str, set[str]] = {}
        self.parse_errors: list[Finding] = []

    @classmethod
    def build(cls, root, relpaths=None) -> "ModuleIndex":
        root = pathlib.Path(root)
        idx = cls(root)
        if relpaths is None:
            relpaths = sorted(
                str(p.relative_to(root))
                for p in (root / PACKAGE).rglob("*.py"))
        for rel in relpaths:
            p = root / rel
            try:
                idx.modules[rel] = Module(rel, p, p.read_text())
            except SyntaxError as e:
                idx.parse_errors.append(Finding(
                    "parse-error", rel, e.lineno or 0, str(e)))
        for m in idx.modules.values():
            for fi in m.functions.values():
                idx.functions[fi.qualname] = fi
                if fi.cls is not None:
                    idx.methods.setdefault(fi.name, []).append(fi)
        idx._build_call_graph()
        idx._classify_thread_roles()
        return idx

    # -- call graph -----------------------------------------------------------
    def _module_for_dotted(self, dotted: str) -> Module | None:
        rel = dotted.replace(".", "/") + ".py"
        if rel in self.modules:
            return self.modules[rel]
        rel = dotted.replace(".", "/") + "/__init__.py"
        return self.modules.get(rel)

    def resolve_call(self, caller: FunctionInfo, desc) -> list[FunctionInfo]:
        m = self.modules[caller.relpath]
        kind = desc[0]
        if kind == "name":
            fname = desc[1]
            # a nested def in the caller or any enclosing scope
            # (sibling nested functions share the parent's scope)
            scope = caller.dotted
            while scope:
                nested = m.functions.get(scope + ".<locals>." + fname)
                if nested is not None:
                    return [nested]
                scope = (scope.rsplit(".<locals>.", 1)[0]
                         if ".<locals>." in scope else "")
            if fname in m.functions:
                return [m.functions[fname]]
            if fname in m.from_imports:
                mod, orig = m.from_imports[fname]
                tm = self._module_for_dotted(mod)
                if tm is not None and orig in tm.functions:
                    return [tm.functions[orig]]
                # `from ..pkg import submodule` style: the name IS a
                # module; calls through it are attribute calls, so
                # nothing to resolve here
            return []
        if kind == "self":
            meth = desc[1]
            if caller.cls is not None:
                same = [f for f in m.functions.values()
                        if f.cls == caller.cls and f.name == meth]
                if same:
                    return same
            # mixin resolution: Engine's mixins live in other modules
            return self.methods.get(meth, [])
        if kind == "mod":
            alias, attr = desc[1], desc[2]
            mod = m.imports.get(alias)
            if mod is None and alias in m.from_imports:
                base, orig = m.from_imports[alias]
                mod = f"{base}.{orig}" if base else orig
            if mod is not None:
                tm = self._module_for_dotted(mod)
                if tm is not None and attr in tm.functions:
                    return [tm.functions[attr]]
            return []
        return []

    def _build_call_graph(self) -> None:
        for fi in self.functions.values():
            edges = self.call_graph.setdefault(fi.qualname, set())
            for desc in fi.calls:
                for callee in self.resolve_call(fi, desc):
                    edges.add(callee.qualname)

    # -- thread roles ---------------------------------------------------------
    @staticmethod
    def _spawned_target(n: ast.Call):
        """(target expr, literal label or None) when the call runs a
        function on another thread: ``threading.Thread(target=...)``
        or a THREAD_RUNNERS call."""
        f = n.func
        fname = (f.id if isinstance(f, ast.Name) else
                 f.attr if isinstance(f, ast.Attribute) else None)
        if fname == "Thread" and (
                isinstance(f, ast.Name)
                or (isinstance(f.value, ast.Name)
                    and f.value.id == "threading")):
            target = label = None
            for kw in n.keywords:
                if kw.arg == "target":
                    target = kw.value
                elif kw.arg == "name":
                    label = const_str(kw.value)
            return target, label
        if fname in THREAD_RUNNERS:
            pos, kwname, role = THREAD_RUNNERS[fname]
            if len(n.args) > pos:
                return n.args[pos], role
            for kw in n.keywords:
                if kw.arg == kwname:
                    return kw.value, role
        return None, None

    def _thread_spawn_seeds(self):
        """(target FunctionInfo, role label) per spawn site in the
        package (see _spawned_target)."""
        seeds = []
        for m in self.modules.values():
            for fi in m.functions.values():
                for n in direct_nodes(fi.node):
                    if not isinstance(n, ast.Call):
                        continue
                    target, label = self._spawned_target(n)
                    if target is None:
                        continue
                    if isinstance(target, ast.Name):
                        desc = ("name", target.id, n.lineno)
                        tname = target.id
                    elif (isinstance(target, ast.Attribute)
                          and isinstance(target.value, ast.Name)
                          and target.value.id == "self"):
                        desc = ("self", target.attr, n.lineno)
                        tname = target.attr
                    else:
                        continue  # e.g. self._server.serve_forever
                    if label:
                        label = label.strip("-_0 ")
                    else:
                        stem = pathlib.PurePath(m.relpath).stem
                        label = f"{stem}.{tname}"
                    for tgt in self.resolve_call(fi, desc):
                        seeds.append((tgt, label))
        return seeds

    def _classify_thread_roles(self) -> None:
        seeds = self._thread_spawn_seeds()
        for (rel, fname, cls), role in HARD_ROLE_SEEDS.items():
            m = self.modules.get(rel)
            if m is None:
                continue
            for fi in m.functions.values():
                if fi.name == fname and fi.cls == cls:
                    seeds.append((fi, role))
        for fi, role in seeds:
            # BFS: everything reachable from the thread body runs on
            # that thread role
            queue = [fi.qualname]
            seen = set()
            while queue:
                q = queue.pop()
                if q in seen:
                    continue
                seen.add(q)
                if role in self.thread_roles.setdefault(q, set()):
                    continue
                self.thread_roles[q].add(role)
                queue.extend(self.call_graph.get(q, ()))

    def roles_of(self, qualname: str) -> set[str]:
        return self.thread_roles.get(qualname, set())
