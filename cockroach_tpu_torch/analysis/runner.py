"""Rule registry, file discovery, and output formatting.

Exit status is a bitmask: each rule with at least one unwaived finding
sets its bit (see RULES ordering), and malformed waivers (empty
reason) set WAIVER_SYNTAX_BIT — so CI can tell "aliasing regression"
from "doc drift" without parsing output. 0 means clean.

``--changed-only`` narrows *reporting* to files touched per git (both
unstaged and staged, plus untracked .py files); the index is still
built over the whole package because the call graph, thread roles,
and the registration tables are whole-program properties — a changed
file can introduce a violation whose finding lands in it, but the
analysis itself is never partial.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time

from .core import PACKAGE, Finding, ModuleIndex
from .rules_concurrency import (check_blocking_under_lock,
                                check_racy_global)
from .rules_device import (check_collective_discipline,
                           check_no_aliasing_upload)
from .rules_lease import check_lease_discipline
from .rules_plan import check_plan_key_completeness
from .rules_reactor import check_reactor_discipline
from .rules_registration import check_registration_drift

# (rule name, exit bit, checker). Order is the documented bit layout.
RULES = (
    ("no-aliasing-upload", 1, check_no_aliasing_upload),
    ("collective-discipline", 2, check_collective_discipline),
    ("racy-global", 4, check_racy_global),
    ("blocking-under-lock", 8, check_blocking_under_lock),
    ("plan-key-completeness", 16, check_plan_key_completeness),
    ("registration-drift", 32, check_registration_drift),
    ("lease-discipline", 64, check_lease_discipline),
    ("reactor-discipline", 128, check_reactor_discipline),
)
WAIVER_SYNTAX_BIT = 256


def changed_files(root) -> list[str] | None:
    """Repo-relative .py paths under cockroach_tpu_torch/ that git reports
    as modified/added/untracked; None when git is unavailable (callers
    fall back to a full report)."""
    try:
        txt = subprocess.run(
            ["git", "status", "--porcelain"], cwd=str(root),
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except Exception:
        return None
    out = []
    for line in txt.splitlines():
        path = line[3:].split(" -> ")[-1].strip().strip('"')
        if path.endswith(".py") and path.startswith(PACKAGE + "/"):
            out.append(path)
    return out


def _waiver_syntax_findings(index: ModuleIndex) -> list[Finding]:
    out = []
    for rel, m in index.modules.items():
        for line, entries in sorted(m.waivers.items()):
            for rule, reason in entries:
                if not reason.strip():
                    out.append(Finding(
                        "waiver-syntax", rel, line,
                        f"waiver for {rule!r} has no reason: every "
                        "waiver must say WHY the site is safe "
                        "(# graftlint: waive[rule] <reason>)"))
    return out


def run(root=None, rules=None, only_files=None, index=None) -> dict:
    """Run the checkers and return a report dict.

    root: repo root (default: the tree this package sits in).
    rules: iterable of rule names (default all).
    only_files: when set, findings are filtered to these repo-relative
        paths (the --changed-only mode); the index stays whole-program.
    index: a prebuilt ModuleIndex to reuse (tests share one build).
    """
    from .rules_registration import repo_root
    root = pathlib.Path(root) if root is not None else repo_root()
    t0 = time.perf_counter()
    if index is None:
        index = ModuleIndex.build(root)
    t_index = time.perf_counter() - t0
    wanted = set(rules) if rules is not None else {n for n, _, _ in RULES}
    findings: list[Finding] = list(index.parse_errors)
    timings: dict[str, float] = {}
    for name, _bit, fn in RULES:
        if name not in wanted:
            continue
        t1 = time.perf_counter()
        findings.extend(fn(index))
        timings[name] = time.perf_counter() - t1
    findings.extend(_waiver_syntax_findings(index))
    if only_files is not None:
        keep = set(only_files)
        findings = [f for f in findings if f.path in keep]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    exit_code = 0
    counts: dict[str, dict[str, int]] = {}
    for f in findings:
        c = counts.setdefault(f.rule, {"findings": 0, "waived": 0})
        c["findings"] += 1
        if f.waived:
            c["waived"] += 1
    for name, bit, _fn in RULES:
        c = counts.get(name)
        if c and c["findings"] > c["waived"]:
            exit_code |= bit
    ws = counts.get("waiver-syntax")
    if ws or counts.get("parse-error"):
        exit_code |= WAIVER_SYNTAX_BIT
    return {
        "root": str(root),
        "files": len(index.modules),
        "functions": len(index.functions),
        "findings": findings,
        "counts": counts,
        "timings": {"index_seconds": round(t_index, 3),
                    **{k: round(v, 3) for k, v in timings.items()},
                    "total_seconds": round(time.perf_counter() - t0, 3)},
        "exit_code": exit_code,
        "index": index,
    }


def render_human(report: dict, show_waived: bool = False) -> str:
    lines = []
    for f in report["findings"]:
        if f.waived and not show_waived:
            continue
        lines.append(f.format())
    t = report["timings"]
    summary = [
        f"graftlint: {report['files']} files, "
        f"{report['functions']} functions, "
        f"{t['total_seconds']:.2f}s "
        f"(index {t['index_seconds']:.2f}s)"]
    for name, _bit, _fn in RULES:
        c = report["counts"].get(name, {"findings": 0, "waived": 0})
        live = c["findings"] - c["waived"]
        summary.append(
            f"  {name}: {live} unwaived, {c['waived']} waived")
    ws = report["counts"].get("waiver-syntax", {"findings": 0})
    if ws["findings"]:
        summary.append(f"  waiver-syntax: {ws['findings']} malformed")
    summary.append(f"exit code: {report['exit_code']}")
    return "\n".join(lines + summary)


def render_json(report: dict) -> str:
    return json.dumps({
        "root": report["root"],
        "files": report["files"],
        "functions": report["functions"],
        "findings": [f.to_dict() for f in report["findings"]],
        "counts": report["counts"],
        "timings": report["timings"],
        "exit_code": report["exit_code"],
    }, indent=2, sort_keys=True)
