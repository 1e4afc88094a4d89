"""Metric hygiene lints for the port, the counterpart of
tests/test_metric_lint.py over cockroach_tpu_torch/.

1. Static scan of every registration site in cockroach_tpu_torch/:
   metric names must be lowercase dotted ([a-z0-9._], an f-string's
   holes aside), and one name must not be registered under two metric
   kinds (a counter in one file and a gauge in another renders a
   nonsense /_status/vars).
2. Exposition-format checks on a synthetic registry of the port's
   utils/metric.py exercising every metric kind, including the
   cumulative-histogram encoding (`_bucket{le=...}` monotone, +Inf ==
   _count) and HELP escaping.
3. Doc-drift lints against cockroach_tpu_torch/OBSERVABILITY.md: every
   registered metric family must appear in its metric-families table,
   and every HTTP path served by server/node.py in its endpoint table.

The scans are the registration-drift rule's
(cockroach_tpu_torch/analysis/rules_registration.py).
"""

import re

import pytest

from cockroach_tpu_torch.analysis import ModuleIndex
from cockroach_tpu_torch.analysis.core import PLACEHOLDER
from cockroach_tpu_torch.analysis.rules_registration import (
    _CODE_SPAN, OBSERVABILITY, documented_endpoints, documented_families,
    is_documented, metric_registrations, name_shape_ok, repo_root,
    served_endpoints)
from cockroach_tpu_torch.utils.metric import MetricRegistry

pytestmark = pytest.mark.graftlint

REPO = repo_root()
DOC = (REPO / OBSERVABILITY).read_text()


@pytest.fixture(scope="module")
def index():
    return ModuleIndex.build(REPO)


@pytest.fixture(scope="module")
def registrations(index):
    """(file, kind-family, name) triples; an f-string keeps its holes as
    PLACEHOLDER."""
    return [(rel, family, name)
            for rel, family, name, _lineno in metric_registrations(index)]


class TestStaticNameLint:
    def test_scan_finds_the_registry(self, registrations):
        names = {n for _, _, n in registrations}
        # the scan must keep seeing the core families — an empty scan
        # would vacuously pass everything below
        assert len(names) >= 20
        for expect in ("rpc.frames.sent", "distsender.rpcs",
                       "breaker.peer.trips", "shuffle.bytes.sent",
                       "sql.exec.latency", "kernel.{}.launches",
                       "exec.oltp.lane.hits", "kv.groupcommit.proposals"):
            assert expect in names, f"scan lost {expect}"

    def test_names_are_lowercase_dotted(self, registrations):
        bad = [(f, n) for f, _, n in registrations if not name_shape_ok(n)]
        assert not bad, f"invalid metric names: {bad}"
        # a hole is kept as a hole, never collapsed into a '0'
        assert not [n for _, _, n in registrations
                    if re.search(r"(^|\.)0(\.|$)", n)]

    def test_no_name_registered_under_two_kinds(self, registrations):
        kinds: dict = {}
        for f, family, name in registrations:
            kinds.setdefault(name, {})[family] = f
        dups = {n: k for n, k in kinds.items() if len(k) > 1}
        assert not dups, f"metric kind collisions: {dups}"


class TestDocDrift:
    def test_doc_scan_finds_the_tables(self):
        exact, prefixes = documented_families(DOC)
        # an empty parse would vacuously pass the drift checks below
        assert len(exact) >= 20
        assert "sql." in prefixes
        for expect in ("rpc.frames.sent", "exec.device.hbm.bytes",
                       "exec.queue.depth", "kernel.groupagg_large.launches",
                       "kernel.groupagg.plain_calls",
                       f"{PLACEHOLDER}.trips",
                       f"breaker.peer.n{PLACEHOLDER}.trips"):
            assert expect in exact, f"doc parse lost {expect}"

    def test_registered_metrics_documented(self, registrations):
        exact, prefixes = documented_families(DOC)
        missing = sorted({n for _, _, n in registrations
                          if not is_documented(n, exact, prefixes)})
        assert not missing, (
            "metric families registered in code but missing from the "
            f"{OBSERVABILITY} table: {missing}")

    def test_served_endpoints_documented(self, index):
        served = {p for p, _lineno in served_endpoints(index)}
        assert "/debug/tracez" in served, "endpoint scan lost tracez"
        documented = documented_endpoints(DOC)
        missing = sorted(served - documented)
        assert not missing, (
            "HTTP endpoints served by server/node.py but missing "
            f"from the {OBSERVABILITY} endpoint table: {missing}")

    def test_fstring_names_match_by_prefix_or_alternatives(self):
        exact, prefixes = documented_families(DOC)
        hole = PLACEHOLDER
        for name in (f"kernel.{hole}.launches", f"kernel.{hole}.plain_calls",
                     f"sql.{hole}.count", f"{hole}.tripped",
                     "breaker.peer.n3.trips"):
            assert is_documented(name, exact, prefixes), name
        for name in (f"kernel.{hole}.builds", f"nope.{hole}.count",
                     "kernel.launches", "nope.total"):
            assert not is_documented(name, exact, prefixes), name


class TestDiagnosticsDocCoverage:
    """The statement-diagnostics surface and the families the port's
    first graftlint run found undocumented must be registered in code
    AND documented, so neither side can silently drop the other."""

    NEW_FAMILIES = ("exec.profile.statements", "exec.profile.operators",
                    "stmtdiag.armed", "stmtdiag.captured",
                    "stmtdiag.fetched", "exec.compile.plan_builds",
                    "exec.compile.prewarm_errors",
                    f"kernel.{PLACEHOLDER}.launches",
                    f"kernel.{PLACEHOLDER}.plain_calls",
                    "exec.oltp.lane.cdc_declines",
                    "kv.groupcommit.commands", "node.maintenance.errors")
    NEW_ENDPOINTS = ("/_status/stmtdiag", "/_status/tenants",
                     "/_status/nodes", "/_debug/ranges")

    def test_new_families_registered(self, registrations):
        regs = {n for _, _, n in registrations}
        for name in self.NEW_FAMILIES:
            assert name in regs, f"{name} no longer registered"

    def test_new_families_documented(self):
        exact, prefixes = documented_families(DOC)
        for name in self.NEW_FAMILIES:
            assert is_documented(name, exact, prefixes), \
                f"{name} missing from {OBSERVABILITY}"

    def test_endpoints_served_and_documented(self, index):
        served = {p for p, _lineno in served_endpoints(index)}
        documented = documented_endpoints(DOC)
        for ep in self.NEW_ENDPOINTS:
            assert ep in served, f"{ep} no longer served"
            assert ep in documented, f"{ep} missing from {OBSERVABILITY}"
        # the by-id fetch path (a startswith route, so its literal
        # carries the trailing slash)
        assert "/_status/stmtdiag/" in served
        assert "/_status/stmtdiag/" in documented

    def test_doc_span_regex_shared_with_rule(self):
        # the endpoint table parse and the metric table parse read the
        # same code spans the registration-drift rule reads
        assert _CODE_SPAN.findall("`a.b` and `/x/y`") == ["a.b", "/x/y"]


class TestExpositionFormat:
    def _registry(self):
        reg = MetricRegistry()
        reg.counter("lint.ops", "ops so far").inc(5)
        reg.gauge("lint.level", "current level").set(2.5)
        reg.func_counter("lint.fc", lambda: 7, "derived counter")
        reg.func_gauge("lint.fg", lambda: 1.5, "derived gauge")
        h = reg.histogram("lint.lat.seconds",
                          "latency\nwith newline \\ backslash")
        for v in (1e-6, 1e-3, 0.1, 0.1, 30.0):
            h.observe(v)
        return reg

    def test_type_lines_per_kind(self):
        text = self._registry().to_prometheus()
        assert "# TYPE lint_ops counter" in text
        assert "# TYPE lint_level gauge" in text
        assert "# TYPE lint_fc counter" in text
        assert "# TYPE lint_fg gauge" in text
        assert "# TYPE lint_lat_seconds histogram" in text
        assert "lint_fc 7" in text and "lint_fg 1.5" in text

    def test_help_newlines_escaped(self):
        text = self._registry().to_prometheus()
        for ln in text.splitlines():
            if ln.startswith("# HELP lint_lat_seconds"):
                assert "\\n" in ln and "\\\\" in ln
                break
        else:
            raise AssertionError("HELP line missing")

    def test_histogram_cumulative_buckets(self):
        text = self._registry().to_prometheus()
        buckets = []
        inf = count = None
        for ln in text.splitlines():
            m = re.match(
                r'lint_lat_seconds_bucket\{le="([^"]+)"\} (\d+)', ln)
            if m:
                if m.group(1) == "+Inf":
                    inf = int(m.group(2))
                else:
                    buckets.append((float(m.group(1)),
                                    int(m.group(2))))
            elif ln.startswith("lint_lat_seconds_count "):
                count = int(ln.split()[-1])
        assert count == 5 and inf == 5
        # bounds ascending, counts cumulative (monotone nondecreasing)
        assert [b for b, _ in buckets] == \
            sorted(b for b, _ in buckets)
        cs = [c for _, c in buckets]
        assert cs == sorted(cs) and cs[-1] <= 5
        # the two 0.1s observations land in a bucket whose bound
        # covers 0.1, so some cumulative step jumps by >= 2
        steps = [b - a for a, b in zip([0] + cs, cs + [5])]
        assert max(steps) >= 2

    def test_every_sample_line_well_formed(self):
        text = self._registry().to_prometheus()
        sample = re.compile(
            r'^[a-z_][a-z0-9_]*(\{le="[^"]+"\})? '
            r'(-?[0-9.eE+]+|-?inf|nan)$')
        for ln in text.splitlines():
            if ln.startswith("#") or not ln.strip():
                continue
            assert sample.match(ln), f"malformed: {ln!r}"
