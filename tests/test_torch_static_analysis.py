"""graftlint for the port (cockroach_tpu_torch/analysis): the tier-1 gate
and self-tests, the counterpart of tests/test_static_analysis.py.

Four layers:

1. **The repo gate**: ``run()`` over the port's tree must report ZERO
   unwaived findings across all eight rules, and every waiver must carry
   a reason and name a real rule. Analyzer wall time and per-rule
   finding counts are printed so the tier-1 log shows what the gate cost
   and covered.
2. **Seeded-bad fixtures** in torch idioms: for each rule, a minimal
   violating snippet written into a throwaway package tree must be
   caught, its waived twin must pass, and a clean twin must report
   nothing.
3. **Core units**: thread roles (the pgwire session handler, the mesh
   dispatcher loop, the page-prefetch worker, the shard threads of
   ``run_sharded``), ``--changed-only`` file discovery, a self-scan and
   ``python -m cockroach_tpu_torch.analysis`` in a subprocess.
4. **Parity**: the fixtures of the rules whose idioms did not change
   with the port (racy-global, blocking-under-lock and
   reactor-discipline on host waits, lease-discipline, waiver parsing)
   are laid out once under ``cockroach_tpu/`` for the reference's
   analyzer and once under ``cockroach_tpu_torch/`` for the port's; both
   must report the same (rule, path below the package, line, waived).

Select just these with ``pytest -m graftlint``.
"""

import json
import subprocess
import sys
import textwrap

import pytest

from cockroach_tpu.analysis import run as ref_run
from cockroach_tpu_torch.analysis import (ModuleIndex, RULES, render_human,
                                          render_json, run)
from cockroach_tpu_torch.analysis import runner as runner_mod
from cockroach_tpu_torch.analysis import rules_plan
from cockroach_tpu_torch.analysis.runner import (WAIVER_SYNTAX_BIT,
                                                 changed_files)
from cockroach_tpu_torch.analysis.rules_registration import repo_root

pytestmark = pytest.mark.graftlint

REPO = repo_root()
PKG = "cockroach_tpu_torch"

RULE_NAMES = [name for name, _bit, _fn in RULES]


@pytest.fixture(scope="module")
def report():
    """One shared whole-tree analysis for every test in this module."""
    return run(root=REPO)


@pytest.fixture(scope="module")
def index(report):
    return report["index"]


def _tree(tmp_path, files: dict):
    """Materialize a throwaway package tree and return its root."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tmp_path


def _scan(tmp_path, files: dict, rules):
    return run(root=_tree(tmp_path, files), rules=rules)


def _unwaived(report, rule=None):
    return [f for f in report["findings"]
            if not f.waived and (rule is None or f.rule == rule)]


# ---------------------------------------------------------------------------
# 1. the repo gate
# ---------------------------------------------------------------------------

class TestRepoGate:
    def test_zero_unwaived_findings(self, report):
        summary = render_human(report, show_waived=True)
        # the tier-1 log carries the analyzer cost + coverage counts
        print(f"\n{summary}")
        t = report["timings"]
        print(f"graftlint gate (port): {report['files']} files in "
              f"{t['total_seconds']:.2f}s; "
              + "; ".join(
                  f"{n}={report['counts'].get(n, {}).get('findings', 0)}"
                  for n in RULE_NAMES))
        assert report["exit_code"] == 0, f"\n{summary}"
        assert not _unwaived(report), f"\n{summary}"
        assert report["files"] >= 150

    def test_all_eight_rules_ran(self, report):
        assert RULE_NAMES == [
            "no-aliasing-upload", "collective-discipline", "racy-global",
            "blocking-under-lock", "plan-key-completeness",
            "registration-drift", "lease-discipline", "reactor-discipline"]
        assert [bit for _n, bit, _f in RULES] == [1, 2, 4, 8, 16, 32, 64,
                                                  128]
        assert WAIVER_SYNTAX_BIT == 256
        for name in RULE_NAMES:
            assert name in report["timings"], f"{name} did not run"

    def test_every_waiver_has_a_reason(self, report, index):
        bad = [(rel, line, rule)
               for rel, m in index.modules.items()
               for line, entries in m.waivers.items()
               for rule, reason in entries if not reason.strip()]
        assert not bad, f"waivers without reasons: {bad}"
        waived = [f for f in report["findings"] if f.waived]
        assert waived and all(f.waiver_reason.strip() for f in waived)

    def test_waivers_name_real_rules(self, index):
        known = set(RULE_NAMES)
        bad = [(rel, line, rule)
               for rel, m in index.modules.items()
               # the analyzer's own sources quote the waiver syntax in
               # their docstrings; everything else must name a rule
               if not rel.startswith(f"{PKG}/analysis/")
               for line, entries in m.waivers.items()
               for rule, _reason in entries if rule not in known]
        assert not bad, f"waivers for unknown rules (typo?): {bad}"

    def test_render_json_round_trips(self, report):
        data = json.loads(render_json(report))
        assert data["exit_code"] == report["exit_code"]
        assert data["files"] == report["files"]
        assert data["functions"] == report["functions"]
        assert len(data["findings"]) == len(report["findings"])
        assert set(data["findings"][0]) == {
            "rule", "path", "line", "message", "waived", "waiver_reason"}
        assert set(data["timings"]) >= set(RULE_NAMES) | {
            "index_seconds", "total_seconds"}


# ---------------------------------------------------------------------------
# 2. seeded-bad fixtures, one set per rule, in torch idioms
# ---------------------------------------------------------------------------

BAD_FROM_NUMPY = """
    import torch

    def upload(buf):
        return torch.from_numpy(buf)
"""

BAD_ALIASED_SPELLINGS = """
    import torch as T
    from torch import as_tensor
    from torch import frombuffer as fb

    def upload(buf, raw):
        a = T.from_numpy(buf)
        b = as_tensor(buf)
        c = fb(raw, dtype=T.uint8)
        return a, b, c
"""

WAIVED_FROM_NUMPY = """
    import numpy as np
    import torch

    def upload(buf):
        fresh = np.concatenate([buf, buf])
        # graftlint: waive[no-aliasing-upload] fresh np.concatenate
        # above, never written after this conversion
        return torch.from_numpy(fresh)
"""

CLEAN_UPLOAD = """
    import numpy as np
    import torch

    def upload(buf, raw):
        keys = np.frombuffer(raw, dtype=np.int64)  # numpy, not torch
        return torch.tensor(buf), torch.tensor(keys)
"""


class TestNoAliasingUpload:
    RULE = ["no-aliasing-upload"]

    def test_bare_from_numpy_in_exec_is_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_FROM_NUMPY},
                  self.RULE)
        hits = _unwaived(r, "no-aliasing-upload")
        assert len(hits) == 1 and r["exit_code"] == 1
        assert "torch.from_numpy" in hits[0].message

    def test_every_spelling_is_caught(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/storage/bad.py": BAD_ALIASED_SPELLINGS},
                  self.RULE)
        hits = _unwaived(r, "no-aliasing-upload")
        assert [h.line for h in hits] == [7, 8, 9]
        assert {h.message.split()[0] for h in hits} == {
            "torch.from_numpy", "torch.as_tensor", "torch.frombuffer"}

    def test_waived_site_passes(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/waived.py": WAIVED_FROM_NUMPY},
                  self.RULE)
        assert r["exit_code"] == 0
        assert not _unwaived(r)
        assert r["counts"]["no-aliasing-upload"]["waived"] == 1
        (f,) = r["findings"]
        # a reason runs on over its comment lines
        assert f.waiver_reason == ("fresh np.concatenate above, never "
                                   "written after this conversion")

    def test_clean_and_out_of_scope_pass(self, tmp_path):
        r = _scan(tmp_path, {
            f"{PKG}/exec/clean.py": CLEAN_UPLOAD,
            # control plane: from_numpy is allowed outside the data plane
            f"{PKG}/server/ctl.py": BAD_FROM_NUMPY,
        }, self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_empty_reason_waiver_fails_the_gate(self, tmp_path):
        src = """
            import torch

            def upload(buf):
                # graftlint: waive[no-aliasing-upload]
                return torch.from_numpy(buf)
        """
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": src}, self.RULE)
        assert r["exit_code"] & WAIVER_SYNTAX_BIT
        assert any(f.rule == "waiver-syntax" for f in r["findings"])


BAD_RUN_SHARDED = """
    from ..parallel import collective

    def fanout(devices, fn):
        return collective.run_sharded(devices, fn)
"""

BAD_RENDEZVOUS_OBJECTS = """
    from ..parallel.collective import ShardAxis, _Rendezvous

    def private_axis(devices):
        return ShardAxis(), _Rendezvous(devices, 5.0)
"""

BAD_ESCAPED_MESH_FN = """
    from ..parallel.distagg import make_distributed_fn

    def plan(runf, mesh, aliases):
        dist = make_distributed_fn(runf, mesh, aliases)
        return dist  # escapes the dispatcher
"""

CLEAN_QUEUED_MESH_FN = """
    from ..parallel.distagg import (make_distributed_fn,
                                    queued_collective_call)

    def plan(runf, mesh, aliases):
        dist = make_distributed_fn(runf, mesh, aliases)
        return queued_collective_call(dist, mesh=mesh)

    def plan_inline(runf, mesh, aliases):
        return queued_collective_call(
            make_distributed_fn(runf, mesh, aliases), mesh=mesh)
"""

BAD_TCPSTORE = """
    import datetime

    import torch.distributed as dist

    def join(host, port, n, i):
        store = dist.TCPStore(host, port, n, i == 0,
                              timeout=datetime.timedelta(seconds=60))
        dist.init_process_group("gloo", store=store, world_size=n, rank=i)
"""

WAIVED_TEARDOWN = """
    import torch.distributed as dist

    def leave():
        # graftlint: waive[collective-discipline] test-only teardown of
        # a process group this process exclusively owns
        dist.destroy_process_group()
"""

CLEAN_WRAPPERS = """
    from ..parallel import multihost

    def join(coord, n, i):
        return multihost.init_distributed(coord, n, i)

    def leave():
        multihost.shutdown_distributed()
"""


class TestCollectiveDiscipline:
    RULE = ["collective-discipline"]

    def test_run_sharded_outside_dispatcher_home_is_caught(self,
                                                           tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_RUN_SHARDED},
                  self.RULE)
        hits = _unwaived(r, "collective-discipline")
        assert len(hits) == 1 and r["exit_code"] == 2
        assert "run_sharded" in hits[0].message

    def test_rendezvous_objects_outside_home_are_caught(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/distsql/bad.py": BAD_RENDEZVOUS_OBJECTS},
                  self.RULE)
        hits = _unwaived(r, "collective-discipline")
        assert sorted(h.message.split()[0] for h in hits) == \
            ["ShardAxis", "_Rendezvous"]

    def test_escaped_make_distributed_fn_is_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_ESCAPED_MESH_FN},
                  self.RULE)
        hits = _unwaived(r, "collective-discipline")
        assert len(hits) == 1
        assert "queued_collective_call" in hits[0].message

    def test_queued_flow_passes(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/ok.py": CLEAN_QUEUED_MESH_FN},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_dispatcher_and_definition_homes_are_exempt(self, tmp_path):
        r = _scan(tmp_path, {
            f"{PKG}/parallel/distagg.py": BAD_RUN_SHARDED,
            f"{PKG}/parallel/collective.py": BAD_RENDEZVOUS_OBJECTS,
        }, self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_store_and_process_group_outside_multihost_are_caught(
            self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/server/bad.py": BAD_TCPSTORE},
                  self.RULE)
        hits = _unwaived(r, "collective-discipline")
        assert len(hits) == 2 and r["exit_code"] == 2
        assert "TCPStore" in hits[0].message
        assert "init_process_group" in hits[1].message
        assert all("multihost" in h.message for h in hits)

    def test_waived_teardown_passes(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/server/waived.py": WAIVED_TEARDOWN},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)
        assert r["counts"]["collective-discipline"]["waived"] == 1

    def test_multihost_home_is_exempt(self, tmp_path):
        r = _scan(tmp_path, {
            f"{PKG}/parallel/multihost.py": BAD_TCPSTORE,
            # wrapper calls from anywhere else are the sanctioned path
            f"{PKG}/server/clean.py": CLEAN_WRAPPERS,
        }, self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)


BAD_RACY_GLOBAL = """
    SECONDS = [0.0]

    def note(dt):
        SECONDS[0] += dt
"""

CLEAN_LOCKED_GLOBAL = """
    import threading

    SECONDS = [0.0]
    _LOCK = threading.Lock()

    def note(dt):
        with _LOCK:
            SECONDS[0] += dt
"""

CLEAN_TALLY_GLOBAL = """
    from ..utils.metric import Tally

    RUNS = Tally()

    def note():
        RUNS.bump("hit")
"""

# the shape the port's first run found in ops/hashtable.py
BAD_ROUND_COUNT = """
    ROUNDS = {"build": 0, "probe": 0}

    def build(keys):
        rounds = len(keys)
        ROUNDS["build"] = rounds
        return keys
"""

CLEAN_RETURNED_COUNT = """
    def build(keys):
        rounds = len(keys)
        return keys, rounds
"""


class TestRacyGlobal:
    RULE = ["racy-global"]

    def test_unlocked_augassign_is_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_RACY_GLOBAL},
                  self.RULE)
        hits = _unwaived(r, "racy-global")
        assert len(hits) == 1 and r["exit_code"] == 4
        assert "SECONDS" in hits[0].message

    def test_locked_augassign_passes(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/ok.py": CLEAN_LOCKED_GLOBAL},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_tally_wrapper_is_exempt(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/ok.py": CLEAN_TALLY_GLOBAL},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_module_round_count_is_caught_and_return_is_clean(
            self, tmp_path):
        r = _scan(tmp_path, {
            f"{PKG}/ops/bad.py": BAD_ROUND_COUNT,
            f"{PKG}/ops/ok.py": CLEAN_RETURNED_COUNT}, self.RULE)
        hits = _unwaived(r, "racy-global")
        assert [(h.path, h.line) for h in hits] == [(f"{PKG}/ops/bad.py",
                                                     6)]
        assert "ROUNDS" in hits[0].message


BAD_UPLOAD_UNDER_LOCK = """
    import threading

    _LOCK = threading.Lock()

    def push(x, device):
        with _LOCK:
            return x.to(device, non_blocking=True)
"""

BAD_CARD_WAITS_UNDER_LOCK = """
    import threading

    import torch

    class Store:
        def __init__(self):
            self._lock = threading.Lock()

        def flush(self, t, ev):
            with self._lock:
                torch.cuda.synchronize()
                ev.synchronize()
                host = t.cpu()
                back = host.cuda()
                return back.to("cuda:0")
"""

BAD_HELPER_UNDER_LOCK = """
    import threading

    _LOCK = threading.Lock()

    def _fetch(t):
        return t.cpu()

    def read(t):
        with _LOCK:
            return _fetch(t)
"""

CLEAN_HOST_WORK_UNDER_LOCK = """
    import threading

    import numpy as np
    import torch

    _LOCK = threading.Lock()

    def stats(arr, t):
        with _LOCK:
            # numpy shares these names with torch: not matched by name
            lo = arr.min().item()
            vals = arr.tolist()
            view = np.asarray(arr).numpy() if hasattr(arr, "numpy") else arr
            # a dtype cast is not a copy to the card
            t64 = t.to(torch.int64)
        return lo, vals, view, t64
"""

CLEAN_UPLOAD_OUTSIDE_LOCK = """
    import threading

    _LOCK = threading.Lock()
    _CACHE = {}

    def push(key, x, device):
        with _LOCK:
            if key in _CACHE:
                return _CACHE[key]
        b = x.to(device, non_blocking=True)
        with _LOCK:
            _CACHE[key] = b
        return b
"""

CLEAN_CV_WAIT = """
    import threading

    _CV = threading.Condition()

    def park():
        with _CV:
            _CV.wait(timeout=1.0)
"""


class TestBlockingUnderLock:
    RULE = ["blocking-under-lock"]

    def test_upload_under_lock_is_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_UPLOAD_UNDER_LOCK},
                  self.RULE)
        hits = _unwaived(r, "blocking-under-lock")
        assert len(hits) == 1 and r["exit_code"] == 8
        assert ".to()" in hits[0].message

    def test_card_waits_under_lock_are_caught(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/storage/bad.py": BAD_CARD_WAITS_UNDER_LOCK},
                  self.RULE)
        hits = _unwaived(r, "blocking-under-lock")
        assert sorted((h.line, h.message.split("(")[0]) for h in hits) == [
            (12, ".synchronize"), (13, ".synchronize"), (14, ".cpu"),
            (15, ".cuda"), (16, ".to")]
        assert all("_lock" in h.message for h in hits)

    def test_one_level_expansion_reaches_a_helper(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_HELPER_UNDER_LOCK},
                  self.RULE)
        hits = _unwaived(r, "blocking-under-lock")
        assert len(hits) == 1 and hits[0].line == 11
        assert "via _fetch:7" in hits[0].message

    def test_host_work_under_lock_is_not_matched(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/storage/ok.py": CLEAN_HOST_WORK_UNDER_LOCK},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_upload_outside_lock_passes(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/exec/ok.py": CLEAN_UPLOAD_OUTSIDE_LOCK},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_condition_variable_wait_is_sanctioned(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/ok.py": CLEAN_CV_WAIT},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)


# --- the batch-window wait/notify and group-commit tally idioms, seeded
# BAD/CLEAN so the analyzer keeps guarding the shapes exec/oltpbatch.py
# and kvserver/raft.py use -------------------------------------------

BAD_WINDOW_STATS = """
    import threading

    WINDOW_SIZES = []
    _LOCK = threading.Lock()

    def note_window(reqs):
        # stats bump escaped the lock: two leaders draining their
        # windows concurrently lose appends
        WINDOW_SIZES.append(len(reqs))
"""

BAD_GLOBAL_PROPOSALS = """
    PROPOSALS = 0

    def bump():
        global PROPOSALS
        PROPOSALS += 1
"""

CLEAN_GROUPCOMMIT_TALLY = """
    import threading

    class _GroupCommitTally:
        def __init__(self):
            self._mu = threading.Lock()
            self._proposals = 0

        def bump(self, commands):
            with self._mu:
                self._proposals += 1

    GROUPCOMMIT = _GroupCommitTally()

    def commit_round(nops):
        GROUPCOMMIT.bump(nops)
"""

BAD_WINDOW_RUN_UNDER_LOCK = """
    import threading

    _LOCK = threading.Lock()

    def submit(req, done):
        with _LOCK:
            # leader runs the window while every follower's submit
            # blocks on the same lock
            done.wait(timeout=5.0)
"""

CLEAN_COLLECTOR_WINDOW = """
    import threading

    class Collector:
        def __init__(self, run_fn):
            self.window_cv = threading.Condition()
            self.queue = []
            self.busy = False
            self.run_fn = run_fn

        def submit(self, req):
            batch = None
            with self.window_cv:
                self.queue.append(req)
                while not req.done:
                    if not self.busy:
                        self.busy = True
                        batch, self.queue = self.queue, []
                        break
                    self.window_cv.wait(timeout=1.0)
            if batch is not None:
                try:
                    self.run_fn(batch)
                finally:
                    with self.window_cv:
                        self.busy = False
                        self.window_cv.notify_all()
"""

WAIVED_WINDOW_STATS = """
    import threading

    WINDOW_SIZES = []
    _LOCK = threading.Lock()

    def note_window(reqs):
        # graftlint: waive[racy-global] single-threaded bench
        # bookkeeping, never reached from session threads
        WINDOW_SIZES.append(len(reqs))
"""


class TestBatchWindowIdioms:
    """Unlocked window stats and bare global proposal counters are
    caught, the lock-inside-Tally wrapper and the condition-variable
    collector are sanctioned, waivers still work."""

    def test_unlocked_window_stats_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/bad.py": BAD_WINDOW_STATS},
                  ["racy-global"])
        hits = _unwaived(r, "racy-global")
        assert len(hits) == 1
        assert "WINDOW_SIZES" in hits[0].message

    def test_bare_global_proposal_counter_caught(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/kvserver/bad.py": BAD_GLOBAL_PROPOSALS},
                  ["racy-global"])
        hits = _unwaived(r, "racy-global")
        assert len(hits) == 1
        assert "PROPOSALS" in hits[0].message

    def test_groupcommit_tally_wrapper_sanctioned(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/kvserver/ok.py": CLEAN_GROUPCOMMIT_TALLY},
                  ["racy-global"])
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_window_run_under_plain_lock_caught(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/exec/bad.py": BAD_WINDOW_RUN_UNDER_LOCK},
                  ["blocking-under-lock"])
        hits = _unwaived(r, "blocking-under-lock")
        assert len(hits) == 1
        assert "wait" in hits[0].message

    def test_collector_cv_idiom_sanctioned(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/ok.py": CLEAN_COLLECTOR_WINDOW},
                  ["blocking-under-lock", "racy-global"])
        assert r["exit_code"] == 0 and not _unwaived(r)

    def test_waived_window_stats_pass(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/ok.py": WAIVED_WINDOW_STATS},
                  ["racy-global"])
        assert not _unwaived(r)
        waived = [f for f in r["findings"] if f.waived]
        assert len(waived) == 1


# a miniature engine: _prepare_select builds its key from _exec_params'
# fields, and hands the exec cache a miss callback as a lambda
PLAN_ENGINE = """
    from dataclasses import dataclass


    @dataclass
    class ExecParams:
        pallas_groupagg: str
        hash_group_capacity: int
        sort_normalized: str


    class Engine:
        def _exec_params(self, session):
            sortn = str(session.vars.get("sort_normalized", "auto"))
            return ExecParams(
                pallas_groupagg=session.vars.get("pallas_groupagg"),
                hash_group_capacity=session.vars.get(
                    "hash_group_capacity"),
                sort_normalized=sortn)

        def _autotune_mode(self, session):
            return session.vars.get("pallas_autotune", None)

        def _on_miss(self, session):
            return self._autotune_mode(session)

        def _prepare_select(self, session, text):
            params = self._exec_params(session)
            mode = session.vars.get("plan_shape_cache", "auto")
            key = (text, mode, params.pallas_groupagg,
                   params.hash_group_capacity{sortkey})
            return self.cache.get(key, miss=lambda: self._on_miss(session))
"""


# the fixture reads two of the whitelisted vars: the others would read
# as whitelist drift
PLAN_WHITELIST = {v: rules_plan.WHITELIST[v]
                  for v in ("pallas_autotune", "plan_shape_cache")}


def _plan_tree(tmp_path, sortkey=", params.sort_normalized"):
    src = textwrap.dedent(PLAN_ENGINE).replace("{sortkey}", sortkey)
    return _tree(tmp_path, {f"{PKG}/exec/engine.py": src})


class TestPlanKeyCompleteness:
    RULE = ["plan-key-completeness"]

    @pytest.fixture
    def fixture_whitelist(self, monkeypatch):
        monkeypatch.setattr(rules_plan, "WHITELIST", dict(PLAN_WHITELIST))
        return rules_plan.WHITELIST

    def test_real_prepare_closure_is_complete(self, report):
        assert not _unwaived(report, "plan-key-completeness")

    def test_lost_anchor_is_a_loud_finding(self, index, monkeypatch):
        # a rename of _prepare_select must NOT silently disable the
        # rule: the anchor miss is itself a finding
        monkeypatch.setattr(rules_plan, "PREPARE_FUNC",
                            "renamed_out_from_under_the_rule")
        findings = rules_plan.check_plan_key_completeness(index)
        assert len(findings) == 1
        assert "anchor" in findings[0].message

    def test_whitelist_entries_are_all_read(self, index):
        findings = rules_plan.check_plan_key_completeness(index)
        drift = [f for f in findings if "whitelist drift" in f.message]
        assert not drift, [f.message for f in drift]

    def test_exec_params_fields_in_the_key_count_as_keyed(
            self, tmp_path, fixture_whitelist):
        r = run(root=_plan_tree(tmp_path), rules=self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r), \
            [f.message for f in r["findings"]]

    def test_a_field_missing_from_the_key_is_caught(self, tmp_path,
                                                    fixture_whitelist):
        r = run(root=_plan_tree(tmp_path, sortkey=""), rules=self.RULE)
        hits = _unwaived(r, "plan-key-completeness")
        assert len(hits) == 1 and r["exit_code"] == 16
        assert "'sort_normalized'" in hits[0].message
        assert "_exec_params" in hits[0].message

    def test_the_closure_follows_lambda_callbacks(self, tmp_path,
                                                  fixture_whitelist):
        # pallas_autotune is read only under the miss= lambda: with its
        # whitelist entry gone the read is a finding, so it was reached
        del fixture_whitelist["pallas_autotune"]
        r = run(root=_plan_tree(tmp_path), rules=self.RULE)
        hits = _unwaived(r, "plan-key-completeness")
        assert [("'pallas_autotune'" in h.message, h.line) for h in hits] \
            == [(True, 22)]


SETTINGS_SRC = """
    from dataclasses import dataclass, field


    class Settings:
        def register(self, name, default, kind, description=""):
            pass


    def defaults(s):
        s.register("sql.ok.setting", 1, int, "documented")
        s.register("sql.bare.setting", 1, int)


    @dataclass
    class SessionVars:
        values: dict = field(default_factory=lambda: {
            "distsql": "auto",
            "index_scan": "on",
        })
"""

VAR_USES = """
    def lookup(session):
        if session.vars.get("index_scan", "on") == "off":
            return None
        return int(session.vars.get("index_lookup_limit", 4096))
"""

FSTRING_METRICS = """
    def register(metrics, name, prefix):
        metrics.func_counter(f"kernel.{name}.launches", lambda: 0, "d")
        metrics.counter(f"sql.{name}.count", "d")
        metrics.func_gauge(f"{prefix}.tripped", lambda: 0, "d")
        metrics.counter(f"breaker.peer.n{name}.trips", "d")
        metrics.counter(f"undocumented.{name}.count", "d")
"""

FSTRING_DOC = """
    | Family | Where | What |
    |---|---|---|
    | `kernel.{groupagg_large,groupagg}.launches` | engine | x |
    | `sql.*` | engine | x |
    | `{prefix}.{trips,tripped}` | circuit | x |
    | `breaker.peer.n{nid}.trips` | netcluster | x |
    | `undocumented.count` | nowhere | x |
"""


class TestRegistrationDrift:
    RULE = ["registration-drift"]

    def test_real_tree_is_clean(self, report):
        assert not _unwaived(report, "registration-drift")

    def test_bad_metric_name_and_doc_drift_caught(self, tmp_path):
        src = """
            def reg(metrics):
                metrics.counter("Bad.Name", "desc").inc()
        """
        r = _scan(tmp_path, {f"{PKG}/exec/m.py": src}, self.RULE)
        msgs = [f.message for f in _unwaived(r, "registration-drift")]
        assert any("lowercase" in m for m in msgs)
        assert any(f"{PKG}/OBSERVABILITY.md" in m for m in msgs)
        assert r["exit_code"] == 32

    def test_fstring_names_match_prefixes_and_alternatives(self,
                                                           tmp_path):
        r = _scan(tmp_path, {f"{PKG}/exec/m.py": FSTRING_METRICS,
                             f"{PKG}/OBSERVABILITY.md": FSTRING_DOC},
                  self.RULE)
        hits = _unwaived(r, "registration-drift")
        # the one name the doc does not cover, named with its hole
        assert [h.line for h in hits] == [7]
        assert "'undocumented.{}.count'" in hits[0].message

    def test_unregistered_session_var_and_bare_setting_caught(
            self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/utils/settings.py": SETTINGS_SRC,
                             f"{PKG}/exec/fastpath.py": VAR_USES},
                  self.RULE)
        hits = _unwaived(r, "registration-drift")
        assert sorted((h.path, h.line) for h in hits) == [
            (f"{PKG}/exec/fastpath.py", 5),
            (f"{PKG}/utils/settings.py", 12)]
        msgs = " ".join(h.message for h in hits)
        assert "'index_lookup_limit'" in msgs
        assert "'sql.bare.setting'" in msgs and "description" in msgs

    def test_served_endpoint_missing_from_doc_caught(self, tmp_path):
        node = """
            def route(path):
                if path == "/healthz":
                    return 1
                if path == "/_status/secret":
                    return 2
        """
        doc = "| `/healthz` | JSON | liveness |\n"
        r = _scan(tmp_path, {f"{PKG}/server/node.py": node,
                             f"{PKG}/OBSERVABILITY.md": doc}, self.RULE)
        hits = _unwaived(r, "registration-drift")
        assert len(hits) == 1 and "'/_status/secret'" in hits[0].message


BAD_LEASE_READ = """
    def plan(leases, table):
        # raw ownership poke: no epoch fence
        return leases._assignments[(table, 3)]
"""

BAD_LEASE_KEY = """
    from cockroach_tpu_torch.parallel import multihost

    def owner_of(table, sid, epoch):
        import json
        raw = multihost.kv_try_get(f"ls/assign/{table}/{epoch}")
        return json.loads(raw)[str(sid)]
"""

WAIVED_LEASE_READ = """
    def cache_depth(leases):
        # graftlint: waive[lease-discipline] introspection only: counts
        # cached epochs, never reads an owner out of the raw table
        return len(leases._assignments)
"""

CLEAN_LEASE_READ = """
    def plan(pod, table, epoch):
        view = pod.leases.view_at(epoch)
        return view.assignment(table)
"""


class TestLeaseDiscipline:
    RULE = ["lease-discipline"]

    def test_real_tree_is_clean(self, report):
        assert not _unwaived(report, "lease-discipline")

    def test_raw_assignment_read_is_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/distsql/bad.py": BAD_LEASE_READ},
                  self.RULE)
        hits = _unwaived(r, "lease-discipline")
        assert len(hits) == 1 and r["exit_code"] == 64
        assert "_assignments" in hits[0].message
        assert "epoch" in hits[0].message

    def test_raw_lease_key_in_server_is_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/server/bad.py": BAD_LEASE_KEY},
                  self.RULE)
        hits = _unwaived(r, "lease-discipline")
        assert len(hits) == 1 and r["exit_code"] == 64
        assert "ls/assign" in hits[0].message

    def test_waived_site_passes(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/distsql/waived.py": WAIVED_LEASE_READ},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)
        assert r["counts"]["lease-discipline"]["waived"] == 1

    def test_clean_and_out_of_scope_pass(self, tmp_path):
        r = _scan(tmp_path, {
            f"{PKG}/distsql/clean.py": CLEAN_LEASE_READ,
            # the lease home itself owns the raw substrate
            f"{PKG}/distsql/leases.py": BAD_LEASE_READ,
            # engine/ops trees are out of scope (no planner reads there)
            f"{PKG}/exec/off.py": BAD_LEASE_KEY,
        }, self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)


BAD_REACTOR_LOOP = """
    class PollReactor:
        def _loop(self):
            while True:
                events = self.sel.select(0.25)
                for key, _mask in events:
                    data = key.fileobj.recv(4096)
                    fut = self.pool.submit(self.work, data)
                    fut.result()
"""

BAD_REACTOR_HELPER = """
    class FanReactor:
        def _loop(self):
            while not self.stopping:
                self._tick()

        def _tick(self):
            self.engine.execute("SELECT 1")
"""

BAD_REACTOR_CARD_WAIT = """
    import torch


    class SyncReactor:
        def _loop(self):
            while not self.stopping:
                self.sel.select(0.25)
                self._flush()

        def _flush(self):
            torch.cuda.synchronize()
            self.last = self.batch.to(self.device, non_blocking=True)
"""

WAIVED_REACTOR = """
    class DrainReactor:
        def _loop(self):
            while not self.stopping:
                self.sel.select(0.25)
            # graftlint: waive[reactor-discipline] shutdown path: the
            # stop flag is already set, no session is parked behind us
            self.flusher.join()
"""

CLEAN_REACTOR = """
    class CalmReactor:
        def _loop(self):
            while not self.stopping:
                events = self.sel.select(0.25)
                for key, _mask in events:
                    self._readable(key.data)

        def _readable(self, sess):
            data = sess.sock.recv(65536)
            with sess.lk:
                sess.frames.append(data)
            self.pool.submit(self._drain, sess)

        def _drain(self, sess):
            # worker side: blocking is fine here, and submit() passed
            # this as an argument, so the walk never enters it
            return sess.fut.result()
"""

NONREACTOR_LOOP = """
    class PollServer:
        def _loop(self):
            self.fut.result()
"""


class TestReactorDiscipline:
    RULE = ["reactor-discipline"]

    def test_real_tree_is_clean(self, report):
        assert not _unwaived(report, "reactor-discipline")

    def test_blocking_in_loop_body_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/server/badfront.py": BAD_REACTOR_LOOP},
                  self.RULE)
        hits = _unwaived(r, "reactor-discipline")
        assert r["exit_code"] == 128
        assert any(".result()" in h.message for h in hits)
        assert any(".recv()" in h.message for h in hits)
        assert len(hits) == 2

    def test_transitive_helper_caught(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/server/fan.py": BAD_REACTOR_HELPER},
                  self.RULE)
        hits = _unwaived(r, "reactor-discipline")
        assert len(hits) == 1 and r["exit_code"] == 128
        assert ".execute()" in hits[0].message
        assert "_tick" in hits[0].message  # blames the helper site

    def test_card_waits_on_the_loop_caught(self, tmp_path):
        r = _scan(tmp_path,
                  {f"{PKG}/server/sync.py": BAD_REACTOR_CARD_WAIT},
                  self.RULE)
        hits = _unwaived(r, "reactor-discipline")
        assert [(h.line, h.message.split("(")[0]) for h in hits] == [
            (12, ".synchronize"), (13, ".to")]
        assert all("_flush" in h.message for h in hits)

    def test_waived_site_passes(self, tmp_path):
        r = _scan(tmp_path, {f"{PKG}/server/drain.py": WAIVED_REACTOR},
                  self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)
        assert r["counts"]["reactor-discipline"]["waived"] == 1

    def test_clean_and_out_of_scope_pass(self, tmp_path):
        r = _scan(tmp_path, {
            f"{PKG}/server/calm.py": CLEAN_REACTOR,
            # classes not named *Reactor* keep the blocking idiom
            f"{PKG}/server/plain.py": NONREACTOR_LOOP,
            # and the rule only scopes server/ modules
            f"{PKG}/exec/off.py": BAD_REACTOR_LOOP,
        }, self.RULE)
        assert r["exit_code"] == 0 and not _unwaived(r)


# ---------------------------------------------------------------------------
# 3. core units
# ---------------------------------------------------------------------------

class TestThreadRoles:
    def test_pgwire_session_handler(self, index):
        roles = index.roles_of(f"{PKG}/server/pgwire.py::_Conn.serve")
        assert "pgwire-session" in roles

    def test_mesh_dispatcher_loop(self, index):
        roles = index.roles_of(f"{PKG}/parallel/distagg.py"
                               "::_MeshDispatcher._loop")
        assert "mesh-dispatch" in roles

    def test_prefetch_worker(self, index):
        roles = index.roles_of(f"{PKG}/exec/stream.py"
                               "::prefetch.<locals>.worker")
        assert "page-prefetch" in roles

    def test_shard_threads(self, index):
        # the thread body of run_sharded, and the function the mesh
        # program hands it (it runs once a slot on the shard threads)
        assert "shard" in index.roles_of(
            f"{PKG}/parallel/collective.py::run_sharded.<locals>.body")
        assert "shard" in index.roles_of(
            f"{PKG}/parallel/distagg.py::make_distributed_fn.<locals>"
            ".wrapped.<locals>.shard")

    def test_roles_propagate_along_calls(self, tmp_path):
        src = """
            import threading

            def _inner():
                pass

            def _body():
                _inner()

            def start():
                threading.Thread(target=_body, name="bg-loop").start()
        """
        idx = ModuleIndex.build(_tree(tmp_path, {f"{PKG}/exec/t.py": src}))
        assert "bg-loop" in idx.roles_of(f"{PKG}/exec/t.py::_body")
        assert "bg-loop" in idx.roles_of(f"{PKG}/exec/t.py::_inner")

    def test_run_sharded_targets_get_the_shard_role(self, tmp_path):
        src = """
            from ..parallel.collective import run_sharded

            def _per_slot(i):
                return i

            def _by_keyword(i):
                return i

            def fan(devices):
                run_sharded(devices, _per_slot)
                return run_sharded(devices, fn=_by_keyword, timeout=5.0)
        """
        idx = ModuleIndex.build(_tree(tmp_path, {f"{PKG}/exec/t.py": src}))
        assert idx.roles_of(f"{PKG}/exec/t.py::_per_slot") == {"shard"}
        assert idx.roles_of(f"{PKG}/exec/t.py::_by_keyword") == {"shard"}
        assert idx.roles_of(f"{PKG}/exec/t.py::fan") == set()


class TestChangedOnly:
    def test_changed_files_parses_porcelain(self, monkeypatch):
        out = (f" M {PKG}/exec/engine.py\n"
               f"?? {PKG}/analysis/new_rule.py\n"
               " M cockroach_tpu/exec/engine.py\n"
               " M tests/test_torch_static_analysis.py\n"
               " M README.md\n"
               f"R  a.py -> {PKG}/exec/renamed.py\n")

        class _Done:
            stdout = out

        monkeypatch.setattr(runner_mod.subprocess, "run",
                            lambda *a, **k: _Done())
        assert changed_files(REPO) == [
            f"{PKG}/exec/engine.py",
            f"{PKG}/analysis/new_rule.py",
            f"{PKG}/exec/renamed.py",
        ]

    def test_changed_files_none_when_git_fails(self, monkeypatch):
        def _boom(*a, **k):
            raise subprocess.SubprocessError("no git")

        monkeypatch.setattr(runner_mod.subprocess, "run", _boom)
        assert changed_files(REPO) is None

    def test_only_files_filters_findings(self, tmp_path):
        root = _tree(tmp_path, {
            f"{PKG}/exec/bad.py": BAD_FROM_NUMPY,
            f"{PKG}/exec/also_bad.py": BAD_FROM_NUMPY,
        })
        r = run(root=root, rules=["no-aliasing-upload"],
                only_files=[f"{PKG}/exec/bad.py"])
        assert {f.path for f in r["findings"]} == {f"{PKG}/exec/bad.py"}


class TestSelfScan:
    def test_analyzer_indexes_itself(self, index):
        for name in ("__init__", "__main__", "core", "runner",
                     "rules_device", "rules_concurrency", "rules_plan",
                     "rules_registration", "rules_lease", "rules_reactor"):
            rel = f"{PKG}/analysis/{name}.py"
            assert rel in index.modules, f"self-scan lost {rel}"
        assert not index.parse_errors

    def test_module_entrypoint_runs_clean(self):
        # the gate's own command, as the README gives it
        proc = subprocess.run(
            [sys.executable, "-m", "cockroach_tpu_torch.analysis", "--json"],
            cwd=str(REPO), capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr
        data = json.loads(proc.stdout)
        assert data["exit_code"] == 0
        assert set(RULE_NAMES) <= set(data["timings"])


# ---------------------------------------------------------------------------
# 4. parity with the reference's analyzer on the shared fixtures
# ---------------------------------------------------------------------------

WAIVER_SHAPES = """
    import threading

    TOTALS = {}
    LOG = []

    def note(k, v):
        # graftlint: waive[racy-global] a comment-only waiver above a
        # statement that spans lines covers its continuation lines
        TOTALS.update(
            {k: v})
        LOG.append(v)  # graftlint: waive[racy-global] trailing waiver
        LOG.extend([v])  # graftlint: waive[racy-global]
"""

BAD_RESULT_UNDER_LOCK = """
    import threading

    class Gate:
        def __init__(self):
            self._lock = threading.Lock()

        def _take(self, slot):
            return slot.acquire(timeout=1.0)

        def run(self, fut, slot):
            with self._lock:
                got = fut.result(timeout=5.0)
                self._take(slot)
            return got
"""

PARITY_CASES = {
    "racy-global": (["racy-global"], {
        "exec/bad.py": BAD_RACY_GLOBAL,
        "exec/ok.py": CLEAN_LOCKED_GLOBAL,
        "exec/stats.py": BAD_WINDOW_STATS,
        "exec/waived.py": WAIVED_WINDOW_STATS,
        "kvserver/bad.py": BAD_GLOBAL_PROPOSALS,
        "kvserver/ok.py": CLEAN_GROUPCOMMIT_TALLY,
        "ops/rounds.py": BAD_ROUND_COUNT,
    }),
    "blocking-under-lock": (["blocking-under-lock"], {
        "exec/window.py": BAD_WINDOW_RUN_UNDER_LOCK,
        "exec/gate.py": BAD_RESULT_UNDER_LOCK,
        "exec/cv.py": CLEAN_CV_WAIT,
        "exec/collector.py": CLEAN_COLLECTOR_WINDOW,
    }),
    "lease-discipline": (["lease-discipline"], {
        "distsql/bad.py": BAD_LEASE_READ,
        "server/bad.py": BAD_LEASE_KEY,
        "distsql/waived.py": WAIVED_LEASE_READ,
        "distsql/clean.py": CLEAN_LEASE_READ,
        "distsql/leases.py": BAD_LEASE_READ,
        "exec/off.py": BAD_LEASE_KEY,
    }),
    "reactor-discipline": (["reactor-discipline"], {
        "server/badfront.py": BAD_REACTOR_LOOP,
        "server/fan.py": BAD_REACTOR_HELPER,
        "server/drain.py": WAIVED_REACTOR,
        "server/calm.py": CLEAN_REACTOR,
        "server/plain.py": NONREACTOR_LOOP,
        "exec/off.py": BAD_REACTOR_LOOP,
    }),
    "waivers": (["racy-global"], {
        "exec/waivers.py": WAIVER_SHAPES,
    }),
}


def _findings_below(report, pkg):
    return sorted((f.rule, f.path[len(pkg) + 1:], f.line, f.waived)
                  for f in report["findings"])


class TestParityWithReference:
    @pytest.mark.parametrize("case", sorted(PARITY_CASES))
    def test_same_findings_from_both_analyzers(self, tmp_path, case):
        rules, files = PARITY_CASES[case]
        ref_root = _tree(tmp_path / "ref", {
            f"cockroach_tpu/{rel}": src for rel, src in files.items()})
        port_root = _tree(tmp_path / "port", {
            f"{PKG}/{rel}": src for rel, src in files.items()})
        want = _findings_below(ref_run(root=ref_root, rules=rules),
                               "cockroach_tpu")
        got = _findings_below(run(root=port_root, rules=rules), PKG)
        assert got == want
        # each case shows something, caught and clean alike
        assert got and any(not w for *_, w in got)


# ---------------------------------------------------------------------------
# 5. chip_smoke.py's phase 24, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_phase24_on_the_cpu(monkeypatch):
    """The phase runs the gate's command in a process of its own and
    reports every rule; only the nvidia-smi line is stood in for."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "no card, not measured")
    out = chip_smoke.analysis_phase()
    assert out["exit_code"] == 0 and out["files"] >= 150
    assert sorted(out["rules"]) == sorted(RULE_NAMES)
    assert all(c["findings"] == c["waived"] for c in out["rules"].values())
    assert out["rules"]["no-aliasing-upload"]["waived"] >= 1
    assert out["python"] == "%d.%d.%d" % sys.version_info[:3]
    assert out["card"] == "no card, not measured"


def test_chip_smoke_phase24_fails_without_the_package(tmp_path,
                                                      monkeypatch):
    """Beside nothing else of the repo the phase's command cannot run,
    and the phase raises."""
    import importlib.util
    import shutil
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_alone", tmp_path / "chip_smoke.py")
    alone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(alone)
    monkeypatch.setattr(alone, "_smi", lambda: "no card, not measured")
    monkeypatch.delenv("PYTHONPATH", raising=False)
    with pytest.raises(AssertionError, match="graftlint exited"):
        alone.analysis_phase()
