"""The port's elastic pod (parallel/multihost.py's elastic half,
distsql/leases.py, the elastic branches of distsql/node.py, hostd
--elastic, /_status/membership) against the reference's.

1. The reference's own cases, tests/test_membership.py (31: membership
   units over the in-process KV, ``plan_rebalance`` and ``LeaseView``,
   stale-epoch fencing, the (join | drain | kill) x (idle | mid-scan |
   mid-merge) churn matrix of in-process ``pod_factory`` pods, scale-out
   from 2 to 4 under load, membership faults, int64 overflow in
   ``merge_partials``, diagnostics up the merge tree, and the ``slow``
   subprocess pod with a late joiner), run on the port's modules with
   every engine on the CPU (``reference_cases`` of test_torch_ranges.py).
   Their oracle is the REFERENCE engine over the same generated rows
   (the ``oracle`` fixture here), so every pod answer is held to the
   JAX package's rows.
2. ``plan_rebalance`` and ``LeaseView`` on seeded random assignments:
   the port's answers equal the reference module's.
3. One ``gpu`` case: a two-host ``hostd --elastic`` pod on the card
   against one port engine on the card.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import time

import pytest
import torch


def _sibling(name: str):
    """A sibling test module, loaded by its path: the card's machine may
    have another package named ``tests``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_sibling_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference_cases = _sibling("test_torch_ranges").reference_cases


ROWS = 600


@pytest.fixture(scope="module")
def oracle():
    """The reference engine over the rows every pod shards: lineitem's
    first 600 rows and part at sf 0.01, at Timestamp(1, 0)."""
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch",
                           "cockroach_tpu.storage.hlc") as (re_, rt, rh):
        eng = re_.Engine()
        eng.execute(rt.DDL["lineitem"])
        eng.execute(rt.DDL["part"])
        eng.store.insert_columns(
            "lineitem", rt.gen_lineitem(0.01, rows=ROWS),
            rh.Timestamp(1, 0))
        eng.store.insert_columns("part", rt.gen_part(0.01),
                                 rh.Timestamp(1, 0))
        yield eng
        eng.close()


reference_cases("test_membership.py", globals(), replace=(
    # the port's engines run on the CPU here (no device means the card)
    ("            eng = Engine()\n", "            eng = Engine(device='cpu')\n"),
    ('"--elastic", "--rows", str(ROWS),',
     '"--elastic", "--device", "cpu", "--rows", str(ROWS),'),
    # a port host takes longer to start (torch's import) than the
    # reference's loop of 8 runs lasts: the founder's loop runs long
    # enough for the late joiner to land inside it
    ('"--initial-hosts", "2", "--repeat", "8",',
     '"--initial-hosts", "2", "--repeat", "40",'),
))


# -- the lease planner against the reference module --------------------------

def _random_assignments(seed: int):
    rng = random.Random(seed)
    for _ in range(60):
        nsh = rng.randint(1, 24)
        hosts = list(range(rng.randint(1, 6)))
        cur = {s: rng.choice(hosts + [-1, 99]) for s in range(nsh)}
        live = rng.sample(hosts, rng.randint(1, len(hosts)))
        yield cur, live


def test_plan_rebalance_and_views_match_the_reference():
    from cockroach_tpu_torch.distsql import leases as port
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.distsql.leases") as (ref,):
        for cur, live in _random_assignments(11):
            want = ref.plan_rebalance(cur, live)
            got = port.plan_rebalance(cur, live)
            assert got == want
            rv = ref.LeaseView(epoch=3, assignments={"t": want})
            pv = port.LeaseView(epoch=3, assignments={"t": got})
            for h in set(live) | {99}:
                assert pv.shards_of("t", h) == rv.shards_of("t", h)
            assert pv.owners("t") == rv.owners("t")
            assert [pv.owner("t", s) for s in cur] == \
                [rv.owner("t", s) for s in cur]
        with pytest.raises(ref.LeaseError):
            ref.plan_rebalance({0: 1}, [])
        with pytest.raises(port.LeaseError):
            port.plan_rebalance({0: 1}, [])


# -- the pod on the card ------------------------------------------------------

@pytest.mark.gpu
def test_two_host_elastic_pod_on_the_card():
    """Founder and one worker of ``hostd --elastic`` on cuda:0 (each its
    own CUDA context): the GROUP BY and Q6 rows equal one port engine's
    on the card over the same generated rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.hostd import GROUPBY_SQL, _jsonable
    from cockroach_tpu_torch.storage.hlc import Timestamp
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr_file = os.path.join(tempfile.mkdtemp(), "kv_addr")
    base = [sys.executable, "-m", "cockroach_tpu_torch.server.hostd",
            "--elastic", "--device", "cuda", "--rows", str(ROWS),
            "--nshards", "4", "--queries", "groupby,q6",
            "--flow-timeout", "60", "--heartbeat-interval", "0.25",
            "--liveness-window", "30"]
    env = dict(os.environ, PYTHONPATH=repo)
    founder = subprocess.Popen(
        base + ["--process-id", "0", "--kv-addr-file", addr_file,
                "--initial-hosts", "2", "--repeat", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=repo, text=True)
    worker = None
    try:
        deadline = time.time() + 120
        while not (os.path.exists(addr_file)
                   and open(addr_file).read().strip()):
            assert founder.poll() is None, founder.stderr.read()
            assert time.time() < deadline, "no KV addr published"
            time.sleep(0.05)
        worker = subprocess.Popen(
            base + ["--process-id", "1", "--kv-addr",
                    open(addr_file).read().strip()],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env, cwd=repo)
        out, err = founder.communicate(timeout=240)
    finally:
        for p in (worker, founder):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    assert founder.returncode == 0, err
    doc = json.loads(out.strip().splitlines()[-1])
    one = Engine()
    one.execute(tpch.DDL["lineitem"])
    one.execute(tpch.DDL["part"])
    for cn, vals in tpch.LINEITEM_DICTS.items():
        one.store.set_dictionary("lineitem", cn, vals)
    one.store.insert_columns(
        "lineitem", tpch.gen_lineitem(0.01, rows=ROWS, encoded=True),
        Timestamp(1, 0))
    one.store.insert_columns("part", tpch.gen_part(0.01), Timestamp(1, 0))
    for name, sql in (("groupby", GROUPBY_SQL), ("q6", tpch.Q6)):
        want = [[_jsonable(v) for v in r] for r in one.execute(sql).rows]
        res = doc["results"][name]
        assert res["consistent"] and res["rows"] == want
    one.close()
    assert doc["membership"]["elastic"]
    assert set(doc["membership"]["leases"]["lineitem"].values()) == {0, 1}
