"""The reference's SQL logic corpus on the port.

Every golden file under tests/testdata/logic_test/ (the corpus that
tests/test_logic.py holds the reference to) runs unchanged on the port's
Engine on the CPU, under the same configs:
- local              one slot, index fastpath on
- local-no-fastpath  one slot, compiled scans only
- fakedist           8 CPU slots (``make_mesh([cpu] * 8)``), DistSQL auto
- 3node / 3node-mesh every statement over a 3-node raft cluster (slow, as
                     the reference marks them)
Each block's output, rendered by ``_fmt`` (tests/test_logic.py's), must
equal its golden byte for byte.

This module imports neither JAX nor the JAX package, so the card's
harness (chip_smoke.py phase 25) loads it by path and runs the corpus
through ``run_file`` on a CUDA engine.
"""

from __future__ import annotations

import datetime
import glob
import importlib.util
import json
import os
import sys

import pytest
import torch

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata",
                   "logic_test")

CONFIGS = {
    "local": {"mesh": False, "vars": {"distsql": "off"}},
    "local-no-fastpath": {"mesh": False,
                          "vars": {"distsql": "off",
                                   "index_scan": "off"}},
    "fakedist": {"mesh": True, "vars": {"distsql": "auto"}},
    "3node": {"mesh": False, "cluster": 3, "vars": {"distsql": "off"}},
    "3node-mesh": {"mesh": True, "cluster": 3,
                   "vars": {"distsql": "auto"}},
}

FILES = sorted(glob.glob(os.path.join(DIR, "*.td")))


def _datadriven():
    """tests/datadriven.py, loaded by its path: the card's machine may have
    another package named ``tests``."""
    name = "_torch_logic_datadriven"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "datadriven.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod     # its dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _fmt(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        s = f"{v:.6f}".rstrip("0").rstrip(".")
        return s if s not in ("", "-") else "0"
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, (list, dict)):
        return json.dumps(v, sort_keys=True, separators=(",", ":"))
    return str(v)


def run_file(path: str, config: dict, device="cpu", slots=8) -> int:
    """Run one golden file on a port Engine on ``device`` under
    ``config``; a mesh config takes ``slots`` slots of that device.
    Raises AssertionError naming every block that differs from its
    golden; returns the number of blocks run."""
    from cockroach_tpu_torch.exec.engine import Engine
    cluster = None
    if config.get("cluster"):
        from cockroach_tpu_torch.kvserver.cluster import Cluster
        cluster = Cluster(n_nodes=config["cluster"])
        cluster.create_range(b"\x00", b"\xff")
        cluster.pump_until(lambda: cluster.leaseholder(1) is not None)
    if config["mesh"]:
        from cockroach_tpu_torch.parallel.mesh import make_mesh
        eng = Engine(cluster=cluster,
                     mesh=make_mesh([torch.device(device)] * slots))
    else:
        eng = Engine(cluster=cluster, device=device)
    session = eng.session()
    for k, v in config["vars"].items():
        session.vars.set(k, v)
    blocks = 0

    def handler(td):
        nonlocal blocks
        blocks += 1
        if td.cmd == "statement":
            eng.execute(td.input, session)
            return "ok"
        if td.cmd == "query":
            res = eng.execute(td.input, session)
            lines = []
            if td.has("colnames"):
                lines.append(" ".join(res.names))
            body = [" ".join(_fmt(v) for v in row) for row in res.rows]
            if td.has("rowsort"):
                body.sort()
            lines += body
            return "\n".join(lines) if lines else "(empty)"
        raise ValueError(f"{td.pos}: unknown directive {td.cmd!r}")

    try:
        _datadriven().run_datadriven(path, handler)
    finally:
        eng.close()
    return blocks


@pytest.mark.parametrize(
    "config",
    [pytest.param(c, marks=([pytest.mark.slow]
                            if CONFIGS[c].get("cluster") else []))
     for c in sorted(CONFIGS)])
@pytest.mark.parametrize(
    "path", FILES, ids=[os.path.basename(p) for p in FILES])
def test_logic(path, config):
    run_file(path, CONFIGS[config])


def test_corpus_and_fmt_are_the_references():
    """The port runs tests/test_logic.py's files and configs, and renders
    every value kind as its ``_fmt`` does."""
    from tests import test_logic as ref
    assert FILES == ref.FILES and len(FILES) == 83
    assert CONFIGS == ref.CONFIGS
    values = [None, True, False, 0, -7, 2 ** 40, 1.5, -0.0000001, 2.0,
              1e-9, "x y", datetime.date(2024, 2, 29),
              datetime.datetime(2024, 1, 2, 3, 4, 5, 6), [1, [2, None]],
              {"b": [1, 2], "a": {"z": True}}, [], {}]
    assert [_fmt(v) for v in values] == [ref._fmt(v) for v in values]
