"""Device-safety rules: host-buffer aliasing and collective discipline.

no-aliasing-upload
    ``torch.from_numpy``, ``torch.as_tensor`` and ``torch.frombuffer``
    are banned in data-plane modules (exec/, storage/, distsql/,
    parallel/), under any spelling (``import torch as T``, ``from torch
    import from_numpy as f``). On the CPU each returns a tensor that
    shares the numpy array's memory, and ``as_tensor`` returns a CPU
    tensor it is given as it is; the streamed-scan plane reuses its page
    assembly buffers, so an aliased tensor silently reads the NEXT
    page's bytes (the reference's ``jnp.asarray`` corruption).
    ``torch.tensor`` always copies. Sites that convert provably fresh,
    never-reused buffers (a ``.copy()`` just made, a dtype probe of an
    empty array, the result tensor of a compiled expression) carry
    explicit waivers; everything else must copy.

collective-discipline
    Multi-device execution must be funneled through the per-mesh FIFO
    dispatcher: the shard threads of one distributed run rendezvous at
    every collective (parallel/collective.py), and two runs that
    interleave over the same slots wait on each other's rendezvous
    until the collective timeout. Statically: ``run_sharded`` and the
    rendezvous objects (``ShardAxis(``, ``_Rendezvous(``) are used only
    in parallel/distagg.py (the dispatcher's home) and
    parallel/collective.py (where they are defined), and every
    ``make_distributed_fn(...)`` result must flow into
    ``queued_collective_call`` within the same function — a mesh
    program that escapes the dispatcher is a rendezvous hazard on the
    first concurrent statement.

    The cross-host rendezvous entry points — ``torch.distributed``'s
    ``TCPStore``, ``init_process_group`` and ``destroy_process_group``
    — are sanctioned only in parallel/multihost.py. The pod's store and
    process group are process-global singletons with strict ordering
    (the store's server must be up before any peer dials it; a
    teardown mid-flight aborts every peer), so a second entry point
    anywhere else either double-initializes the pod or tears live peers
    down. Everything outside the home goes through the multihost
    wrappers (``init_distributed`` / ``shutdown_distributed``), which
    are idempotent and teardown-ordered.
"""

from __future__ import annotations

import ast

from .core import PACKAGE, Finding, direct_nodes

DATA_PLANE_PREFIXES = (
    f"{PACKAGE}/exec/", f"{PACKAGE}/storage/",
    f"{PACKAGE}/distsql/", f"{PACKAGE}/parallel/",
)

# the one module allowed to run a program on the shard threads:
# everything it runs goes through its own _MeshDispatcher FIFO thread
COLLECTIVE_HOME = f"{PACKAGE}/parallel/distagg.py"
# where the shard threads and their rendezvous are defined
COLLECTIVE_DEFS = f"{PACKAGE}/parallel/collective.py"
COLLECTIVE_NAMES = ("run_sharded", "ShardAxis", "_Rendezvous")

# the one module allowed to touch the cross-host rendezvous: its
# init/shutdown wrappers are idempotent and run registered teardowns in
# LIFO order, so the process-global store has exactly one owner
MULTIHOST_HOME = f"{PACKAGE}/parallel/multihost.py"
MULTIHOST_NAMES = ("TCPStore", "init_process_group",
                   "destroy_process_group")

# torch's constructors that share a numpy array's memory on the CPU
ALIASING_UPLOADS = ("from_numpy", "as_tensor", "frombuffer")


def _torch_alias(module, name: str) -> bool:
    """True when ``name`` is bound to the torch module in ``module``
    (``import torch``, ``import torch as T``; ``import torch.cuda`` binds
    ``torch`` too)."""
    target = module.imports.get(name, "")
    return target == "torch" or (name == "torch"
                                 and target.startswith("torch."))


def _aliasing_upload(node: ast.Call, module) -> str | None:
    """``torch.<name>`` when the call is one of ALIASING_UPLOADS, under
    any import spelling; else None."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in ALIASING_UPLOADS \
            and isinstance(f.value, ast.Name) \
            and _torch_alias(module, f.value.id):
        return f"torch.{f.attr}"
    if isinstance(f, ast.Name):
        mod, orig = module.from_imports.get(f.id, ("", ""))
        if mod == "torch" and orig in ALIASING_UPLOADS:
            return f"torch.{orig}"
    return None


def check_no_aliasing_upload(index) -> list[Finding]:
    rule = "no-aliasing-upload"
    out = []
    for rel, m in index.modules.items():
        if not rel.startswith(DATA_PLANE_PREFIXES):
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _aliasing_upload(node, m)
            if name is None:
                continue
            reason = m.waiver_for(rule, node.lineno, node.end_lineno)
            out.append(Finding(
                rule, rel, node.lineno,
                f"{name} shares the numpy buffer's memory on the CPU; "
                "data-plane page buffers are reused, so use "
                "torch.tensor (copies) or waive with the fresh-buffer "
                "argument",
                waived=reason is not None,
                waiver_reason=reason or ""))
    return out


def _call_name(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _emit(out, m, rule, rel, node, msg) -> None:
    reason = m.waiver_for(rule, node.lineno, node.end_lineno)
    out.append(Finding(rule, rel, node.lineno, msg,
                       waived=reason is not None,
                       waiver_reason=reason or ""))


def check_collective_discipline(index) -> list[Finding]:
    rule = "collective-discipline"
    out = []
    for rel, m in index.modules.items():
        if not rel.startswith(PACKAGE + "/"):
            continue
        # (a) the shard threads and their rendezvous outside the
        # dispatcher's home; (c) cross-host rendezvous entry points
        # outside the multihost home (same walk, same rule bit)
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in COLLECTIVE_NAMES:
                if rel in (COLLECTIVE_HOME, COLLECTIVE_DEFS):
                    continue
                _emit(out, m, rule, rel, node,
                      f"{name} used outside {COLLECTIVE_HOME}: shard "
                      "programs must run through the queued "
                      "_MeshDispatcher or concurrent statements wait on "
                      "each other's rendezvous until the collective "
                      "timeout")
            elif name in MULTIHOST_NAMES and rel != MULTIHOST_HOME:
                _emit(out, m, rule, rel, node,
                      f"torch.distributed {name} called outside "
                      f"{MULTIHOST_HOME}: the cross-host rendezvous "
                      "(the pod's store and process group) is a "
                      "process-global singleton — a second entry point "
                      "double-initializes the pod or tears live peers "
                      "down; use the multihost wrappers "
                      "(init_distributed / shutdown_distributed)")
        # (b) make_distributed_fn results must flow into
        # queued_collective_call within the same function
        for fi in m.functions.values():
            nodes = direct_nodes(fi.node)
            calls = [n for n in nodes if isinstance(n, ast.Call)]
            mdf_calls = [c for c in calls
                         if _call_name(c) == "make_distributed_fn"]
            if not mdf_calls:
                continue
            bound: dict[str, list[ast.Call]] = {}
            for n in nodes:
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)):
                    hits = [c for c in ast.walk(n.value)
                            if isinstance(c, ast.Call) and c in mdf_calls]
                    if hits:
                        bound.setdefault(n.targets[0].id, []).extend(hits)
            disciplined: set[int] = set()   # id() of blessed Call nodes
            for c in calls:
                if _call_name(c) != "queued_collective_call":
                    continue
                for sub in ast.walk(c):
                    if isinstance(sub, ast.Call) and sub in mdf_calls:
                        disciplined.add(id(sub))
                    if isinstance(sub, ast.Name) and sub.id in bound:
                        for h in bound[sub.id]:
                            disciplined.add(id(h))
            for c in mdf_calls:
                if id(c) in disciplined:
                    continue
                _emit(out, m, rule, rel, c,
                      "make_distributed_fn result does not flow into "
                      "queued_collective_call in this function: the "
                      "mesh program would run on the shard threads "
                      "outside the per-mesh FIFO dispatcher (rendezvous "
                      "hazard under concurrency)")
    return out
