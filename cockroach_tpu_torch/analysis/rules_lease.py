"""lease-discipline: shard ownership is read ONLY through the
epoch-guarded accessors.

The elastic pod (distsql/leases.py) serializes every lease flip on the
membership epoch: ``ShardLeases.view_at(e)`` / ``current_view()``
return an immutable per-epoch snapshot, which is what makes "exactly
one owner per shard per epoch" checkable. A planner or server that
pokes the raw ``_assignments`` cache — or reads the ``ls/assign/...``
KV records directly — sees ownership WITHOUT an epoch fence: it can
observe the next epoch's assignment under the current epoch's plan and
double-count a moved shard, the exact bug the epoch CAS exists to
prevent. Same shape as collective-discipline's pin of the
torch.distributed entry points to parallel/multihost.py: the raw
substrate has one home, everyone else goes through the door.

Flagged in ``distsql/`` and ``server/`` (outside the lease home):

- attribute reads of ``_assignments`` (the raw epoch->assignment
  cache on ShardLeases);
- string literals naming the raw lease records (``ls/assign`` /
  ``ls/pending`` / ``ls/ready`` KV prefixes).

Waivable per site with ``# graftlint: waive[lease-discipline] why``.
"""

from __future__ import annotations

import ast

from .core import PACKAGE, Finding

# the one module allowed to touch the raw lease substrate
LEASE_HOME = f"{PACKAGE}/distsql/leases.py"

# trees where planner/server code lives; the engine and tests are out
# of scope (tests seed violations on purpose)
_SCOPES = (f"{PACKAGE}/distsql/", f"{PACKAGE}/server/")

# raw lease-record KV prefixes: any literal mentioning one outside the
# home is a hand-rolled ownership read/write
_RAW_PREFIXES = ("ls/assign", "ls/pending", "ls/ready")


def _in_scope(rel: str) -> bool:
    return rel != LEASE_HOME and rel.startswith(_SCOPES)


def check_lease_discipline(index) -> list[Finding]:
    rule = "lease-discipline"
    out = []
    for rel, m in index.modules.items():
        if not _in_scope(rel):
            continue
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr == "_assignments":
                reason = m.waiver_for(rule, node.lineno,
                                      node.end_lineno)
                out.append(Finding(
                    rule, rel, node.lineno,
                    "raw ShardLeases._assignments access outside "
                    f"{LEASE_HOME}: ownership read without an epoch "
                    "fence can observe the next epoch's assignment "
                    "under the current plan and double-count a moved "
                    "shard; go through view_at(epoch)/current_view()",
                    waived=reason is not None,
                    waiver_reason=reason or ""))
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and any(p in node.value for p in _RAW_PREFIXES):
                reason = m.waiver_for(rule, node.lineno,
                                      node.end_lineno)
                out.append(Finding(
                    rule, rel, node.lineno,
                    f"raw lease-record key {node.value!r} outside "
                    f"{LEASE_HOME}: the ls/* KV records are the lease "
                    "substrate — reading or writing them directly "
                    "bypasses the create-only CAS + epoch flip that "
                    "keeps every shard single-owned; use the "
                    "ShardLeases accessors",
                    waived=reason is not None,
                    waiver_reason=reason or ""))
    return out
