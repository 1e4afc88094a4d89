"""graftlint for the port: AST invariant analysis of cockroach_tpu_torch.

The port's copy of cockroach_tpu/analysis, with the rules that read
JAX idioms rewritten for torch. The hazards are the same: an upload
that shares a host buffer (``torch.from_numpy``/``torch.as_tensor`` on
the CPU share the numpy array's memory, as ``jnp.asarray`` can), a
collective that runs outside the per-mesh dispatcher, a module global
mutated without a lock by concurrent sessions, a wait under a lock, a
session variable that shapes the plan but misses the plan-cache key,
and a metric, setting, session variable or endpoint that is used but
not registered or documented.

Layout:

- ``core``                — module index, call graph, thread-role
                            classification, waiver parsing
- ``rules_device``        — no-aliasing-upload, collective-discipline
- ``rules_concurrency``   — racy-global, blocking-under-lock
- ``rules_plan``          — plan-key-completeness
- ``rules_registration``  — registration-drift (metrics, settings,
                            session vars, HTTP endpoints)
- ``rules_lease``         — lease-discipline
- ``rules_reactor``       — reactor-discipline
- ``runner``              — rule registry, file discovery, output

Run it::

    python -m cockroach_tpu_torch.analysis            # human output
    python -m cockroach_tpu_torch.analysis --json     # machine output
    python -m cockroach_tpu_torch.analysis --changed-only   # git-diff scope

Waive a finding in place, always with a reason::

    # graftlint: waive[no-aliasing-upload] a copy made on this line
    t = torch.from_numpy(buf.copy())

An empty reason is itself a finding (``waiver-syntax``), so waivers
stay auditable. The exit status is a bitmask of the rules with
unwaived findings (runner.RULES), 256 for a malformed waiver.
"""

from .core import Finding, ModuleIndex  # noqa: F401
from .runner import RULES, run, render_human, render_json  # noqa: F401
