"""The reference's adversarial cases on the port.

tests/test_nemesis.py runs unchanged on the port's modules
(``reference_cases`` of test_torch_ranges.py), with every Engine on the
CPU:
- raft under ``ChaosTransport`` (seeds 1, 7 and 42: reordered,
  duplicated and delayed messages) converges, its replicas agree, and
  ``invariants.validate_cluster`` holds; a node restarted under chaos
  catches up; duplicated proposals apply once;
- results do not move under the metamorphic constants
  (``COCKROACH_TPU_METAMORPHIC``, a subprocess per seed);
- ``invariants.validate_table`` passes a healthy store and catches a
  corrupt one;
- concurrent transactions lose no update and conserve a bank's total.
The port's raft ignores stale append successes (kvserver/raft.py
``_handle_append_resp``, a named divergence): the chaos cases hold with
that repair in place.
"""

from tests.test_torch_ranges import reference_cases

reference_cases("test_nemesis.py", globals(), replace=(
    # the port's engines run on the CPU here (no device means the card)
    ("\ne = Engine()\n", "\ne = Engine(device='cpu')\n"),
    ("        e = Engine()\n", "        e = Engine(device='cpu')\n"),
))
