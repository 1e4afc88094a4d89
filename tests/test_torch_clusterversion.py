"""The port's cluster versions (kvserver/clusterversion.py) and the join
handshake of its NetCluster (kvserver/netcluster.py).

The reference's own cases, tests/test_clusterversion.py (8: the version
primitives and gates, a too-old binary refused at join, a joiner refusing
a newer cluster, the mixed-version upgrade flow and a same-version
cluster), run on the port's modules (``reference_cases`` of
test_torch_ranges.py), so each assertion holds the port to the
reference's.
"""

from __future__ import annotations

from tests.test_torch_ranges import reference_cases

reference_cases("test_clusterversion.py", globals())


def test_constants_are_the_references():
    from cockroach_tpu.kvserver import clusterversion as ref
    from cockroach_tpu_torch.kvserver import clusterversion as port
    assert str(port.BINARY_VERSION) == str(ref.BINARY_VERSION)
    assert str(port.MIN_SUPPORTED) == str(ref.MIN_SUPPORTED)
    assert {k: str(v) for k, v in port.GATES.items()} == {
        k: str(v) for k, v in ref.GATES.items()}
