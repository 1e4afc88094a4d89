"""The shard mesh: the cluster topology of the engine's distributed
plans (the counterpart of cockroach_tpu/parallel/mesh.py).

The reference partitions work by range leaseholder across nodes and, on
the accelerator, shards scan rows over the ``shards`` axis of a JAX
device mesh, merging partial aggregates with collectives inside
shard_map. Here a ``Mesh`` is an ordered tuple of shard slots, each a
``torch.device``: one slot per card on a machine with several, or
several slots on one device when the caller asks for that explicitly
(``make_mesh(devices=[torch.device("cuda:0")] * 4)``, or ``[cpu] * 8``
in the tests, the counterpart of the reference's forced host devices).
A distributed plan runs once per slot, one thread each, and its
collectives meet at a rendezvous (parallel/collective.py).

Each slot carries an id (its position in the mesh it was made from), so
two slots on one device stay distinct: sub-meshes of a four-slot mesh
on one card are disjoint rendezvous domains with dispatchers of their
own, as the reference's sub-meshes over distinct devices are.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

SHARD_AXIS = "shards"


class Mesh:
    """An ordered tuple of shard slots: ``devices[i]`` is slot i's
    torch.device and ``ids[i]`` its id. ``size`` is the slot count."""

    def __init__(self, devices, ids=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.ids = (tuple(int(i) for i in ids) if ids is not None
                    else tuple(range(len(self.devices))))
        if len(self.ids) != len(self.devices) \
                or len(set(self.ids)) != len(self.ids):
            raise ValueError("a mesh needs one distinct id a slot")
        self.size = len(self.devices)

    def key(self) -> tuple:
        """The slots' identity: (device, id) per slot, in order. Two
        meshes with one key are one rendezvous domain."""
        return tuple((str(d), i) for d, i in zip(self.devices, self.ids))

    def submesh(self, start: int, size: int) -> "Mesh":
        return Mesh(self.devices[start:start + size],
                    self.ids[start:start + size])


def pod_mesh(device=None) -> Mesh:
    """Mesh over THIS host's slice of the pod: its own cards, one slot
    each (``device`` names another, e.g. "cpu"). Device collectives stay
    inside the host and the host tree (the DistSQL merge_to and
    merge_children flows) carries the cross-host merge, as in the
    reference on the CPU; its hybrid ICI+DCN mesh of a TPU pod has no
    counterpart here (multihost.global_mesh)."""
    from cockroach_tpu_torch.parallel import multihost
    return Mesh(multihost.global_mesh(device))


def make_mesh(devices=None, n: Optional[int] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card, one slot
    each; raises without one). With ``n``, the first n slots; fewer
    than n is refused rather than silently truncated: an n-way sharding
    tested on fewer slots would test nothing."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= explicitly "
                "(e.g. [torch.device('cpu')] * 8) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = list(devices)
    if n is not None:
        if len(devs) < n:
            raise RuntimeError(
                f"make_mesh(n={n}): only {len(devs)} slots given; "
                "refusing to silently truncate the mesh")
        devs = devs[:n]
    if not devs:
        raise RuntimeError("make_mesh: a mesh needs at least one slot")
    return Mesh(devs)


def shard_spec() -> str:
    """Placement tag of a row-sharded upload: each slot holds an equal
    slice of the padded table's rows."""
    return "sharded"


def replicated_spec() -> str:
    """Placement tag of a replicated upload: every slot holds the whole
    table (a join's build side)."""
    return "replicated"


class _DomainGate:
    """Two-mode execution window for one domain family (a root mesh and
    its sub-meshes). Entries of the SAME mode run concurrently (disjoint
    sub-meshes, or full-mesh calls serialized by their own dispatcher);
    entries of DIFFERENT modes exclude each other, because their slot
    sets overlap: a full-mesh run and a sub-mesh run in flight at once
    would share slots. A waiting mode also blocks NEW entries of the
    active mode, so a steady sub-mesh stream cannot starve a full-mesh
    statement (and vice versa)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._active = {"root": 0, "sub": 0}
        self._waiting = {"root": 0, "sub": 0}

    @contextlib.contextmanager
    def window(self, mode: str):
        other = "sub" if mode == "root" else "root"
        with self._cv:
            self._waiting[mode] += 1
            while self._active[other] > 0 or (
                    self._waiting[other] > 0 and self._active[mode] > 0):
                self._cv.wait()
            self._waiting[mode] -= 1
            self._active[mode] += 1
        try:
            yield
        finally:
            with self._cv:
                self._active[mode] -= 1
                self._cv.notify_all()


# slot key -> (gate, mode); filled by MeshPool so that
# distagg.queued_collective_call can bracket every dispatch of a
# registered family. Meshes outside any pool family dispatch ungated.
_DOMAIN_GATES: dict = {}
_DOMAIN_GATES_LOCK = threading.Lock()


def _devkey(mesh: Mesh) -> tuple:
    # gate families are per rendezvous domain: two host processes of
    # one pod each see local slots 0..k-1, and the gate registry must
    # never conflate host A's slots with host B's
    from cockroach_tpu_torch.parallel import multihost
    topo = multihost.topology()
    dom = topo.process_id if topo is not None else -1
    return (dom,) + mesh.key()


def execution_window(mesh):
    """Context manager bracketing a dispatch on ``mesh`` (enqueue
    through completion), or None when the mesh belongs to no
    registered domain family."""
    if mesh is None:
        return None
    ent = _DOMAIN_GATES.get(_devkey(mesh))
    if ent is None:
        return None
    gate, mode = ent
    return gate.window(mode)


class MeshPool:
    """Partition a mesh's slots into disjoint sub-meshes per power of
    two: an 8-slot mesh yields two 4-slot, four 2-slot and eight 1-slot
    domains. Disjoint slot sets are disjoint rendezvous domains, each
    with its own dispatcher (distagg keys them by slot key), so
    distributed plans on different sub-meshes run concurrently instead
    of queueing behind one dispatch thread.

    ``acquire(size)`` returns the least-loaded sub-mesh of that size;
    results are the same at every size, because the partial-aggregate
    merges are exact at any shard count (floats within their
    tolerance: a reduction order per shard count).

    Pod awareness: sub-mesh partitioning never crosses a host
    boundary. The pool splits THIS process's slots; the cross-host
    dimension is the DistSQL merge tree's job (``num_hosts`` is read
    from the rendezvous, parallel/multihost.py)."""

    def __init__(self, mesh: Mesh):
        from cockroach_tpu_torch.parallel import multihost
        self.mesh = mesh
        self.num_hosts = multihost.num_hosts()
        self._subs: dict[int, list[Mesh]] = {}
        size = mesh.size // 2
        while size >= 1:
            self._subs[size] = [mesh.submesh(i, size)
                                for i in range(0, mesh.size, size)]
            size //= 2
        self._inflight: dict[int, list[int]] = {
            s: [0] * len(ms) for s, ms in self._subs.items()}
        self._lock = threading.Lock()
        self._rr = 0
        self.dispatches = 0
        # register the domain family: two pools over the same slots
        # (two engines on one mesh) share ONE gate, as they share one
        # rendezvous domain per slot set
        with _DOMAIN_GATES_LOCK:
            ent = _DOMAIN_GATES.get(_devkey(mesh))
            gate = ent[0] if ent is not None else _DomainGate()
            _DOMAIN_GATES[_devkey(mesh)] = (gate, "root")
            for ms in self._subs.values():
                for m in ms:
                    _DOMAIN_GATES[_devkey(m)] = (gate, "sub")

    def sizes(self) -> list[int]:
        return sorted(self._subs, reverse=True)

    def count(self, size: int) -> int:
        return len(self._subs.get(size, ()))

    def submeshes(self, size: int) -> list:
        return list(self._subs.get(size, ()))

    def occupancy(self) -> int:
        with self._lock:
            return sum(sum(v) for v in self._inflight.values())

    def acquire(self, size: int):
        """Least-loaded sub-mesh of ``size``; returns (mesh, token). Ties
        rotate round-robin, so idle acquires spread over the
        sub-meshes instead of piling onto the first."""
        with self._lock:
            load = self._inflight[size]
            k = len(load)
            i = min(range(k), key=lambda j: (load[j], (j - self._rr) % k))
            self._rr = (i + 1) % k
            load[i] += 1
            self.dispatches += 1
            return self._subs[size][i], (size, i)

    def release(self, token) -> None:
        size, i = token
        with self._lock:
            self._inflight[size][i] = max(0, self._inflight[size][i] - 1)
