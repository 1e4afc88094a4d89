"""The shard axis and its rendezvous: the port's form of shard_map's
collectives.

The reference compiles a distributed plan into one SPMD program under
``shard_map`` and merges per-shard partials with ``psum``/``pmin``/
``pmax``, ``all_gather`` and ``all_to_all`` over the mesh's ``shards``
axis, inside the program (cockroach_tpu/exec/compile.py). Here the
compiled plan runs once per shard slot, one thread each
(``run_sharded``), and keeps those call sites: the plan calls
``axis.psum(x)`` and the like on ``AXIS``, which finds the running
shard's rendezvous through a thread-local.

A collective is a rendezvous: a barrier at which every shard thread
leaves its tensor. The last to arrive runs one reduction **in fixed
shard order** (0, 1, ..., N-1), so float results are the same from run
to run, and every thread takes the result back on its own slot's
device (copied between cards where slots sit on different cards; a
fresh copy for each other slot on one device, so no two shards alias
one tensor). Every wait has a timeout (``CollectiveTimeout``). A shard
that raises aborts the rendezvous: the others leave their waits at
once with ``ShardAborted``, and ``run_sharded`` re-raises the first
shard's own error.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from .mesh import SHARD_AXIS

# seconds a shard waits at a collective, and a distributed run's whole
# budget; generous, since a shard may build a kernel library first
COLLECTIVE_TIMEOUT_S = 300.0

_CTX = threading.local()


class CollectiveError(RuntimeError):
    """A collective used outside a distributed run, or shards that
    disagree on which collective they are at."""


class CollectiveTimeout(CollectiveError):
    """A shard waited past its timeout at a collective, or a
    distributed run outlived its budget."""


class ShardAborted(CollectiveError):
    """Another shard of this run failed; this one left its wait."""


def _fold_bool(fn):
    def folded(a, b):
        if a.dtype == torch.bool:
            return fn(a.to(torch.uint8), b.to(torch.uint8)).to(torch.bool)
        return fn(a, b)
    return folded


_ELEMENTWISE = {
    "sum": torch.add,
    "min": _fold_bool(torch.minimum),
    "max": _fold_bool(torch.maximum),
}


def _combine(op: str, xs: list, devices: tuple):
    """The reduction of one collective over every shard's tensor, in
    shard order, on slot 0's device; for all_to_all, one result a
    shard, on that shard's device."""
    dev0 = xs[0].device
    if op in _ELEMENTWISE:
        fold = _ELEMENTWISE[op]
        acc = xs[0]
        for x in xs[1:]:
            acc = fold(acc, x.to(dev0))
        return acc
    if op == "gather":
        return torch.cat([x.to(dev0) for x in xs])
    if op == "all_to_all":
        n = len(xs)
        if xs[0].shape[0] % n:
            raise CollectiveError("all_to_all: rows not a multiple of "
                                  "the shard count")
        blk = xs[0].shape[0] // n
        return [torch.cat([x[j * blk:(j + 1) * blk].to(devices[j])
                           for x in xs]) for j in range(n)]
    raise CollectiveError(f"unknown collective {op!r}")


class _Rendezvous:
    """One distributed run's meeting point: N shard threads."""

    def __init__(self, devices: tuple, timeout: float):
        self.devices = tuple(devices)
        self.n = len(self.devices)
        self.timeout = timeout
        self._in: list = [None] * self.n
        self._out = None
        self._err: BaseException | None = None
        self._aborted = False
        self._barrier = threading.Barrier(self.n, action=self._reduce)

    def _reduce(self) -> None:
        try:
            ops = {op for op, _ in self._in}
            if len(ops) != 1:
                raise CollectiveError(
                    f"shards disagree on the collective: {sorted(ops)}")
            op = ops.pop()
            self._out = (op, _combine(op, [x for _, x in self._in],
                                      self.devices))
        except BaseException as e:
            self._err = e
            raise
        finally:
            self._in = [None] * self.n

    def collective(self, i: int, op: str, x: torch.Tensor):
        self._in[i] = (op, x)
        try:
            self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            if self._err is not None:
                raise ShardAborted(
                    f"collective {op} failed: {self._err!r}") from None
            if self._aborted:
                raise ShardAborted(f"shard {i} left collective {op}: "
                                   "another shard failed") from None
            raise CollectiveTimeout(
                f"shard {i} waited past {self.timeout} s at collective "
                f"{op}") from None
        _, out = self._out
        if op == "all_to_all":
            return out[i]
        if i == 0:
            return out
        dev = self.devices[i]
        return out.clone() if out.device == dev else out.to(dev)

    def abort(self) -> None:
        self._aborted = True
        self._barrier.abort()


class ShardAxis:
    """The mesh axis a distributed plan's collectives run over (the
    reference's ``axis_name``). Each method is a collective: every shard
    of the running plan must call it, in the same order."""

    name = SHARD_AXIS

    @staticmethod
    def _shard():
        cur = getattr(_CTX, "shard", None)
        if cur is None:
            raise CollectiveError("a shard-axis collective outside a "
                                  "distributed run")
        return cur

    def index(self) -> int:
        return self._shard()[1]

    def _call(self, op: str, x: torch.Tensor):
        rz, i = self._shard()
        return rz.collective(i, op, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._call("sum", x)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._call("min", x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._call("max", x)

    def all_gather(self, x: torch.Tensor, tiled: bool = True):
        """Every shard's x concatenated along rows, in shard order."""
        if not tiled:
            raise CollectiveError("all_gather: only the tiled form")
        return self._call("gather", x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Row block j of every shard's x, in shard order, to shard j
        (split and concat along rows, tiled)."""
        return self._call("all_to_all", x)

    def __repr__(self) -> str:
        return f"ShardAxis({self.name!r})"


AXIS = ShardAxis()


@contextlib.contextmanager
def _on_device(dev: torch.device):
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            yield
    else:
        yield


def run_sharded(devices, fn, timeout: float | None = None, carry=None):
    """Run ``fn(i)`` for every shard slot i, one thread each, with the
    shard axis bound to one rendezvous; returns the N results. ``carry``
    (a context-manager factory) runs around each shard's call, to carry
    the issuing thread's statement state into it. A shard that raises
    aborts the others' waits; the first shard's own error is raised
    (not a ShardAborted of the shards it released). Raises
    CollectiveTimeout when a wait or the whole run passes ``timeout``
    (COLLECTIVE_TIMEOUT_S by default)."""
    timeout = COLLECTIVE_TIMEOUT_S if timeout is None else timeout
    devices = tuple(devices)
    n = len(devices)
    rz = _Rendezvous(devices, timeout)
    results: list = [None] * n
    errors: list = [None] * n

    def body(i: int) -> None:
        _CTX.shard = (rz, i)
        try:
            with _on_device(devices[i]), \
                    (carry() if carry is not None
                     else contextlib.nullcontext()):
                results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            rz.abort()
        finally:
            _CTX.shard = None

    threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                name=f"shard-{i}") for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        rz.abort()
        for t in threads:
            t.join(1.0)
        raise CollectiveTimeout(f"a distributed run passed {timeout} s")
    own = [e for e in errors if e is not None
           and not isinstance(e, ShardAborted)]
    if own:
        raise own[0]
    failed = [e for e in errors if e is not None]
    if failed:
        raise failed[0]
    return results
