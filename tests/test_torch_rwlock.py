"""The statement gate's lock (cockroach_tpu_torch/utils/rwlock.py):
readers share it, a writer excludes readers and other writers, the
write side is reentrant (a read under the write side too), a waiting
writer holds back new readers, and a read-to-write upgrade raises
instead of deadlocking. Every thread joins within a timeout."""

import threading

import pytest

from cockroach_tpu_torch.utils.rwlock import RWLock

TIMEOUT = 10.0


def _start(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def test_readers_share():
    lock = RWLock()
    inside = threading.Barrier(3, timeout=TIMEOUT)

    def reader():
        lock.acquire_read()
        try:
            inside.wait()      # all three hold the read side at once
        finally:
            lock.release_read()

    ts = [_start(reader) for _ in range(3)]
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive()


def test_writer_excludes_readers_and_writers():
    lock = RWLock()
    lock.acquire_write()
    got = []
    ts = [_start(lambda: (lock.acquire_read(), got.append("r"),
                          lock.release_read())),
          _start(lambda: (lock.acquire_write(), got.append("w"),
                          lock.release_write()))]
    threading.Event().wait(0.2)
    assert got == []
    lock.release_write()
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert sorted(got) == ["r", "w"]


def test_write_side_reentrant():
    lock = RWLock()
    with lock:
        with lock:
            lock.acquire_read()      # a read under the write side
            lock.release_read()
    # released fully: another thread can write now
    t = _start(lambda: (lock.acquire_write(), lock.release_write()))
    t.join(TIMEOUT)
    assert not t.is_alive()


def test_waiting_writer_holds_back_new_readers():
    lock = RWLock()
    lock.acquire_read()
    order = []
    w = _start(lambda: (lock.acquire_write(), order.append("w"),
                        lock.release_write()))
    while not lock._waiting_writers:
        threading.Event().wait(0.01)
    r = _start(lambda: (lock.acquire_read(), order.append("r"),
                        lock.release_read()))
    threading.Event().wait(0.2)
    assert order == []            # the new reader waits behind the writer
    lock.release_read()
    for t in (w, r):
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert order == ["w", "r"]


def test_upgrade_raises():
    lock = RWLock()
    lock.acquire_read()
    try:
        with pytest.raises(RuntimeError, match="upgrade"):
            lock.acquire_write()
    finally:
        lock.release_read()
    with lock:                    # nothing leaked
        pass
