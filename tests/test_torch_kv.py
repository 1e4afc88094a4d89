"""The port's transactional KV plane (kv/, storage/mvcc.py and below)
against the JAX package's, on the shapes of tests/test_kv_txn.py:
latches, the timestamp cache, intents and read-your-writes, rollback,
write-write conflicts resolved by a push, the tscache bumping a writer,
read refresh (success and failure), the retry loop and the abort path.

Each deterministic scenario runs on both implementations and returns a
trace of what it observed (values read, errors raised by class name,
the order of timestamps): the traces must be equal, and equal to the
expected one. A short randomized concurrent bank (4 threads, 0.5 s)
then checks the port alone for serializability, as the reference's
kvnemesis test does.
"""

from __future__ import annotations

import importlib
import random
import threading
import time
from types import SimpleNamespace

import pytest

PKGS = {"port": "cockroach_tpu_torch", "ref": "cockroach_tpu"}


def _kv(pkg):
    conc = importlib.import_module(f"{pkg}.kv.concurrency")
    txn = importlib.import_module(f"{pkg}.kv.txn")
    mvcc = importlib.import_module(f"{pkg}.storage.mvcc")
    return SimpleNamespace(
        Span=conc.Span, SpanLatchManager=conc.SpanLatchManager,
        TimestampCache=conc.TimestampCache,
        TxnAbortedError=conc.TxnAbortedError,
        TxnRetryError=conc.TxnRetryError, DB=txn.DB, Txn=txn.Txn,
        ts=mvcc.ts)


def _try(trace, fn, *errs):
    try:
        trace.append(("ok", fn()))
    except errs as e:
        trace.append(("err", type(e).__name__))


def s_latches(k):
    trace = []
    m = k.SpanLatchManager()
    g1 = m.acquire([(k.Span(b"a"), False)])
    g2 = m.acquire([(k.Span(b"a"), False)], timeout=0.5)  # read-read
    m.release(g1)
    m.release(g2)
    g1 = m.acquire([(k.Span(b"a", b"c"), True)])
    g2 = m.acquire([(k.Span(b"d", b"f"), True)], timeout=0.5)  # disjoint
    m.release(g2)
    _try(trace, lambda: m.acquire([(k.Span(b"b"), False)], timeout=0.05),
         TimeoutError)
    m.release(g1)
    got = []

    def reader():
        g = m.acquire([(k.Span(b"x"), False)], timeout=5)
        got.append(1)
        m.release(g)

    w = m.acquire([(k.Span(b"x"), True)])
    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.05)
    trace.append(("blocked", not got))
    m.release(w)
    t.join(timeout=5)
    trace.append(("joined", not t.is_alive() and bool(got)))
    return trace


def s_tscache(k):
    c = k.TimestampCache()
    c.add(k.Span(b"a"), k.ts(10))
    c.add(k.Span(b"c", b"f"), k.ts(20))
    return [c.get_max(k.Span(b"a")) == k.ts(10),
            c.get_max(k.Span(b"b")) == c.low_water,
            c.get_max(k.Span(b"d")) == k.ts(20),
            c.get_max(k.Span(b"a", b"z")) == k.ts(20)]


def s_intents(k):
    trace = []
    db = k.DB()
    t = k.Txn(db.store)
    t.put(b"k", b"v1")
    trace.append(t.get(b"k"))            # read your own intent
    t2 = k.Txn(db.store)
    # a pending intent is never read as committed: the reader's push
    # either fails (retry) or aborts the writer and reads nothing
    _try(trace, lambda: t2.get(b"k"), k.TxnRetryError)
    t2.rollback()
    _try(trace, lambda: t.commit() is not None, k.TxnAbortedError)
    trace.append(db.get(b"k"))
    t = k.Txn(db.store)
    t.put(b"r", b"gone")
    t.rollback()
    trace.append(db.get(b"r"))           # rollback discards
    trace.append(len(db.store.txns._records))
    return trace


def s_write_write(k):
    trace = []
    db = k.DB()
    t1 = k.Txn(db.store)
    t1.put(b"k", b"t1")
    # t1's heartbeat expires, so t2's push aborts it
    db.store.txns.get(t1.meta.id).last_heartbeat -= 100
    t2 = k.Txn(db.store)
    t2.put(b"k", b"t2")
    t2.commit()
    _try(trace, t1.commit, k.TxnAbortedError)
    trace.append(db.get(b"k"))
    return trace


def s_tscache_bumps_writer(k):
    db = k.DB()
    db.put(b"k", b"v0")
    t1 = k.Txn(db.store)
    t2 = k.Txn(db.store)
    seen = t2.get(b"k")
    t2.commit()
    t1.put(b"k", b"v1")
    return [seen, t1.commit() > t2.meta.read_ts]


def s_refresh(k):
    trace = []
    db = k.DB()
    db.put(b"a", b"a0")
    db.put(b"b", b"b0")
    t = k.Txn(db.store)
    trace.append(t.get(b"a"))
    t3 = k.Txn(db.store)
    trace.append(t3.get(b"k2"))
    t3.commit()
    t.put(b"k2", b"x")                    # bumped above t3's read
    _try(trace, lambda: t.commit() is not None, k.TxnRetryError)
    t = k.Txn(db.store)
    trace.append(t.get(b"b"))
    db.put(b"b", b"b1")                   # behind the txn's read
    t4 = k.Txn(db.store)
    trace.append(t4.get(b"k3"))
    t4.commit()
    t.put(b"k3", b"y")
    _try(trace, t.commit, k.TxnRetryError)
    return trace


def s_retry_loop(k):
    db = k.DB()
    db.put(b"b", b"b0")
    calls = []

    def fn(t):
        calls.append(1)
        v = t.get(b"b")
        if len(calls) == 1:
            db.put(b"b", b"b1")
            t5 = k.Txn(db.store)
            t5.get(b"sab")
            t5.commit()
        t.put(b"sab", b"s")
        return v

    v = db.txn(fn)
    return [len(calls) >= 2, v]


def s_abort_in_fn(k):
    db = k.DB()
    trace = []
    _try(trace, lambda: db.txn(lambda t: (t.put(b"zz", b"v"), 1 / 0)),
         ZeroDivisionError)
    trace.append(len(db.store.txns._records))
    db.put(b"zz", b"clean")               # no zombie intent in the way
    trace.append(db.get(b"zz"))

    def rmw(t):
        t.get(b"zz")
        t.put(b"zz", b"v1")
        return t.meta.write_ts == t.meta.read_ts
    trace.append(db.txn(rmw))             # own read never pushes
    return trace


SCENARIOS = {
    "latches": (s_latches, [("err", "TimeoutError"), ("blocked", True),
                            ("joined", True)]),
    "tscache": (s_tscache, [True, True, True, True]),
    # the reader's push aborts the writer, whose commit then fails;
    # the aborted record stays until a rollback removes it
    "intents": (s_intents, [b"v1", ("ok", None), ("err", "TxnAbortedError"),
                            None, None, 1]),
    "write_write": (s_write_write, [("err", "TxnAbortedError"), b"t2"]),
    "tscache_bumps_writer": (s_tscache_bumps_writer, [b"v0", True]),
    "refresh": (s_refresh, [b"a0", None, ("ok", True), b"b0", None,
                            ("err", "TxnRetryError")]),
    "retry_loop": (s_retry_loop, [True, b"b1"]),
    "abort_in_fn": (s_abort_in_fn, [("err", "ZeroDivisionError"), 0,
                                    b"clean", True]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_kv_scenario_equals_reference(name):
    fn, want = SCENARIOS[name]
    got = {side: fn(_kv(pkg)) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"] == want


def test_concurrent_transfers_serializable():
    k = _kv(PKGS["port"])
    accounts, initial = 6, 100
    db = k.DB()
    for i in range(accounts):
        db.put(b"acct%d" % i, str(initial).encode())
    committed, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker(seed):
        rng = random.Random(seed)
        while not stop.is_set():
            frm, to = rng.sample(range(accounts), 2)
            amt = rng.randrange(1, 20)
            t = k.Txn(db.store)
            try:
                bf = int(t.get(b"acct%d" % frm))
                bt = int(t.get(b"acct%d" % to))
                if bf < amt:
                    t.rollback()
                    continue
                t.put(b"acct%d" % frm, str(bf - amt).encode())
                t.put(b"acct%d" % to, str(bt + amt).encode())
                cts = t.commit()
                with lock:
                    committed.append((cts, frm, to, amt, bf, bt))
            except (k.TxnRetryError, k.TxnAbortedError):
                t.rollback()
            except Exception as e:   # reported below
                errors.append(e)
                return

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert committed
    committed.sort(key=lambda e: e[0])
    model = {i: initial for i in range(accounts)}
    for _cts, frm, to, amt, bf, bt in committed:
        assert (model[frm], model[to]) == (bf, bt)
        model[frm] -= amt
        model[to] += amt
    assert all(model[i] == int(db.get(b"acct%d" % i))
               for i in range(accounts))


def _pushed_committed_intent(k):
    """A store holding one txn's intent on b"k" that the txn committed
    above the intent's timestamp (a served read of b"j" pushed its write
    timestamp). Returns (db, txn meta, commit ts, intent ts)."""
    mvcc = importlib.import_module("cockroach_tpu_torch.storage.mvcc")
    db = k.DB()
    db.put(b"k", b"v0")
    t = k.Txn(db.store)
    t.put(b"k", b"v1")
    laid = t.meta.write_ts
    r = k.Txn(db.store)
    r.get(b"j")                       # the tscache now sits above laid
    r.commit()
    t.put(b"j", b"w")                 # pushes t's write timestamp
    cts = t.meta.write_ts
    assert cts > laid
    db.store.txns.end(t.meta.id, mvcc.TxnStatus.COMMITTED, commit_ts=cts)
    return db, t.meta, cts, laid


@pytest.mark.parametrize("second", ["nested", "thread"])
def test_two_resolvers_of_a_pushed_intent_keep_the_value(second):
    """Two resolvers of one committed intent pushed above its timestamp
    (the committer and a pusher that found the record COMMITTED) must
    leave the committed value at the commit timestamp. The second
    resolver runs between the first one's meta read and its move of
    the provisional value: in the same thread ("nested"), or in another
    that the first waits for ("thread"). A resolution that is not
    atomic writes the missing provisional value, None, at the commit
    timestamp, which erases the committed version: readers then see
    v0."""
    mvcc_mod = importlib.import_module("cockroach_tpu_torch.storage.mvcc")
    k = _kv(PKGS["port"])
    db, meta, cts, _laid = _pushed_committed_intent(k)
    mvcc = db.store.mvcc
    committed = mvcc_mod.TxnStatus.COMMITTED
    meta_of = mvcc._meta
    fired = threading.Event()
    done = threading.Event()
    other: list = []

    def resolve_other():
        try:
            other.append(mvcc.resolve_intent(b"k", meta, committed, cts))
        finally:
            done.set()

    def hooked_meta(key):
        got = meta_of(key)
        if key == b"k" and not fired.is_set():
            fired.set()
            if second == "nested":
                resolve_other()
            else:
                th = threading.Thread(target=resolve_other, daemon=True)
                th.start()
                # a resolution that holds the engine keeps the other
                # out until it ends: the wait then expires
                done.wait(timeout=0.5)
        return got

    mvcc._meta = hooked_meta
    try:
        first = mvcc.resolve_intent(b"k", meta, committed, cts)
    finally:
        mvcc._meta = meta_of
    assert done.wait(timeout=10)
    assert mvcc._meta(b"k") is None
    got = mvcc.get(b"k", db.store.clock.now())
    assert got is not None and (got.ts, got.value) == (cts, b"v1")
    assert db.get(b"k") == b"v1"
    # exactly one of the two resolved it
    assert sorted([first] + other) == [False, True]
