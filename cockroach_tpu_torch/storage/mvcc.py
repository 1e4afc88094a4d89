"""MVCC operations over the LSM engine: the transactional KV plane.

The analogue of pkg/storage/mvcc.go (MVCCGet :1044, MVCCPut :1428,
MVCCScan :3965) and the intent model of pkg/storage/enginepb: each key
has optionally a *meta* record (an unresolved write intent: which txn,
at what timestamp) sorting before its versioned values, and versioned
values at descending timestamps. Reads at timestamp T return the
newest version <= T; an intent at or below T belongs to a possibly-
uncommitted txn and raises WriteIntentError for consistent reads
(the concurrency layer, kv/concurrency.py, turns that into queueing +
pushes).

Value encoding: empty bytes = MVCC tombstone (deleted row version),
else a 1-byte tag + payload (tag 0x01 raw bytes, 0x02 JSON). Meta
records are JSON TxnMeta. Timestamps quantize to 4096ns (hlc.py), so
tests use Timestamp(wall*4096)-style values via `ts(...)`.
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from .hlc import Timestamp
from .keys import EngineKey, next_key
from .lsm import LSM

TAG_RAW = b"\x01"
TAG_JSON = b"\x02"


def ts(wall: int, logical: int = 0) -> Timestamp:
    """Test-friendly constructor: quantized wall ticks."""
    return Timestamp(wall << 12, logical)


class TxnStatus(Enum):
    PENDING = "pending"
    COMMITTED = "committed"
    ABORTED = "aborted"


@dataclass
class TxnMeta:
    """Transaction metadata carried by intents (enginepb.TxnMeta)."""
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    key: bytes = b""            # anchor key (txn record location)
    epoch: int = 0
    write_ts: Timestamp = Timestamp(0, 0)
    read_ts: Timestamp = Timestamp(0, 0)
    seq: int = 0
    status: TxnStatus = TxnStatus.PENDING

    def to_json(self) -> bytes:
        return json.dumps({
            "id": self.id, "key": self.key.hex(), "epoch": self.epoch,
            "write_ts": self.write_ts.to_int(),
            "read_ts": self.read_ts.to_int(), "seq": self.seq,
        }).encode()

    @staticmethod
    def from_json(b: bytes) -> "TxnMeta":
        d = json.loads(b)
        return TxnMeta(id=d["id"], key=bytes.fromhex(d["key"]),
                       epoch=d["epoch"],
                       write_ts=Timestamp.from_int(d["write_ts"]),
                       read_ts=Timestamp.from_int(d["read_ts"]),
                       seq=d["seq"])


class WriteIntentError(Exception):
    def __init__(self, key: bytes, txn_meta: TxnMeta):
        self.key = key
        self.txn_meta = txn_meta
        super().__init__(f"conflicting intent on {key!r} "
                         f"from txn {txn_meta.id[:8]}")


class WriteTooOldError(Exception):
    def __init__(self, key: bytes, write_ts: Timestamp,
                 existing_ts: Timestamp):
        self.key = key
        self.actual_ts = existing_ts.next()
        super().__init__(
            f"write at {write_ts} too old for {key!r}; "
            f"existing committed value at {existing_ts}")


@dataclass
class MVCCValue:
    key: bytes
    ts: Timestamp
    value: Optional[bytes]  # None = tombstone (deleted)

    @property
    def is_tombstone(self) -> bool:
        return self.value is None


def _enc_value(v: Optional[bytes]) -> bytes:
    return b"" if v is None else TAG_RAW + v


def _dec_value(b: bytes) -> Optional[bytes]:
    if b == b"":
        return None
    if b[:1] == TAG_RAW:
        return b[1:]
    if b[:1] == TAG_JSON:
        return b[1:]
    raise ValueError(f"bad value tag {b[:1]!r}")


class MVCC:
    """MVCC ops bound to an LSM engine instance."""

    def __init__(self, engine: Optional[LSM] = None):
        self.engine = engine or LSM()

    # -- helpers -----------------------------------------------------------
    def _meta(self, key: bytes) -> Optional[TxnMeta]:
        raw = self.engine.get(EngineKey.meta(key))
        return TxnMeta.from_json(raw) if raw is not None else None

    def _newest_version(self, key: bytes,
                        max_ts: Optional[Timestamp] = None
                        ) -> Optional[MVCCValue]:
        """Newest version with ts <= max_ts (or any, if None)."""
        start = (EngineKey.versioned(key, max_ts) if max_ts is not None
                 else EngineKey(key, 0))
        hit = self.engine.get_newest(
            start, EngineKey(next_key(key), -1),
            lambda ek: ek.key == key and not ek.is_meta)
        if hit is None:
            return None
        ek, v = hit
        return MVCCValue(key, ek.ts, _dec_value(v))

    @staticmethod
    def _own(meta: Optional[TxnMeta], txn: Optional[TxnMeta]) -> bool:
        """Own readable intent: same txn AND same epoch — a restarted
        txn (new epoch) must not read its pre-restart provisional
        writes (mvcc.go epoch handling)."""
        return (meta is not None and txn is not None
                and meta.id == txn.id and meta.epoch == txn.epoch)

    def _check_intent(self, key: bytes, read_ts: Timestamp,
                      txn: Optional[TxnMeta],
                      inconsistent: bool) -> Optional[TxnMeta]:
        meta = self._meta(key)
        if meta is None:
            return None
        if txn is not None and meta.id == txn.id:
            return meta  # own txn (any epoch): never a conflict
        if meta.write_ts <= read_ts and not inconsistent:
            raise WriteIntentError(key, meta)
        return meta

    # -- reads -------------------------------------------------------------
    def get(self, key: bytes, read_ts: Timestamp,
            txn: Optional[TxnMeta] = None,
            inconsistent: bool = False) -> Optional[MVCCValue]:
        """MVCCGet: newest version <= read_ts; tombstones read as None
        result (not a value). Own-txn intents are visible at any ts
        (read-your-writes)."""
        meta = self._check_intent(key, read_ts, txn, inconsistent)
        if self._own(meta, txn):
            mv = self._newest_version(key, meta.write_ts)
            if mv is not None and mv.ts == meta.write_ts:
                return None if mv.is_tombstone else mv
        mv = self._newest_version(key, read_ts)
        if mv is not None and meta is not None and \
                not self._own(meta, txn) and mv.ts == meta.write_ts:
            # skip another txn's (or an old epoch's) provisional value
            mv = self._newest_version(key, mv.ts.prev())
        if mv is None or mv.is_tombstone:
            return None
        return mv

    def scan(self, start: bytes, end: bytes, read_ts: Timestamp,
             txn: Optional[TxnMeta] = None, max_keys: int = 0,
             inconsistent: bool = False,
             intents_out: Optional[list] = None) -> list[MVCCValue]:
        """MVCCScan over [start, end).

        In inconsistent mode, skipped intents are appended to
        ``intents_out`` as (key, TxnMeta) so callers (intent cleanup,
        the pebbleMVCCScanner contract) learn what they skipped."""
        out: list[MVCCValue] = []
        cur: Optional[bytes] = None
        have_meta: Optional[TxnMeta] = None
        best: Optional[MVCCValue] = None

        def emit():
            nonlocal best
            if best is not None and not best.is_tombstone:
                out.append(best)
            best = None

        for ek, raw in self.engine.scan(EngineKey.meta(start),
                                        EngineKey.meta(end),
                                        include_tombstones=True):
            if raw is None:
                continue
            if ek.key != cur:
                emit()
                if max_keys and len(out) >= max_keys:
                    return out
                cur = ek.key
                have_meta = None
            if ek.is_meta:
                have_meta = TxnMeta.from_json(raw)
                if not (txn is not None and have_meta.id == txn.id):
                    if have_meta.write_ts <= read_ts:
                        if inconsistent:
                            if intents_out is not None:
                                intents_out.append((ek.key, have_meta))
                        else:
                            raise WriteIntentError(ek.key, have_meta)
                continue
            if best is not None:
                continue  # already have newest visible version
            own = self._own(have_meta, txn)
            vis_ts = read_ts if not own else max(read_ts,
                                                 have_meta.write_ts)
            if ek.ts <= vis_ts:
                skip_provisional = (have_meta is not None and not own
                                    and ek.ts == have_meta.write_ts)
                if not skip_provisional:
                    best = MVCCValue(ek.key, ek.ts, _dec_value(raw))
        emit()
        return out

    # -- writes ------------------------------------------------------------
    def put(self, key: bytes, write_ts: Timestamp, value: Optional[bytes],
            txn: Optional[TxnMeta] = None) -> None:
        """MVCCPut (value=None: MVCCDelete — writes a tombstone).

        Txn writes lay an intent: a meta record + provisional value at
        txn.write_ts. Non-txn writes commit immediately at write_ts."""
        meta = self._meta(key)
        if meta is not None:
            if txn is None or meta.id != txn.id:
                raise WriteIntentError(key, meta)
            if meta.epoch == txn.epoch and txn.seq < meta.seq:
                raise ValueError("seq regression within epoch")
            # replacing own intent: clear the old provisional version
            self.engine.delete(EngineKey.versioned(key, meta.write_ts))
        existing = self._newest_version(key)
        wts = txn.write_ts if txn is not None else write_ts
        if existing is not None and existing.ts >= wts:
            if txn is None:
                raise WriteTooOldError(key, wts, existing.ts)
            # txn path: WriteTooOld bumps the intent timestamp past the
            # existing value (txn refresh decides later whether the txn
            # must restart) — mvcc.go's WriteTooOld intent behavior
            txn.write_ts = existing.ts.next()
            wts = txn.write_ts
        if txn is not None:
            m = TxnMeta(id=txn.id, key=txn.key, epoch=txn.epoch,
                        write_ts=wts, read_ts=txn.read_ts, seq=txn.seq)
            self.engine.write_batch([
                (EngineKey.meta(key), m.to_json()),
                (EngineKey.versioned(key, wts), _enc_value(value)),
            ])
        else:
            self.engine.put(EngineKey.versioned(key, wts),
                            _enc_value(value))

    def delete(self, key: bytes, write_ts: Timestamp,
               txn: Optional[TxnMeta] = None) -> None:
        self.put(key, write_ts, None, txn)

    def resolve_intent(self, key: bytes, txn: TxnMeta,
                       status: TxnStatus,
                       commit_ts: Optional[Timestamp] = None) -> bool:
        """MVCCResolveWriteIntent: commit rewrites the provisional
        version to commit_ts; abort removes it.

        The meta read, the provisional value's read and the batch run
        under the engine's lock: the committer and a pusher that found
        the record COMMITTED may resolve one intent at once, and the
        second must find the meta gone. Interleaved, it read the moved
        provisional value as None and wrote that at commit_ts, a delete
        of the committed version (readers saw the pre-image). Only the
        resolver that reads the meta writes, and never a value it did
        not find."""
        with self.engine.atomic():
            meta = self._meta(key)
            if meta is None or meta.id != txn.id:
                return False
            ops: list = [(EngineKey.meta(key), None)]
            prov_key = EngineKey.versioned(key, meta.write_ts)
            if status == TxnStatus.COMMITTED:
                cts = commit_ts or meta.write_ts
                if cts != meta.write_ts:
                    raw = self.engine.get(prov_key)
                    if raw is None:
                        return False    # another resolver moved it
                    ops.append((prov_key, None))
                    ops.append((EngineKey.versioned(key, cts), raw))
            else:
                ops.append((prov_key, None))
            self.engine.write_batch(ops)
        return True

    def has_writes_between(self, start: bytes, end: bytes,
                           t0: Timestamp, t1: Timestamp,
                           exclude_txn: Optional[str] = None) -> bool:
        """Any committed version in [start,end) with t0 < ts <= t1?
        The span-refresh validity check (kvcoord span refresher):
        provisional values (under a meta record) don't count, nor do
        versions written by `exclude_txn` itself."""
        cur_meta: Optional[TxnMeta] = None
        cur_key: Optional[bytes] = None
        for ek, raw in self.engine.scan(EngineKey.meta(start),
                                        EngineKey.meta(end),
                                        include_tombstones=True):
            if raw is None:
                continue
            if ek.key != cur_key:
                cur_key = ek.key
                cur_meta = None
            if ek.is_meta:
                cur_meta = TxnMeta.from_json(raw)
                continue
            if not (t0 < ek.ts <= t1):
                continue
            if cur_meta is not None and ek.ts == cur_meta.write_ts:
                if exclude_txn is not None and cur_meta.id == exclude_txn:
                    continue  # our own intent
                return True  # foreign intent in the window: refresh fails
            return True
        return False

    # -- GC ------------------------------------------------------------------
    def gc(self, start: bytes, end: bytes, threshold: Timestamp) -> int:
        """MVCC GC over [start, end): drop the versions shadowed as of
        ``threshold`` and the tombstones older than it (the reference's
        mvcc_gc_queue semantics). Nothing under an unresolved intent
        goes: if its txn aborts, the version beneath is live again."""
        removed = 0
        newest_below: set[bytes] = set()
        to_delete: list[EngineKey] = []
        intent_keys: set[bytes] = set()
        for ek, raw in self.engine.scan(EngineKey.meta(start),
                                        EngineKey.meta(end),
                                        include_tombstones=True):
            if ek.is_meta:
                if raw is not None:
                    intent_keys.add(ek.key)
                continue
            if raw is None or ek.key in intent_keys or ek.ts > threshold:
                continue
            if ek.key not in newest_below:
                # the newest version at or below the threshold stays,
                # unless it is a tombstone
                newest_below.add(ek.key)
                if _dec_value(raw) is None:
                    to_delete.append(ek)
            else:
                to_delete.append(ek)  # shadowed below the threshold
        for ek in to_delete:
            self.engine.delete(ek)
            removed += 1
        return removed
