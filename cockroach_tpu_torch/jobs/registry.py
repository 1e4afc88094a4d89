"""Durable jobs: registry, leases, checkpointed resume.

The port of cockroach_tpu/jobs/registry.py (the reference's pkg/jobs:
the Resumer interface ``resume``/``on_fail_or_cancel``
registry.go:1317, adoption registry.go:1508, progress.go). A job is a
JSON record in the transactional KV plane at /System/jobs/<id>, so a
claim is a serializable txn and a checkpoint survives the death of the
session that ran the job: another registry over the same KV adopts any
job whose lease lapsed and resumes it from its last checkpoint.

Adoption runs when a caller asks (``adopt_and_run_all``, ``run_job``);
the node's maintenance loop calls it on a cadence (server/node.py).

The owner of a running job renews its lease to ``now + lease_seconds``
at every checkpoint (in the same KV write as the progress) and through
``JobContext.renew_lease``/``keep_alive`` between checkpoints (at
least every third of ``lease_seconds``), as a claimed job's
sqlliveness session heartbeats in CockroachDB: a job that runs past
``lease_seconds`` (a changefeed runs until canceled) is not adopted
while its owner lives. A job whose owner stopped renewing is adoptable
once its lease lapses. The reference sets the lease at the claim only
and never renews it.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..kv.txn import DB as KVDB
from ..utils import log

JOBS_PREFIX = b"/System/jobs/"

PENDING = "pending"
RUNNING = "running"
SUCCEEDED = "succeeded"
FAILED = "failed"
CANCELED = "canceled"
CANCEL_REQUESTED = "cancel-requested"


class JobsError(Exception):
    pass


class JobCanceled(JobsError):
    """Raised inside a Resumer by ``ctx.check_cancel()``."""


class LeaseLostError(JobsError):
    """The job's lease moved to another session: a pre-empted runner
    stops instead of overwriting the adopter's progress."""


@dataclass
class JobRecord:
    id: int
    type: str
    payload: dict
    status: str = PENDING
    progress: dict = field(default_factory=dict)
    lease_owner: str = ""
    lease_expires: float = 0.0   # unix seconds; 0 = unleased
    error: str = ""
    fraction_completed: float = 0.0

    def encode(self) -> bytes:
        return json.dumps(self.__dict__, sort_keys=True).encode()

    @staticmethod
    def decode(raw: bytes) -> "JobRecord":
        return JobRecord(**json.loads(raw.decode()))


def _job_key(job_id: int) -> bytes:
    return JOBS_PREFIX + f"{job_id:016d}".encode()


class JobContext:
    """What a Resumer sees while it runs (the reference's jobs.Job)."""

    def __init__(self, registry: "Registry", record: JobRecord):
        self._registry = registry
        self.job_id = record.id
        self.payload = dict(record.payload)
        self._progress = dict(record.progress)
        self._renewed_at = registry.now()   # the claim set the lease

    def progress(self) -> dict:
        return dict(self._progress)

    def checkpoint(self, progress: dict,
                   fraction: Optional[float] = None) -> None:
        """Persist progress now and renew the lease in the same write.
        Raises LeaseLostError when another session adopted the job
        meanwhile: the slow runner abandons it."""
        reg = self._registry
        reg._update(self.job_id, progress=dict(progress),
                    fraction=fraction, expect_owner=reg.session_id,
                    lease_expires=reg.now() + reg.lease_seconds)
        self._progress = dict(progress)
        self._renewed_at = reg.now()

    def renew_lease(self) -> None:
        """Extend the lease to now + lease_seconds without a checkpoint
        (a long runner's heartbeat between checkpoints). Raises
        LeaseLostError when another session holds the job."""
        reg = self._registry
        reg._update(self.job_id, expect_owner=reg.session_id,
                    lease_expires=reg.now() + reg.lease_seconds)
        self._renewed_at = reg.now()

    def keep_alive(self) -> None:
        """Renew the lease when a third of ``lease_seconds`` has passed
        since the last renewal or checkpoint: a runner calls it on every
        pass of its loop, whatever its own cadence."""
        reg = self._registry
        if reg.now() - self._renewed_at >= reg.lease_seconds / 3:
            self.renew_lease()

    def check_cancel(self) -> None:
        if self._registry.job(self.job_id).status == CANCEL_REQUESTED:
            raise JobCanceled(f"job {self.job_id} canceled")


class Registry:
    """Create, claim, run and observe jobs over one KV store."""

    def __init__(self, db: KVDB, session_id: str = "node-1",
                 lease_seconds: float = 10.0,
                 now: Callable[[], float] = time.time):
        self.db = db
        self.session_id = session_id
        self.lease_seconds = lease_seconds
        self.now = now
        self._resumers: dict[str, Callable[[], object]] = {}
        self._next_id_hint = 1

    def register(self, job_type: str, factory: Callable[[], object]) -> None:
        """``factory()`` gives an object with ``resume(ctx)`` and,
        optionally, ``on_fail_or_cancel(ctx)``."""
        self._resumers[job_type] = factory

    def create(self, job_type: str, payload: dict) -> int:
        if job_type not in self._resumers:
            raise JobsError(f"no resumer registered for {job_type!r}")

        def txn(t):
            jid = self._next_id_hint
            while t.get(_job_key(jid)) is not None:
                jid += 1
            t.put(_job_key(jid),
                  JobRecord(id=jid, type=job_type, payload=payload).encode())
            return jid
        jid = self.db.txn(txn)
        self._next_id_hint = jid + 1
        return jid

    def job(self, job_id: int) -> JobRecord:
        raw = self.db.get(_job_key(job_id))
        if raw is None:
            raise JobsError(f"job {job_id} does not exist")
        return JobRecord.decode(raw)

    def jobs(self) -> list[JobRecord]:
        return [JobRecord.decode(v) for _k, v in
                self.db.scan(JOBS_PREFIX, JOBS_PREFIX + b"\xff")]

    # -- lifecycle -----------------------------------------------------------
    def _update(self, job_id: int, expect_owner: Optional[str] = None,
                **changes) -> JobRecord:
        def txn(t):
            raw = t.get(_job_key(job_id))
            if raw is None:
                raise JobsError(f"job {job_id} vanished")
            rec = JobRecord.decode(raw)
            if expect_owner is not None and rec.lease_owner != expect_owner:
                raise LeaseLostError(
                    f"job {job_id} lease now held by "
                    f"{rec.lease_owner!r}, not {expect_owner!r}")
            if "progress" in changes:
                rec.progress = changes["progress"]
            if changes.get("fraction") is not None:
                rec.fraction_completed = float(changes["fraction"])
            for f in ("status", "lease_owner", "lease_expires", "error"):
                if f in changes:
                    setattr(rec, f, changes[f])
            t.put(_job_key(job_id), rec.encode())
            return rec
        return self.db.txn(txn)

    def _try_claim(self, job_id: int) -> Optional[JobRecord]:
        """Serializable claim: a pending job, a running one whose lease
        lapsed (the dead-session adoption path) or is ours, or one whose
        cancel was requested."""
        now = self.now()

        def txn(t):
            raw = t.get(_job_key(job_id))
            if raw is None:
                return None
            rec = JobRecord.decode(raw)
            adoptable = (
                rec.status in (PENDING, CANCEL_REQUESTED)
                or (rec.status == RUNNING
                    and (rec.lease_owner == self.session_id
                         or rec.lease_expires <= now)))
            if not adoptable:
                return None
            if rec.status != CANCEL_REQUESTED:
                rec.status = RUNNING
            rec.lease_owner = self.session_id
            rec.lease_expires = now + self.lease_seconds
            t.put(_job_key(job_id), rec.encode())
            return rec
        return self.db.txn(txn)

    def _finish(self, job_id: int, **changes) -> JobRecord:
        """The terminal update of a run this session owns; a lease lost
        meanwhile leaves the record to the adopter."""
        try:
            return self._update(job_id, expect_owner=self.session_id,
                                lease_owner="", lease_expires=0.0,
                                **changes)
        except LeaseLostError:
            return self.job(job_id)

    def run_job(self, job_id: int) -> JobRecord:
        """Claim and run one job to a terminal state, synchronously."""
        rec = self._try_claim(job_id)
        if rec is None:
            return self.job(job_id)
        log.structured(log.JOBS, "job_run", job_id=job_id,
                       job_type=rec.type, owner=self.session_id)
        factory = self._resumers.get(rec.type)
        if factory is None:
            return self._update(job_id, status=FAILED,
                                error=f"no resumer for {rec.type!r}")
        resumer = factory()
        ctx = JobContext(self, rec)
        on_fail = getattr(resumer, "on_fail_or_cancel", None)
        if rec.status == CANCEL_REQUESTED:
            if on_fail is not None:
                on_fail(ctx)
            return self._update(job_id, status=CANCELED, lease_owner="",
                                lease_expires=0.0)
        try:
            resumer.resume(ctx)
        except LeaseLostError:
            # adopted out from under this session (its lease lapsed
            # mid-chunk): the adopter owns the record now
            return self.job(job_id)
        except JobCanceled:
            if on_fail is not None:
                on_fail(ctx)
            return self._finish(job_id, status=CANCELED)
        except _CrashForTesting:
            # a simulated death: the record stays RUNNING with its
            # lease, which only expiry lets another registry adopt
            raise
        except Exception as e:  # a Resumer failure is terminal
            log.error(log.JOBS, "job %s (%s) failed: %s", job_id, rec.type, e)
            if on_fail is not None:
                try:
                    on_fail(ctx)
                except Exception as e2:
                    log.error(log.JOBS, "job %s rollback failed: %s",
                              job_id, e2)
            return self._finish(job_id, status=FAILED, error=str(e))
        return self._finish(job_id, status=SUCCEEDED, fraction=1.0)

    def adopt_and_run_all(self) -> list[JobRecord]:
        """Run every adoptable job once (the adoption loop's body)."""
        now = self.now()
        return [self.run_job(rec.id) for rec in self.jobs()
                if rec.status in (PENDING, CANCEL_REQUESTED)
                or (rec.status == RUNNING and rec.lease_expires <= now)]

    def cancel(self, job_id: int) -> JobRecord:
        rec = self.job(job_id)
        if rec.status in (SUCCEEDED, FAILED, CANCELED):
            return rec
        if rec.status == PENDING:
            return self._update(job_id, status=CANCELED)
        return self._update(job_id, status=CANCEL_REQUESTED)


class _CrashForTesting(BaseException):
    """Fault injection (the reference's TestingKnobs): the process dies
    mid-job, its lease and its last checkpoint stay."""
