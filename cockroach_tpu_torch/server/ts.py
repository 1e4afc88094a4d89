"""Internal time-series database: metrics stored in the KV plane.

The analogue of pkg/ts (ts/db.go:91 DB, :214 StoreData): every node
periodically snapshots its metric registry into the KV store itself —
samples at a fine resolution are appended to hourly "slabs" keyed by
(resolution, metric, slab start), and a maintenance pass rolls old
fine-resolution slabs up to a coarse resolution and prunes beyond the
retention horizon (the reference's ts maintenance queue). Queries
read slabs and downsample server-side, which is what backs the DB
console graphs.

Layout:  /ts/<res_s>/<metric>/<slab_start_s>  ->  json [[offset_s, value], ...]

The port's copy of cockroach_tpu/server/ts.py, over the port's kv.DB.
"""

from __future__ import annotations

import json
import time

TS_PREFIX = b"/ts/"
FINE_RES_S = 10          # sample resolution (reference: 10s)
COARSE_RES_S = 300       # rollup resolution (reference: 30m; 5m here)
SLAB_S = 3600            # one KV entry holds an hour of samples


def _slab_key(res_s: int, metric: str, slab_start: int) -> bytes:
    return (TS_PREFIX + str(res_s).encode() + b"/" + metric.encode()
            + b"/" + str(slab_start).zfill(12).encode())


class TimeSeriesDB:
    def __init__(self, kv, metrics, now_s=None):
        self.kv = kv              # kv.txn.DB
        self.metrics = metrics    # utils.metric.MetricRegistry
        self.now_s = now_s or time.time

    # -- write path ----------------------------------------------------------
    def record(self) -> int:
        """Snapshot every scalar metric into its current fine slab.
        Counter/gauge values are stored as-is (cumulative counters are
        rate()-ed at query time, like Prometheus)."""
        now = int(self.now_s())
        samples = []
        for name, m in self.metrics.snapshot().items():
            v = m if isinstance(m, (int, float)) else None
            if v is None and isinstance(m, dict):
                continue  # histograms are not stored (quantiles are
                # derived live; the reference stores summary gauges)
            if v is not None:
                samples.append((name, float(v)))
        if not samples:
            return 0
        slab_start = now - now % SLAB_S
        offset = now - slab_start

        def fn(t):
            for name, v in samples:
                key = _slab_key(FINE_RES_S, name, slab_start)
                raw = t.get(key)
                slab = json.loads(raw.decode()) if raw else []
                if slab and slab[-1][0] == offset:
                    slab[-1][1] = v
                else:
                    slab.append([offset, v])
                t.put(key, json.dumps(slab).encode())
        self.kv.txn(fn)
        return len(samples)

    # -- read path -----------------------------------------------------------
    def query(self, metric: str, start_s: int, end_s: int,
              downsample_s: int = FINE_RES_S, agg: str = "avg",
              rate: bool = False) -> list[tuple[int, float]]:
        """Samples of `metric` in [start_s, end_s), bucketed to
        `downsample_s` with avg/min/max/sum aggregation; rate=True
        returns the per-second derivative (for cumulative counters),
        clamped at 0 across resets."""
        pts: list[tuple[int, float]] = []
        for res in (FINE_RES_S, COARSE_RES_S):
            lo = start_s - start_s % SLAB_S
            klo = _slab_key(res, metric, lo)
            khi = _slab_key(res, metric, end_s)
            for _k, v in self.kv.scan(klo, khi + b"\xff"):
                slab_start = int(_k.rsplit(b"/", 1)[1])
                for off, val in json.loads(v.decode()):
                    ts = slab_start + off
                    if start_s <= ts < end_s:
                        pts.append((ts, val))
        pts.sort()
        # dedup (a timestamp present in both resolutions): fine wins
        dedup: dict[int, float] = {}
        for ts, val in pts:
            dedup.setdefault(ts, val)
        pts = sorted(dedup.items())
        if rate:
            rated = []
            for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                dt = t1 - t0
                if dt > 0:
                    rated.append((t1, max(0.0, (v1 - v0) / dt)))
            pts = rated
        if downsample_s <= FINE_RES_S:
            return pts
        buckets: dict[int, list[float]] = {}
        for ts, val in pts:
            buckets.setdefault(ts - ts % downsample_s, []).append(val)
        fn = {"avg": lambda xs: sum(xs) / len(xs), "min": min,
              "max": max, "sum": sum}.get(agg)
        if fn is None:
            raise ValueError(f"unknown downsampler {agg!r}")
        return [(b, fn(xs)) for b, xs in sorted(buckets.items())]

    def list_metrics(self) -> list[str]:
        names = set()
        for k, _v in self.kv.scan(TS_PREFIX,
                                  TS_PREFIX + b"\xff"):
            parts = k[len(TS_PREFIX):].split(b"/")
            if len(parts) == 3:
                names.add(parts[1].decode())
        return sorted(names)

    # -- maintenance (rollup + prune) ----------------------------------------
    def maintain(self, retention_fine_s: int = 6 * 3600,
                 retention_coarse_s: int = 30 * 24 * 3600) -> dict:
        """One ts-maintenance pass: roll fine slabs older than the
        fine retention up into the coarse resolution (avg per coarse
        bucket), then delete them; prune coarse slabs beyond the
        coarse retention. Returns counts."""
        now = int(self.now_s())
        fine_cut = now - retention_fine_s
        coarse_cut = now - retention_coarse_s
        rolled = pruned = 0
        prefix = TS_PREFIX + str(FINE_RES_S).encode() + b"/"
        for k, v in list(self.kv.scan(prefix, prefix + b"\xff")):
            parts = k[len(prefix):].split(b"/")
            metric, slab_start = parts[0].decode(), int(parts[1])
            if slab_start + SLAB_S > fine_cut:
                continue  # still within fine retention
            buckets: dict[int, list[float]] = {}
            for off, val in json.loads(v.decode()):
                ts = slab_start + off
                buckets.setdefault(ts - ts % COARSE_RES_S,
                                   []).append(val)

            def fn(t, k=k, metric=metric, buckets=buckets):
                for b, xs in sorted(buckets.items()):
                    ck = _slab_key(COARSE_RES_S, metric,
                                   b - b % SLAB_S)
                    raw = t.get(ck)
                    slab = json.loads(raw.decode()) if raw else []
                    off = b - (b - b % SLAB_S)
                    if not any(o == off for o, _ in slab):
                        slab.append([off, sum(xs) / len(xs)])
                        slab.sort()
                        t.put(ck, json.dumps(slab).encode())
                t.delete(k)
            self.kv.txn(fn)
            rolled += 1
        cprefix = TS_PREFIX + str(COARSE_RES_S).encode() + b"/"
        for k, _v in list(self.kv.scan(cprefix, cprefix + b"\xff")):
            slab_start = int(k.rsplit(b"/", 1)[1])
            if slab_start + SLAB_S <= coarse_cut:
                self.kv.txn(lambda t, k=k: t.delete(k))
                pruned += 1
        return {"rolled_up": rolled, "pruned": pruned}
