"""Device memory as the card's allocator reports it
(cockroach_tpu/utils/devstats.py over ``torch.cuda.memory_stats()`` and
``torch.cuda.mem_get_info()``). ``utils/mon.py`` accounts what the
budget admitted; this module reads what the caching allocator really
holds, so the two can be printed side by side. On the CPU there is no
allocator report and the monitor's reservations stand in. ``register``
publishes them, with the statements' execute seconds and the backlog
in front of the card (writers at the statement gate and executions
queued at the mesh dispatchers), as the reference's ``exec.device.*``
metrics."""

from __future__ import annotations

import threading

import torch


class DeviceStats:
    """Allocated bytes, their high-water mark and the card's free and
    total memory for one engine's device."""

    def __init__(self, device: torch.device, hbm=None):
        self.device = device
        self._hbm_monitor = hbm
        self._lock = threading.Lock()
        self._watermark = 0
        self._util_seconds = 0.0
        self.queue_depth = self.dispatch_depth

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def hbm_bytes(self) -> int:
        """Bytes the allocator holds for tensors now (the monitor's
        reservations on the CPU)."""
        if self._cuda():
            v = int(torch.cuda.memory_stats(self.device)
                    .get("allocated_bytes.all.current", 0))
        else:
            v = int(self._hbm_monitor.used) if self._hbm_monitor else 0
        with self._lock:
            self._watermark = max(self._watermark, v)
        return v

    def hbm_watermark(self) -> int:
        """High-water mark: the allocator's peak since the last
        ``reset_peak`` on the card, else the largest value read."""
        v = self.hbm_bytes()
        if self._cuda():
            return int(torch.cuda.max_memory_allocated(self.device))
        with self._lock:
            return max(self._watermark, v)

    def reset_peak(self) -> None:
        if self._cuda():
            torch.cuda.reset_peak_memory_stats(self.device)
        with self._lock:
            self._watermark = 0

    def free_total(self) -> tuple[int, int] | None:
        """(free, total) bytes of the card, or None on the CPU."""
        if not self._cuda():
            return None
        free, total = torch.cuda.mem_get_info(self.device)
        return int(free), int(total)

    def note_execute(self, seconds: float) -> None:
        """Credit one statement's execute seconds (its wall time)."""
        if seconds > 0:
            with self._lock:
                self._util_seconds += seconds

    def util_seconds(self) -> float:
        with self._lock:
            return self._util_seconds

    @staticmethod
    def dispatch_depth() -> int:
        """Executions queued at every mesh dispatcher alive in the
        process (parallel/distagg.py)."""
        from ..parallel import distagg
        with distagg._DISPATCHERS_LOCK:
            live = list(distagg._DISPATCHERS.values())
        return sum(d.depth() for d in live)

    def register(self, metrics, queue_depth=None) -> "DeviceStats":
        """The ``exec.device.*`` metrics; ``queue_depth`` reads the
        statements waiting at the gate, to which the dispatchers'
        queued executions add."""
        if queue_depth is not None:
            self.queue_depth = lambda: queue_depth() + self.dispatch_depth()
        metrics.func_gauge(
            "exec.device.hbm.bytes", self.hbm_bytes,
            "device memory in use: the allocator's report on the card, "
            "the budget's reservations on the CPU")
        metrics.func_gauge(
            "exec.device.hbm.watermark", self.hbm_watermark,
            "high-water mark of exec.device.hbm.bytes")
        metrics.func_counter(
            "exec.device.util.seconds", self.util_seconds,
            "cumulative per-statement execute seconds")
        metrics.func_gauge(
            "exec.device.queue.depth", lambda: self.queue_depth(),
            "statements waiting in front of the card (writers at the "
            "statement gate, executions queued at the mesh "
            "dispatchers)")
        return self
