"""Straggler detection and cross-host liveness (a copy of
``repro.dist.straggler``, which is plain Python; the port imports nothing
of the JAX package).

``StepWatchdog`` flags step-time outliers online (Welford mean/variance over
non-suspect steps; a step is suspect when it exceeds mean + k_sigma * std and
the absolute ``min_budget_s`` floor).  Suspect steps are excluded from the
running statistics so one hiccup does not inflate the threshold and mask the
next one.  Its always-finite :meth:`StepWatchdog.budget_s` is the staleness
budget of :class:`repro_torch.dist.mvgc.ShardedPagedKVEngine` when
``GCConfig.stale_after_s`` is inf.

``HeartbeatFile`` writes a tiny JSON record through a shared filesystem
(atomic tmp+rename), the standard multi-host liveness channel when hosts
share only storage: a supervisor, or any peer host, declares a host dead
when its heartbeat age exceeds a few step budgets.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import List, Optional


class StepWatchdog:
    """Per-step wall-clock outlier detector.

    >>> wd = StepWatchdog()
    >>> wd.start(); ...train step...; dt = wd.stop(step)
    """

    def __init__(self, k_sigma: float = 3.0, min_budget_s: float = 0.25,
                 warmup_steps: int = 5):
        self.k_sigma = k_sigma
        self.min_budget_s = min_budget_s
        self.warmup_steps = warmup_steps
        self.suspect_steps: List[int] = []
        self._t0: Optional[float] = None
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def threshold(self) -> float:
        """Current suspect threshold in seconds (inf during warmup)."""
        if self._n < self.warmup_steps:
            return math.inf
        std = math.sqrt(self._m2 / max(1, self._n - 1))
        return max(self.min_budget_s, self._mean + self.k_sigma * std)

    def budget_s(self, grace_steps: float = 3.0) -> float:
        """Always-finite staleness budget for cross-host liveness checks,
        in seconds: ``grace_steps`` suspect-thresholds' worth of wall clock.

        Unlike :meth:`threshold`, this never returns inf: during warmup (or
        when ``stop()`` was never called after ``start()``) it falls back to
        ``grace_steps * min_budget_s``.  Comparing a ``HeartbeatFile.age_s``
        of inf (host never beat) against an inf warmup threshold evaluates
        ``inf > inf == False`` — a dead host reads as live exactly while the
        watchdog knows least.  The finite floor closes that hole; the
        sharded-GC staleness aging (DESIGN.md §13) compares ages against
        *this*."""
        thr = self.threshold()
        if not math.isfinite(thr):
            thr = self.min_budget_s
        return grace_steps * thr

    def is_stale(self, age_s: float, grace_steps: float = 3.0) -> bool:
        """True when a heartbeat/announcement of age ``age_s`` seconds is
        past the staleness budget (inf ages — never beaten — are always
        stale; see :meth:`budget_s`)."""
        return age_s > self.budget_s(grace_steps)

    def stop(self, step: int) -> float:
        """Returns the step duration; records ``step`` if it is a straggler."""
        assert self._t0 is not None, "stop() without start()"
        dt = time.monotonic() - self._t0
        self._t0 = None
        if dt > self.threshold():
            self.suspect_steps.append(step)
            return dt  # outliers stay out of the running stats
        self._n += 1
        delta = dt - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (dt - self._mean)
        return dt


class HeartbeatFile:
    """Liveness beacon on the shared filesystem, one file per host."""

    def __init__(self, path: str, host_id: int = 0):
        self.path = path
        self.host_id = int(host_id)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def beat(self, step: int) -> None:
        rec = {"host_id": self.host_id, "step": int(step), "time": time.time()}
        tmp = f"{self.path}.tmp-{self.host_id}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)  # atomic on POSIX

    def read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def age_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last beat (inf when never beaten/corrupt)."""
        rec = self.read()
        if rec is None:
            return math.inf
        return (now if now is not None else time.time()) - rec["time"]
