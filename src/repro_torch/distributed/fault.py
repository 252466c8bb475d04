"""Straggler / failure handling harness (host-side control plane).

Port of `repro.distributed.fault` (it imports neither jax nor torch; the
copy keeps the port free of the JAX package).

At 1000+ nodes the control plane must notice slow or dead workers. This
module provides the pieces the launcher composes:

  * StepMonitor — per-step timing stats, flags stragglers beyond a
    robust threshold (median + k·MAD), keeps an incident log.
  * HeartbeatTracker — host heartbeats with a dead-man switch.
  * simulate_failures — deterministic failure injection for tests
    (used with checkpoint.restart to prove exact-replay recovery).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StepMonitor:
    window: int = 64
    mad_k: float = 5.0
    # history bound: long-lived consumers (the runtime's per-site RPC
    # monitor, the serving dispatch monitor — see RuntimeStats.faults)
    # record forever; percentiles cover recent history, memory stays flat
    max_history: int = 4096
    times: list = field(default_factory=list)
    incidents: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler.

        Hot path — called once per serving dispatch / site RPC, so the
        common (non-straggler) case is a slice + append + `sum()` over
        the <=64-entry window; the median/MAD pair only runs when the
        sample already clears the cheap mean guard (a straggler is
        several sigma out, so it clears any reasonable mean too)."""
        hist = self.times[-self.window:]
        self.times.append(seconds)
        if len(self.times) >= 2 * self.max_history:
            del self.times[:-self.max_history]
        if len(self.incidents) >= 2 * self.max_history:
            del self.incidents[:-self.max_history]
        n = len(hist)
        if n < 8:
            return False
        if seconds <= 1.2 * (sum(hist) / n):
            return False
        srt = sorted(hist)
        mid = n // 2
        med = srt[mid] if n % 2 else 0.5 * (srt[mid - 1] + srt[mid])
        dev = sorted(abs(t - med) for t in hist)
        mad = (dev[mid] if n % 2 else 0.5 * (dev[mid - 1] + dev[mid])) \
            or 1e-9
        if seconds > med + self.mad_k * mad and seconds > 1.2 * med:
            self.incidents.append(
                {"step": step, "seconds": seconds, "median": med})
            return True
        return False

    def p50_p99(self) -> tuple[float, float]:
        arr = np.array(self.times or [0.0])
        return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


@dataclass
class HeartbeatTracker:
    timeout_s: float = 60.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last_seen[host] = now if now is not None else time.monotonic()

    def dead_hosts(self, now: Optional[float] = None) -> list[str]:
        now = now if now is not None else time.monotonic()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]


def simulate_failures(total_steps: int, fail_steps: tuple, run_fn,
                      resume_fn):
    """Drive run_fn until each injected failure, then resume_fn; returns
    the final state. Used by tests to prove restart exactness."""
    state = None
    for fs in sorted(fail_steps):
        state = run_fn(until=fs, state=state)
        state = resume_fn(state)
    return run_fn(until=total_steps, state=state)
