"""Deterministic fault injection + the runtime fault policy.

Port of `repro.core.faults` (which imports no jax): the same spec
language, the same sha1 draws and the same meters, so one spec fires on
the same call indices in both packages. The port's instrumented sites
are the reference's: `read_csv_chunks` and the streaming prefetch
worker (chunk_io), the closure cache's build (compile), the serving
coalescer (serving_dispatch) and `LocalSite.execute` (the site kinds
site_rpc, site_slow, site_dead and site_lost, healed or degraded by the
runtime's `_site_call` ladder).

SystemDS targets federated sites, streamed out-of-core data, and a
serving front door — exactly the places real deployments see timeouts,
stragglers, dead workers, and partial failures. This module provides
both halves of making that survivable:

  * a **seeded fault-injection registry** (`FaultPlan` / `inject()` /
    env ``REPRO_FAULT_SPEC``): every instrumented call site
    (`LocalSite.execute` site RPCs, `read_csv_chunks` byte-window
    reads, the chunk-prefetch worker, `jit_cache.compile`, the serving
    coalescer) asks the active plan whether to fail THIS call. Firing
    decisions key on ``(fault kind, per-kind call index, seed)`` via a
    sha1 draw, so a given spec reproduces the exact same fault
    sequence on every run — tests assert exact injection/recovery
    counters and bit-level result parity against clean runs;

  * the **fault policy meters** (`FaultLog`, surfaced as
    `RuntimeStats.faults`): injections observed, retries, timeouts,
    backoff seconds slept, degradations taken, requests shed — plus
    the rescued `repro_torch.distributed.fault` control plane: per-site and
    per-dispatch latencies route through `StepMonitor` (median + k·MAD
    straggler flagging) and sites heartbeat into a `HeartbeatTracker`
    whose dead-host state shows up in ``as_dict()``.

The policy itself (retry/backoff/degradation ladders) lives at the
call sites in `repro_torch.core.runtime`, `repro_torch.serving.server`
and `repro_torch.data.csv_io`; this module only decides *whether a call fails*
and *counts what the policy did about it*. ``REPRO_FAULT_POLICY=off``
is the kill switch: injection entries and policy wrappers become
no-ops and every error propagates raw (the behaviour without a
policy).

Spec format (env ``REPRO_FAULT_SPEC`` or `inject()` argument)::

    seed=42;site_rpc@1,3;site_slow:p=0.1:delay=0.02;site_dead:site=2

``;``-separated rules, an optional leading ``seed=N``. Each rule is
``kind[@i,j,...][:key=val]*``: explicit call indices (``@1,3`` fires on
the 2nd and 4th call of that kind), a seeded probability (``p=0.1``),
or both (indices win when given). Kinds:

  site_rpc    transient site-RPC failure (InjectedFault from
              `LocalSite.execute`; retried with backoff)
  site_slow   straggler: sleep ``delay`` seconds inside the site call
              (trips the per-site timeout -> discard + retry)
  site_dead   persistent compute failure of site ``site=K`` — every
              RPC to that site fails; the runtime degrades to
              collect-and-recompute from the site's surviving data
  site_lost   site ``site=K``'s data plane is gone too: degradation is
              impossible and the run fails with `SiteFailedError`
  chunk_io    IO error in `read_csv_chunks` / the chunk-prefetch
              worker (read retried; a dead worker degrades the stream
              to the synchronous chunk loop)
  compile     `jit_cache.compile` failure — the segment falls back to
              the fuse=False interpreter (parity by construction)
  serving_dispatch  coalescer crash between pop and dispatch — the
              supervisor restarts the loop and fails only the popped
              batch
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

from ..distributed.fault import HeartbeatTracker, StepMonitor

# Fault kinds with per-kind call-index counters. `site_dead`/`site_lost`
# are *stateful* (keyed on the site id, not a call index) and listed for
# spec validation only.
KINDS = frozenset({
    "site_rpc", "site_slow", "site_dead", "site_lost",
    "chunk_io", "compile", "serving_dispatch",
})


class InjectedFault(RuntimeError):
    """A failure triggered by the active `FaultPlan`. Policy layers
    catch this (and real exceptions) and run their recovery ladder;
    with the policy off it propagates like any other error."""


class SiteFailedError(RuntimeError):
    """A federated site is permanently unavailable — compute AND data
    plane — so no degradation is semantically sound. Names the site and
    the instruction so operators know exactly what died where."""

    def __init__(self, site: int, instruction: str, detail: str = ""):
        self.site = int(site)
        self.instruction = str(instruction)
        msg = (f"federated site {site} failed permanently during "
               f"{instruction!r} and its data is unreachable — "
               "cannot degrade to collect-and-recompute")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class CompileFailedError(RuntimeError):
    """jit compilation of one segment failed. The segment executor
    catches this and falls back to the fuse=False interpreter for that
    segment; batched/sharded segments (no eager equivalent of the same
    executable) re-raise."""

    def __init__(self, seg_key: str, cause: BaseException):
        self.seg_key = seg_key
        self.cause = cause
        super().__init__(
            f"jit compile failed for segment {seg_key!r}: "
            f"{type(cause).__name__}: {cause}")


class DeadlineExceededError(RuntimeError):
    """A serving request's per-request deadline expired while it was
    still queued. Shed *before* dispatch, never after — a request that
    reached the device always delivers its (late) result."""


class ServerClosedError(RuntimeError):
    """The serving dispatcher is gone (shutdown, or the thread died
    unrecoverably) — raised to queued/waiting futures instead of
    letting them hang forever."""


# ---------------------------------------------------------------------------
# The registry: seeded, deterministic firing decisions
# ---------------------------------------------------------------------------

def _draw(seed: int, kind: str, idx: int) -> float:
    """Uniform [0, 1) from (seed, kind, call index) — sha1-based, NOT
    python's salted `hash()`, so the sequence is identical across
    processes/reruns (chaos CI fixes three seeds and asserts exact
    counters)."""
    h = hashlib.sha1(f"{seed}|{kind}|{idx}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass
class FaultRule:
    kind: str
    at: Optional[frozenset] = None   # explicit call indices (win over p)
    p: float = 0.0                   # seeded per-call probability
    params: dict = field(default_factory=dict)  # delay=, site=, ...

    def matches(self, seed: int, idx: int, **ctx: Any) -> bool:
        site = self.params.get("site")
        if site is not None and ctx.get("site") != int(site):
            return False
        if self.kind in ("site_dead", "site_lost"):
            return True  # stateful: every call to that site fails
        if self.at is not None:
            return idx in self.at
        if self.p > 0.0:
            return _draw(seed, self.kind, idx) < self.p
        return False


class FaultPlan:
    """Active fault schedule: seed + rules + per-kind call counters.

    Thread-safe (the chunk-prefetch worker and serving threads fire
    entries concurrently with the main thread); `fired` counts every
    triggered injection per kind — the injection-side ground truth
    tests assert against the policy-side `FaultLog` counters."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self._lock = threading.Lock()
        self._kinds = frozenset(r.kind for r in self.rules)

    def check(self, kind: str, **ctx: Any) -> Optional[FaultRule]:
        """Advance `kind`'s call counter and return the matching rule,
        if any. Stateful kinds (site_dead/site_lost) do not consume
        call indices — they key purely on the site id."""
        if kind not in self._kinds:
            # still advance the index for index-addressable kinds so
            # specs mixing rules see stable indices per kind
            if kind in ("site_dead", "site_lost"):
                return None
            with self._lock:
                self.calls[kind] = self.calls.get(kind, 0) + 1
            return None
        with self._lock:
            if kind in ("site_dead", "site_lost"):
                idx = -1
            else:
                idx = self.calls.get(kind, 0)
                self.calls[kind] = idx + 1
            for r in self.rules:
                if r.kind == kind and r.matches(self.seed, idx, **ctx):
                    self.fired[kind] = self.fired.get(kind, 0) + 1
                    return r
        return None

    def site_is_dead(self, site: int) -> bool:
        return any(r.kind in ("site_dead", "site_lost")
                   and int(r.params.get("site", -1)) == int(site)
                   for r in self.rules)

    def data_lost(self, site: int) -> bool:
        """True when `site`'s DATA plane is gone too — degradation by
        collect-and-recompute is impossible."""
        return any(r.kind == "site_lost"
                   and int(r.params.get("site", -1)) == int(site)
                   for r in self.rules)


def parse_spec(spec: str) -> FaultPlan:
    """Parse a ``REPRO_FAULT_SPEC`` string into a `FaultPlan`."""
    rules: list[FaultRule] = []
    seed = 0
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("seed="):
            seed = int(raw[5:])
            continue
        head, *kvs = raw.split(":")
        at: Optional[frozenset] = None
        if "@" in head:
            kind, idxs = head.split("@", 1)
            at = frozenset(int(i) for i in idxs.split(",") if i)
        else:
            kind = head
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in REPRO_FAULT_SPEC "
                f"(valid: {sorted(KINDS)})")
        p = 0.0
        params: dict = {}
        for kv in kvs:
            k, _, v = kv.partition("=")
            if k == "p":
                p = float(v)
            elif k in ("delay",):
                params[k] = float(v)
            elif k in ("site",):
                params[k] = int(v)
            else:
                raise ValueError(
                    f"unknown fault rule parameter {k!r} in {raw!r}")
        if kind in ("site_dead", "site_lost") and "site" not in params:
            raise ValueError(f"{kind} rule requires site=K ({raw!r})")
        rules.append(FaultRule(kind=kind, at=at, p=p, params=params))
    return FaultPlan(rules, seed=seed)


# ---------------------------------------------------------------------------
# Plan activation: inject() context > env REPRO_FAULT_SPEC
# ---------------------------------------------------------------------------

_stack: list[Optional[FaultPlan]] = []
_env_cache: tuple[Optional[str], Optional[FaultPlan]] = (None, None)
_env_lock = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    """The fault plan in effect: the innermost `inject()` context wins
    (an explicit ``inject(None)`` masks the env spec — tests that need
    a clean run inside chaos CI use that), else the env spec. The
    parsed env plan is cached per spec string so the no-fault fast
    path costs one dict lookup."""
    if _stack:
        return _stack[-1]
    global _env_cache
    spec = os.environ.get("REPRO_FAULT_SPEC") or None
    cached_spec, cached_plan = _env_cache
    if spec == cached_spec:
        return cached_plan
    with _env_lock:
        plan = parse_spec(spec) if spec else None
        _env_cache = (spec, plan)
    return plan


@contextmanager
def inject(spec: Any = None):
    """Activate a fault plan for the dynamic extent of the block.

    `spec` is a spec string, a ready `FaultPlan`, or None (explicitly
    NO faults — overrides the env spec). Yields the plan so tests can
    assert `plan.fired` afterwards."""
    plan = spec if isinstance(spec, (FaultPlan, type(None))) \
        else parse_spec(str(spec))
    _stack.append(plan)
    try:
        yield plan
    finally:
        _stack.pop()


def policy_enabled() -> bool:
    """Kill switch: ``REPRO_FAULT_POLICY=off`` disables BOTH injection
    and the recovery policy (raw error propagation). Read
    per call, like the other runtime knobs, so one process can compare
    both modes (the fault benchmark does exactly that)."""
    return os.environ.get("REPRO_FAULT_POLICY", "").lower() != "off"


# ---------------------------------------------------------------------------
# Instrumented call-site entries (no-ops without an active plan)
# ---------------------------------------------------------------------------

def site_entry(site: Optional[int], op: str = "") -> None:
    """Injection point at the top of `LocalSite.execute`.

    `site=None` means a master-side (recovery/local) execution — never
    injected, which is what makes the degradation ladder's recompute
    deterministic. May sleep (site_slow) or raise `InjectedFault`
    (site_rpc / site_dead / site_lost)."""
    if site is None or not policy_enabled():
        return
    plan = active_plan()
    if plan is None:
        return
    r = plan.check("site_slow", site=site)
    if r is not None:
        time.sleep(float(r.params.get("delay", 0.05)))
    for kind in ("site_rpc", "site_dead", "site_lost"):
        r = plan.check(kind, site=site)
        if r is not None:
            raise InjectedFault(
                f"injected {kind} at site {site} during {op!r}")


def io_entry(what: str = "read") -> None:
    """Injection point for chunked IO: `read_csv_chunks` byte-window
    reads and the streaming chunk-prefetch worker."""
    if not policy_enabled():
        return
    plan = active_plan()
    if plan is None:
        return
    if plan.check("chunk_io") is not None:
        raise InjectedFault(f"injected chunk_io during {what!r}")


def compile_entry(key: Any = None) -> None:
    """Injection point at the top of `JitProgramCache.compile`."""
    if not policy_enabled():
        return
    plan = active_plan()
    if plan is None:
        return
    if plan.check("compile") is not None:
        raise InjectedFault(f"injected compile failure for {key!r}")


def dispatch_entry() -> None:
    """Injection point in the serving coalescer, between batch pop and
    dispatch — the window the supervisor's restart ladder covers."""
    if not policy_enabled():
        return
    plan = active_plan()
    if plan is None:
        return
    if plan.check("serving_dispatch") is not None:
        raise InjectedFault("injected serving_dispatch crash")


# ---------------------------------------------------------------------------
# The policy meter: RuntimeStats.faults
# ---------------------------------------------------------------------------

@dataclass
class FaultLog:
    """What the fault policy observed and did, plus the rescued
    control-plane instruments.

    Counter semantics (tests assert these exactly):

      injected      `InjectedFault`s caught by a policy layer (site_rpc
                    / site_dead / site_lost / chunk_io / compile /
                    serving_dispatch firings; site_slow manifests as
                    `timeouts` + `stragglers` instead — the plan's own
                    `fired` dict carries the injection-side count)
      retries       recovery re-attempts taken (site RPC + chunk IO)
      timeouts      site calls whose wall time exceeded
                    `costmodel.fed_timeout_s()` (result discarded,
                    call retried — in-process sites cannot be
                    preempted, so the timeout binds at the attempt
                    boundary)
      backoff_s     total exponential-backoff seconds slept
      degradations  ladder steps taken: dead-site collect-and-
                    recompute, compile -> interpreter fallback,
                    prefetch-worker death -> synchronous chunk loop
      shed          serving requests expired before dispatch
                    (`DeadlineExceededError`)
      restarts      coalescer supervisor restarts
      stragglers    site/dispatch latencies flagged by the median+k·MAD
                    monitor
    """

    injected: int = 0
    retries: int = 0
    timeouts: int = 0
    backoff_s: float = 0.0
    degradations: int = 0
    shed: int = 0
    restarts: int = 0
    stragglers: int = 0
    # rescued control plane (distributed.fault): per-site RPC
    # latencies and per-dispatch serving latencies through the robust
    # straggler monitor; sites heartbeat on every successful RPC
    site_monitor: StepMonitor = field(default_factory=StepMonitor)
    dispatch_monitor: StepMonitor = field(default_factory=StepMonitor)
    heartbeats: HeartbeatTracker = field(default_factory=HeartbeatTracker)

    def record_site(self, site: int, seconds: float,
                    ok: bool = True) -> bool:
        """Route one site-RPC latency through the straggler monitor;
        successful calls heartbeat the site. Returns the straggler
        flag."""
        slow = self.site_monitor.record(site, seconds)
        if slow:
            self.stragglers += 1
        if ok:
            self.heartbeats.beat(f"site{site}")
        return slow

    def record_dispatch(self, batch_idx: int, seconds: float) -> bool:
        slow = self.dispatch_monitor.record(batch_idx, seconds)
        if slow:
            self.stragglers += 1
        return slow

    @property
    def total(self) -> int:
        """Incident count — nonzero iff anything fault-related
        happened (gates the `as_dict` section like the other logs)."""
        return (self.injected + self.retries + self.timeouts
                + self.degradations + self.shed + self.restarts
                + self.stragglers)

    def as_dict(self) -> dict:
        p50, p99 = self.site_monitor.p50_p99()
        out = dict(injected=self.injected, retries=self.retries,
                   timeouts=self.timeouts,
                   backoff_s=round(self.backoff_s, 6),
                   degradations=self.degradations, shed=self.shed,
                   restarts=self.restarts, stragglers=self.stragglers,
                   incidents=self.total,
                   site_p50_us=round(p50 * 1e6, 1),
                   site_p99_us=round(p99 * 1e6, 1))
        if self.dispatch_monitor.times:
            dp50, dp99 = self.dispatch_monitor.p50_p99()
            out["dispatch_p50_us"] = round(dp50 * 1e6, 1)
            out["dispatch_p99_us"] = round(dp99 * 1e6, 1)
        if self.heartbeats.last_seen:
            out["sites_seen"] = len(self.heartbeats.last_seen)
            out["dead_sites"] = sorted(self.heartbeats.dead_hosts())
        return out
