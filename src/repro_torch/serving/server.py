"""ModelServer: adaptive request coalescing onto bucketed vmapped
closures.

Port of `repro.serving.server`: the single-dispatcher loop at pipeline
depth 1 and, at depth >= 2 (the default, `costmodel.pipeline_depth`),
the issue/completion split below.

Architecture (one `ModelServer` per deployed `PreparedScript`):

  deploy()   traces the script's serving plan once
             (`PreparedScript.prepare_batched` → `batching
             .compile_serving`), then replays zero-stacks through every
             power-of-two bucket up to `max_batch` so each vmapped
             segment closure is built, cached, and **pinned**
             (`jit_cache.pinning`) before the first request arrives.

  score()    validates the request against the declared arg shapes
             (`PreparedScript.validate_args`), enqueues it on a BOUNDED
             queue (backpressure: `QueueFullError` past `queue_limit`
             rather than unbounded latency), and blocks on its
             completion event.

  coalescer  a single dispatcher thread. While requests queue up it
             holds dispatch for an *adaptive* window: the cost model
             prices what one more coalesced request is worth
             (`costmodel.coalesce_wait_s` — the whole solo dispatch if
             the next padding lane is free, only the marginal vmap cost
             at a bucket boundary, nothing at `max_batch`), divides by
             the queue depth already waiting, and clamps by
             `max_wait_us` (the p99 guard). The deadline is anchored to
             the oldest queued request so arrivals can only shrink it.

  dispatch   stacks the coalesced bindings, pads to the nearest warm
             bucket, and replays through the batched-segment machinery
             (`LineageRuntime.replay_batch`) on the runtime's device —
             the dispatcher thread runs on the device and CUDA stream
             that were current when `deploy` ran, and each request's
             outputs leave the device once, at the plan's roots. Any
             closure-cache miss taken here after warmup is counted in
             `RuntimeStats.serving.retraces` — the deploy contract is
             that this stays 0.

Continuous rebatching (pipeline depth >= 2): the coalescer splits into
an ISSUE stage (the coalescer thread itself — pops a batch, stacks its
bindings) and a COMPLETION worker (a second thread that replays the
batch and delivers futures), joined by a 1-deep handoff queue. While the
worker waits on the device for batch N, the coalescer is already
admitting arrivals into batch N+1 and stacking it, so a sustained
open-loop stream never serializes queue-drain behind device compute.
Batches coalesced while another was in flight are counted in
`RuntimeStats.pipeline.rebatches`. All runtime execution stays on the
single completion worker — it enters the device and CUDA stream that
were current at `deploy` (a new thread would start on the default
stream), so every kernel and every read-back of a batch runs in that
stream's order; the coalescer touches only its own queue and
pure-numpy stacking. At depth 1 the dispatcher replays inline.

A coalesced score is bitwise the same request scored alone
(`script(x)`), at either depth: the one-row product `x @ beta` is summed
in a fixed order whatever the bucket (`core.backend._row_product`).

Mesh-aware degradation: a script compiled under a device mesh keeps its
sharded segment lowering; at replay the runtime runs the local-equivalent
(unshard) closure wherever the mesh does not resolve on the serving
device — the runtime's own fallback, no serving-specific handling.
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..core import costmodel, faults
from ..core.batching import bucket_size, stack_requests
from ..core.faults import DeadlineExceededError, ServerClosedError
from ..core.jit_cache import get_jit_cache
from ..core.runtime import LineageRuntime, PreparedScript


class QueueFullError(RuntimeError):
    """Backpressure: the server's bounded request queue is at
    `queue_limit`. Callers should shed load or retry with backoff —
    queueing further would trade an explicit rejection for unbounded
    tail latency."""


class ScoreFuture:
    """Handle for one in-flight request (`ModelServer.submit`). Client
    event loops keep several of these outstanding so the coalescer sees
    real concurrency without one OS thread per request."""

    __slots__ = ("arrays", "done", "_result", "error", "t_enqueue",
                 "deadline", "_server")

    def __init__(self, arrays: list[np.ndarray],
                 deadline_us: Optional[float] = None,
                 server: Optional["ModelServer"] = None):
        self.arrays = arrays
        self.done = threading.Event()
        self._result: Optional[list[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()
        # absolute monotonic deadline; expired requests are shed at
        # dispatch entry (DeadlineExceededError), never mid-replay
        self.deadline = (None if deadline_us is None
                         else self.t_enqueue + float(deadline_us) * 1e-6)
        self._server = server

    def result(self, timeout: Optional[float] = None) -> list[np.ndarray]:
        """Block until the request's coalesced batch has been dispatched
        and return the per-request output list.

        Waits in short slices so a dead dispatcher surfaces as
        `ServerClosedError` instead of an infinite hang — the wait ends
        the moment the result lands either way."""
        limit = None if timeout is None else time.monotonic() + timeout
        while not self.done.is_set():
            slice_s = 0.05
            if limit is not None:
                slice_s = min(slice_s, limit - time.monotonic())
                if slice_s <= 0:
                    raise TimeoutError(
                        f"score timed out after {timeout}s")
            if self.done.wait(max(slice_s, 1e-4)):
                break
            srv = self._server
            if srv is not None and not srv._dispatcher_alive():
                raise ServerClosedError(
                    "serving dispatcher is gone (shutdown or "
                    "unrecoverable crash) — request will never be "
                    "dispatched")
        if self.error is not None:
            raise self.error
        return self._result  # type: ignore[return-value]


class ModelServer:
    """Low-latency scoring server for one `PreparedScript`.

    Thread-safe: any number of caller threads may `score()`
    concurrently; a single dispatcher thread coalesces them. Use as a
    context manager (`with ModelServer(script) as srv:`) or call
    `deploy()` / `shutdown()` explicitly.

    Parameters
    ----------
    script:       the compiled `PreparedScript` to serve.
    max_batch:    largest coalesced batch (also the largest bucket
                  warmed at deploy); rounded up to a power of two.
    max_wait_us:  hard cap on how long a queued request may be held for
                  coalescing — the p99 latency guard.
    queue_limit:  bounded-queue depth; enqueueing past it raises
                  `QueueFullError`.
    adaptive:     price the coalescing window with the cost model
                  (True) or always hold for `max_wait_us` (False).
    runtime:      override the runtime (defaults to the script's).
    """

    def __init__(self, script: PreparedScript, *, max_batch: int = 16,
                 max_wait_us: float = 2000.0, queue_limit: int = 256,
                 adaptive: bool = True,
                 runtime: Optional[LineageRuntime] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.script = script
        self.runtime = runtime or script.runtime
        self.max_batch = bucket_size(max_batch) \
            if max_batch > 1 else max_batch
        self.max_wait_s = float(max_wait_us) * 1e-6
        self.queue_limit = int(queue_limit)
        self.adaptive = bool(adaptive)
        # supervisor restart budget: crashes beyond this kill the
        # dispatcher thread (persistent poison) instead of spinning
        self.max_restarts = 64

        self._bplan = None
        self._inv_nodes: list = []
        self._var_nodes: list = []
        self._budget_s: list[float] = []   # wait budget per k (deploy)
        self._pinned_keys: set = set()
        self._queue: deque[ScoreFuture] = deque()
        self._cv = threading.Condition()
        self._busy = False          # dispatcher currently replaying
        self._force = False         # flush(): dispatch without waiting
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._deployed = False
        self._warm_misses = 0       # jit-cache miss watermark at deploy
        self._stream = None         # CUDA stream current at deploy
        # continuous rebatching (pipeline depth >= 2): issue/completion
        # split — the coalescer hands stacked batches to a single
        # completion worker through a 1-deep queue and keeps admitting
        self._pipelined = False
        self._inflight = 0          # batches issued, not yet delivered
        self._pending: Optional[_queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        # fault policy: the batch popped but not yet handed off/
        # dispatched — the supervisor fails exactly these futures when
        # the coalescer crashes in that window, then restarts in-thread
        self._popped: Optional[list[ScoreFuture]] = None

    # -- lifecycle -----------------------------------------------------
    def deploy(self) -> "ModelServer":
        """Compile the serving plan and warm every power-of-two bucket
        up to `max_batch`, pinning the closures against LRU
        eviction. All build cost is paid here, off the request path;
        after `deploy` returns, the hot path is lookup-only."""
        if self._deployed:
            return self
        self._bplan = self.script.prepare_batched()
        plan = self._bplan.plan
        variant = self._bplan.variant_uids
        self._var_nodes = [i.node for i in plan.instructions
                           if i.out_id in variant]
        self._inv_nodes = [i.node for i in plan.instructions
                           if i.out_id not in variant]
        # price the coalescing window once per queue depth — the cost
        # model walks the instruction lists, far too slow per wakeup
        self._budget_s = [0.0] + [
            self._wait_budget_s(k) for k in range(1, self.max_batch + 1)]
        jcache = get_jit_cache()
        buckets = sorted({bucket_size(k)
                          for k in range(1, self.max_batch + 1)})
        with jcache.pinning() as touched:
            for b in buckets:
                zeros = [np.zeros((b,) + shape, dtype=dtype)
                         for shape, dtype in zip(self.script._arg_shapes,
                                                 self.script._arg_dtypes)]
                self.runtime.replay_batch(self._bplan, zeros, b)
        self._pinned_keys = set(touched)
        self._warm_misses = jcache.stats.misses
        self._stop = False
        dev = self.runtime.device
        if dev.type == "cuda":
            self._stream = torch.cuda.current_stream(dev)
        self._pipelined = costmodel.pipeline_depth() >= 2
        if self._pipelined:
            self._pending = _queue.Queue(maxsize=1)
            self._worker = threading.Thread(
                target=self._complete_loop,
                name="repro-serving-completer", daemon=True)
            self._worker.start()
        self._thread = threading.Thread(
            target=self._run_dispatcher, name="repro-serving-coalescer",
            daemon=True)
        self._thread.start()
        self._deployed = True
        return self

    def shutdown(self) -> None:
        """Drain queued requests, stop the dispatcher, unpin the warm
        closures (they fall back under normal LRU pressure), and
        release the serving plan's placeholder leaves."""
        if not self._deployed:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._worker is not None:
            # the coalescer has drained and exited; a sentinel past any
            # still-queued batch stops the completion worker after it
            # delivers everything in flight — no dropped batches
            self._pending.put(None)
            self._worker.join()
            self._worker = None
            self._pending = None
        # a clean coalescer exit drains the queue first, so leftovers
        # exist only when the dispatcher died unrecoverably (policy
        # off) — deliver a terminal error rather than leaving waiters
        # to hang / poll out
        leftover: list[ScoreFuture] = []
        with self._cv:
            while self._queue:
                leftover.append(self._queue.popleft())
        if leftover:
            err = ServerClosedError(
                "server shut down before this request was dispatched")
            for req in leftover:
                if not req.done.is_set():
                    req.error = err
                    req.done.set()
        get_jit_cache().unpin_all(self._pinned_keys)
        self._pinned_keys = set()
        if self._bplan is not None:
            self._bplan.release_leaves()
        self._deployed = False

    def __enter__(self) -> "ModelServer":
        return self.deploy()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- request path --------------------------------------------------
    def submit(self, *arrays,
               deadline_us: Optional[float] = None) -> ScoreFuture:
        """Enqueue one request without blocking on its result.

        Validates against the declared arg shapes/dtypes, applies
        backpressure (`QueueFullError` at `queue_limit`), and returns a
        `ScoreFuture` — pipelining clients keep several outstanding so
        coalescing happens without one blocked thread per request.

        `deadline_us` sets a per-request deadline: a request still
        queued when it expires is shed at dispatch entry with
        `DeadlineExceededError` (counted in `RuntimeStats.faults.shed`)
        instead of wasting a padded lane on an answer nobody is waiting
        for. A request whose batch has reached the device always
        delivers its (possibly late) result — shed before dispatch,
        never after."""
        if not self._deployed:
            raise RuntimeError("ModelServer.submit before deploy()")
        validated = self.script.validate_args(arrays, exact_shapes=True)
        req = ScoreFuture(validated, deadline_us=deadline_us, server=self)
        log = self.runtime.stats.serving
        with self._cv:
            if len(self._queue) >= self.queue_limit:
                log.rejected += 1
                raise QueueFullError(
                    f"serving queue at limit ({self.queue_limit}); "
                    "shed load or retry with backoff")
            self._queue.append(req)
            depth = len(self._queue)
            log.queue_peak = max(log.queue_peak, depth)
            # Wake the dispatcher only where the coalescing price
            # changes: the first request (opens the window), a
            # power-of-two bucket boundary (marginal cost jumps), or a
            # full batch (dispatch now). Intermediate arrivals land in
            # free padding lanes — the pending deadline already covers
            # them, and waking a single-core dispatcher per request
            # costs more in context switches than it saves in hold time.
            if (depth == 1 or depth >= self.max_batch
                    or depth == bucket_size(depth)):
                self._cv.notify_all()
        return req

    def score(self, *arrays, timeout: Optional[float] = None,
              deadline_us: Optional[float] = None) -> list[np.ndarray]:
        """Score one request. Blocks until its coalesced batch has been
        dispatched and returns the per-request output list, bitwise
        what a solo `script(*arrays)` run computes.

        Raises `QueueFullError` when the bounded queue is at
        `queue_limit` (backpressure), `TimeoutError` when `timeout`
        seconds elapse first, `DeadlineExceededError` when
        `deadline_us` expires while still queued, and
        `ServerClosedError` when the dispatcher is gone."""
        return self.submit(*arrays,
                           deadline_us=deadline_us).result(timeout)

    def flush(self) -> None:
        """Dispatch everything queued right now — skipping any pending
        coalescing window — and block until it has completed."""
        with self._cv:
            self._force = True
            self._cv.notify_all()
            self._cv.wait_for(
                lambda: (not self._queue and not self._busy
                         and not self._inflight)
                or (self._stop and self._thread is None))

    # -- coalescer -----------------------------------------------------
    def _dispatcher_alive(self) -> bool:
        """True while the dispatch machinery can still deliver queued
        requests (`ScoreFuture.result` polls this instead of hanging
        on a dead dispatcher): the coalescer thread, plus the
        completion worker when pipelined."""
        t = self._thread
        if t is None or not t.is_alive():
            return False
        w = self._worker
        return w is None or w.is_alive()

    def _run_dispatcher(self) -> None:
        """Dispatcher thread target: `_coalesce_loop` under a
        supervisor. A coalescer crash (injected `serving_dispatch`
        faults, or a real bug in the pop→dispatch window) fails ONLY
        the batch it had popped — queued and in-flight requests are
        untouched — then restarts the loop in-thread, so repeated
        crash/recover cycles leak zero threads. With the policy off
        the error is delivered and the thread dies raw (pre-policy
        behaviour); waiters then surface `ServerClosedError` via the
        liveness poll. Restarts are capped (`max_restarts`) so a
        *persistent* poison — one that crashes every restart — kills
        the thread instead of spinning hot forever."""
        crashes = 0
        while True:
            try:
                with self._on_device():
                    self._coalesce_loop()
                return  # clean shutdown
            except BaseException as e:
                with self._cv:
                    batch, self._popped = self._popped, None
                    if batch:
                        # undo the pop-time state so flush()/shutdown
                        # cannot wedge on a batch that will never run
                        if self._pipelined:
                            self._inflight -= 1
                        else:
                            self._busy = False
                    self._cv.notify_all()
                for req in batch or []:
                    if not req.done.is_set():
                        req.error = e
                        req.done.set()
                crashes += 1
                if not faults.policy_enabled() or crashes > self.max_restarts:
                    raise
                flog = self.runtime.stats.faults
                if isinstance(e, faults.InjectedFault):
                    flog.injected += 1
                flog.restarts += 1

    def _on_device(self):
        """The replaying thread's device and CUDA stream (the dispatcher
        at depth 1, the completion worker at depth >= 2): those current
        when `deploy` ran (a new thread would start on the default
        stream of the current device)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.runtime.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _wait_budget_s(self, k: int) -> float:
        """How long holding k queued requests for one more is worth."""
        if not self.adaptive:
            return self.max_wait_s
        return costmodel.coalesce_wait_s(
            self._inv_nodes, self._var_nodes, k, self.max_batch,
            self.max_wait_s)

    def _coalesce_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                # Adaptive hold: wait while the cost model says one
                # more coalesced request is worth it. The window is
                # anchored at whichever is later — the oldest queued
                # request or the moment this dispatcher went idle
                # (requests that queued up during the PREVIOUS dispatch
                # have aged, but dispatching on them instantly would
                # chronically under-coalesce a pipelining client) —
                # and hard-clamped to `max_wait_us` past the oldest
                # enqueue, so no request is ever *held* longer than the
                # p99 guard. Arrivals re-price the budget (gain/k
                # shrinks as k grows) but can never extend the anchor.
                idle_from = time.monotonic()
                while not self._stop and not self._force:
                    k = len(self._queue)
                    if k >= self.max_batch:
                        break
                    oldest = self._queue[0].t_enqueue
                    budget = self._budget_s[min(k, self.max_batch)]
                    deadline = min(max(oldest, idle_from) + budget,
                                   oldest + self.max_wait_s)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = [self._queue.popleft()
                         for _ in range(min(len(self._queue),
                                            self.max_batch))]
                if not self._queue:
                    self._force = False
                if self._pipelined:
                    if self._inflight:
                        # coalesced while the completion worker still
                        # had a batch on the device: the continuous-
                        # rebatching overlap actually happened
                        self.runtime.stats.pipeline.rebatches += 1
                    self._inflight += 1
                else:
                    self._busy = True
                # the supervisor's responsibility window opens here:
                # these futures are off the queue but not yet owned by
                # a dispatch (which delivers errors itself)
                self._popped = batch if batch else None
            if batch:
                faults.dispatch_entry()  # injected coalescer crash
            if self._pipelined:
                # issue stage: stack batch N+1's bindings while the
                # worker replays batch N (the put blocks only when a
                # stacked batch is already waiting — at most one batch
                # is ever staged ahead of the device)
                stacked = stack_requests(
                    [r.arrays for r in batch],
                    len(self.script._arg_shapes))
                self._pending.put((batch, stacked))
                with self._cv:
                    self._popped = None  # the worker owns delivery now
            else:
                try:
                    self._dispatch(batch)
                finally:
                    with self._cv:
                        self._popped = None
                        self._busy = False
                        self._cv.notify_all()

    def _complete_loop(self) -> None:
        """Completion worker (pipeline depth >= 2): replay staged
        batches and deliver their futures. The ONLY thread that touches
        the runtime — execution stays single-threaded under
        rebatching — on the deploy-time device and stream."""
        with self._on_device():
            while True:
                item = self._pending.get()
                if item is None:
                    return
                batch, stacked = item
                try:
                    self._dispatch(batch, stacked)
                finally:
                    with self._cv:
                        self._inflight -= 1
                        self._cv.notify_all()

    def _dispatch(self, batch: list[ScoreFuture],
                  stacked: Optional[list[np.ndarray]] = None) -> None:
        if batch and faults.policy_enabled():
            # deadline shedding — at dispatch ENTRY only: an expired
            # request is answered DeadlineExceededError instead of
            # burning a padded lane on a result nobody waits for; once
            # the (possibly pre-stacked) batch proceeds to the device
            # every survivor delivers, late or not
            flog = self.runtime.stats.faults
            now = time.monotonic()
            live = [r for r in batch
                    if r.deadline is None or now <= r.deadline]
            if len(live) != len(batch):
                err = DeadlineExceededError(
                    "request deadline expired while queued; shed "
                    "before dispatch")
                for r in batch:
                    if r not in live and not r.done.is_set():
                        flog.shed += 1
                        r.error = err
                        r.done.set()
                batch = live
                stacked = None  # pre-stacked bindings no longer match
        k = len(batch)
        if k == 0:
            return
        jcache = get_jit_cache()
        log = self.runtime.stats.serving
        t0 = time.monotonic()
        try:
            if stacked is None:
                stacked = stack_requests([r.arrays for r in batch],
                                         len(self.script._arg_shapes))
            miss0 = jcache.stats.misses
            results = self.runtime.replay_batch(self._bplan, stacked, k)
            # the hot-path hygiene counter: any closure build after
            # deploy warmup is a retrace the bucket warming should have
            # covered
            log.retraces += jcache.stats.misses - miss0
            log.requests += k
            log.batches += 1
            log.max_coalesce = max(log.max_coalesce, k)
            log.padded += bucket_size(k) - k
            log.queue_wait_s += sum(t0 - r.t_enqueue for r in batch)
            for req, res in zip(batch, results):
                req._result = res
                req.done.set()
        except BaseException as e:  # deliver, don't kill the dispatcher
            for req in batch:
                if not req.done.is_set():
                    req.error = e
                    req.done.set()
        finally:
            dt = time.monotonic() - t0
            log.busy_s += dt
            # per-dispatch latency through the rescued straggler
            # monitor (distributed.fault.StepMonitor): p50/p99
            # and median+k·MAD flags surface in stats['faults']
            self.runtime.stats.faults.record_dispatch(log.batches, dt)

    # -- introspection -------------------------------------------------
    def explain(self) -> str:
        """EXPLAIN dump of the deployed serving plan (see
        `BatchedPlan.explain`), prefixed with the warm-bucket set."""
        if self._bplan is None:
            return "ModelServer: not deployed"
        buckets = sorted({bucket_size(k)
                          for k in range(1, self.max_batch + 1)})
        head = (f"serving: max_batch={self.max_batch} "
                f"warm_buckets={buckets} "
                f"pinned={len(self._pinned_keys)} "
                f"adaptive={self.adaptive} "
                f"max_wait_us={self.max_wait_s * 1e6:.0f}")
        return head + "\n" + self._bplan.explain(
            reuse_active=self.runtime.cache is not None)
