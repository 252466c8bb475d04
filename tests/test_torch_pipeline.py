"""Asynchronous pipelined dispatch: the port's depth-2 lane against its
own depth-1 lane and against the reference at the same depth. Mirrors
tests/test_pipeline.py case for case (depth parity, chunk-cache key
parity across depths, the prefetch memory bound, donation safety,
prefetch error handling, continuous serving rebatching), on the CPU.

Where the reference runs the same program, it runs on the same seeded
numpy data at the same `REPRO_PIPELINE_DEPTH`, and every counter that is
not a timing must be identical: the `PipelineLog` (async segments,
prefetch issued/hits/cancelled, donated buffers and bytes), the
`StreamLog` (chunks, chunk hits, combines, bytes, peak live bytes) and
the jit-cache misses the donated closures add. Results agree to rel
1e-10 across the packages and are bitwise across the port's depths.

The serving cases wait on the runtime's own counters instead of
sleeping, so they do not depend on how threads are scheduled.
"""
import threading
import time

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import costmodel as rcm
from repro.lifecycle.algorithms import pca as rpca
from repro.lifecycle.regression import lmDS as rlmDS
from repro_torch.core import costmodel, ops
from repro_torch.core import runtime as rt_mod
from repro_torch.core.dag import input_tensor
from repro_torch.core.jit_cache import get_jit_cache
from repro_torch.core.reuse import ReuseCache
from repro_torch.core.runtime import LineageRuntime, PreparedScript
from repro_torch.lifecycle.algorithms import pca
from repro_torch.lifecycle.regression import lmDS
from repro_torch.serving import ModelServer, QueueFullError

BUDGET = 1 << 16
PKGS = {"ref": R, "port": T}


@pytest.fixture(scope="module", autouse=True)
def _reference_jit_cache_left_cold():
    """The reference's jit cache is process-global, and this module
    compiles the reference's donating executables on the plans and shapes
    of tests/test_pipeline.py, which counts its own compiles: drop them
    when the module ends, so that a worker running both files, in either
    order, gives that test the cold cache it expects (the reference's
    tests clear the cache for the same reason)."""
    yield
    R.clear_jit_cache()


@pytest.fixture
def budget(monkeypatch):
    """Set the streaming budget of both packages."""
    def set_(b):
        monkeypatch.setattr(costmodel, "CHUNK_MEM_BUDGET", b)
        monkeypatch.setattr(rcm, "CHUNK_MEM_BUDGET", b)
    return set_


def _lm_ref(Xh, yh, reg=1e-3):
    return np.linalg.solve(Xh.T @ Xh + reg * np.eye(Xh.shape[1]),
                           Xh.T @ yh)


def _lm_run(rt, Xh, yh, reg=1e-3):
    X = input_tensor("X", Xh)
    y = input_tensor("y", yh)
    return np.asarray(lmDS(X, y, reg=reg, runtime=rt)).ravel()


def _ref_run(rt, Xh, yh, reg=1e-3):
    X = R.input_tensor("X", Xh)
    y = R.input_tensor("y", yh)
    return np.asarray(rlmDS(X, y, reg=reg, runtime=rt)).ravel()


def _rt(key, **kw):
    if key == "port":
        return LineageRuntime(device="cpu", **kw)
    return R.LineageRuntime(**kw)


def _meters(rt) -> dict:
    """Every pipeline and streaming counter that is not a timing."""
    p = rt.stats.pipeline.as_dict()
    return dict(
        pipeline={k: v for k, v in p.items()
                  if not k.endswith("_s") and k != "overlap_ratio"},
        streaming=rt.stats.streaming.as_dict())


def _no_prefetch_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("chunk-prefetch") and t.is_alive()]


def test_default_depth_is_two(monkeypatch):
    monkeypatch.delenv("REPRO_PIPELINE_DEPTH", raising=False)
    assert costmodel.pipeline_depth() == rcm.pipeline_depth() == 2
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "0")
    assert costmodel.pipeline_depth() == 2
    for d in ("1", "2", "3"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", d)
        assert costmodel.pipeline_depth() == rcm.pipeline_depth() == int(d)


@pytest.mark.parametrize("env", [None, "1", "3"])
def test_prefetch_depth_matches_reference(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("REPRO_PIPELINE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", env)
    for row_bytes, n_chunks in ((8.0, 1), (64.0, 64), (8.0 * 1001, 13),
                                (1.0, 100)):
        assert costmodel.prefetch_depth(row_bytes, n_chunks) \
            == rcm.prefetch_depth(row_bytes, n_chunks)
        assert costmodel.pipeline_gain_s(row_bytes) \
            == rcm.pipeline_gain_s(row_bytes)
    assert costmodel.PIPELINE_MIN_GAIN_S == rcm.PIPELINE_MIN_GAIN_S


# ---------------------------------------------------------------------------
# depth-1 contract: the synchronous runtime, exactly
# ---------------------------------------------------------------------------

def test_depth1_has_no_pipeline_footprint(rng, monkeypatch, budget):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")
    budget(BUDGET)
    rt = LineageRuntime(cache=ReuseCache(), fuse=True, device="cpu")
    Xh, yh = rng.normal(size=(4096, 8)), rng.normal(size=(4096,))
    got = _lm_run(rt, Xh, yh)
    assert np.abs(got - _lm_ref(Xh, yh).ravel()).max() < 1e-10
    p = rt.stats.pipeline
    assert p.total == 0
    assert p.dispatch_s == p.block_s == p.prefetch_s == 0.0
    assert "pipeline" not in rt.stats.as_dict()
    assert rt.stats.streaming.chunks > 1  # the stream really ran
    ref = R.LineageRuntime(cache=R.ReuseCache(), fuse=True)
    _ref_run(ref, Xh, yh)
    assert _meters(rt) == _meters(ref)


def test_depth_parity_streamed_lmds_across_fuse_modes(rng, monkeypatch,
                                                      budget):
    budget(BUDGET)
    Xh, yh = rng.normal(size=(4096, 8)), rng.normal(size=(4096,))
    got = {}
    for depth in ("1", "2"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        for fuse in (True, False):
            rt = LineageRuntime(cache=ReuseCache(), fuse=fuse,
                                device="cpu")
            got[(depth, fuse)] = _lm_run(rt, Xh, yh)
            ref = R.LineageRuntime(cache=R.ReuseCache(), fuse=fuse)
            want = _ref_run(ref, Xh, yh)
            assert np.abs(got[(depth, fuse)] - want).max() \
                <= 1e-10 * np.abs(want).max()
            assert _meters(rt) == _meters(ref), (depth, fuse)
            if fuse and depth == "2":
                assert rt.stats.pipeline.total > 0
    base = got[("1", True)]
    for k, v in got.items():
        assert np.abs(v - base).max() < 1e-10, k
    # fused runs are bitwise across depths: same closures, same
    # accumulation order, only the sync points moved
    assert np.array_equal(got[("1", True)], got[("2", True)])


def test_depth_parity_streamed_pca(rng, monkeypatch, budget):
    budget(BUDGET)
    Xh = rng.normal(size=(4096, 8))
    comps = {}
    for depth in ("1", "2"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        rt = LineageRuntime(cache=ReuseCache(), fuse=True, device="cpu")
        c, _ = pca(input_tensor("X", Xh), 3, runtime=rt)
        comps[depth] = np.asarray(c)
        assert rt.stats.streaming.chunks > 1
        ref = R.LineageRuntime(cache=R.ReuseCache(), fuse=True)
        rc, _ = rpca(R.input_tensor("X", Xh), 3, runtime=ref)
        assert np.abs(np.abs(comps[depth]) - np.abs(np.asarray(rc))).max() \
            < 1e-10
        assert _meters(rt) == _meters(ref)
    assert np.array_equal(comps["1"], comps["2"])


# ---------------------------------------------------------------------------
# chunk-cache key parity across depths (derived slice fingerprints)
# ---------------------------------------------------------------------------

def test_depth1_populated_chunk_cache_fully_hits_at_depth2(
        rng, monkeypatch, budget):
    # 1 MiB budget over a 16 MiB matrix: bucket slices are > 64 KiB and
    # 4096-byte aligned, so the depth-2 loop takes the table-derived
    # fingerprint path — and must reproduce depth 1's sha1 keys bitwise
    budget(1 << 20)
    Xh = rng.normal(size=(1 << 15, 64))
    yh = rng.normal(size=(1 << 15,))
    Xc = Xh.copy()
    Xc[777, 3] = 42.0
    meters = {}
    for key in PKGS:
        rt = _rt(key, cache=PKGS[key].ReuseCache(), fuse=True)
        run = _lm_run if key == "port" else _ref_run
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")
        cold = run(rt, Xh, yh)
        s = rt.stats.streaming
        base_chunks, base_reused = s.chunks, s.chunks_reused
        assert base_chunks > 1
        # correction: one changed cell re-dispatches exactly one bucket
        # at depth 2 — every untouched bucket's pipelined key HITS the
        # synchronously-written cache entries
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
        got = run(rt, Xc, yh)
        assert np.abs(got - _lm_ref(Xc, yh).ravel()).max() < 1e-10
        assert s.chunks - base_chunks == 1
        assert s.chunks_reused - base_reused == base_chunks - 1
        assert rt.stats.pipeline.prefetch_issued >= 1
        assert np.isfinite(cold).all()
        meters[key] = _meters(rt)
    assert meters["port"] == meters["ref"]


def test_depth2_append_retrain_reuses_all_old_buckets(rng, monkeypatch,
                                                      budget):
    budget(BUDGET)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    Xh, yh = rng.normal(size=(4096, 8)), rng.normal(size=(4096,))
    extra = 409
    Xa = np.vstack([Xh, rng.normal(size=(extra, 8))])
    ya = np.concatenate([yh, rng.normal(size=(extra,))])
    meters = {}
    for key in PKGS:
        rt = _rt(key, cache=PKGS[key].ReuseCache(), fuse=True)
        run = _lm_run if key == "port" else _ref_run
        run(rt, Xh, yh)
        s = rt.stats.streaming
        base_chunks, base_reused = s.chunks, s.chunks_reused
        got = run(rt, Xa, ya)
        assert np.abs(got - _lm_ref(Xa, ya).ravel()).max() < 1e-10
        assert s.chunks_reused - base_reused == base_chunks
        assert s.chunks - base_chunks <= extra // 16 + 1
        meters[key] = _meters(rt)
    assert meters["port"] == meters["ref"]


# ---------------------------------------------------------------------------
# memory bound with prefetch live
# ---------------------------------------------------------------------------

def test_peak_live_bytes_under_budget_with_prefetch(rng, monkeypatch,
                                                    budget):
    budget(BUDGET)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    Xh, yh = rng.normal(size=(4096, 8)), rng.normal(size=(4096,))
    rt = LineageRuntime(cache=None, fuse=True, device="cpu")
    _lm_run(rt, Xh, yh)
    s = rt.stats.streaming
    assert s.chunks > 1
    assert rt.stats.pipeline.prefetch_issued > 1
    # the meter charges BOTH in-flight buckets, and still fits: the
    # bucket sizing keeps CHUNK_LIVE_FACTOR headroom per slice
    assert 0 < s.peak_live_bytes <= BUDGET
    assert _no_prefetch_threads()
    ref = R.LineageRuntime(cache=None, fuse=True)
    _ref_run(ref, Xh, yh)
    assert _meters(rt) == _meters(ref)


# ---------------------------------------------------------------------------
# donation safety
# ---------------------------------------------------------------------------

def _donating_run(Xh, yh, key="port"):
    """One fused lmDS run on a FRESH reuse-cache runtime: probe points
    split the plan into 4 segments, and the normal-equations combine
    frees a non-probe intermediate across a boundary — the depth-2
    executor donates it. Fresh cache per run keeps the probe outcomes
    (and therefore the donation masks and closure keys) deterministic."""
    rt = _rt(key, cache=PKGS[key].ReuseCache(), fuse=True)
    run = _lm_run if key == "port" else _ref_run
    return run(rt, Xh, yh), rt


def test_depth2_donates_and_keys_separate(rng, monkeypatch, budget):
    budget(1 << 30)
    Xh, yh = rng.normal(size=(2048, 16)), rng.normal(size=(2048,))
    jstats = get_jit_cache().stats
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")
    got1, rt1 = _donating_run(Xh, yh)
    assert rt1.stats.pipeline.donated_buffers == 0
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    miss0 = jstats.misses
    got2, rt2 = _donating_run(Xh, yh)
    p = rt2.stats.pipeline
    assert p.donated_buffers > 0
    assert p.donated_bytes > 0
    assert p.async_segments > 0
    # donating closures are NEW cache entries (the |don: key suffix):
    # they can never shadow or be served by the plain depth-1 closures
    assert jstats.misses > miss0
    assert any("|don:" in k[0] for k in get_jit_cache().keys())
    assert np.array_equal(got1, got2)
    # replaying depth 2 on identical content: the donating closures hit
    # their own keys — not a single extra build
    miss1 = jstats.misses
    got3, _ = _donating_run(Xh, yh)
    assert jstats.misses == miss1
    assert np.array_equal(got2, got3)
    # the reference donates the same positions, the same bytes
    _, ref = _donating_run(Xh, yh, key="ref")
    assert _meters(rt2) == _meters(ref)


def test_donating_closure_drops_the_donated_argument(rng):
    """A donating closure is handed the argument list itself, clears the
    donated position, holds no reference of its own to that tensor once
    it returns, keeps the other arguments, and computes the plain
    closure's bits."""
    import weakref

    import torch
    from repro_torch.core.compiler import compile_plan
    from repro_torch.core.segments import build_segment_fn
    a = input_tensor("a", rng.normal(size=(8, 8)))
    b = input_tensor("b", rng.normal(size=(8, 8)))
    plan = compile_plan([ops.sum_((a * 2.0 + b) @ b)])
    seg = plan.segments_for(False)[0]
    pos_a = seg.input_uids.index(a.node.uid)
    args = [torch.from_numpy(rng.normal(size=(8, 8))) for _ in range(2)]
    plain = build_segment_fn(seg, torch.device("cpu"))(*args)
    box = [t.clone() for t in args]
    gone = weakref.ref(box[pos_a])
    out = build_segment_fn(seg, torch.device("cpu"), donate=(pos_a,))(box)
    assert box[pos_a] is None and gone() is None
    assert torch.equal(box[1 - pos_a], args[1 - pos_a])
    assert all(torch.equal(x, y) for x, y in zip(plain, out))


def test_donation_never_claims_reuse_cache_entries(rng, monkeypatch,
                                                   budget):
    # probe values enter the reuse cache as live references; three runs
    # on one cache: the second hits the probes the first stored, the
    # third proves the hit values were never donated out from under the
    # cache
    budget(1 << 30)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    Xh, yh = rng.normal(size=(2048, 16)), rng.normal(size=(2048,))
    rt = LineageRuntime(cache=ReuseCache(), fuse=True, device="cpu")
    a = _lm_run(rt, Xh, yh)
    reused0 = rt.stats.reused
    b = _lm_run(rt, Xh, yh)
    assert rt.stats.reused > reused0  # warm run really hit the cache
    c = _lm_run(rt, Xh, yh)
    assert np.array_equal(a, b)
    assert np.array_equal(b, c)


def test_leaves_are_never_donated(rng, monkeypatch, budget):
    # the same leaf arrays serve four plans back-to-back; a donated leaf
    # would leave the later runs without their operand
    budget(1 << 30)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    Xh, yh = rng.normal(size=(1024, 8)), rng.normal(size=(1024,))
    X0, y0 = Xh.copy(), yh.copy()
    runs = [_donating_run(Xh, yh)[0] for _ in range(4)]
    for r in runs[1:]:
        assert np.array_equal(runs[0], r)
    assert np.isfinite(runs[0]).all()
    assert np.array_equal(Xh, X0) and np.array_equal(yh, y0)


def test_batched_dispatches_never_donate(rng, monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")

    def fn(pk):
        def f(X, y):
            return pk.ops.solve(X.T @ X + 1e-3 * pk.ops.eye(4), X.T @ y)
        return f

    Xh, yh = rng.normal(size=(256, 4)), rng.normal(size=(256,))
    stacked = [np.stack([Xh, Xh * 2.0]), np.stack([yh, yh * 0.5])]
    outs, logs = {}, {}
    for key, pk in PKGS.items():
        rt = _rt(key, cache=pk.ReuseCache(), fuse=True)
        script = pk.PreparedScript(fn(pk), [Xh.shape, yh.shape], runtime=rt)
        bplan = script.prepare_batched()
        outs[key] = rt.replay_batch(bplan, stacked, 2)
        assert rt.stats.pipeline.donated_buffers == 0
        logs[key] = _meters(rt)
        bplan.release_leaves()
    assert logs["port"] == logs["ref"]
    for a, b in zip(outs["port"], outs["ref"]):
        assert np.abs(a[0] - b[0]).max() < 1e-10


def test_evaluate_batch_depth_parity(rng, monkeypatch):
    from repro_torch.lifecycle.validation import grid_search_lm
    xn, yn = rng.normal(size=(300, 6)), rng.normal(size=(300, 1))
    got = {}
    for depth in ("1", "2"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        rt = LineageRuntime(device="cpu")
        betas, losses = grid_search_lm(
            input_tensor("gX", xn), input_tensor("gy", yn),
            [0.01, 0.1, 1.0, 10.0], runtime=rt, mode="vmap")
        got[depth] = (np.asarray(betas), np.asarray(losses))
        assert rt.stats.batched_segments > 0
        assert (rt.stats.pipeline.async_segments > 0) == (depth == "2")
    assert np.array_equal(got["1"][0], got["2"][0])
    assert np.array_equal(got["1"][1], got["2"][1])


# ---------------------------------------------------------------------------
# prefetch-worker error propagation
# ---------------------------------------------------------------------------

def _boom_on_prefetch(real):
    def boom(a):
        if threading.current_thread().name.startswith("chunk-prefetch"):
            raise RuntimeError("prefetch boom")
        return real(a)
    return boom


def test_prefetch_error_degrades_to_sync_tail(rng, monkeypatch, budget):
    # under the default fault policy a prefetch-worker crash is not
    # fatal: the runtime cancels queued preps, joins the worker, and
    # finishes the stream on the synchronous chunk loop
    budget(BUDGET)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    real = rt_mod._reuse_nbytes
    monkeypatch.setattr(rt_mod, "_reuse_nbytes", _boom_on_prefetch(real))
    Xh, yh = rng.normal(size=(4096, 8)), rng.normal(size=(4096,))
    rt = LineageRuntime(cache=None, fuse=True, device="cpu")
    got = _lm_run(rt, Xh, yh)
    assert np.abs(got - _lm_ref(Xh, yh).ravel()).max() < 1e-10
    assert rt.stats.faults.degradations == 1
    assert _no_prefetch_threads()
    # the runtime is not poisoned: the next run (healthy worker) streams
    # pipelined again to the same answer, bitwise
    monkeypatch.setattr(rt_mod, "_reuse_nbytes", real)
    again = _lm_run(rt, Xh, yh)
    assert np.array_equal(again, got)
    assert rt.stats.faults.degradations == 1  # healthy run added none
    assert _no_prefetch_threads()


def test_prefetch_error_propagates_with_policy_off(rng, monkeypatch,
                                                   budget):
    # REPRO_FAULT_POLICY=off: the worker error propagates to the caller
    # and the worker is joined
    monkeypatch.setenv("REPRO_FAULT_POLICY", "off")
    budget(BUDGET)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    real = rt_mod._reuse_nbytes
    monkeypatch.setattr(rt_mod, "_reuse_nbytes", _boom_on_prefetch(real))
    Xh, yh = rng.normal(size=(4096, 8)), rng.normal(size=(4096,))
    rt = LineageRuntime(cache=None, fuse=True, device="cpu")
    with pytest.raises(RuntimeError, match="prefetch boom"):
        _lm_run(rt, Xh, yh)
    assert _no_prefetch_threads()
    monkeypatch.setattr(rt_mod, "_reuse_nbytes", real)
    got = _lm_run(rt, Xh, yh)
    assert np.abs(got - _lm_ref(Xh, yh).ravel()).max() < 1e-10
    assert _no_prefetch_threads()


# ---------------------------------------------------------------------------
# serving: continuous rebatching
# ---------------------------------------------------------------------------

def _score_script():
    rt = LineageRuntime(cache=None, fuse=True, device="cpu")

    def fn(x):
        return ops.matmul(x, x.T)

    return PreparedScript(fn, [(4, 4)], runtime=rt), rt


def _until(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError("condition not reached")
        time.sleep(0.001)


def test_serving_single_row_bitwise_parity_across_depths(rng, monkeypatch):
    x = rng.normal(size=(4, 4))
    got = {}
    for depth in ("1", "2"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        script, _rt_ = _score_script()
        with ModelServer(script, max_batch=4, max_wait_us=200.0) as srv:
            assert srv._pipelined == (depth == "2")
            got[depth] = srv.score(x)[0]
        assert np.allclose(got[depth], x @ x.T, atol=1e-12)
    # the depth-2 issue/completion split replays the SAME closures
    assert np.array_equal(got["1"], got["2"])


def test_serving_rebatching_overlaps_inflight_batches(rng, monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    script, rt = _score_script()
    srv = ModelServer(script, max_batch=2, max_wait_us=100.0,
                      queue_limit=64)
    with srv:
        assert srv._pipelined
        gate = threading.Event()
        orig = rt.replay_batch

        def slow(*a, **k):
            gate.wait(10.0)
            return orig(*a, **k)

        monkeypatch.setattr(rt, "replay_batch", slow)
        xs = [rng.normal(size=(4, 4)) for _ in range(6)]
        futs = [srv.submit(x) for x in xs]
        # the first batch is held on the worker: the coalescer must
        # still pop the next one — wait for that, not for a clock
        _until(lambda: rt.stats.pipeline.rebatches >= 1)
        gate.set()
        outs = [f.result(timeout=10.0) for f in futs]
        srv.flush()
    for x, out in zip(xs, outs):
        assert np.allclose(out[0], x @ x.T, atol=1e-12)
    assert rt.stats.pipeline.rebatches >= 1
    assert rt.stats.serving.retraces == 0
    assert rt.stats.serving.busy_s > 0.0


def test_serving_error_delivery_and_queue_full_while_inflight(
        rng, monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    script, rt = _score_script()
    srv = ModelServer(script, max_batch=1, max_wait_us=50.0,
                      queue_limit=2)
    with srv:
        gate = threading.Event()
        orig = rt.replay_batch
        calls = []

        def failing(*a, **k):
            calls.append(1)
            gate.wait(10.0)
            if len(calls) == 1:
                raise ValueError("replay boom")
            return orig(*a, **k)

        monkeypatch.setattr(rt, "replay_batch", failing)
        x = rng.normal(size=(4, 4))
        f1 = srv.submit(x)           # in flight, will fail
        _until(lambda: calls)        # it reached the worker
        f2 = srv.submit(x)           # staged behind it
        f3 = srv.submit(x)
        # bounded queue still applies while a batch is in flight
        with pytest.raises(QueueFullError):
            for _ in range(8):
                srv.submit(x)
        gate.set()
        with pytest.raises(ValueError, match="replay boom"):
            f1.result(timeout=10.0)
        # the failed batch did not kill the pipeline: staged requests
        # complete and match the direct product
        for f in (f2, f3):
            assert np.allclose(f.result(timeout=10.0)[0], x @ x.T,
                               atol=1e-12)
        assert rt.stats.serving.rejected >= 1
    # shutdown joined both stages
    assert not [t for t in threading.enumerate()
                if t.name.startswith("repro-serving") and t.is_alive()]


def test_serving_depth1_keeps_inline_dispatch(rng, monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")
    script, rt = _score_script()
    with ModelServer(script, max_batch=2, max_wait_us=50.0) as srv:
        assert not srv._pipelined
        assert srv._worker is None
        x = rng.normal(size=(4, 4))
        assert np.allclose(srv.score(x)[0], x @ x.T, atol=1e-12)
    assert rt.stats.pipeline.rebatches == 0
