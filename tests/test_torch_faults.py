"""Fault policy: the port's `repro_torch.core.faults` (seeded injection,
the retry/backoff/degradation ladders, the serving supervisor) against
the reference's `repro.core.faults`. Mirrors tests/test_faults.py where
the port has the call site: spec parsing and plans, the compile fallback,
the CSV chunk-IO retries, the serving faults, thread hygiene and the
StepMonitor bounds. The federated and prefetch classes wait for those
lanes (ROADMAP Queue 1 items 8 and 10).

Determinism contract, as in the reference: an injected fault is a pure
function of (kind, call index, seed), so the same spec fires on the same
calls in both packages, a faulted run equals the clean run (1e-12, bitwise
in practice) and the counters equal the reference's exactly. `stragglers`
(wall-clock through the median+MAD monitor) is left out of exact
assertions. The reference runs at pipeline depth 1 (the port's lane).
"""
import threading
import time

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import faults as rfaults
from repro.data import csv_io as rcsv
from repro.lifecycle import regression as rreg
from repro_torch.core import costmodel, faults, ops
from repro_torch.core.dag import input_tensor
from repro_torch.core.faults import (DeadlineExceededError, InjectedFault,
                                     ServerClosedError, SiteFailedError,
                                     parse_spec)
from repro_torch.core.jit_cache import clear_jit_cache
from repro_torch.core.reuse import ReuseCache
from repro_torch.core.runtime import LineageRuntime, PreparedScript
from repro_torch.data.csv_io import read_csv_chunks, write_csv
from repro_torch.distributed.fault import (HeartbeatTracker, StepMonitor,
                                           simulate_failures)
from repro_torch.lifecycle.regression import lmDS
from repro_torch.serving import ModelServer, ScoreFuture

D = 16


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _counters(rt):
    """The deterministic counter tuple (everything but stragglers)."""
    f = rt.stats.faults
    return dict(injected=f.injected, retries=f.retries,
                timeouts=f.timeouts, degradations=f.degradations,
                shed=f.shed, restarts=f.restarts)


def _rt(**kw):
    return LineageRuntime(device="cpu", **kw)


# ---------------------------------------------------------------------------
# Spec parsing / plan semantics
# ---------------------------------------------------------------------------

class TestSpecAndPlan:
    def test_parse_spec_round_trip(self):
        plan = parse_spec(
            "seed=42;site_rpc@1,3;site_slow:p=0.1:delay=0.02;"
            "site_dead:site=2")
        assert plan.seed == 42
        kinds = [r.kind for r in plan.rules]
        assert kinds == ["site_rpc", "site_slow", "site_dead"]
        assert plan.rules[0].at == frozenset({1, 3})
        assert plan.rules[1].params["delay"] == pytest.approx(0.02)
        assert plan.rules[2].params["site"] == 2
        assert plan.site_is_dead(2) and not plan.data_lost(2)

    @pytest.mark.parametrize("spec,match", [
        ("bogus@1", "bogus"), ("site_dead", "site=K"),
        ("chunk_io:q=1", "parameter")])
    def test_parse_spec_rejects(self, spec, match):
        with pytest.raises(ValueError, match=match):
            parse_spec(spec)
        with pytest.raises(ValueError, match=match):
            rfaults.parse_spec(spec)

    def test_indexed_firing_is_positional(self):
        plan = parse_spec("seed=7;site_rpc@2")
        hits = [plan.check("site_rpc", site=0) is not None
                for _ in range(4)]
        assert hits == [False, False, True, False]
        assert plan.fired["site_rpc"] == 1
        assert plan.calls["site_rpc"] == 4

    def test_probability_draws_are_seeded(self):
        def pattern(seed):
            plan = parse_spec(f"seed={seed};chunk_io:p=0.5")
            return [plan.check("chunk_io") is not None
                    for _ in range(64)]
        assert pattern(1) == pattern(1)
        assert pattern(1) != pattern(2)

    @pytest.mark.parametrize("spec", [
        "seed=3;chunk_io:p=0.3;compile@1,4;serving_dispatch:p=0.5",
        "seed=11;site_dead:site=2;site_rpc@0,9;site_slow:p=0.2",
        "chunk_io@0,1;compile:p=0.9"])
    def test_same_spec_fires_on_same_indices_as_reference(self, spec):
        """One spec, one call sequence: the port's plan and the
        reference's fire on exactly the same calls, with the same draws
        and counters."""
        calls = [("chunk_io", {}), ("compile", {}), ("site_rpc", {"site": 2}),
                 ("serving_dispatch", {}), ("site_dead", {"site": 2}),
                 ("site_slow", {"site": 1}), ("site_rpc", {"site": 0})] * 12
        tp, rp = parse_spec(spec), rfaults.parse_spec(spec)
        got = [tp.check(k, **c) is not None for k, c in calls]
        want = [rp.check(k, **c) is not None for k, c in calls]
        assert got == want and any(got)
        assert tp.fired == rp.fired and tp.calls == rp.calls
        for i in range(50):
            assert faults._draw(tp.seed, "chunk_io", i) == \
                rfaults._draw(rp.seed, "chunk_io", i)

    def test_inject_stack_overrides_env(self, monkeypatch):
        monkeypatch.setenv("REPRO_FAULT_SPEC", "chunk_io@0")
        env_plan = faults.active_plan()
        assert env_plan is not None
        with faults.inject(None):            # explicit clean run
            assert faults.active_plan() is None
        with faults.inject("seed=1;chunk_io@0") as p:
            assert faults.active_plan() is p
        assert faults.active_plan() is env_plan

    def test_policy_kill_switch_csv(self, monkeypatch, rng, tmp_path):
        monkeypatch.setenv("REPRO_FAULT_POLICY", "off")
        assert not faults.policy_enabled()
        path = str(tmp_path / "x.csv")
        write_csv(path, rng.normal(size=(100, 3)))
        flog = faults.FaultLog()
        # injection entries are no-ops with the policy off
        with faults.inject("seed=1;chunk_io@0,1,2") as plan:
            parts = list(read_csv_chunks(path, 16, fault_log=flog))
        assert not plan.fired and flog.total == 0
        assert sum(p.shape[0] for _, p in parts) == 100

    def test_policy_kill_switch_serving(self, monkeypatch, rng):
        monkeypatch.setenv("REPRO_FAULT_POLICY", "off")
        rt = _rt()
        script = _script(rng, rt)
        x = rng.normal(size=(1, D))
        with faults.inject("seed=1;serving_dispatch@0") as plan:
            with ModelServer(script, runtime=rt, max_batch=8,
                             max_wait_us=500.0) as srv:
                got, = srv.score(x, timeout=5.0)
        assert not plan.fired and rt.stats.faults.restarts == 0
        assert (got == script(x)[0]).all()


# ---------------------------------------------------------------------------
# Compile failures: interpreter fallback
# ---------------------------------------------------------------------------

class TestCompileFallback:
    def test_segment_summary_names_ops(self, rng):
        from repro_torch.core.compiler import compile_plan
        X = input_tensor("X", rng.normal(size=(32, 4)))
        plan = compile_plan([ops.gram(X)], reuse_enabled=False)
        s = plan.segments_for(False)[0].summary()
        assert s.startswith("segment#") and "gram" in s and "ins=" in s

    @pytest.mark.parametrize("cache", [True, False])
    def test_compile_fault_falls_back_to_interpreter(self, rng, cache):
        xh = rng.normal(size=(61, 9))
        yh = rng.normal(size=(61, 1))

        def run(spec):
            clear_jit_cache()       # the first build is compile call 0
            rt = _rt(cache=ReuseCache() if cache else None)
            with faults.inject(spec):
                w = lmDS(input_tensor("X", xh), input_tensor("y", yh),
                         reg=1e-3, runtime=rt)
            return np.asarray(w), rt

        w1, rt1 = run("seed=1;compile@0")
        w0, _ = run(None)
        assert np.abs(w1 - w0).max() < 1e-12
        assert _counters(rt1) == dict(injected=1, retries=0, timeouts=0,
                                      degradations=1, shed=0, restarts=0)
        assert rt1.stats.as_dict()["faults"]["degradations"] == 1

    def test_every_build_failing_still_computes(self, rng):
        xh, yh = rng.normal(size=(40, 5)), rng.normal(size=(40, 1))
        clear_jit_cache()
        rt = _rt(cache=ReuseCache())
        with faults.inject("compile:p=1") as plan:
            w1 = lmDS(input_tensor("X", xh), input_tensor("y", yh),
                      reg=1e-3, runtime=rt)
        w0 = lmDS(input_tensor("X", xh), input_tensor("y", yh), reg=1e-3,
                  runtime=_rt(fuse=False))
        assert np.abs(w1 - w0).max() < 1e-12
        f = rt.stats.faults
        assert f.degradations == f.injected == plan.fired["compile"] >= 2

    def test_vmapped_segment_reraises(self, rng):
        from repro_torch.lifecycle import grid_search_lm
        X = input_tensor("gX", rng.normal(size=(30, 4)))
        y = input_tensor("gy", rng.normal(size=(30, 1)))
        clear_jit_cache()
        with faults.inject("compile:p=1"):
            with pytest.raises(faults.CompileFailedError, match="vmap"):
                grid_search_lm(X, y, [0.1, 1.0], runtime=_rt(), mode="vmap")

    def test_policy_off_propagates_raw(self, rng, monkeypatch):
        from repro_torch.core import jit_cache
        monkeypatch.setenv("REPRO_FAULT_POLICY", "off")
        clear_jit_cache()

        def boom(self, key, build_fn):
            raise RuntimeError("build exploded")
        monkeypatch.setattr(jit_cache.JitProgramCache, "compile", boom)
        X = input_tensor("X", rng.normal(size=(8, 3)))
        with pytest.raises(RuntimeError, match="build exploded"):
            _rt().evaluate([ops.gram(X)])


# ---------------------------------------------------------------------------
# Streaming: chunk IO retry (the CSV half of TestStreamingRecovery)
# ---------------------------------------------------------------------------

BUDGET = 1 << 16


class TestStreamingRecovery:
    def test_csv_read_retries_transient_io(self, rng, tmp_path):
        path = str(tmp_path / "x.csv")
        write_csv(path, rng.normal(size=(300, 4)))
        flog = faults.FaultLog()
        with faults.inject("seed=5;chunk_io@0,1"):
            chunks = list(read_csv_chunks(path, 64, chunk_bytes=1 << 12,
                                          fault_log=flog))
        clean = list(read_csv_chunks(path, 64, chunk_bytes=1 << 12))
        assert len(chunks) == len(clean)
        for (o1, c1), (o0, c0) in zip(chunks, clean):
            assert o1 == o0 and (c1 == c0).all()
        assert flog.injected == 2 and flog.retries == 2
        assert flog.backoff_s == pytest.approx(
            costmodel.retry_backoff_s(1) + costmodel.retry_backoff_s(2))

    def test_csv_read_exhausts_retries(self, rng, tmp_path):
        path = str(tmp_path / "x.csv")
        write_csv(path, rng.normal(size=(50, 3)))
        with faults.inject("seed=5;chunk_io@0,1,2"):
            with pytest.raises(InjectedFault):
                list(read_csv_chunks(path, 16))

    def test_retry_knobs_read_from_env(self, rng, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_MAX_RETRIES", "3")
        monkeypatch.setenv("REPRO_RETRY_BASE_S", "0")
        path = str(tmp_path / "x.csv")
        write_csv(path, rng.normal(size=(50, 3)))
        flog = faults.FaultLog()
        with faults.inject("seed=5;chunk_io@0,1,2"):
            got = list(read_csv_chunks(path, 16, fault_log=flog))
        assert len(got) == 4 and flog.retries == 3 and flog.backoff_s == 0

    def test_streamed_lmds_parity_with_io_faults(self, rng, tmp_path,
                                                 monkeypatch):
        monkeypatch.setattr(costmodel, "CHUNK_MEM_BUDGET", BUDGET)
        xh = rng.normal(size=(4096, 8))
        yh = rng.normal(size=(4096, 1))
        path = str(tmp_path / "x.csv")
        write_csv(path, np.hstack([xh, yh]))

        def ingest(spec, flog):
            with faults.inject(spec):
                parts = [c for _, c in read_csv_chunks(
                    path, 512, chunk_bytes=1 << 14, fault_log=flog)]
            return np.vstack(parts)

        flog = faults.FaultLog()
        data1 = ingest("seed=9;chunk_io@0,1", flog)
        data0 = ingest(None, faults.FaultLog())
        assert (data1 == data0).all()
        assert flog.injected == 2 and flog.retries == 2

        def fit(data):
            rt = _rt(cache=ReuseCache())
            with faults.inject(None):
                w = lmDS(input_tensor("X", data[:, :-1]),
                         input_tensor("y", data[:, -1:]),
                         reg=1e-3, runtime=rt)
            assert rt.stats.streaming.chunks > 1   # actually streamed
            return np.asarray(w)

        assert np.abs(fit(data1) - fit(data0)).max() < 1e-12


def test_counters_equal_the_reference(rng, tmp_path):
    """The reference's combined scenario without its federated part: CSV
    ingestion with two chunk-IO faults, then lmDS with one compile fault,
    in both packages from a cleared closure cache — the same firings,
    the same counters, and results within 1e-12."""
    data = np.hstack([rng.normal(size=(208, 7)), rng.normal(size=(208, 1))])
    path = str(tmp_path / "d.csv")
    write_csv(path, data)
    spec = "seed=13;chunk_io@0,1;compile@0"
    out = {}
    for key, pk, fmod, csvmod, reg in (
            ("port", T, faults, None, None),
            ("ref", R, rfaults, rcsv, rreg)):
        pk.clear_jit_cache()
        rt = (pk.LineageRuntime(device="cpu") if key == "port"
              else pk.LineageRuntime())
        read = read_csv_chunks if csvmod is None else csvmod.read_csv_chunks
        fit = lmDS if reg is None else reg.lmDS
        with fmod.inject(spec) as plan:
            parts = [c for _, c in read(path, 64, chunk_bytes=1 << 12,
                                        fault_log=rt.stats.faults)]
            d = np.vstack(parts)
            w = fit(pk.input_tensor("X", d[:, :-1]),
                    pk.input_tensor("y", d[:, -1:]), reg=1e-3, runtime=rt)
        out[key] = (np.asarray(w), _counters(rt), dict(plan.fired),
                    rt.stats.faults.backoff_s)
    assert np.abs(out["port"][0] - out["ref"][0]).max() < 1e-12
    assert out["port"][1] == out["ref"][1] == dict(
        injected=3, retries=2, timeouts=0, degradations=1, shed=0,
        restarts=0)
    assert out["port"][2] == out["ref"][2] == {"chunk_io": 2, "compile": 1}
    assert out["port"][3] == out["ref"][3]


# ---------------------------------------------------------------------------
# Serving: deadlines, supervisor, terminal errors
# ---------------------------------------------------------------------------

def _script(rng, rt):
    W = input_tensor("fltW", rng.normal(size=(D, 1)))
    return PreparedScript(lambda x: (ops.matmul(x, W),), [(1, D)],
                          runtime=rt)


class TestServingFaults:
    def test_deadline_shed_before_dispatch(self, rng):
        rt = _rt()
        script = _script(rng, rt)
        srv = ModelServer(script, runtime=rt, max_batch=8,
                          adaptive=False, max_wait_us=5e4)
        with faults.inject("seed=1"), srv:
            fut = srv.submit(rng.normal(size=(1, D)), deadline_us=1.0)
            with pytest.raises(DeadlineExceededError):
                fut.result(timeout=5.0)
        assert rt.stats.faults.shed == 1
        assert rt.stats.as_dict()["faults"]["shed"] == 1

    def test_supervisor_restarts_coalescer_in_thread(self, rng):
        rt = _rt()
        script = _script(rng, rt)
        x = rng.normal(size=(1, D))
        before = set(threading.enumerate())
        with faults.inject("seed=1;serving_dispatch@0"):
            with ModelServer(script, runtime=rt, max_batch=8,
                             max_wait_us=500.0) as srv:
                # the first dispatch crashes in the pop->dispatch window:
                # exactly that batch fails, the loop restarts in-thread
                with pytest.raises(InjectedFault):
                    srv.score(x, timeout=5.0)
                got, = srv.score(x, timeout=5.0)
        ref, = script(x)
        assert (got == ref).all()
        assert rt.stats.faults.restarts == 1
        assert rt.stats.faults.injected == 1
        assert set(threading.enumerate()) == before

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_dead_dispatcher_surfaces_not_hangs(self, rng):
        # a persistent (non-injected) poison kills the dispatcher once the
        # restart budget is spent; waiters get ServerClosedError instead
        # of hanging, and shutdown delivers terminal errors to anything
        # still queued
        rt = _rt()
        script = _script(rng, rt)
        srv = ModelServer(script, runtime=rt, max_batch=8,
                          max_wait_us=500.0).deploy()
        srv.max_restarts = 2
        srv._budget_s = None            # poisons every coalesce pass
        fut = srv.submit(rng.normal(size=(1, D)))
        with pytest.raises((ServerClosedError, TypeError)):
            fut.result(timeout=5.0)
        deadline = time.monotonic() + 5.0
        while srv._dispatcher_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._dispatcher_alive()
        late = srv.submit(rng.normal(size=(1, D)))
        srv.shutdown()
        with pytest.raises(ServerClosedError):
            late.result(timeout=5.0)
        assert rt.stats.faults.restarts == 2

    def test_result_timeout(self):
        fut = ScoreFuture([np.zeros((1, D))])
        with pytest.raises(TimeoutError):
            fut.result(timeout=0.1)

    def test_score_timeout_kwarg(self, rng):
        rt = _rt()
        script = _script(rng, rt)
        with ModelServer(script, runtime=rt).deploy() as srv:
            got, = srv.score(rng.normal(size=(1, D)), timeout=5.0)
            assert got.shape == (1, 1)

    def test_dispatch_latencies_metered(self, rng):
        rt = _rt()
        script = _script(rng, rt)
        with faults.inject(None), \
                ModelServer(script, runtime=rt).deploy() as srv:
            srv.score(rng.normal(size=(1, D)), timeout=5.0)
        d = rt.stats.faults
        assert d.dispatch_monitor.times
        assert "dispatch_p50_us" in d.as_dict()

    def test_site_failed_error_names_site(self):
        e = SiteFailedError(3, "fed_gram", "data plane lost")
        assert e.site == 3 and "site 3" in str(e) and "fed_gram" in str(e)


# ---------------------------------------------------------------------------
# Thread hygiene: repeated crash/recover cycles leak nothing
# ---------------------------------------------------------------------------

class TestThreadHygiene:
    def test_serving_crash_cycles_leak_no_threads(self, rng):
        rt = _rt()
        script = _script(rng, rt)
        x = rng.normal(size=(1, D))
        before = set(threading.enumerate())
        with ModelServer(script, runtime=rt, max_batch=8,
                         max_wait_us=500.0) as srv:
            for i in range(4):
                with faults.inject(f"seed={i};serving_dispatch@0"):
                    with pytest.raises(InjectedFault):
                        srv.score(x, timeout=5.0)
                with faults.inject(None):
                    got, = srv.score(x, timeout=5.0)
                    assert got.shape == (1, 1)
        assert rt.stats.faults.restarts == 4
        assert set(threading.enumerate()) == before


# ---------------------------------------------------------------------------
# Rescued control plane: StepMonitor bounds, heartbeats
# ---------------------------------------------------------------------------

class TestStepMonitorBounds:
    def test_history_stays_bounded(self):
        m = StepMonitor(max_history=16)
        for i in range(200):
            m.record(i, 0.001)
        assert len(m.times) < 2 * 16
        p50, p99 = m.p50_p99()
        assert p50 == pytest.approx(0.001)

    def test_straggler_still_flagged_after_trim(self):
        m = StepMonitor(max_history=16)
        for i in range(100):
            m.record(i, 1.0)
        assert m.record(100, 10.0)
        assert m.incidents[-1]["step"] == 100

    def test_flags_match_the_reference(self):
        from repro.distributed.fault import StepMonitor as RMonitor
        seq = [1.0, 1.1, 0.9] * 5 + [5.0, 1.0, 1.0, 9.0] + [1.0] * 70
        ours, theirs = StepMonitor(max_history=32), RMonitor(max_history=32)
        got = [ours.record(i, t) for i, t in enumerate(seq)]
        want = [theirs.record(i, t) for i, t in enumerate(seq)]
        assert got == want and sum(got) == 2
        assert ours.times == theirs.times
        assert ours.incidents == theirs.incidents

    def test_heartbeats_and_simulated_failures(self):
        hb = HeartbeatTracker(timeout_s=10.0)
        hb.beat("a", now=0.0)
        hb.beat("b", now=5.0)
        assert hb.dead_hosts(now=12.0) == ["a"]
        calls = []

        def run_fn(until, state):
            calls.append((until, state))
            return until

        assert simulate_failures(9, (6, 3), run_fn,
                                 lambda s: s + 100) == 9
        assert calls == [(3, None), (6, 103), (9, 106)]
