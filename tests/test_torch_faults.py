"""Fault policy: the port's `repro_torch.core.faults` (seeded injection,
the retry/backoff/degradation ladders, the serving supervisor) against
the reference's `repro.core.faults`. Mirrors tests/test_faults.py: spec
parsing and plans, the federated site ladder (retries, timeouts,
degradation to a recompute on the master, the lost data plane, the
combined acceptance scenario), the compile fallback, the CSV chunk-IO
retries, the prefetch worker's degradation to the synchronous loop, the
serving faults, thread hygiene and the StepMonitor bounds.

Determinism contract, as in the reference: an injected fault is a pure
function of (kind, call index, seed), so the same spec fires on the same
calls in both packages, a faulted run equals the clean run (1e-12, bitwise
in practice) and the counters equal the reference's exactly. `stragglers`
(wall-clock through the median+MAD monitor) is left out of exact
assertions. Both packages run at pipeline depth 1 unless a case says
otherwise (the prefetch cases run at depth 2). The slow-site case runs
both packages on a stand-in clock whose `sleep` advances it, so the
injected delay is exactly what the timeout sees, whatever the machine's
load (the reference's own case, 10 ms against 50 ms of real sleep, has
flaked under six xdist workers).
"""
import threading
import time

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import costmodel as rcm
from repro.core import faults as rfaults
from repro.core import runtime as rruntime
from repro.core.federated import FederatedTensor as RFed
from repro.data import csv_io as rcsv
from repro.lifecycle import regression as rreg
from repro_torch.core import costmodel, faults, ops
from repro_torch.core import runtime as truntime
from repro_torch.core.dag import input_tensor
from repro_torch.core.federated import FederatedTensor
from repro_torch.core.faults import (DeadlineExceededError, InjectedFault,
                                     ServerClosedError, SiteFailedError,
                                     parse_spec)
from repro_torch.core.jit_cache import clear_jit_cache
from repro_torch.core.reuse import ReuseCache
from repro_torch.core.runtime import LineageRuntime, PreparedScript
from repro_torch.data.csv_io import read_csv_chunks, write_csv
from repro_torch.distributed.fault import (HeartbeatTracker, StepMonitor,
                                           simulate_failures)
from repro_torch.lifecycle.regression import lmDS, lmDS_federated
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


PKGS = {"port": (T, faults, FederatedTensor, lmDS_federated),
        "ref": (R, rfaults, RFed, rreg.lmDS_federated)}


def _fed_run(x, y, spec=None, intercept=True, sites=4, key="port"):
    pk, fmod, fed_cls, fit = PKGS[key]
    rt = _rt() if key == "port" else pk.LineageRuntime()
    fed = fed_cls.partition_rows(x, sites)
    with fmod.inject(spec) as plan:
        w = fit(fed, y, intercept=intercept, runtime=rt)
    return np.asarray(w), rt, plan


@pytest.fixture
def fed_data(rng):
    return rng.normal(size=(200, 6)), rng.normal(size=(200, 1))


class _Clock:
    """`time` for a runtime/faults module under test: `sleep` advances a
    private offset instead of sleeping, and `perf_counter` includes it,
    so an injected site delay is seen in full by the timeout check and
    costs no wall time."""

    def __init__(self):
        self.offset = 0.0

    def perf_counter(self):
        return time.perf_counter() + self.offset

    def sleep(self, seconds):
        self.offset += seconds

    def __getattr__(self, name):
        return getattr(time, name)


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

    def test_policy_kill_switch(self, monkeypatch, fed_data):
        monkeypatch.setenv("REPRO_FAULT_POLICY", "off")
        assert not faults.policy_enabled()
        x, y = fed_data
        w0, rt0, _ = _fed_run(x, y)
        # injection entries are no-ops with the policy off
        w1, rt1, plan = _fed_run(x, y, "seed=1;site_rpc@0,1")
        assert not plan.fired
        assert np.abs(w1 - w0).max() == 0.0
        assert rt1.stats.faults.injected == 0

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
# Federated: retry, timeout, degradation ladders
# ---------------------------------------------------------------------------

class TestFederatedRecovery:
    def _both(self, x, y, spec, **kw):
        """The port's and the reference's faulted run of one spec: the
        same firings, the same counters, betas within rel 1e-10."""
        w, rt, plan = _fed_run(x, y, spec, **kw)
        rw, rrt, rplan = _fed_run(x, y, spec, key="ref", **kw)
        assert np.abs(w - rw).max() <= 1e-10 * np.abs(rw).max()
        assert _counters(rt) == _counters(rrt)
        assert dict(plan.fired if plan else {}) == \
            dict(rplan.fired if rplan else {})
        assert rt.stats.exchange.as_dict() == rrt.stats.exchange.as_dict()
        return w, rt, plan

    def test_transient_rpc_faults_heal_by_retry(self, fed_data):
        x, y = fed_data
        w0, _, _ = _fed_run(x, y)
        w1, rt, plan = self._both(x, y, "seed=3;site_rpc@0,1")
        assert np.abs(w1 - w0).max() < 1e-12
        assert np.array_equal(w1, w0)
        assert _counters(rt) == dict(injected=2, retries=2, timeouts=0,
                                     degradations=0, shed=0, restarts=0)
        assert plan.fired == {"site_rpc": 2}
        assert rt.stats.faults.backoff_s > 0.0

    def test_dead_site_degrades_to_recompute(self, fed_data):
        # 1 dead site of 4 plus 2 transient RPC failures: every fed
        # instruction exhausts retries against site 2, then collects its
        # partition and recomputes locally through the SAME cached
        # closure -> bitwise parity with the clean run
        x, y = fed_data
        w0, _, _ = _fed_run(x, y)
        spec = "seed=11;site_dead:site=2;site_rpc@0,9"
        w1, rt, plan = self._both(x, y, spec)
        assert np.array_equal(w1, w0)
        # 3 fed instructions (fed_map, fed_gram, fed_xtv): dead site
        # burns 3 attempts each (9 injected minus one call where the
        # positional site_rpc rule fired first), transient rules add 2
        assert _counters(rt) == dict(injected=10, retries=7, timeouts=0,
                                     degradations=3, shed=0, restarts=0)
        assert plan.fired == {"site_rpc": 2, "site_dead": 8}

    def test_faulted_run_is_deterministic(self, fed_data):
        x, y = fed_data
        spec = "seed=11;site_dead:site=2;site_rpc@0,9"
        w1, rt1, p1 = _fed_run(x, y, spec)
        w2, rt2, p2 = _fed_run(x, y, spec)
        assert np.abs(w1 - w2).max() == 0.0
        assert _counters(rt1) == _counters(rt2)
        assert dict(p1.fired) == dict(p2.fired)

    def test_slow_site_times_out_then_degrades(self, monkeypatch,
                                               fed_data):
        # every call to site 1 is 5 s late on the stand-in clock against
        # a 1 s timeout (a clean site call takes well under a
        # millisecond here): the attempt-boundary timeout discards the
        # late result, retries, then degrades. site_slow never raises ->
        # injected stays 0.
        clock = _Clock()
        for mod in (truntime, faults, rruntime, rfaults):
            monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setenv("REPRO_FED_TIMEOUT_S", "1.0")
        x, y = fed_data
        w0, _, _ = _fed_run(x, y, intercept=False)
        w1, rt, plan = self._both(
            x, y, "site_slow:p=1:site=1:delay=5.0", intercept=False)
        assert np.array_equal(w1, w0)
        assert _counters(rt) == dict(injected=0, retries=4, timeouts=6,
                                     degradations=2, shed=0, restarts=0)
        assert plan.fired == {"site_slow": 6}

    def test_lost_data_plane_is_fatal(self, fed_data):
        # site_lost means the partition itself is gone: no degradation
        # rung remains and the failure surfaces with site + instruction
        x, y = fed_data
        for key in PKGS:
            with pytest.raises((SiteFailedError,
                                rfaults.SiteFailedError)) as ei:
                _fed_run(x, y, "seed=1;site_lost:site=1", key=key)
            assert ei.value.site == 1
            assert "site 1" in str(ei.value)
            assert ei.value.instruction     # names the fed instruction

    def test_control_plane_surfaces_in_stats(self, fed_data):
        x, y = fed_data
        _, rt, _ = _fed_run(x, y, "seed=11;site_dead:site=2")
        d = rt.stats.as_dict()["faults"]
        assert d["degradations"] == 3
        assert d["incidents"] >= d["injected"] + d["degradations"]
        assert "site_p50_us" in d and "site_p99_us" in d
        # heartbeats: the 3 surviving sites beat on every successful
        # RPC; the dead site never does
        assert d["sites_seen"] == 3
        assert d["dead_sites"] == []    # dead-man switch is 60s

    def test_combined_faults_acceptance(self, rng, tmp_path):
        # the acceptance scenario: site failures + chunk IO errors + one
        # compile failure in ONE seeded run — 1e-12 parity with the
        # clean run, identical counters on every rerun and in both
        # packages. The closure cache is cleared per run so build-call
        # indices (and hence the compile@0 firing) are reproducible.
        xh = rng.normal(size=(208, 7))
        yh = rng.normal(size=(208, 1))
        path = str(tmp_path / "d.csv")
        write_csv(path, np.hstack([xh, yh]))

        def run(spec, key="port"):
            pk, fmod, fed_cls, fit = PKGS[key]
            pk.clear_jit_cache()
            rt = _rt() if key == "port" else pk.LineageRuntime()
            read = read_csv_chunks if key == "port" \
                else rcsv.read_csv_chunks
            with fmod.inject(spec) as plan:
                parts = [c for _, c in read(
                    path, 64, chunk_bytes=1 << 12,
                    fault_log=rt.stats.faults)]
                data = np.vstack(parts)
                fed = fed_cls.partition_rows(data[:, :-1], 4)
                w = fit(fed, data[:, -1:], intercept=True, runtime=rt)
            return (np.asarray(w), rt,
                    dict(plan.fired) if plan else {})

        spec = ("seed=13;site_dead:site=3;site_rpc@2;"
                "chunk_io@0,1;compile@0")
        w0, _, _ = run(None)
        w1, rt1, fired1 = run(spec)
        w2, rt2, fired2 = run(spec)
        rw, rrt, rfired = run(spec, key="ref")
        assert np.array_equal(w1, w0)
        assert np.abs(w1 - w2).max() == 0.0
        assert np.abs(w1 - rw).max() <= 1e-10 * np.abs(rw).max()
        assert _counters(rt1) == _counters(rt2) == _counters(rrt) == dict(
            injected=13, retries=10, timeouts=0, degradations=3,
            shed=0, restarts=0)
        assert fired1 == fired2 == rfired == {
            "chunk_io": 2, "compile": 1, "site_rpc": 1, "site_dead": 9}
        assert rt1.stats.exchange.as_dict() == rrt.stats.exchange.as_dict()

    def test_clean_run_has_no_fault_section(self, fed_data):
        x, y = fed_data
        rt = _rt()
        fed = FederatedTensor.partition_rows(x, 4)
        with faults.inject(None):
            lmDS_federated(fed, y, intercept=True, runtime=rt)
        assert _counters(rt) == dict(injected=0, retries=0, timeouts=0,
                                     degradations=0, shed=0, restarts=0)
        assert "faults" not in rt.stats.as_dict()

    @pytest.mark.parametrize("depth", ["1", "2"])
    def test_dead_site_bitwise_at_both_depths(self, fed_data, monkeypatch,
                                              depth):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        x, y = fed_data
        w0, _, _ = _fed_run(x, y)
        w1, rt, _ = _fed_run(x, y, "seed=11;site_dead:site=2")
        assert np.array_equal(w1, w0)
        assert rt.stats.faults.degradations == 3


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


class TestPrefetchRecovery:
    def test_prefetch_worker_death_degrades_to_sync(self, rng,
                                                    monkeypatch):
        # kill the chunk-prefetch worker mid-stream: the consumer drains
        # in-flight work and finishes the tail synchronously
        # (injection-free), same chunks, bitwise result — in both
        # packages, with the same counters
        monkeypatch.setattr(costmodel, "CHUNK_MEM_BUDGET", BUDGET)
        monkeypatch.setattr(rcm, "CHUNK_MEM_BUDGET", BUDGET)
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
        xh = rng.normal(size=(4096, 8))
        yh = rng.normal(size=(4096, 1))

        def run(spec, key="port"):
            if key == "port":
                rt = _rt(cache=ReuseCache(), fuse=True)
                fit, fmod, pk = lmDS, faults, T
            else:
                rt = R.LineageRuntime(cache=R.ReuseCache(), fuse=True)
                fit, fmod, pk = rreg.lmDS, rfaults, R
            with fmod.inject(spec):
                w = fit(pk.input_tensor("X", xh), pk.input_tensor("y", yh),
                        reg=1e-3, runtime=rt)
            return np.asarray(w), rt

        w0, rt0 = run(None)
        w1, rt1 = run("seed=2;chunk_io@1")
        assert np.array_equal(w1, w0)
        assert rt1.stats.streaming.chunks == rt0.stats.streaming.chunks
        f = rt1.stats.faults
        assert f.injected == 1 and f.degradations == 1
        rw, rrt = run("seed=2;chunk_io@1", key="ref")
        assert np.abs(w1 - rw).max() <= 1e-10 * np.abs(rw).max()
        assert _counters(rt1) == _counters(rrt)
        assert rt1.stats.streaming.as_dict() == rrt.stats.streaming.as_dict()
        # (prefetch_cancelled is left out: whether the worker took the
        # next prep before the consumer cancelled it is a race, in the
        # reference as here)
        p, rp = rt1.stats.pipeline, rrt.stats.pipeline
        assert (p.prefetch_issued, p.prefetch_hits) \
            == (rp.prefetch_issued, rp.prefetch_hits)


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

    def test_streaming_crash_cycles_leak_no_threads(self, rng,
                                                    monkeypatch):
        monkeypatch.setattr(costmodel, "CHUNK_MEM_BUDGET", BUDGET)
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
        xh = rng.normal(size=(4096, 8))
        yh = rng.normal(size=(4096, 1))
        before = set(threading.enumerate())
        ws = []
        for i in range(3):
            rt = _rt(cache=ReuseCache(), fuse=True)
            with faults.inject(f"seed={i};chunk_io@1"):
                ws.append(np.asarray(
                    lmDS(input_tensor("X", xh), input_tensor("y", yh),
                         reg=1e-3, runtime=rt)))
            assert rt.stats.faults.degradations == 1
        assert np.abs(ws[0] - ws[1]).max() == 0.0
        assert np.abs(ws[0] - ws[2]).max() == 0.0
        assert set(threading.enumerate()) == before

    def test_pipelined_serving_crash_cycles_leak_no_threads(
            self, rng, monkeypatch):
        # the depth-2 server: a coalescer crash fails only its batch, and
        # shutdown joins the coalescer and the completion worker
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
        rt = _rt()
        script = _script(rng, rt)
        x = rng.normal(size=(1, D))
        before = set(threading.enumerate())
        with ModelServer(script, runtime=rt, max_batch=8,
                         max_wait_us=500.0) as srv:
            assert srv._pipelined
            for i in range(3):
                with faults.inject(f"seed={i};serving_dispatch@0"):
                    with pytest.raises(InjectedFault):
                        srv.score(x, timeout=5.0)
                with faults.inject(None):
                    got, = srv.score(x, timeout=5.0)
                    assert (got == script(x)[0]).all()
        assert rt.stats.faults.restarts == 3
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
