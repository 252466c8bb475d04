"""Runtime parity: the port's LineageRuntime against the reference's.

Same programs on the same numpy data through `repro` (jax, CPU, at
pipeline depth 1 — the synchronous lane the port implements) and
`repro_torch` (`device="cpu"`). Results agree to rel 1e-10, and every
counter that is not a timing must be identical: reuse-cache probes, hits,
misses and bytes, RuntimeStats instruction/segment/reuse counts, jit-cache
hits and misses from a cleared cache, and the streaming meter. Within the
port, `fuse=True` and `fuse=False` agree bit for bit.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import costmodel as rcm
from repro_torch.core import costmodel as tcm

PKGS = {"ref": R, "port": T}
RTOL = 1e-10


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _rt(key, **kw):
    if key == "port":
        return T.LineageRuntime(device="cpu", **kw)
    return R.LineageRuntime(**kw)


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b))


def _counters(rt):
    d = rt.stats.as_dict()
    return {k: v for k, v in d.items()
            if not k.endswith("_s") and k != "jit_cache"}


def _jit_delta(pk, before):
    s = pk.get_jit_cache().stats
    return dict(hits=s.hits - before[0], misses=s.misses - before[1],
                evictions=s.evictions - before[2])


def _jit_now(pk):
    s = pk.get_jit_cache().stats
    return s.hits, s.misses, s.evictions


def _jit_mark(pk):
    pk.clear_jit_cache()
    return _jit_now(pk)


def _quickstart(pk, rt, xn, yn):
    X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
    return [rt.evaluate([pk.ops.solve(X.T @ X + lam * pk.ops.eye(xn.shape[1]),
                                      X.T @ y)])[0]
            for lam in (0.01, 0.1, 1.0, 10.0)]


def _data(m=500, n=16, seed=0):
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(m, n))
    return xn, xn @ rng.normal(size=(n, 1)) + 0.01 * rng.normal(size=(m, 1))


@pytest.mark.parametrize("fuse", [True, False])
def test_quickstart_sweep_matches_reference(fuse):
    xn, yn = _data()
    out = {}
    for key, pk in PKGS.items():
        mark = _jit_mark(pk)
        rt = _rt(key, cache=pk.ReuseCache(), fuse=fuse)
        betas = _quickstart(pk, rt, xn, yn)
        out[key] = (betas, rt.cache.stats.as_dict(), _counters(rt),
                    _jit_delta(pk, mark))
    for a, b in zip(out["port"][0], out["ref"][0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= RTOL
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1]["hits"] >= 3
    assert out["port"][2] == out["ref"][2]
    assert out["port"][3] == out["ref"][3]


@pytest.mark.parametrize("cache", [False, True])
def test_fuse_modes_bitwise_equal(cache):
    xn, yn = _data(seed=1)
    res = {}
    for fuse in (True, False):
        rt = T.LineageRuntime(cache=T.ReuseCache() if cache else None,
                              fuse=fuse, device="cpu")
        res[fuse] = (_quickstart(T, rt, xn, yn),
                     rt.cache.stats.as_dict() if cache else None)
    for a, b in zip(res[True][0], res[False][0]):
        assert np.array_equal(a, b)
    assert res[True][1] == res[False][1]


def test_prepared_script_replays_hit_without_rebuilds():
    counts = {}
    for key, pk in PKGS.items():
        def fn(a, b, pk=pk):
            return pk.ops.solve(pk.ops.gram(a) + 0.5 * pk.ops.eye(8),
                                pk.ops.xtv(a, b))
        mark = _jit_mark(pk)
        rt = _rt(key)
        ps = pk.PreparedScript(fn, [(64, 8), (64, 1)], runtime=rt)
        outs, trace = [], []
        for k in range(4):
            xn, yn = _data(64, 8, seed=10 + k)
            outs.append(ps(xn, yn)[0])
            trace.append(_jit_delta(pk, mark))
        counts[key] = (outs, trace, _counters(rt))
    port_outs, trace, _ = counts["port"]
    assert trace[0]["misses"] > 0
    assert all(t["misses"] == trace[0]["misses"] for t in trace)  # no rebuild
    assert [t["hits"] for t in trace] == sorted({t["hits"] for t in trace})
    assert trace[-1]["hits"] > trace[0]["hits"]
    assert trace == counts["ref"][1]
    assert counts["port"][2] == counts["ref"][2]
    for a, b in zip(port_outs, counts["ref"][0]):
        assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("m,n,budget,buckets,warm_rebuilds", [
    (4096, 8, 1 << 16, 32, 0), (1024, 512, 1 << 19, 64, 1)])
def test_streaming_lane_matches_reference(monkeypatch, m, n, budget, buckets,
                                          warm_rebuilds):
    """Cold fit, two warm refits and a fit on appended rows: the same
    streaming meter, reuse counters and jit-cache hits/misses per fit as
    the reference. At the wider shape the generator segment (the literal
    reg, then eye(n)) ends in an eye worth a reuse probe; the first warm
    refit hits it and builds one compensation closure for the literal, in
    both packages. The second warm refit builds none."""
    monkeypatch.setattr(rcm, "CHUNK_MEM_BUDGET", budget)
    monkeypatch.setattr(tcm, "CHUNK_MEM_BUDGET", budget)
    rng = np.random.default_rng(3)
    xn, yn = rng.normal(size=(m, n)), rng.normal(size=(m, 1))
    x2 = np.vstack([xn, rng.normal(size=(700, n))])
    y2 = np.vstack([yn, rng.normal(size=(700, 1))])
    out = {}
    for key, pk in PKGS.items():
        lmDS = import_module(f"{pk.__name__.split('.')[0]}.lifecycle"
                             ".regression").lmDS
        rt = _rt(key, cache=pk.ReuseCache())
        fits, streams, jits = [], [], []
        for xa, ya in ((xn, yn), (xn, yn), (xn, yn), (x2, y2)):
            mark = _jit_mark(pk) if not fits else _jit_now(pk)
            fits.append(lmDS(pk.input_tensor("X", xa), pk.input_tensor("y", ya),
                             reg=1e-3, runtime=rt))
            streams.append(dict(rt.stats.streaming.as_dict()))
            jits.append(_jit_delta(pk, mark))
        out[key] = (fits, streams, jits, rt.cache.stats.as_dict(),
                    _counters(rt))
    want = np.linalg.solve(xn.T @ xn + 1e-3 * np.eye(n), xn.T @ yn)
    assert _rel(out["port"][0][0], want) <= RTOL
    for a, b in zip(out["port"][0], out["ref"][0]):
        assert _rel(a, b) <= RTOL
    streams, jits = out["port"][1], out["port"][2]
    assert streams[0]["chunks"] == buckets and streams[0]["full_hits"] == 0
    assert streams[1]["full_hits"] == 1                      # warm refits
    assert streams[2]["full_hits"] == 2
    assert streams[3]["chunks_reused"] == buckets            # appended rows:
    rows = m // buckets                                      # new buckets only
    assert (streams[3]["chunks"] - streams[2]["chunks"]
            == -(-(m + 700) // rows) - buckets)
    assert jits[0]["misses"] > 0
    assert [j["misses"] for j in jits[1:3]] == [warm_rebuilds, 0]
    assert out["port"][1:] == out["ref"][1:]


def test_streaming_lane_times_its_host_steps(monkeypatch):
    """The bucket loop times each host step into the streaming meter, apart
    from the counters that compare with the reference; a whole-stream
    reuse hit adds no bucket time."""
    monkeypatch.setattr(tcm, "CHUNK_MEM_BUDGET", 1 << 16)
    xn, yn = _data(4096, 8, seed=4)
    from repro_torch.lifecycle import lmDS
    rt = _rt("port", cache=T.ReuseCache())
    lmDS(T.input_tensor("X", xn), T.input_tensor("y", yn), runtime=rt)
    cold = rt.stats.streaming.spans()
    assert set(cold) == {"fingerprint_s", "upload_s", "dispatch_s",
                         "download_s", "combine_s"}
    assert all(v > 0 for v in cold.values())
    assert not set(cold) & set(rt.stats.streaming.as_dict())
    lmDS(T.input_tensor("X", xn), T.input_tensor("y", yn), runtime=rt)
    assert rt.stats.streaming.full_hits == 1
    assert rt.stats.streaming.spans() == cold


def test_jit_cache_lru_and_pins_match_reference():
    """Entry-cap LRU eviction with a pinned entry: the same lookup/build
    sequence counts the same hits, misses, evictions and pins."""
    seq = ["a", "b", "a", "c", "d", "b", "e", "a", "c"]
    stats = {}
    for key, pk in PKGS.items():
        jc = import_module(f"{pk.__name__}.jit_cache")
        cache = jc.JitProgramCache(capacity=3, byte_capacity=1 << 40)
        args = [np.ones(3)]
        for name in seq:
            if key == "ref":
                k, exe = cache.lookup(name, args)
                if exe is None:
                    cache.compile(k, lambda x: (x + 1,), args)
            else:
                k, exe = cache.lookup(name, args, torch.device("cpu"))
                if exe is None:
                    cache.compile(k, lambda: (lambda x: (x + 1,)))
            if name == "c":
                cache.pin(k)
        stats[key] = [getattr(cache.stats, f)
                      for f in ("hits", "misses", "evictions", "pinned")]
    assert stats["port"] == stats["ref"]
    assert stats["port"][2] > 0 and stats["port"][3] == 1


def test_lineage_trace_matches_reference():
    xn, yn = _data(40, 3)
    traces = {}
    for key, pk in PKGS.items():
        X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
        traces[key] = pk.lineage_trace(
            pk.ops.solve(X.T @ X + 0.1 * pk.ops.eye(3), X.T @ y))
    assert traces["port"] == traces["ref"]


def test_unported_lanes_are_refused(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    rt = T.LineageRuntime(device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        rt.evaluate([T.ops.sum_(T.input_tensor("x", np.ones((3, 3))))])
