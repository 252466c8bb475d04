"""Plan serving: the port's `repro_torch.serving.ModelServer` (deploy,
warm and pinned buckets, the adaptive coalescer) and the bind-time
validation and closure-cache pinning it stands on, against the
reference's `repro.serving` (at pipeline depth 1, the single-dispatcher
loop the port runs). Mirrors tests/test_serving.py's
TestPreparedScriptValidation, TestJitCachePinning and TestCoalescer
(TestMeshDegradation waits for sharded placement, ROADMAP Queue 1 item
12); the port's server scores within 1e-12 of the reference's, warms
and pins the same buckets, and explains the same plan.

Coalesced-versus-solo parity is bitwise for one-row requests, as in the
reference: the port sums a one-row product in a fixed order
(`backend._row_product`), since torch.matmul sends one row and a stack
of rows to different kernels on the CPU and under cuBLAS alike.
Multi-row request blocks are held within 1e-12, as the reference holds
them.
"""
import re
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.runtime import PreparedScript as RScript
from repro.serving import ModelServer as RServer
from repro_torch.core import backend
from repro_torch.core.batching import bucket_size, stack_requests
from repro_torch.core.jit_cache import JitProgramCache, get_jit_cache
from repro_torch.core.runtime import PreparedScript
from repro_torch.serving import ModelServer, QueueFullError

D = 16
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


@pytest.fixture
def weights(rng):
    return T.input_tensor("srvW", rng.normal(size=(D, 1)))


def _rt(**kw):
    return T.LineageRuntime(device="cpu", **kw)


def _scoring(pk, W):
    def scoring(x):
        yhat = pk.ops.matmul(x, W)
        return yhat, pk.ops.sigmoid(yhat)
    return scoring


def _concurrent(fn, args):
    """fn(arg) on one thread each; returns the results in order."""
    outs = [None] * len(args)
    ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, fn(args[i]))) for i in range(len(args))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
        assert not t.is_alive()
    return outs


def canon(text: str) -> str:
    """uids renumbered in order of first appearance (each package counts
    its own nodes)."""
    ids: dict[str, int] = {}
    return re.sub(r"%(\d+)",
                  lambda m: f"%{ids.setdefault(m.group(1), len(ids))}", text)


# ---------------------------------------------------------------------------
# PreparedScript bind-time validation
# ---------------------------------------------------------------------------

class TestPreparedScriptValidation:
    def test_arg_count(self, weights):
        s = PreparedScript(_scoring(T, weights), [(1, D)], runtime=_rt())
        with pytest.raises(ValueError, match="1 argument"):
            s(np.zeros((1, D)), np.zeros((1, D)))

    def test_rank_mismatch_rejected(self, weights):
        s = PreparedScript(_scoring(T, weights), [(1, D)], runtime=_rt())
        with pytest.raises(ValueError, match="bound shape"):
            s(np.zeros((D,)))

    def test_unsafe_dtype_rejected(self, weights):
        s = PreparedScript(_scoring(T, weights), [(1, D)], runtime=_rt())
        with pytest.raises(ValueError, match="safe-cast"):
            s(np.zeros((1, D), dtype=np.complex128))

    def test_safe_dtype_cast(self, weights):
        s = PreparedScript(_scoring(T, weights), [(1, D)], runtime=_rt())
        xi = np.arange(D, dtype=np.int32).reshape(1, D)
        for a, b in zip(s(xi), s(xi.astype(np.float64))):
            assert (a == b).all()

    def test_free_axis_accepted(self, rng):
        s = PreparedScript(lambda x: T.ops.colSums(x), [(4, D)],
                           runtime=_rt())
        xn = rng.normal(size=(7, D))
        got, = s(xn)
        np.testing.assert_allclose(got, xn.sum(axis=0, keepdims=True))
        assert s._shape_verdicts[((7, D),)] is None
        got2, = s(xn)
        assert (got2 == got).all()

    def test_constrained_axis_rejected(self, rng):
        s = PreparedScript(lambda x: T.ops.gram(x) + T.ops.eye(D), [(8, D)],
                           runtime=_rt())
        with pytest.raises(ValueError, match="declared"):
            s(rng.normal(size=(8, D - 2)))
        got, = s(rng.normal(size=(5, D)))
        assert got.shape == (D, D)

    def test_generator_row_axis_rejected(self, rng):
        s = PreparedScript(lambda x: T.ops.cbind(x, T.ops.ones((6, 1))),
                           [(6, D)], runtime=_rt())
        with pytest.raises(ValueError, match="declared"):
            s(rng.normal(size=(9, D)))

    def test_exact_shapes_mode(self, rng):
        s = PreparedScript(lambda x: T.ops.colSums(x), [(4, D)],
                           runtime=_rt())
        with pytest.raises(ValueError, match="bound shape"):
            s.validate_args([rng.normal(size=(7, D))], exact_shapes=True)


# ---------------------------------------------------------------------------
# Closure-cache pinning
# ---------------------------------------------------------------------------

class TestJitCachePinning:
    @staticmethod
    def _fill(cache, n, start=0):
        for i in range(start, start + n):
            key, exe = cache.lookup(f"k{i}", (np.float64(i),), CPU)
            if exe is None:
                cache.compile(key, lambda: (lambda x: (x + 1.0,)))

    def _hit(self, cache, i):
        return cache.lookup(f"k{i}", (np.float64(i),), CPU)[1] is not None

    def test_pinned_survive_entry_pressure(self):
        cache = JitProgramCache(capacity=2, byte_capacity=1 << 40)
        with cache.pinning() as keys:
            self._fill(cache, 2)
        assert len(keys) == 2 and cache.stats.pinned == 2
        self._fill(cache, 4, start=2)
        assert self._hit(cache, 0) and self._hit(cache, 1)
        assert cache.stats.evictions > 0

    def test_pinned_survive_byte_pressure(self):
        cache = JitProgramCache(capacity=64, byte_capacity=1)
        with cache.pinning():
            self._fill(cache, 2)
        self._fill(cache, 3, start=2)
        assert len(cache) == 3
        assert self._hit(cache, 0) and self._hit(cache, 1)

    def test_open_pinning_block_protects_its_keys(self):
        # deploy warms more closures than the caps hold at once: keys the
        # open block recorded are never evicted mid-warmup
        cache = JitProgramCache(capacity=1, byte_capacity=1 << 40)
        with cache.pinning():
            self._fill(cache, 3)
            assert len(cache) == 3 and cache.stats.evictions == 0
        assert cache.stats.pinned == 3

    def test_unpinned_behavior_unchanged(self):
        cache = JitProgramCache(capacity=2, byte_capacity=1 << 40)
        self._fill(cache, 3)
        assert len(cache) == 2 and cache.stats.evictions == 1
        assert not self._hit(cache, 0)
        assert cache.stats.pinned == 0

    def test_unpin_reapplies_caps(self):
        cache = JitProgramCache(capacity=1, byte_capacity=1 << 40)
        with cache.pinning() as keys:
            self._fill(cache, 3)
        assert len(cache) == 3
        cache.unpin_all(keys)
        assert cache.stats.pinned == 0 and len(cache) == 1

    def test_clear_drops_pins(self):
        cache = JitProgramCache()
        with cache.pinning():
            self._fill(cache, 1)
        cache.clear()
        assert cache.stats.pinned == 0 and len(cache) == 0

    def test_pinned_surfaces_in_stats(self):
        assert JitProgramCache().stats.as_dict()["pinned"] == 0

    def test_counters_match_the_reference(self):
        """A pinning block over the caps, churn past it, then unpin_all:
        the same hits, misses, evictions and pins in both caches."""
        from repro.core.jit_cache import JitProgramCache as RCache
        seq = ["a", "b", "c", "d", "a", "e", "b", "f"]
        stats = {}
        for key, cache in (("port", JitProgramCache(capacity=2)),
                           ("ref", RCache(capacity=2))):
            args = [np.ones(3)]

            def touch(name, cache=cache, key=key, args=args):
                if key == "ref":
                    k, exe = cache.lookup(name, args)
                    if exe is None:
                        cache.compile(k, lambda x: (x + 1,), args)
                else:
                    k, exe = cache.lookup(name, args, CPU)
                    if exe is None:
                        cache.compile(k, lambda: (lambda x: (x + 1,)))
            with cache.pinning() as keys:
                for name in seq[:3]:
                    touch(name)
            for name in seq[3:]:
                touch(name)
            trace = [cache.stats.pinned, len(cache)]
            cache.unpin_all(keys)
            stats[key] = trace + [getattr(cache.stats, f) for f in
                                  ("hits", "misses", "evictions", "pinned")
                                  ] + [len(cache)]
        assert stats["port"] == stats["ref"]


# ---------------------------------------------------------------------------
# The fixed-order one-row product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c", [(1, 1), (7, 2), (16, 1), (1000, 3)])
def test_row_product_is_bitwise_under_vmap(rng, n, c):
    beta = torch.from_numpy(rng.normal(size=(n, c)))
    xs = torch.from_numpy(rng.normal(size=(16, 1, n)))
    solo = torch.stack([backend._matmul(xs[i], beta) for i in range(16)])
    np.testing.assert_allclose(solo.numpy(), xs.numpy() @ beta.numpy(),
                               rtol=1e-12, atol=1e-12)
    for b in (2, 4, 8, 16):
        got = torch.func.vmap(lambda x: backend._matmul(x, beta))(xs[:b])
        assert torch.equal(got, solo[:b])
    # x invariant, beta batched: the same bits again
    betas = torch.stack([beta, beta * 2.0])
    got = torch.func.vmap(lambda bb: backend._matmul(xs[0], bb))(betas)
    assert torch.equal(got[0], solo[0])


def test_wide_row_product_keeps_matmul(rng):
    n = backend.ROW_PRODUCT_MAX_ELEMS + 1
    a = torch.from_numpy(rng.normal(size=(1, n)))
    assert torch.equal(backend._matmul(a, a.mT), torch.matmul(a, a.mT))


def test_stack_requests():
    reqs = [[np.full((1, 2), i), np.full((3,), -i)] for i in range(3)]
    a, b = stack_requests(reqs, 2)
    assert a.shape == (3, 1, 2) and b.shape == (3, 3)
    assert a[2, 0, 1] == 2 and b[1, 0] == -1


# ---------------------------------------------------------------------------
# The coalescer
# ---------------------------------------------------------------------------

def _serve(script, rt, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_us", 500.0)
    return ModelServer(script, runtime=rt, **kw)


class TestCoalescer:
    @pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
    def test_concurrent_bitwise_parity(self, rng, weights, k):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        xs = [rng.normal(size=(1, D)) for _ in range(k)]
        with _serve(script, rt) as srv:
            outs = _concurrent(srv.score, xs)
            log = rt.stats.serving
            assert log.requests == k and log.retraces == 0
        for i in range(k):
            ref = script(xs[i])
            assert len(outs[i]) == len(ref)
            for a, b in zip(outs[i], ref):
                assert a.shape == b.shape and (a == b).all()

    def test_multirow_requests_allclose(self, rng, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(4, D)], runtime=rt)
        xs = [rng.normal(size=(4, D)) for _ in range(3)]
        with _serve(script, rt) as srv:
            outs = _concurrent(srv.score, xs)
        for i in range(3):
            for a, b in zip(outs[i], script(xs[i])):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)

    def test_padding_sliced_and_counted(self, rng, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        with _serve(script, rt, adaptive=False, max_wait_us=5e6) as srv:
            futs = [srv.submit(rng.normal(size=(1, D))) for _ in range(3)]
            srv.flush()
            outs = [f.result(timeout=5.0) for f in futs]
        log = rt.stats.serving
        assert log.batches == 1 and log.requests == 3
        assert log.padded == bucket_size(3) - 3 == 1
        assert log.max_coalesce == 3 and log.queue_peak == 3
        assert rt.stats.as_dict()["serving"]["mean_coalesce"] == 3.0
        for o in outs:                   # bucket lane never leaks out
            assert o[0].shape == (1, 1)

    def test_zero_retraces_after_warmup(self, rng, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        with _serve(script, rt) as srv:
            for k in (1, 2, 3, 5, 8, 4, 7):
                _concurrent(srv.score,
                            [rng.normal(size=(1, D)) for _ in range(k)])
            assert rt.stats.serving.retraces == 0
            assert rt.stats.serving.requests == 30

    def test_bounded_queue_rejects(self, rng, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        srv = ModelServer(script, runtime=rt, max_batch=4,
                          max_wait_us=10e6, queue_limit=2, adaptive=False)
        srv.deploy()
        futs, rejected = [], 0
        for _ in range(8):
            try:
                futs.append(srv.submit(rng.normal(size=(1, D))))
            except QueueFullError:
                rejected += 1
        srv.flush()
        for f in futs:
            f.result(timeout=5.0)
        srv.shutdown()
        log = rt.stats.serving
        assert rejected == 6 and log.rejected == 6
        assert log.requests == len(futs) == 2
        assert log.queue_peak == 2

    def test_score_before_deploy_raises(self, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        with pytest.raises(RuntimeError, match="deploy"):
            ModelServer(script, runtime=rt).score(np.zeros((1, D)))

    def test_invalid_request_rejected_not_fatal(self, rng, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        with _serve(script, rt) as srv:
            with pytest.raises(ValueError, match="bound shape"):
                srv.score(np.zeros((2, D)))
            y, = srv.score(np.zeros((1, D)))[:1]
            assert y.shape == (1, 1)

    def test_reuse_cache_runtime_stays_sound(self, rng, weights):
        rt = _rt(cache=T.ReuseCache())
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        x1, x2 = rng.normal(size=(1, D)), rng.normal(size=(1, D))
        with _serve(script, rt) as srv:
            y1 = srv.score(x1)
            y2 = srv.score(x2)
            y1b = srv.score(x1)
        assert not (y1[0] == y2[0]).all()
        for a, b, c in zip(y1, script(x1), y1b):
            assert (a == b).all() and (a == c).all()

    def test_deploy_warms_and_pins_all_buckets(self, weights):
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        jc = get_jit_cache()
        pinned0 = jc.stats.pinned
        srv = _serve(script, rt, max_batch=16)
        srv.deploy()
        assert jc.stats.pinned - pinned0 == len({2, 4, 8, 16})
        assert "warm_buckets=[2, 4, 8, 16]" in srv.explain()
        srv.shutdown()
        assert jc.stats.pinned == pinned0
        assert "pinned=0" in srv.explain()

    def test_pipelined_server_refused(self, weights, monkeypatch):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
        rt = _rt()
        script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
        with pytest.raises(NotImplementedError, match="completion worker"):
            ModelServer(script, runtime=rt).deploy()


# ---------------------------------------------------------------------------
# The port's server against the reference's
# ---------------------------------------------------------------------------

def _deploy_both(wn, max_batch=8, shape=(1, D), reuse=False):
    out = {}
    for key, pk, Script, Server in (("ref", R, RScript, RServer),
                                    ("port", T, PreparedScript, ModelServer)):
        kw = {"cache": pk.ReuseCache()} if reuse else {}
        rt = (pk.LineageRuntime(device="cpu", **kw) if key == "port"
              else pk.LineageRuntime(**kw))
        W = pk.input_tensor("W", wn)
        script = Script(_scoring(pk, W), [shape], runtime=rt)
        pinned0 = pk.get_jit_cache().stats.pinned
        srv = Server(script, runtime=rt, max_batch=max_batch,
                     max_wait_us=500.0).deploy()
        out[key] = (srv, script, rt, pk.get_jit_cache().stats.pinned
                    - pinned0)
    return out


@pytest.mark.parametrize("reuse", [False, True])
def test_scores_match_the_reference(rng, reuse):
    wn = rng.normal(size=(D, 1))
    xs = [rng.normal(size=(1, D)) for _ in range(11)]
    both = _deploy_both(wn, reuse=reuse)
    got = {}
    try:
        for key, (srv, script, rt, _) in both.items():
            got[key] = _concurrent(srv.score, xs)
            assert rt.stats.serving.retraces == 0
    finally:
        for srv, *_ in both.values():
            srv.shutdown()
    for a, b in zip(got["port"], got["ref"]):
        for u, v in zip(a, b, strict=True):
            assert u.shape == v.shape
            np.testing.assert_allclose(u, v, rtol=1e-12, atol=1e-12)
    assert both["port"][2].stats.serving.requests == 11


def test_multirow_scores_match_the_reference(rng):
    wn = rng.normal(size=(D, 1))
    both = _deploy_both(wn, max_batch=4, shape=(4, D))
    xs = [rng.normal(size=(4, D)) for _ in range(3)]
    try:
        got = {key: [srv.score(x) for x in xs]
               for key, (srv, *_) in both.items()}
    finally:
        for srv, *_ in both.values():
            srv.shutdown()
    for a, b in zip(got["port"], got["ref"]):
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("max_batch", [1, 5, 16])
def test_buckets_and_explain_match_the_reference(rng, max_batch):
    both = _deploy_both(rng.normal(size=(D, 1)), max_batch=max_batch)
    try:
        (rsrv, _, _, rpinned), (tsrv, _, _, tpinned) = both["ref"], \
            both["port"]
        assert tsrv.max_batch == rsrv.max_batch
        assert tpinned == rpinned == len({bucket_size(k) for k in
                                          range(1, tsrv.max_batch + 1)})
        assert canon(tsrv.explain()) == canon(rsrv.explain())
        assert tsrv._budget_s == pytest.approx(rsrv._budget_s, rel=1e-12)
    finally:
        for srv, *_ in both.values():
            srv.shutdown()


def test_replay_batch_pads_and_binds_nothing_global(rng, weights):
    from repro_torch.core.dag import LEAVES
    rt = _rt()
    script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
    bplan = script.prepare_batched()
    assert len(bplan.leaf_order) == 1
    bound = dict(LEAVES.values)
    xs = np.stack([rng.normal(size=(1, D)) for _ in range(3)])
    outs = rt.replay_batch(bplan, [xs], 3)
    assert len(outs) == 3 and all(o[0].shape == (1, 1) for o in outs)
    for i in range(3):
        assert (outs[i][0] == script(xs[i])[0]).all()
    assert LEAVES.values.keys() == bound.keys()
    assert all(LEAVES.values[u] is bound[u] for u in bound)
    bplan.release_leaves()
    assert bplan.leaf_order[0] not in LEAVES.values


def test_dispatcher_waits_on_events_not_time(rng, weights):
    """flush() dispatches a held batch at once, whatever the window."""
    rt = _rt()
    script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
    with _serve(script, rt, adaptive=False, max_wait_us=60e6) as srv:
        fut = srv.submit(rng.normal(size=(1, D)))
        t0 = time.monotonic()
        srv.flush()
        assert fut.done.wait(timeout=30.0)
        assert time.monotonic() - t0 < 30.0


def test_many_clients_stress(rng, weights):
    """More client threads than cores, a short switch interval: every
    request is answered once, with its own row's score, and the meters
    count each request once."""
    import sys
    rt = _rt()
    script = PreparedScript(_scoring(T, weights), [(1, D)], runtime=rt)
    xs = rng.normal(size=(96, 1, D))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _serve(script, rt, max_batch=16) as srv:
            outs = _concurrent(
                lambda i: [srv.score(xs[j], timeout=30.0)
                           for j in range(i, 96, 32)], list(range(32)))
    finally:
        sys.setswitchinterval(old)
    for i, per in enumerate(outs):
        for j, got in zip(range(i, 96, 32), per, strict=True):
            assert (got[0] == script(xs[j])[0]).all()
    log = rt.stats.serving
    assert log.requests == 96 and log.retraces == 0
    assert log.batches <= 96 and log.max_coalesce <= 16
