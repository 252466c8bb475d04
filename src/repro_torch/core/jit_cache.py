"""Process-wide cache of built segment closures.

Port of `repro.core.jit_cache`. Keyed by (segment canonical structural
key, concrete input signature), so structurally identical segments
from *different* plans — HPO loops, CV folds, repeated `PreparedScript`
construction — share one entry and replay without rebuilding.

PyTorch runs eagerly, so what the reference compiles with
`jax.jit(...).lower(...).compile()` is here the segment closure built
over the kernel registry (`segments.build_segment_fn`); `trace_time`
counts the seconds spent building. The signature carries shapes,
dtypes and the device (torch has no weak types; a closure built for
one device must never serve another). The hit/miss/eviction/pin
counters, the LRU order and the entry/byte caps behave as in the
reference, so the same program sequence from a cleared cache counts
the same hits and misses in both packages. The serving lane pins the
closures it warms at deploy (`pinning()`), and the fault policy's
`compile` kind fails a build here (`faults.compile_entry`), as in the
reference. CUDA-graph capture of the closures waits for a benchmark
(ROADMAP).
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import faults
from .sparse import BCOO

DEFAULT_CAPACITY = int(os.environ.get("REPRO_JIT_CACHE_ENTRIES", 512))
DEFAULT_BYTE_CAPACITY = int(
    os.environ.get("REPRO_JIT_CACHE_BYTES", 256 << 20))
# A closure has no generated-code size: every entry is charged this flat
# amount so the byte cap still exerts pressure, as in the reference for
# executables without a memory analysis.
FALLBACK_EXE_BYTES = 64 << 10


@dataclass
class JitCacheStats:
    hits: int = 0
    misses: int = 0
    trace_time: float = 0.0   # cumulative closure-build seconds
    aot_fallbacks: int = 0    # always 0: there is no AOT step to fail
    evictions: int = 0        # entries dropped by the entry/byte caps
    bytes_cached: int = 0     # resident bytes (flat estimate per entry)
    pinned: int = 0           # entries exempt from LRU

    def as_dict(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    trace_time_s=round(self.trace_time, 6),
                    aot_fallbacks=self.aot_fallbacks,
                    evictions=self.evictions,
                    bytes_cached=self.bytes_cached,
                    pinned=self.pinned)


def arg_signature(args, device: torch.device) -> tuple:
    """Device plus shape/dtype signature of concrete call arguments. A
    BCOO argument also carries its nse and index flags, as in the
    reference: two sparse matrices of one shape with different nse
    buckets get separate closures (the count of builds must match)."""
    out = [("device", str(device))]
    for a in args:
        if isinstance(a, BCOO):
            out.append(("bcoo", tuple(a.shape), str(a.dtype), a.nse,
                        a.indices_sorted, a.unique_indices))
        elif isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), str(a.dtype)))
        else:
            a = np.asarray(a)
            out.append((tuple(a.shape), str(a.dtype)))
    return tuple(out)


class JitProgramCache:
    """LRU cache: (segment key, input signature) -> segment closure.

    Bounded by `capacity` entries AND `byte_capacity` bytes; the
    least-recently-used unpinned entries are evicted when either cap is
    exceeded (`stats.evictions` / `stats.bytes_cached`)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 byte_capacity: int = DEFAULT_BYTE_CAPACITY):
        self.capacity = int(capacity)
        self.byte_capacity = int(byte_capacity)
        # key -> (closure, bytes)
        self._entries: "OrderedDict[tuple, tuple[Callable, int]]" = \
            OrderedDict()
        self._pinned: set[tuple] = set()
        # active pinning() recorders (normally 0 or 1)
        self._recorders: list[set[tuple]] = []
        self.stats = JitCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list[tuple]:
        """The cached (segment key, signature) pairs, oldest first."""
        return list(self._entries)

    def lookup(self, seg_key: str, args, device: torch.device
               ) -> tuple[tuple, Optional[Callable]]:
        """Return (full key, closure-or-None); counts hit/miss."""
        key = (seg_key, arg_signature(args, device))
        for rec in self._recorders:
            rec.add(key)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return key, entry[0]
        self.stats.misses += 1
        return key, None

    def compile(self, key: tuple, build_fn: Callable[[], Callable]
                ) -> tuple[Callable, float]:
        """Build the closure with `build_fn()`, store it under `key`;
        returns (closure, build seconds). A seeded `compile` fault fails
        the call before the build; the runtime then degrades that segment
        to the interpreter."""
        faults.compile_entry(key[0] if isinstance(key, tuple) else key)
        t0 = time.perf_counter()
        exe = build_fn()
        dt = time.perf_counter() - t0
        self.stats.trace_time += dt
        nb = FALLBACK_EXE_BYTES
        old = self._entries.pop(key, None)
        if old is not None:
            self.stats.bytes_cached -= old[1]
        self._entries[key] = (exe, nb)
        self.stats.bytes_cached += nb
        self._evict()
        return exe, dt

    def _evict(self) -> None:
        # LRU-first, skipping pinned entries and the keys an open
        # pinning() block has recorded (deploy warms more closures than
        # the caps may hold at once); the newest unpinned entry is never
        # evicted (a single over-budget closure still runs)
        protected = self._pinned.union(*self._recorders) \
            if self._recorders else self._pinned
        while True:
            unpinned = [k for k in self._entries if k not in protected]
            if len(unpinned) <= 1:
                break
            over = (len(self._entries) > self.capacity
                    or self.stats.bytes_cached > self.byte_capacity)
            if not over:
                break
            key = unpinned[0]
            _, nb = self._entries.pop(key)
            self.stats.bytes_cached -= nb
            self.stats.evictions += 1

    # -- pinning (serving deploy-time warmup) ----------------------------
    def pin(self, key: tuple) -> None:
        """Exempt `key` from LRU eviction (no-op if already pinned)."""
        if key not in self._pinned:
            self._pinned.add(key)
            self.stats.pinned = len(self._pinned)

    def unpin(self, key: tuple) -> None:
        self._pinned.discard(key)
        self.stats.pinned = len(self._pinned)
        self._evict()

    def unpin_all(self, keys=None) -> None:
        """Unpin `keys` (or everything) and re-apply the caps."""
        if keys is None:
            self._pinned.clear()
        else:
            self._pinned.difference_update(keys)
        self.stats.pinned = len(self._pinned)
        self._evict()

    @contextmanager
    def pinning(self):
        """Record every cache key touched inside the block and pin the
        ones resident at exit. `ModelServer.deploy` wraps its bucket
        warmup in this so the LRU can never evict a serving closure
        mid-flight; the yielded set is kept so `shutdown` can unpin."""
        rec: set[tuple] = set()
        self._recorders.append(rec)
        try:
            yield rec
        finally:
            self._recorders.remove(rec)
            for key in rec:
                if key in self._entries:
                    self.pin(key)

    def clear(self) -> None:
        self._entries.clear()
        self._pinned.clear()
        self.stats.bytes_cached = 0
        self.stats.pinned = 0


_global_cache: Optional[JitProgramCache] = None


def get_jit_cache() -> JitProgramCache:
    global _global_cache
    if _global_cache is None:
        _global_cache = JitProgramCache()
    return _global_cache


def clear_jit_cache() -> None:
    """Drop all cached closures (tests / memory pressure)."""
    if _global_cache is not None:
        _global_cache.clear()
