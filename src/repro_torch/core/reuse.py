"""Lineage-based reuse cache (SystemDS §4.1, "Reuse of Intermediates").

Intermediates are identified by their lineage hash (hash of the lineage
DAG). Before executing an instruction, the runtime probes the cache for
*full reuse*; *partial reuse* is realized by the compensation-plan
rewrites in `repro_torch.core.rewrites.distribute_for_reuse`, which
decompose operators (gram/xtv over rbind/cbind) so their pieces become cache hits.

Eviction follows SystemDS's cost-and-size heuristic: keep entries with
high (compute-cost / byte), weighted by recency (LRU decay).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

# Below this compute cost (seconds) an intermediate is not worth caching.
# The runtime applies this gate at *compile time* via the cost model
# (`repro_torch.core.costmodel.PROBE_MIN_COST_S`) and calls
# `put(gated=False)`; the measured-cost check below only applies to external callers using
# the cache standalone.
MIN_CACHE_COST_S = 20e-6
# Standalone-caller admission only: below this size a measured-cheap
# value is kept anyway (scalars/metadata cost nothing to hold). The
# runtime's compile-time probe gate does not consult this — sub-threshold
# intermediates are fused through, not cached.
ALWAYS_CACHE_BYTES = 1 << 12


def nbytes(value) -> int:
    """True byte size of a cached value: a torch tensor (device or host),
    a host numpy array (streamed partial aggregates), or a tuple of them
    (the streaming executor caches one partial tuple per row bucket).

    Tensors are counted first, by their element payload: a tensor also
    answers to `.data` and `.indices`, which the reference's sparse-pair
    accounting would misread. The port has no sparse or federated values
    yet, so those branches of `repro.core.reuse.nbytes` are not carried.
    """
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (tuple, list)):
        return sum(nbytes(v) for v in value)
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    return 64


@dataclass
class CacheEntry:
    value: Any
    size: int
    cost: float          # seconds it took to compute
    last_used: float
    hits: int = 0


@dataclass
class ReuseStats:
    probes: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_cached: int = 0
    time_saved: float = 0.0   # Σ cost of hit entries

    def as_dict(self) -> dict:
        return dict(probes=self.probes, hits=self.hits, misses=self.misses,
                    evictions=self.evictions, bytes=self.bytes_cached,
                    time_saved_s=round(self.time_saved, 6))


class ReuseCache:
    """Lineage-hash keyed intermediate cache with cost/size eviction."""

    def __init__(self, budget_bytes: int = 4 << 30,
                 policy: str = "costsize"):
        assert policy in ("costsize", "lru")
        self.budget = int(budget_bytes)
        self.policy = policy
        self.entries: dict[str, CacheEntry] = {}
        self.stats = ReuseStats()

    # -- interface ----------------------------------------------------------
    def probe(self, lhash: str) -> Optional[Any]:
        self.stats.probes += 1
        e = self.entries.get(lhash)
        if e is None:
            self.stats.misses += 1
            return None
        e.hits += 1
        e.last_used = time.perf_counter()
        self.stats.hits += 1
        self.stats.time_saved += e.cost
        return e.value

    def put(self, lhash: str, value: Any, cost: float,
            gated: bool = True) -> None:
        """Insert an entry. `gated=False` skips the measured-cost
        worth-keeping check — used by the runtime, whose compile-time
        cost model already admitted the value as a probe point (keeps
        admission identical across interpreter and fused modes)."""
        size = nbytes(value)
        if gated and cost < MIN_CACHE_COST_S and size > ALWAYS_CACHE_BYTES:
            return  # not worth the pool space
        if size > self.budget:
            return
        if lhash in self.entries:
            return
        self._make_room(size)
        self.entries[lhash] = CacheEntry(value=value, size=size, cost=cost,
                                         last_used=time.perf_counter())
        self.stats.bytes_cached += size

    def clear(self) -> None:
        self.entries.clear()
        self.stats.bytes_cached = 0

    # -- eviction -------------------------------------------------------------
    def _score(self, e: CacheEntry, now: float) -> float:
        if self.policy == "lru":
            return -(now - e.last_used)
        # costsize: value density (seconds saved per byte), light recency decay
        age = now - e.last_used
        return (e.cost / max(e.size, 1)) / (1.0 + 0.01 * age)

    def _make_room(self, need: int) -> None:
        if self.stats.bytes_cached + need <= self.budget:
            return
        now = time.perf_counter()
        victims = sorted(self.entries.items(),
                         key=lambda kv: self._score(kv[1], now))
        for key, e in victims:
            if self.stats.bytes_cached + need <= self.budget:
                break
            del self.entries[key]
            self.stats.bytes_cached -= e.size
            self.stats.evictions += 1
