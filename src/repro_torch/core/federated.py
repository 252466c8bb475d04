"""Federated tensors and federated instructions (SystemDS §3.3, §4.3).

Port of `repro.core.federated`. A `FederatedTensor` is a metadata object
holding references to per-site partitions covering disjoint row ranges.
Federated instructions push computation to the sites and exchange only
the minimal aggregates (paper Example 2):

  fed_mv   : broadcast v -> local X_i @ v       -> rbind of results
  fed_vm   : send v slice -> local v_i^T @ X_i  -> elementwise sum
  fed_gram : local X_i^T X_i                    -> sum (n² exchange only)
  fed_xtv  : local X_i^T y_i                    -> sum

Every exchange is metered (`ExchangeLog`, with per-site byte counters) —
the paper's "exchange constraints" become an auditable byte budget per
site.

Two execution paths share these instruction semantics, as in the
reference:

  * the **compiler placement path** — `federated_input` creates a DAG
    leaf with `placement='federated'`; `repro_torch.core.compiler
    .lower_federated` lowers eligible HOPs into `fed_*` instructions and
    `repro_torch.core.runtime.LineageRuntime` executes them, running each
    site's local work as a cached closure through `LocalSite.execute`
    (the kernel registry + the process-wide closure cache, so a site's
    gram and xtv are the hand-written kernels' launches on the card);
  * the **eager numpy methods** on `FederatedTensor` (`fed_mv`,
    `fed_gram`, ...) — the in-process oracle the tests hold the compiled
    path against, byte for byte.

Device residency: a site is an in-process stand-in for a remote worker,
and one device stands in for every site. A site whose partition is a
host numpy array uploads it to the runtime's device at its first
`execute` and keeps that copy (`LocalSite.on`) for every later call, so
repeated federated plans do not re-send partitions over PCIe. That
upload is the site's own storage, not an exchange: it is never metered.
The copy is keyed on the partition object; binding the site to another
array uploads that one. Exchanges are metered in the bytes the
reference meters — a value's element count times its dtype's size —
whether it is a host array or a device tensor, so `ExchangeLog` equals
the eager oracle's log exactly.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch


def _nbytes(arr) -> int:
    """Payload bytes of an exchanged value, without moving it."""
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def _host(arr) -> np.ndarray:
    """A host numpy view/copy of a partition (the oracle's operand)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


@dataclass
class ExchangeLog:
    """Byte meter for master<->site traffic, with per-site attribution.

    Besides bytes, *exchange rounds* are counted: one round per
    (federated instruction, site) — the latency unit of the federation
    boundary. A task-parallel grid executed batched performs ONE round
    per site per federated instruction regardless of the grid size k
    (the stacked operand travels in one payload), where the sequential
    loop performs k; `rounds_per_site` is how tests assert that.
    """

    to_sites: int = 0      # bytes master -> workers
    from_sites: int = 0    # bytes workers -> master
    per_site: dict = field(default_factory=dict)  # site idx -> total bytes
    rounds: int = 0        # (instruction, site) exchange round trips
    rounds_per_site: dict = field(default_factory=dict)

    def add_out(self, arr, site: Optional[int] = None):
        nb = _nbytes(arr)
        self.to_sites += nb
        if site is not None:
            self.per_site[site] = self.per_site.get(site, 0) + nb

    def add_in(self, arr, site: Optional[int] = None):
        nb = _nbytes(arr)
        self.from_sites += nb
        if site is not None:
            self.per_site[site] = self.per_site.get(site, 0) + nb

    def add_round(self, site: int):
        self.rounds += 1
        self.rounds_per_site[site] = self.rounds_per_site.get(site, 0) + 1

    @property
    def total(self) -> int:
        return self.to_sites + self.from_sites

    def as_dict(self) -> dict:
        return dict(to_sites=self.to_sites, from_sites=self.from_sites,
                    total=self.total, rounds=self.rounds,
                    per_site={int(k): int(v)
                              for k, v in sorted(self.per_site.items())},
                    rounds_per_site={int(k): int(v) for k, v in
                                     sorted(self.rounds_per_site.items())})


@dataclass
class LocalSite:
    """An in-process 'remote worker' owning one partition.

    Two faces:

      * `execute(op, args, attrs)` — the plan-executing worker: builds
        the kernel from the `repro_torch.core.backend` registry and runs
        it as a cached closure (`repro_torch.core.jit_cache`), so
        per-site work builds once and replays warm across federated plan
        executions. This is the path the compiler-placed `fed_*`
        instructions use.
      * the eager numpy methods (`mv`, `vm`, `gram`, `xtv`, `colsums`)
        — the pure-numpy oracle for tests.
    """

    data: Any  # np.ndarray or device tensor; rows × ncols partition
    # (partition object, device, its copy there): see `on`
    _resident: Optional[tuple] = field(default=None, repr=False,
                                       compare=False)

    def on(self, device: torch.device) -> torch.Tensor:
        """This site's partition on `device`: uploaded at the first call
        and kept (the site's storage on the card standing in for it), as
        long as `data` is the same object."""
        d = self.data
        if isinstance(d, torch.Tensor) and d.device == device:
            return d
        r = self._resident
        if r is not None and r[0] is d and r[1] == device:
            return r[2]
        from . import backend
        t = backend.to_device(d, device)
        self._resident = (d, device, t)
        return t

    def execute(self, op: str, args: tuple, attrs: tuple = (), stats=None,
                vmap_axes: Optional[tuple] = None,
                site: Optional[int] = None, device=None):
        """Run one op over this site's data as a cached closure.

        `args` is the *full* kernel argument tuple: a `LocalSite` (this
        one or an aligned site of another federated operand) or this
        site's `data` stands for that partition on `device`; host values
        (the slices and broadcasts the master sends) are uploaded for the
        call. `attrs` are the op's static attributes as a sorted
        key/value tuple (part of the closure-cache key). Per-site closures
        are shared across sites and runs whenever (op, attrs, argument
        signature) match. `stats` (a `RuntimeStats`) receives the same
        accounting the segment executor books: build seconds into
        `trace_time`, warm lookups into `jit_cache_hits`.

        `vmap_axes` (batched `parfor` grids) maps the kernel over a
        leading config axis of the flagged operands (`torch.func.vmap`
        in_dims) — the site runs its local work for the WHOLE grid in
        one dispatch, so a k-configuration grid still touches the site
        once per federated instruction.

        `site` is this site's index in the owning `FederatedTensor` —
        the identity the seeded fault registry keys on. `site=None`
        marks a master-side execution (the degradation ladder's
        collect-and-recompute), which is never injected: recovery runs
        the SAME cached closure on the surviving data, so a degraded run
        is bitwise the clean run. The call waits for the device, as an
        RPC returns only with its result; its latency is the site's.
        """
        from . import backend, faults
        from .jit_cache import get_jit_cache
        faults.site_entry(site, op)
        dev = backend.resolve_device(device)
        xs = []
        for a in args:
            if isinstance(a, LocalSite):
                xs.append(a.on(dev))
            elif a is self.data:
                xs.append(self.on(dev))
            else:
                xs.append(backend.to_device(a, dev))
        cache = get_jit_cache()
        seg_key = f"fedsite|{op}|{attrs!r}"
        if vmap_axes is not None:
            seg_key += f"|vmap:{vmap_axes!r}"
        key, exe = cache.lookup(seg_key, xs, dev)
        if exe is None:
            def build():
                kern = backend.get_kernel(op, dict(attrs))
                fn = lambda *a: (kern(*a),)  # noqa: E731
                if vmap_axes is not None:
                    fn = torch.func.vmap(fn, in_dims=vmap_axes, out_dims=0)
                return fn
            exe, dt = cache.compile(key, build)
            if stats is not None:
                stats.trace_time += dt
        elif stats is not None:
            stats.jit_cache_hits += 1
        out = exe(*xs)[0]
        backend.synchronize(dev)
        return out

    # -- eager numpy oracle -------------------------------------------------
    def mv(self, v):           # X_i @ v
        return _host(self.data) @ v

    def vm(self, v_slice):     # v_i^T @ X_i
        return v_slice.T @ _host(self.data)

    def gram(self):            # X_i^T X_i
        d = _host(self.data)
        return d.T @ d

    def xtv(self, y_i):        # X_i^T y_i
        return _host(self.data).T @ y_i

    def colsums(self):
        return _host(self.data).sum(axis=0, keepdims=True)

    def rows(self):
        return self.data.shape[0]


@dataclass
class FederatedTensor:
    """Row-partitioned federated matrix: sites cover disjoint row ranges."""

    sites: list[LocalSite]
    ranges: list[tuple[int, int]]  # [start, stop) per site
    ncols: int
    log: ExchangeLog = field(default_factory=ExchangeLog)
    # batched (`parfor`) site layout: when set, every site's partition
    # carries a leading config axis — data is (k, rows_i, ncols) for the
    # k stacked grid configurations. Produced by batched `fed_map`
    # execution; consumed by the batched paths of the other fed_*
    # instructions (vmap over axis 0 at each site) and by `collect`.
    batch: Optional[int] = None

    @classmethod
    def partition_rows(cls, x: np.ndarray, n_sites: int) -> "FederatedTensor":
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(
                f"partition_rows requires a matrix, got shape {x.shape}")
        if not 1 <= n_sites <= x.shape[0]:
            raise ValueError(
                f"n_sites must be in [1, {x.shape[0]}] (one non-empty row "
                f"range per site), got {n_sites}")
        splits = np.array_split(np.arange(x.shape[0]), n_sites)
        sites, ranges = [], []
        for idx in splits:
            sites.append(LocalSite(x[idx]))
            ranges.append((int(idx[0]), int(idx[-1]) + 1))
        return cls(sites=sites, ranges=ranges, ncols=x.shape[1])

    def _require_sites(self, op: str) -> None:
        if not self.sites:
            raise ValueError(
                f"{op} over a federated tensor with zero sites — "
                "partition data with FederatedTensor.partition_rows first")

    @property
    def nrows(self) -> int:
        return sum(s.rows() for s in self.sites)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    # -- eager federated instructions (Example 2; the numpy oracle) ---------
    def fed_mv(self, v: np.ndarray) -> np.ndarray:
        """X @ v: broadcast v, local MV, rbind results."""
        self._require_sites("fed_mv")
        parts = []
        for i, s in enumerate(self.sites):
            self.log.add_out(v, site=i)          # broadcast
            r = s.mv(v)
            self.log.add_in(r, site=i)           # collect
            self.log.add_round(i)
            parts.append(r)
        return np.concatenate(parts, axis=0)

    def fed_vm(self, v: np.ndarray) -> np.ndarray:
        """v^T @ X: send only the relevant slice of v, add local results."""
        self._require_sites("fed_vm")
        out = None
        for i, (s, (a, b)) in enumerate(zip(self.sites, self.ranges)):
            vs = v[a:b]
            self.log.add_out(vs, site=i)
            r = s.vm(vs)
            self.log.add_in(r, site=i)
            self.log.add_round(i)
            out = r if out is None else out + r
        return out

    def fed_gram(self) -> np.ndarray:
        """X^T X with only n×n bytes exchanged per site (data never moves)."""
        self._require_sites("fed_gram")
        out = None
        for i, s in enumerate(self.sites):
            g = s.gram()
            self.log.add_in(g, site=i)
            self.log.add_round(i)
            out = g if out is None else out + g
        return out

    def fed_xtv(self, y: np.ndarray) -> np.ndarray:
        self._require_sites("fed_xtv")
        out = None
        for i, (s, (a, b)) in enumerate(zip(self.sites, self.ranges)):
            ys = y[a:b]
            self.log.add_out(ys, site=i)
            r = s.xtv(ys)
            self.log.add_in(r, site=i)
            self.log.add_round(i)
            out = r if out is None else out + r
        return out

    def fed_colsums(self) -> np.ndarray:
        self._require_sites("fed_colsums")
        out = None
        for i, s in enumerate(self.sites):
            r = s.colsums()
            self.log.add_in(r, site=i)
            self.log.add_round(i)
            out = r if out is None else out + r
        return out

    def collect(self) -> np.ndarray:
        """Materialize (breaks federation — for tests/debug only)."""
        self._require_sites("collect")
        return np.concatenate([_host(s.data) for s in self.sites], axis=0)


# ---------------------------------------------------------------------------
# Compiler integration: federated DAG leaves (§3.3 — fed_* instructions
# are generated by the optimizer, not hand-written by users)
# ---------------------------------------------------------------------------

def site_fingerprints(fed: FederatedTensor) -> str:
    """Stable identity of a federated tensor's *data*: one content
    fingerprint per site plus the row partitioning. Lineage hashes over
    federated inputs derive from this, so reuse of federated
    intermediates is sound — re-partitioned or re-bound data never
    aliases a cached value."""
    from .dag import _fingerprint
    h = hashlib.sha1()
    for s, (a, b) in zip(fed.sites, fed.ranges):
        h.update(f"{a}:{b}:".encode())
        h.update(_fingerprint(_host(s.data)).encode())
    return h.hexdigest()


def federated_input(name: Optional[str], fed: FederatedTensor,
                    sparsity: float = 1.0):
    """Create a DAG leaf bound to a `FederatedTensor`.

    The leaf carries `placement='federated'`; the compiler's placement
    pass (`repro_torch.core.compiler.lower_federated`) propagates
    placement over the DAG and lowers eligible patterns into `fed_*`
    instructions. Its lineage id hashes the per-site data fingerprints,
    so lineage reuse works on federated intermediates exactly like local
    ones.
    """
    from .dag import LEAVES, LTensor, make_node
    fed._require_sites("federated_input")
    name = name or "fed"
    dtype = np.result_type(*(_host(s.data).dtype for s in fed.sites))
    node = make_node("input", (), fed.shape, dtype, sparsity,
                     placement="federated", name=name,
                     n_sites=len(fed.sites))
    LEAVES.bind(node, fed, f"fed:{name}:{site_fingerprints(fed)}")
    return LTensor(node)


# ---------------------------------------------------------------------------
# Federated closed-form regression (the §4.3 enterprise use-case)
# ---------------------------------------------------------------------------

def federated_lmds(fx: FederatedTensor, y: np.ndarray, reg: float = 1e-7,
                   intercept: bool = False) -> np.ndarray:
    """lmDS over a federated X: only gram-sized aggregates leave sites.

    Eager numpy oracle. The compiled equivalent is
    `repro_torch.lifecycle.regression.lmDS` over a `federated_input`
    leaf, which routes the same exchange pattern through the DAG -> cost
    model -> segment stack with the same exchange bytes.
    """
    if intercept:
        fx = FederatedTensor(
            sites=[LocalSite(np.concatenate(
                [_host(s.data), np.ones((s.rows(), 1))], axis=1))
                for s in fx.sites],
            ranges=fx.ranges, ncols=fx.ncols + 1, log=fx.log)
    a = fx.fed_gram() + reg * np.eye(fx.ncols)
    b = fx.fed_xtv(y)
    return np.linalg.solve(a, b)
