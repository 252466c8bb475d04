"""Heterogeneous tensors (SystemDS §3.3).

Port of `repro.core.hetero`: host-side numpy, as in the reference, so
every output and `TransformMeta` is the reference's bit for bit.

`DataTensor` is the DataTensorBlock analogue: a 2-D+ array where the
second dimension carries a schema; internally it is composed of
homogeneous columns (numpy arrays; string columns stay host-side as
object arrays).

`transformencode` / `transformapply` are the feature-transform builtins
(recode, dummycode, binning, standardization) that bridge heterogeneous
data into the dense LA world (SystemDS §4.2), emitting plain matrices
consumable by the DSL / models (`input_tensor` uploads them).

The paper's fixed-size n-dimensional blocking scheme (1024², 128³, 32⁴,
16⁵, 8⁶, 8⁷ — §3.3 "Distributed Tensors") is provided as `block_shape` +
`reblock` for local tiles.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

VALID_TYPES = ("f64", "f32", "i64", "i32", "bool", "str")
_NP = {"f64": np.float64, "f32": np.float32, "i64": np.int64,
       "i32": np.int32, "bool": np.bool_, "str": object}


# ---------------------------------------------------------------------------
# Schema detection (§4.2 "schema detection" builtin)
# ---------------------------------------------------------------------------

def detect_value_type(col: np.ndarray) -> str:
    """Semantic type detection heuristic for a raw (string-ish) column."""
    vals = [v for v in col.ravel() if v is not None and str(v) != ""]
    if not vals:
        return "str"
    def _is(f):
        try:
            for v in vals[:256]:
                f(str(v))
            return True
        except ValueError:
            return False
    sv = [str(v).strip().lower() for v in vals[:256]]
    if all(v in ("true", "false", "t", "f", "0", "1") for v in sv):
        return "bool"
    if _is(int):
        mx = max(abs(int(str(v))) for v in vals[:256])
        return "i32" if mx < 2 ** 31 else "i64"
    if _is(float):
        return "f64"
    return "str"


@dataclass
class DataTensor:
    """Heterogeneous 2-D tensor: one schema'd dimension (columns)."""

    names: list[str]
    types: list[str]
    columns: list[np.ndarray]  # each 1-D, len == nrows

    def __post_init__(self):
        assert len(self.names) == len(self.types) == len(self.columns)
        for t in self.types:
            assert t in VALID_TYPES, t
        n = self.nrows
        for c in self.columns:
            assert len(c) == n

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dict(cls, data: dict[str, Sequence], types: Optional[dict] = None
                  ) -> "DataTensor":
        names, tps, cols = [], [], []
        for k, v in data.items():
            arr = np.asarray(v, dtype=object) \
                if (types or {}).get(k) == "str" else np.asarray(v)
            t = (types or {}).get(k)
            if t is None:
                if arr.dtype == object or arr.dtype.kind in "US":
                    t = detect_value_type(arr.astype(object))
                elif arr.dtype.kind == "b":
                    t = "bool"
                elif arr.dtype.kind in "iu":
                    t = "i64" if arr.dtype.itemsize > 4 else "i32"
                else:
                    t = "f64" if arr.dtype.itemsize > 4 else "f32"
            if t != "str":
                arr = arr.astype(_NP[t])
            else:
                arr = arr.astype(object)
            names.append(k); tps.append(t); cols.append(arr)
        return cls(names, tps, cols)

    @classmethod
    def from_frame(cls, frame: np.ndarray, names: Optional[list[str]] = None
                   ) -> "DataTensor":
        """Raw 2-D object array -> typed DataTensor via schema detection."""
        ncol = frame.shape[1]
        names = names or [f"c{i}" for i in range(ncol)]
        data, types = {}, {}
        for i, nm in enumerate(names):
            col = frame[:, i].astype(object)
            t = detect_value_type(col)
            types[nm] = t
            if t == "bool":
                data[nm] = np.array(
                    [str(v).strip().lower() in ("true", "t", "1")
                     for v in col])
            elif t != "str":
                data[nm] = np.array([_NP[t](str(v)) if str(v) != "" else
                                     (np.nan if t.startswith("f") else 0)
                                     for v in col], dtype=_NP[t])
            else:
                data[nm] = col
        return cls.from_dict(data, types)

    # -- access ---------------------------------------------------------------
    @property
    def nrows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def ncols(self) -> int:
        return len(self.names)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def schema(self) -> list[tuple[str, str]]:
        return list(zip(self.names, self.types))

    def column(self, name: str) -> np.ndarray:
        return self.columns[self.names.index(name)]

    def select_rows(self, idx) -> "DataTensor":
        return DataTensor(self.names[:], self.types[:],
                          [c[idx] for c in self.columns])

    def numeric_matrix(self, dtype=np.float64) -> np.ndarray:
        """All non-string columns as a dense matrix (NaNs preserved)."""
        cols = [c.astype(dtype) for c, t in zip(self.columns, self.types)
                if t != "str"]
        return np.stack(cols, axis=1) if cols else np.zeros((self.nrows, 0))


# ---------------------------------------------------------------------------
# transformencode / transformapply (§4.2)
# ---------------------------------------------------------------------------

@dataclass
class TransformMeta:
    spec: dict[str, str]
    recode_maps: dict[str, dict[Any, int]] = field(default_factory=dict)
    bins: dict[str, np.ndarray] = field(default_factory=dict)
    centers: dict[str, float] = field(default_factory=dict)
    scales: dict[str, float] = field(default_factory=dict)
    out_names: list[str] = field(default_factory=list)


def transformencode(dt: DataTensor, spec: dict[str, str]
                    ) -> tuple[np.ndarray, TransformMeta]:
    """Fit + apply feature transforms; returns (X, meta)."""
    meta = TransformMeta(spec=dict(spec))
    for name in dt.names:
        how = spec.get(name, "passthrough")
        col = dt.column(name)
        if how == "recode" or (how == "dummycode"):
            vals = sorted({v for v in col.tolist()}, key=lambda v: str(v))
            meta.recode_maps[name] = {v: i for i, v in enumerate(vals)}
        elif how.startswith("bin"):
            k = int(how.split(":")[1]) if ":" in how else 10
            c = col.astype(np.float64)
            qs = np.nanquantile(c, np.linspace(0, 1, k + 1)[1:-1])
            meta.bins[name] = np.unique(qs)
        elif how == "scale":
            c = col.astype(np.float64)
            meta.centers[name] = float(np.nanmean(c))
            meta.scales[name] = float(np.nanstd(c) or 1.0)
    x = transformapply(dt, meta)
    return x, meta


def transformapply(dt: DataTensor, meta: TransformMeta) -> np.ndarray:
    outs, names = [], []
    for name, typ in zip(dt.names, dt.types):
        how = meta.spec.get(name, "passthrough")
        col = dt.column(name)
        if how == "drop":
            continue
        if how == "recode":
            m = meta.recode_maps[name]
            outs.append(np.array([m.get(v, -1) for v in col.tolist()],
                                 dtype=np.float64)[:, None])
            names.append(name)
        elif how == "dummycode":
            m = meta.recode_maps[name]
            k = len(m)
            codes = np.array([m.get(v, -1) for v in col.tolist()])
            oh = np.zeros((len(col), k))
            valid = codes >= 0
            oh[np.arange(len(col))[valid], codes[valid]] = 1.0
            outs.append(oh)
            names.extend(f"{name}={v}" for v in m)
        elif how.startswith("bin"):
            edges = meta.bins[name]
            outs.append(np.digitize(col.astype(np.float64), edges
                                    ).astype(np.float64)[:, None])
            names.append(name)
        elif how == "scale":
            c = col.astype(np.float64)
            outs.append(((c - meta.centers[name]) / meta.scales[name]
                         )[:, None])
            names.append(name)
        else:  # passthrough
            if typ == "str":
                raise ValueError(f"string column {name!r} needs an encoder")
            outs.append(col.astype(np.float64)[:, None])
            names.append(name)
    meta.out_names = names
    return np.concatenate(outs, axis=1) if outs else \
        np.zeros((dt.nrows, 0))


# ---------------------------------------------------------------------------
# n-D fixed-size blocking scheme (§3.3) — local tile math
# ---------------------------------------------------------------------------

_BLOCK_EDGE = {1: 1024 * 1024, 2: 1024, 3: 128, 4: 32, 5: 16, 6: 8, 7: 8}


def block_shape(rank: int) -> tuple[int, ...]:
    """Exponentially decreasing edge lengths: 1024², 128³, 32⁴, 16⁵, 8⁶, 8⁷."""
    edge = _BLOCK_EDGE.get(rank)
    if edge is None:
        raise ValueError(f"unsupported rank {rank}")
    return (edge,) * rank


def reblock(arr: np.ndarray, target_rank: int) -> dict[tuple, np.ndarray]:
    """Split an array into the fixed-size blocks of `target_rank`'s scheme.

    Mirrors the paper's local conversion example: a 1024² matrix block
    splits into 64 × 128² sub-blocks when joining with a 3-D tensor.
    """
    bs = block_shape(target_rank)[: arr.ndim]
    grid = [range(0, s, b) for s, b in zip(arr.shape, bs)]
    out: dict[tuple, np.ndarray] = {}
    import itertools as it
    for starts in it.product(*grid):
        key = tuple(s // b for s, b in zip(starts, bs))
        sl = tuple(slice(s, min(s + b, d))
                   for s, b, d in zip(starts, bs, arr.shape))
        out[key] = arr[sl]
    return out
