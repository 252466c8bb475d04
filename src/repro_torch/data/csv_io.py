"""CSV / raw-format I/O with generated readers (SystemDS §4.2).

`make_reader(descriptor)` generates python source for a chunked parser
from a high-level format description and exec's it — the paper's
"automatically generate code for efficient readers and writers from
high-level descriptions of data formats" at this container's scale.
Generated readers parse in large chunks through numpy, not per-line
python loops.

Port of `repro.data.csv_io`: host numpy, like the reference — its
arrays are what `input_tensor` binds and the runtime uploads. Chunk
reads go through the port's fault policy (`repro_torch.core.faults`).
"""
from __future__ import annotations

import io
import os
import time
from typing import Callable

import numpy as np


def _fault_read(f, chunk_bytes: int, fault_log=None) -> bytes:
    """One byte-window read behind the seeded chunk_io injection point
    (`repro_torch.core.faults`), with bounded exponential-backoff retry.

    Transient IO errors — injected or real `OSError`s — are retried up
    to `costmodel.max_retries()` times; the file position is untouched
    by a failed attempt (injection fires *before* the read), so a
    retry resumes the stream exactly where it left off. `fault_log`
    (a `FaultLog`) meters injected/retries/backoff_s when given.
    ``REPRO_FAULT_POLICY=off`` bypasses everything."""
    from ..core import costmodel, faults
    if not faults.policy_enabled():
        return f.read(chunk_bytes)
    tries = costmodel.max_retries() + 1
    for attempt in range(tries):
        try:
            faults.io_entry("read_csv_chunks")
            return f.read(chunk_bytes)
        except (OSError, faults.InjectedFault) as e:
            if fault_log is not None and isinstance(e, faults.InjectedFault):
                fault_log.injected += 1
            if attempt + 1 >= tries:
                raise
            pause = costmodel.retry_backoff_s(attempt + 1)
            if fault_log is not None:
                fault_log.retries += 1
                fault_log.backoff_s += pause
            if pause > 0:
                time.sleep(pause)
    raise AssertionError("unreachable")  # pragma: no cover


def write_csv(path: str, x: np.ndarray, fmt: str = "%.6g") -> int:
    """Returns bytes written."""
    with open(path, "w") as f:
        np.savetxt(f, x, delimiter=",", fmt=fmt)
    return os.path.getsize(path)


def read_csv(path: str, chunk_bytes: int = 64 << 20) -> np.ndarray:
    """Chunked numeric CSV reader (string->double is the hot loop, §5.2)."""
    chunks = []
    with open(path, "rb") as f:
        rem = b""
        while True:
            buf = f.read(chunk_bytes)
            if not buf:
                break
            buf = rem + buf
            last_nl = buf.rfind(b"\n")
            if last_nl < 0:
                rem = buf
                continue
            rem, block = buf[last_nl + 1:], buf[: last_nl + 1]
            chunks.append(np.genfromtxt(io.BytesIO(block), delimiter=","))
        if rem.strip():
            chunks.append(np.genfromtxt(io.BytesIO(rem), delimiter=","))
    out = np.vstack([np.atleast_2d(c) for c in chunks])
    return out


def read_csv_chunks(path: str, rows_per_chunk: int,
                    chunk_bytes: int = 64 << 20, fault_log=None):
    """Iterate a numeric CSV as `(row_offset, array)` chunks of exactly
    `rows_per_chunk` rows (the last one ragged) — the I/O twin of the
    out-of-core streaming executor: feed each yielded block to a
    `chunk_*` partial aggregate and only one block is ever resident.

    Reads the file in byte windows (same newline-split recipe as
    `read_csv`) and re-blocks the parsed rows to the requested row
    bucket, so the byte window size and the chunk row count are
    independent knobs.

    Each byte-window read goes through the fault policy (`_fault_read`):
    transient IO errors — injected via ``REPRO_FAULT_SPEC`` or real —
    retry with bounded exponential backoff, metered into `fault_log`
    when given, so a flaky source degrades to a slower stream instead
    of a dead ingestion loop."""
    if rows_per_chunk < 1:
        raise ValueError(f"rows_per_chunk must be >= 1, got "
                         f"{rows_per_chunk}")
    pending: list[np.ndarray] = []
    have = 0
    offset = 0

    def drain(final: bool):
        nonlocal pending, have, offset
        while have >= rows_per_chunk or (final and have):
            block = np.vstack(pending) if len(pending) > 1 else pending[0]
            out, tail = (block[:rows_per_chunk],
                         block[rows_per_chunk:])
            pending = [tail] if tail.shape[0] else []
            have = tail.shape[0]
            off, offset = offset, offset + out.shape[0]
            yield off, out

    with open(path, "rb") as f:
        rem = b""
        while True:
            buf = _fault_read(f, chunk_bytes, fault_log)
            if not buf:
                break
            buf = rem + buf
            last_nl = buf.rfind(b"\n")
            if last_nl < 0:
                rem = buf
                continue
            rem, block = buf[last_nl + 1:], buf[: last_nl + 1]
            arr = np.atleast_2d(np.genfromtxt(io.BytesIO(block),
                                              delimiter=","))
            pending.append(arr)
            have += arr.shape[0]
            yield from drain(final=False)
        if rem.strip():
            arr = np.atleast_2d(np.genfromtxt(io.BytesIO(rem),
                                              delimiter=","))
            pending.append(arr)
            have += arr.shape[0]
        yield from drain(final=True)


READER_TEMPLATE = '''
def _generated_reader(path, chunk_bytes={chunk_bytes}):
    """Generated by repro_torch.data.csv_io.make_reader for format:
    delimiter={delim!r} columns={ncols} types={types!r}"""
    import io
    import numpy as np
    dtypes = {np_types!r}
    chunks = []
    with open(path, "rb") as f:
        rem = b""
        while True:
            buf = f.read(chunk_bytes)
            if not buf:
                break
            buf = rem + buf
            last = buf.rfind(b"\\n")
            if last < 0:
                rem = buf
                continue
            rem, block = buf[last + 1:], buf[: last + 1]
            arr = np.genfromtxt(io.BytesIO(block), delimiter={delim!r},
                                dtype=None, encoding="utf-8",
                                names={names!r})
            chunks.append(arr)
    import numpy.lib.recfunctions as rf
    rec = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    return {{n: rec[n] for n in rec.dtype.names}}
'''


def make_reader(descriptor: dict) -> Callable[[str], dict]:
    """descriptor: {"delimiter": ",", "columns": [(name, type), ...]}
    type in {"f64","i64","str"}. Returns a reader(path) -> dict of cols."""
    delim = descriptor.get("delimiter", ",")
    cols = descriptor["columns"]
    names = [c[0] for c in cols]
    np_types = {"f64": "f8", "i64": "i8", "str": "U64"}
    src = READER_TEMPLATE.format(
        chunk_bytes=descriptor.get("chunk_bytes", 64 << 20),
        delim=delim, ncols=len(cols),
        types=[c[1] for c in cols],
        np_types=[np_types[c[1]] for c in cols],
        names=names)
    ns: dict = {}
    exec(src, ns)            # codegen'd reader (paper §4.2)
    fn = ns["_generated_reader"]
    fn.__source__ = src
    return fn
