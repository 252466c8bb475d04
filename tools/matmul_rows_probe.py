"""Does torch.matmul give a row the same bits alone and in a stack?

    python3 tools/matmul_rows_probe.py [--device cuda]

For n in 16, 64 and 1,000 and seeded float64 data, counts the rows of a
`torch.func.vmap`-ped (b, 1, n) @ (n, 1) (b = 2, 4, 8, 16: the serving
lane's buckets) that differ from the same rows multiplied one by one,
with the same count for a plain (b, n) @ (n, 1), for stacked (4, n)
blocks, and for the port's fixed-order one-row product
(`repro_torch.core.backend._matmul`). Prints the card's name and power
limit first when run on CUDA, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import backend  # noqa: E402


def rows_apart(fn, xs, beta) -> dict:
    solo = torch.stack([fn(x, beta) for x in xs])
    out = {}
    for b in (2, 4, 8, 16):
        got = torch.func.vmap(lambda x: fn(x, beta))(xs[:b])
        out[b] = int((got != solo[:b]).any(dim=-1).any(dim=-1).sum())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    out = {}
    for n in (16, 64, 1000):
        beta = torch.from_numpy(rng.normal(size=(n, 1))).to(dev)
        xs = torch.from_numpy(rng.normal(size=(16, 1, n))).to(dev)
        x4 = torch.from_numpy(rng.normal(size=(16, 4, n))).to(dev)
        solo = torch.stack([torch.matmul(x, beta) for x in xs])
        out[n] = dict(
            vmap=rows_apart(torch.matmul, xs, beta),
            stacked_mm={b: int((torch.matmul(xs[:b, 0], beta)[:, None]
                                != solo[:b]).sum()) for b in (2, 4, 8, 16)},
            blocks_of_4=rows_apart(torch.matmul, x4, beta),
            row_product=rows_apart(backend._matmul, xs, beta))
    print(json.dumps(dict(device=str(dev), rows_apart=out)))


if __name__ == "__main__":
    main()
