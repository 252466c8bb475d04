"""Deterministic, resumable, sharded LM token pipeline.

Each (host, data-shard) draws disjoint slices of a seeded synthetic
stream; iteration state is just (seed, step), so restart-after-failure
replays exactly (the lineage story of §4.1 applied to data: the batch at
step t is a pure function of the pipeline lineage).

Port of `repro.data.tokens`: numpy only, the reference's batches bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from .synthetic import gen_tokens


@dataclass
class TokenPipeline:
    vocab: int
    batch: int                 # per-shard batch size
    seq_len: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1
    n_codebooks: int = 0
    step: int = 0              # resumable position

    def batch_at(self, step: int) -> dict:
        """Pure function (seed, shard, step) -> batch."""
        rng_seed = (self.seed * 1_000_003 + self.shard * 7919 + step) \
            % (2 ** 31)
        need = self.batch * (self.seq_len + 1)
        stream = gen_tokens(need, self.vocab, seed=rng_seed,
                            n_codebooks=self.n_codebooks)
        if self.n_codebooks:
            stream = stream.reshape(self.batch, self.seq_len + 1,
                                    self.n_codebooks)
            return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
        stream = stream.reshape(self.batch, self.seq_len + 1)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    def state(self) -> dict:
        return {"seed": self.seed, "shard": self.shard, "step": self.step}

    @classmethod
    def restore(cls, state: dict, **kw) -> "TokenPipeline":
        return cls(seed=state["seed"], shard=state["shard"],
                   step=state["step"], **kw)
