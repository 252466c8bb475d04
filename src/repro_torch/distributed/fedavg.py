"""Federated parameter server over sites (SystemDS §4.3 + DiLoCo-style
relaxed sync).

Port of `repro.distributed.fedavg`. `FedAvgTrainer` simulates K
federated sites: each site runs H local optimizer steps on its own data
shard, then the sites exchange parameter deltas (optionally int8-
compressed with error feedback) and apply their mean. Traffic per sync =
one (compressed) parameter delta a site instead of H gradient
all-reduces.

Sites are host-level, as in the reference: each holds its own parameter
tensors, AdamW moments and residual on the caller's device.

Parameters are a dict of name -> tensor, as the port's AdamW takes them
(`optim.adamw`: updated in place, float32 moments, the default clip 1.0,
no weight decay here as in the reference). `loss_fn(params, batch)`
returns (loss, aux); each local step differentiates it by autograd with
respect to every parameter, the gradient `jax.value_and_grad` takes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..launch import hlocost
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from . import compress


@dataclass
class SiteState:
    params: dict
    opt_state: AdamWState
    err: Any = None            # error-feedback residual (compression)


def _copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


@dataclass
class FedAvgTrainer:
    loss_fn: Callable[[dict, dict], tuple]  # (params, batch) -> (loss, aux)
    n_sites: int
    sync_every: int = 8
    lr: float = 1e-3
    compress_int8: bool = False
    sites: list[SiteState] = field(default_factory=list)
    anchor: Any = None         # last synced global params
    bytes_exchanged: int = 0
    step: int = 0

    def init(self, params: dict) -> None:
        self.anchor = params
        self.sites = [
            SiteState(params=_copy(params), opt_state=adamw_init(params),
                      err=compress.init_error_state(params))
            for _ in range(self.n_sites)]

    def _grad(self, params: dict, batch: dict):
        """((loss, aux), grads) of `loss_fn` at `params`."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss, aux = self.loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        materialize_grads=True)
        return (loss.detach(), aux), dict(zip(leaves, grads))

    def local_step(self, site: int, batch: dict) -> float:
        s = self.sites[site]
        (loss, _), grads = self._grad(s.params, batch)
        s.params, s.opt_state, _ = adamw_update(
            grads, s.opt_state, s.params, lr=self.lr, weight_decay=0.0)
        return float(loss)

    @torch.no_grad()
    def maybe_sync(self) -> bool:
        self.step += 1
        if self.step % self.sync_every:
            return False
        # exchange deltas from the anchor (what actually crosses sites)
        deltas = []
        for s in self.sites:
            delta = {k: p.to(torch.float32) - self.anchor[k].to(torch.float32)
                     for k, p in s.params.items()}
            if self.compress_int8:
                q, scale, s.err = compress.compress_tree(delta, s.err)
                self.bytes_exchanged += compress.compressed_bytes(delta)[0]
                delta = {k: compress.dequantize(q[k], scale[k])
                         for k in delta}
            else:
                self.bytes_exchanged += compress.compressed_bytes(delta)[1]
            deltas.append(delta)
        if hlocost.active():  # one site's view: its delta averaged
            hlocost.collective("all-reduce", compress.compressed_bytes(
                deltas[-1])[0 if self.compress_int8 else 1],
                len(self.sites))
        mean_delta = {k: sum(d[k] for d in deltas) / len(deltas)
                      for k in deltas[0]}
        self.anchor = {k: (a.to(torch.float32) + mean_delta[k]).to(a.dtype)
                       for k, a in self.anchor.items()}
        for s in self.sites:
            s.params = _copy(self.anchor)
        return True
