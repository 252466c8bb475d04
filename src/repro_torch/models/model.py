"""Model: init / prefill / decode for the dense, ssm and hybrid families.

Port of `repro.models.model` as an `nn.Module`. The layers are grouped
into periods as in the reference (one "attn" layer per period for the
dense family, one "rwkv6" layer for the ssm family, jamba's eight for the
hybrid family: "mamba" and "mamba+moe" around one "attn"); `periods` is an
`nn.ModuleList` of `nn.ModuleDict`s keyed "{i}:{kind}", so the module
state mirrors the reference's pytree, with the stacked leading axis
unrolled into the list. Caches keep the reference's structure and its
stacked layout of `scan_layers`: {"prefix": [], "periods": {key: spec}}
with each kind's cache spec a pytree of tensors carrying a leading
(n_periods,) axis, e.g. "0:attn": (k, v) of shape (n_periods, B,
max_len, Hkv, hd), "0:rwkv6": {"wkv": (n_periods, B, H, dh, dh) float32,
"shift_tm", "shift_cm": (n_periods, B, 1, D)}, "1:mamba+moe": {"h":
(n_periods, B, di, ds) float32, "conv": (n_periods, B, di, ck - 1)}.
Prefill writes each layer's cache into the leading slots of every axis
of caches allocated at `max_len` (the values the reference's
`_pad_seq_caches` gives: leaves with a sequence axis are padded, state
leaves are written whole); decode updates them in place.

The MoE layers' aux losses are summed over the layers, as in the
reference (serving reads none of them).

Entry points compute on CUDA unless the caller passes `device="cpu"`
(`build_model`); the other families (moe, audio, vlm) raise
`NotImplementedError`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.backend import resolve_device
from . import blocks
from .config import ModelConfig
from .layers import Embedding, Head, RMSNorm

_PORTED = ("dense", "ssm", "hybrid")


def _is_spec(x) -> bool:
    """A (shape, dtype) leaf of a cache spec."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def _tree_map(fn, tree, *rest):
    """`fn` over the leaves (tensors or (shape, dtype) specs) of a cache
    pytree of dicts and tuples, zipped with trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet; the "
                "port serves the dense, ssm and hybrid families (ROADMAP "
                "Queue 1 item 14)")
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        self.embed = Embedding(cfg, device)
        self.head = Head(cfg, device)
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.periods = nn.ModuleList(
            nn.ModuleDict({f"{i}:{kind}": blocks.Block(cfg, kind, device)
                           for i, kind in enumerate(self.kinds)})
            for _ in range(cfg.n_periods()))

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> "Model":
        """Draw every weight from `generator` (a fresh one on the model's
        device seeded with `seed` if none is given); returns self."""
        cfg = self.cfg
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed.reset_parameters(gen, cfg)
        self.head.reset_parameters(gen, cfg)
        self.final_norm.reset_parameters(gen)
        for period in self.periods:
            for blk in period.values():
                blk.reset_parameters(gen, cfg)
        return self

    def n_params(self) -> int:
        """Every parameter, norm scales included (the reference's
        `Model.n_params`; `cfg.total_params()` leaves the scales out)."""
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------------
    # prefill forward
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False,
                max_len: Optional[int] = None):
        """Returns (h_final (B, S, D), aux_loss, caches-or-None). With
        `collect_cache`, caches are allocated at `max_len` (default S) and
        hold the prompt's K/V in their first S slots (and each recurrent
        layer's final state)."""
        cfg = self.cfg
        x = self.embed(tokens)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = self.init_cache(B, max_len or S) if collect_cache else None
        for layer, period in enumerate(self.periods):
            for key, blk in period.items():
                x, aux, cache = blocks.block_forward(
                    blk, cfg, key.split(":", 1)[1], x, positions,
                    collect_cache=collect_cache)
                aux_total = aux_total + aux
                if collect_cache:
                    _tree_map(lambda buf, t: buf[layer][
                        tuple(slice(0, n) for n in t.shape)].copy_(t),
                        caches["periods"][key], cache)
        return self.final_norm(x), aux_total, caches

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_len: int):
        """Process a prompt; returns (next-token logits (B, V), caches)
        with the caches allocated at `max_len`."""
        h, _, caches = self.forward(tokens, collect_cache=True,
                                    max_len=max_len)
        return self.head(h[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches, cur_len: int):
        """token: (B, 1); cur_len: number of tokens already in the cache.
        Returns (logits (B, V), caches), the caches updated in place."""
        cfg = self.cfg
        cur_len = int(cur_len)
        x = self.embed(token)
        for layer, period in enumerate(self.periods):
            for key, blk in period.items():
                layer_cache = _tree_map(lambda t: t[layer],
                                        caches["periods"][key])
                x, _ = blocks.block_decode(blk, cfg, key.split(":", 1)[1],
                                           x, layer_cache, cur_len)
        x = self.final_norm(x)
        return self.head(x[:, -1]), caches

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int):
        """The caches' (shape, dtype) leaves, stacked over periods."""
        n = self.cfg.n_periods()
        period = {f"{i}:{kind}": blocks.cache_spec(self.cfg, kind, batch,
                                                   max_len)
                  for i, kind in enumerate(self.kinds)}
        return {"prefix": [],
                "periods": _tree_map(lambda s: ((n,) + s[0], s[1]), period)}

    def init_cache(self, batch: int, max_len: int):
        return _tree_map(lambda s: torch.zeros(s[0], dtype=s[1],
                                               device=self.device),
                         self.cache_shapes(batch, max_len))


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on `device` (CUDA unless the caller asks for another;
    raises without a GPU; "meta" allocates nothing), its weights zero
    until `Model.init` or a `load_state_dict` (see
    `repro_torch.interop.params_from_reference`)."""
    return Model(cfg, resolve_device(device))
