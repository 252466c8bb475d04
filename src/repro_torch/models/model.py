"""Model: init / loss / prefill / decode for every family of the model zoo.

Port of `repro.models.model` as an `nn.Module`. The `first_dense_layers`
(the deepseek models' leading "attn+mlp_first" layers) run first, one by
one, as `prefix`; the other layers are grouped into periods as in the
reference (one "attn" layer per period for the dense and audio families,
one "attn+moe" for the moe family, one "rwkv6" for the ssm family,
jamba's eight for the hybrid family: "mamba" and "mamba+moe" around one
"attn"; the vision model's five: four "attn" and one "xattn"); `periods`
is an `nn.ModuleList` of `nn.ModuleDict`s keyed "{i}:{kind}", so the
module state mirrors the reference's pytree, with the stacked leading
axis unrolled into the list. Caches keep the reference's structure and
its stacked layout of `scan_layers`: {"prefix": [one cache per prefix
layer], "periods": {key: spec}} with each kind's cache spec a pytree of
tensors carrying a leading (n_periods,) axis, e.g. "0:attn": (k, v) of
shape (n_periods, B, max_len, Hkv, hd) (under MLA (c_kv, k_rope) of
(n_periods, B, max_len, kv_lora_rank) and (..., rope_head_dim)),
"4:xattn": the image's (k, v) of (n_periods, B, n_image_tokens, Hkv, hd),
"0:rwkv6": {"wkv": (n_periods, B, H, dh, dh) float32, "shift_tm",
"shift_cm": (n_periods, B, 1, D)}, "1:mamba+moe": {"h": (n_periods, B,
di, ds) float32, "conv": (n_periods, B, di, ck - 1)}.
Prefill writes each layer's cache into the leading slots of every axis
of caches allocated at `max_len` (the values the reference's
`_pad_seq_caches` gives: leaves with a sequence axis are padded, state
leaves are written whole); decode updates them in place.

Tokens are (B, S), or (B, S, K) for the K codebooks of the audio family
(decode: (B, 1, K)), whose logits are (B, K, V). The vision model takes
`image_embeds` (B, n_image_tokens, D) at prefill; the port casts them to
the compute dtype once, at entry. The reference in bf16 takes the image
in bf16 only: a float32 image promotes its xattn output, and so the
scanned residual, to float32, which its layer scan refuses. The cast
gives the port that same bf16 image whatever dtype it is handed.

The MoE layers' aux losses are summed over the layers, as in the
reference (serving reads none of them; `loss` adds 0.01 of their sum).

Training: `build_model(cfg, train=True)` holds every parameter as a
float32 leaf that requires grad (the reference's pytree, which
`jax.value_and_grad` differentiates whole); the use sites cast to the
compute dtype. `loss` runs a grad-enabled forward on the reference's
plain routes (no kernel has a backward) and, with `cfg.remat`, each
period under a non-reentrant checkpoint, as the reference's
`jax.checkpoint` of its period body: the backward recomputes a period's
activations from its input and from the tensors the forward ran the
period at, which the checkpoint takes as inputs and the recompute puts
back in the period's parameter and buffer slots (`_Period.run_at`, as
`torch.func.functional_call` would, without its per-call set-up). So a
loss taken at other
parameters than the module's own (`functional_call` of the model, as
`FedAvgTrainer`'s sites do) recomputes at those, as the reference's
`Model.loss(params, batch)` does. The prefix layers run outside it, as
in the reference. A MoE layer's host read of its group sizes runs again
in the recompute and routes the same tokens (top-k breaks ties to the
lower index), so the recompute matches the forward.

Entry points compute on CUDA unless the caller passes `device="cpu"`
(`build_model`).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.backend import resolve_device
from . import blocks
from .config import ModelConfig
from .layers import Embedding, Head, RMSNorm, chunked_cross_entropy

_PREFIX = "attn+mlp_first"  # the kind of the first dense layers


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


class _Period(nn.ModuleDict):
    """One period's layers, keyed "{i}:{kind}"; `forward` runs them
    without caches (the checkpointed training route)."""

    def slots(self) -> list:
        """(the dict that holds it, its name) for each tensor the period
        runs at: every parameter and buffer of its modules."""
        return [(d, name) for m in self.modules()
                for d in (m._parameters, m._buffers)
                for name, t in d.items() if t is not None]

    def run_at(self, slots, cfg, x, positions, image_embeds, plain: bool,
               *tensors):
        """`forward` with `tensors` in `slots`, the slots' own tensors
        put back after."""
        held = [d[name] for d, name in slots]
        for (d, name), t in zip(slots, tensors):
            d[name] = t
        try:
            return self(cfg, x, positions, image_embeds, plain)
        finally:
            for (d, name), t in zip(slots, held):
                d[name] = t

    def forward(self, cfg, x, positions, image_embeds, plain: bool):
        """(x, the period's aux)."""
        aux_p = torch.zeros((), dtype=torch.float32, device=x.device)
        for key, blk in self.items():
            x, aux, _ = blocks.block_forward(
                blk, cfg, key.split(":", 1)[1], x, positions, image_embeds,
                plain=plain)
            aux_p = aux_p + aux
        return x, aux_p


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        self.embed = Embedding(cfg, device)
        self.head = Head(cfg, device)
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.prefix = nn.ModuleList(blocks.Block(cfg, _PREFIX, device)
                                    for _ in range(cfg.first_dense_layers))
        self.periods = nn.ModuleList(
            _Period({f"{i}:{kind}": blocks.Block(cfg, kind, device)
                     for i, kind in enumerate(self.kinds)})
            for _ in range(cfg.n_periods()))

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

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
        for blk in self.prefix:
            blk.reset_parameters(gen, cfg)
        for period in self.periods:
            for blk in period.values():
                blk.reset_parameters(gen, cfg)
        return self

    def param_shapes(self) -> dict:
        """{name: (shape, dtype)} of every parameter (the reference's
        `jax.eval_shape` of `init`): read from the module, allocating
        nothing; a model on "meta" gives a config's without holding any
        weight."""
        return {n: (tuple(p.shape), p.dtype)
                for n, p in self.named_parameters()}

    def n_params(self) -> int:
        """Every parameter, norm scales included (the reference's
        `Model.n_params`; `cfg.total_params()` leaves the scales out)."""
        return sum(p.numel() for p in self.parameters())

    def as_trainable(self) -> "Model":
        """In place: every parameter a float32 leaf that requires grad;
        returns self. Casting a compute-dtype weight up is exact, so a
        served model's weights carry over unchanged."""
        self.float()
        return self.requires_grad_(True)

    @property
    def trainable(self) -> bool:
        return all(p.dtype == torch.float32 and p.requires_grad
                   for p in self.parameters())

    # ------------------------------------------------------------------
    # forward (training and prefill share this body)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, image_embeds=None,
                collect_cache: bool = False, max_len: Optional[int] = None):
        """Returns (h_final (B, S, D), aux_loss, caches-or-None). With
        `collect_cache`, caches are allocated at `max_len` (default S) and
        hold the prompt's K/V in their first S slots (and each recurrent
        layer's final state, each xattn layer's image K/V)."""
        return self._forward(tokens, image_embeds=image_embeds,
                             collect_cache=collect_cache, max_len=max_len)

    def _forward(self, tokens, *, image_embeds=None,
                 collect_cache: bool = False, max_len: Optional[int] = None,
                 plain: bool = False, remat: bool = False):
        """`forward`'s body, in the caller's grad mode; `plain` takes the
        reference's plain routes on every device, `remat` checkpoints each
        period (training)."""
        cfg = self.cfg
        x = self.embed(tokens)
        B, S = x.shape[0], x.shape[1]
        if image_embeds is not None:
            image_embeds = torch.as_tensor(image_embeds).to(x.device, x.dtype)
            if image_embeds.shape[1] != cfg.n_image_tokens:
                raise ValueError(f"{cfg.name}: {image_embeds.shape[1]} image "
                                 f"tokens, the config caches "
                                 f"{cfg.n_image_tokens}")
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = self.init_cache(B, max_len or S) if collect_cache else None

        def write(bufs, cache):  # the leading slots of each axis
            _tree_map(lambda buf, t: buf[
                tuple(slice(0, n) for n in t.shape)].copy_(t), bufs, cache)

        for i, blk in enumerate(self.prefix):
            x, aux, cache = blocks.block_forward(
                blk, cfg, _PREFIX, x, positions, image_embeds,
                collect_cache=collect_cache, plain=plain)
            aux_total = aux_total + aux
            if collect_cache:
                write(caches["prefix"][i], cache)
        for layer, period in enumerate(self.periods):
            if remat:
                # the tensors the period runs at now (under functional_call
                # of the model, the caller's), kept for the recompute; the
                # forward draws no random numbers: no RNG state to keep
                # (the slots bound, not passed: checkpoint walks its
                # arguments' containers)
                slots = period.slots()
                x, aux = checkpoint(partial(period.run_at, slots), cfg, x,
                                    positions, image_embeds, plain,
                                    *(d[name] for d, name in slots),
                                    use_reentrant=False,
                                    preserve_rng_state=False)
                aux_total = aux_total + aux
                continue
            for key, blk in period.items():
                x, aux, cache = blocks.block_forward(
                    blk, cfg, key.split(":", 1)[1], x, positions,
                    image_embeds, collect_cache=collect_cache, plain=plain)
                aux_total = aux_total + aux
                if collect_cache:
                    write(_tree_map(lambda t: t[layer],
                                    caches["periods"][key]), cache)
        return self.final_norm(x), aux_total, caches

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def loss(self, batch: dict):
        """batch: {'tokens', 'labels', optional 'image_embeds'} (numpy or
        tensors). Returns (ce + 0.01 · aux, {"ce", "aux"}), float32 scalars
        on the model's device, differentiable in the caller's grad mode:
        the reference's plain routes on every device, each period
        checkpointed when `cfg.remat`."""
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        labels = torch.as_tensor(batch["labels"]).to(dev)
        h, aux, _ = self._forward(tokens,
                                  image_embeds=batch.get("image_embeds"),
                                  plain=True, remat=self.cfg.remat)
        ce = chunked_cross_entropy(self.head, self.cfg, h, labels)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_len: int,
                image_embeds=None):
        """Process a prompt; returns (next-token logits (B, V) or (B, K,
        V), caches) with the caches allocated at `max_len`."""
        h, _, caches = self.forward(tokens, image_embeds=image_embeds,
                                    collect_cache=True, max_len=max_len)
        return self.head(h[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches, cur_len: int):
        """token: (B, 1) (or (B, 1, K) audio); cur_len: number of tokens
        already in the cache. Returns (logits (B, V) or (B, K, V),
        caches), the caches updated in place."""
        cfg = self.cfg
        cur_len = int(cur_len)
        x = self.embed(token)
        for blk, cache in zip(self.prefix, caches["prefix"], strict=True):
            x, _ = blocks.block_decode(blk, cfg, _PREFIX, x, cache, cur_len)
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
        cfg = self.cfg
        n = cfg.n_periods()
        period = {f"{i}:{kind}": blocks.cache_spec(cfg, kind, batch, max_len)
                  for i, kind in enumerate(self.kinds)}
        return {"prefix": [blocks.cache_spec(cfg, _PREFIX, batch, max_len)
                           for _ in range(cfg.first_dense_layers)],
                "periods": _tree_map(lambda s: ((n,) + s[0], s[1]), period)}

    def init_cache(self, batch: int, max_len: int):
        return _tree_map(lambda s: torch.zeros(s[0], dtype=s[1],
                                               device=self.device),
                         self.cache_shapes(batch, max_len))


def build_model(cfg: ModelConfig, device=None, *, train: bool = False
                ) -> Model:
    """The model on `device` (CUDA unless the caller asks for another;
    raises without a GPU; "meta" allocates nothing), its weights zero
    until `Model.init` or a `load_state_dict` (see
    `repro_torch.interop.params_from_reference`). A serving model holds
    its matrices in the compute dtype and differentiates nothing; with
    `train`, every parameter is a float32 leaf that requires grad
    (`Model.as_trainable`)."""
    model = Model(cfg, resolve_device(device))
    return model.as_trainable() if train else model
