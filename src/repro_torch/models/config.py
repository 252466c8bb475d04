"""ModelConfig: one dataclass describing every supported architecture.

Port of `repro.models.config`, copied whole (it is pure Python); the
port serves the dense and ssm families, the others are described for
their parameter counts.

Families:
  dense  — llama-style GQA transformer (llama3.2, phi3, qwen3)
  moe    — fine-grained MoE with shared experts (deepseek-moe/v2; v2 = MLA)
  ssm    — attention-free RWKV-6 (Finch)
  hybrid — jamba: mamba+attention 1:7 interleave, MoE every other layer
  audio  — musicgen: decoder-only over EnCodec tokens (4 codebooks, stub
           frontend)
  vlm    — llama-3.2-vision: self-attn layers + cross-attn image layers
           (stub vision encoder; precomputed patch embeddings)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0             # 0 -> = n_heads (MHA)
    d_head: int = 0                 # 0 -> d_model // n_heads

    # attention flavour
    attn_type: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 500000.0

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0             # 0 -> d_head

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0               # fine-grained expert hidden size
    moe_layer_freq: int = 1         # every k-th layer is MoE
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_type: str = ""              # rwkv6 | mamba
    attn_layer_period: int = 0      # jamba: one attn layer per period
    d_state: int = 16
    expand: int = 2
    conv_kernel: int = 4
    rwkv_head_dim: int = 64

    # multimodal
    cross_attn_period: int = 0      # vlm: 1 cross-attn layer per period
    n_image_tokens: int = 1024      # stub frontend sequence length
    n_codebooks: int = 0            # musicgen

    # compute / distribution knobs
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 512           # chunked cross-entropy block
    attn_chunk: int = 1024          # kv-block size for chunked attention
    rwkv_chunk: int = 128
    use_pallas: bool = False        # TPU kernels (CPU container: off)
    fsdp_embed: bool = True

    # -- derived -------------------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def vdim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def period(self) -> int:
        """Length of the repeating heterogeneous super-block."""
        if self.family == "hybrid":
            return self.attn_layer_period
        if self.family == "vlm":
            return self.cross_attn_period
        return 1

    def layer_kinds(self) -> list[str]:
        """Layer kinds within one period (scan unit)."""
        if self.family == "ssm":
            return ["rwkv6"]
        if self.family == "hybrid":
            # jamba period of 8: attn at index 4, mamba elsewhere;
            # MoE replaces the MLP on every second layer (odd indices)
            kinds = []
            for i in range(self.attn_layer_period):
                base = "attn" if i == self.attn_layer_period // 2 else "mamba"
                moe = "+moe" if (i % 2 == 1) and self.n_experts else ""
                kinds.append(base + moe)
            return kinds
        if self.family == "vlm":
            return ["attn"] * (self.cross_attn_period - 1) + ["xattn"]
        if self.family == "moe":
            return ["attn+moe"]
        return ["attn"]  # dense / audio

    def n_periods(self) -> int:
        assert self.n_scanned() % self.period == 0, \
            (self.name, self.n_layers, self.period)
        return self.n_scanned() // self.period

    def n_scanned(self) -> int:
        return self.n_layers - self.first_dense_layers

    # -- parameter counts (for roofline MODEL_FLOPS) --------------------------
    def param_counts(self) -> dict[str, int]:
        d, hd, vd = self.d_model, self.head_dim, self.vdim
        nh, nkv = self.n_heads, self.kv_heads
        counts: dict[str, int] = {}
        counts["embed"] = self.vocab_size * d * (
            self.n_codebooks or 1)
        counts["head"] = d * self.vocab_size * (self.n_codebooks or 1)
        attn = 0
        if self.attn_type == "mla":
            q_in = self.q_lora_rank or d
            attn += (d * self.q_lora_rank if self.q_lora_rank else 0)
            attn += q_in * nh * (hd + self.rope_head_dim)
            attn += d * (self.kv_lora_rank + self.rope_head_dim)
            attn += self.kv_lora_rank * nh * (hd + vd)
            attn += nh * vd * d
        else:
            attn += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp_dense = 3 * d * self.d_ff
        moe = 0
        if self.n_experts:
            de = self.d_expert or self.d_ff
            moe = self.n_experts * 3 * d * de \
                + self.n_shared_experts * 3 * d * de + d * self.n_experts
        mamba = 0
        if self.ssm_type == "mamba" or self.family == "hybrid":
            di, ds = self.d_inner, self.d_state
            mamba = (d * 2 * di + di * self.conv_kernel
                     + di * (2 * ds + 1) + di  # x_proj(B,C,dt) + dt rank 1
                     + di * d + di * ds)       # out proj + A
        rwkv = 0
        if self.ssm_type == "rwkv6":
            # time-mix (r,k,v,w,g + lora for w) + channel-mix
            rwkv = d * d * 5 + d * 64 * 2 + 2 * d * self.d_ff
        counts["attn_per_layer"] = attn
        counts["mlp_per_layer"] = mlp_dense
        counts["moe_per_layer"] = moe
        counts["mamba_per_layer"] = mamba
        counts["rwkv_per_layer"] = rwkv
        return counts

    def total_params(self) -> int:
        c = self.param_counts()
        kinds = self.layer_kinds() * self.n_periods()
        kinds = ["attn+mlp_first"] * self.first_dense_layers + kinds
        total = c["embed"] + c["head"]
        for k in kinds:
            if "rwkv" in k:
                total += c["rwkv_per_layer"]
                continue
            if "mamba" in k:
                total += c["mamba_per_layer"]
            if "attn" in k or "xattn" in k:
                total += c["attn_per_layer"]
            if "moe" in k and "mlp_first" not in k:
                total += c["moe_per_layer"]
            else:
                total += c["mlp_per_layer"]
        return total

    def active_params(self) -> int:
        """Activated params per token (MoE top-k instead of all experts)."""
        c = self.param_counts()
        if not self.n_experts:
            return self.total_params()
        de = self.d_expert or self.d_ff
        active_moe = (self.moe_top_k + self.n_shared_experts) * 3 * self.d_model * de \
            + self.d_model * self.n_experts
        kinds = self.layer_kinds() * self.n_periods()
        kinds = ["attn+mlp_first"] * self.first_dense_layers + kinds
        total = c["embed"] + c["head"]
        for k in kinds:
            if "mamba" in k:
                total += c["mamba_per_layer"]
            if "attn" in k or "xattn" in k:
                total += c["attn_per_layer"]
            if "moe" in k and "mlp_first" not in k:
                total += active_moe
            else:
                total += c["mlp_per_layer"]
        return total

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=max(self.period * (2 if self.first_dense_layers else 1),
                         2 * self.period) + self.first_dense_layers,
            d_model=128, n_heads=4, d_ff=256, vocab_size=512,
            n_kv_heads=min(self.kv_heads, 2) if self.n_kv_heads else 0,
            d_head=32, loss_chunk=64, attn_chunk=64, rwkv_chunk=16,
            rope_head_dim=16, v_head_dim=32 if self.v_head_dim else 0,
            scan_layers=True, dtype="float32")
        if self.attn_type == "mla":
            kw.update(kv_lora_rank=64, q_lora_rank=96)
        if self.n_experts:
            kw.update(n_experts=8, moe_top_k=min(self.moe_top_k, 2),
                      d_expert=64 if self.d_expert else 0,
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.family == "hybrid":
            kw.update(n_experts=4, moe_top_k=2, d_state=8, expand=2)
        if self.ssm_type == "rwkv6":
            kw.update(rwkv_head_dim=32)
        if self.first_dense_layers:
            kw.update(first_dense_layers=1)
        return self.with_(**kw)
