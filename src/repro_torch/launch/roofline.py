"""Roofline terms of a counted dry-run cell, at the H100's constants.

Port of `repro.launch.roofline`, with the card's constants in place of
the TPU's:

    compute term    = FLOPs per device / the peak of the cell's dtype
    memory term     = bytes per device / HBM bandwidth
    collective term = ring-model wire bytes per device / NVLink bandwidth

FLOPs and bytes come from `repro_torch.launch.hlocost` (every executed
op, unfused: its bytes exceed XLA's per-fusion figure). MODEL_FLOPS =
6·N·D (dense) or 6·N_active·D (MoE) + the attention window term; the
ratio MODEL_FLOPS / counted FLOPs flags recompute and redundant work.

`PEAKS` holds NVIDIA's published dense peaks (data sheets, SXM part
unless named; without sparsity) by the name `nvidia-smi` reports: FLOP/s
by input dtype and memory bytes/s. float64 counts the FP64 tensor-core
rate; float32 the non-tensor rate (TF32 is off for torch's products);
bfloat16 and tf32 the tensor-core rates. Those rates assume the card's
full power limit, 700 W for "NVIDIA H100 80GB HBM3"; a card set below
it runs slower under load. The module's constants are that card's at
700 W.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

PEAKS = {
    "NVIDIA H100 PCIe": dict(float64=51.2e12, float32=51.2e12,
                             bfloat16=756e12, tf32=378e12, bw=2.0e12),
    "NVIDIA H100 NVL": dict(float64=60e12, float32=60e12, bfloat16=835e12,
                            tf32=417.5e12, bw=3.9e12),
    "NVIDIA H100 80GB HBM3": dict(float64=67e12, float32=67e12,
                                  bfloat16=989e12, tf32=494.7e12,
                                  bw=3.35e12),
}

# NVIDIA H100 80GB HBM3 at 700 W (per card)
CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = PEAKS[CARD]["bfloat16"]   # bf16 tensor cores
HBM_BW = PEAKS[CARD]["bw"]             # bytes/s
NVLINK_BW = 450e9                      # bytes/s each way, all to all


def peaks_for(name: str) -> tuple[str, dict]:
    """(key, peaks) of the card `name` (`torch.cuda.get_device_name` or
    `nvidia-smi`'s name); raises for a card with no recorded peaks."""
    if name in PEAKS:
        return name, PEAKS[name]
    for key, p in PEAKS.items():
        if key.removeprefix("NVIDIA ") in name:
            return key, p
    raise RuntimeError(f"no published peaks recorded for {name!r}")


@dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    kind: str                      # train | prefill | decode
    # per-device counted (hlocost)
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_raw_bytes: float = 0.0
    per_collective: dict = field(default_factory=dict)
    by_group_size: dict = field(default_factory=dict)
    unknown_trips: int = 0
    # the reference's XLA body-once figures: none in the port
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    # per device: the arguments' and outputs' shards, the counted peak
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    # analytic
    model_flops: float = 0.0       # useful flops per device per step
    tokens: int = 0
    compile_seconds: float = 0.0   # seconds the count took
    dtype: str = "bfloat16"        # the compute dtype: its peak rate

    # -- derived ---------------------------------------------------------
    @property
    def peak_flops(self) -> float:
        return PEAKS[CARD][self.dtype]

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_wire_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / modeled step time (perfect overlap)."""
        t_star = self.model_flops / self.peak_flops
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_star / t_step if t_step > 0 else 0.0

    @property
    def flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 roofline_fraction=self.roofline_fraction,
                 flops_ratio=self.flops_ratio)
        return d


def model_flops_per_device(cfg, kind: str, batch: int, seq: int,
                           n_devices: int) -> tuple[float, int]:
    """Analytic useful FLOPs per device per step + tokens processed.

    train: 6·N_active·D (fwd 2 + bwd 4) + attention 12·B·S²·H·hd·L_attn/2
    prefill: 2·N_active·D + attention 4·B·S²·H·hd·L_attn/2
    decode: 2·N_active·B + attention 4·B·S·H·hd·L_attn (one token)."""
    n_active = cfg.active_params()
    hd = cfg.head_dim
    # attention layer count
    kinds = cfg.layer_kinds() * cfg.n_periods()
    n_attn = sum(1 for k in kinds if k.startswith("attn")) \
        + cfg.first_dense_layers
    n_mamba = sum(1 for k in kinds if k.startswith("mamba"))
    if kind == "train":
        tokens = batch * seq
        base = 6.0 * n_active * tokens
        attn = 12.0 * batch * seq * seq * cfg.n_heads * hd * n_attn / 2
        ssm = 18.0 * batch * seq * cfg.d_inner * cfg.d_state * n_mamba \
            if n_mamba else 0.0
        if cfg.ssm_type == "rwkv6":
            # chunked linear attention: ≈ 2·(C + 2·dh)·d per token fwd
            ssm = 6.0 * batch * seq * cfg.d_model \
                * (cfg.rwkv_chunk + 2 * cfg.rwkv_head_dim) * cfg.n_layers
        total = base + attn + ssm
    elif kind == "prefill":
        tokens = batch * seq
        total = 2.0 * n_active * tokens \
            + 4.0 * batch * seq * seq * cfg.n_heads * hd * n_attn / 2
    else:  # decode: one new token, attends over the full cache
        tokens = batch
        total = 2.0 * n_active * batch \
            + 4.0 * batch * seq * cfg.n_heads * hd * n_attn
    return total / n_devices, tokens


def serve_work(cfg, batch: int, prompt: int, weight_bytes: float,
               cache_bytes: float, touched: float) -> tuple[float, float]:
    """(prefill operations, decode bytes a step) of serving `cfg` at
    `batch` prompts of `prompt` tokens: prefill each weight a token uses
    once per token (an xattn layer's wk, wv once per image token), the
    visible attention pairs at 2·(d_qk + d_v) each, the head at the last
    position; decode reads every weight but the embedding's
    (`weight_bytes`) and the experts no token chose (`touched` of each
    MoE layer's experts are read), and the caches (`cache_bytes`)."""
    D, V, K = cfg.d_model, cfg.vocab_size, cfg.n_codebooks or 1
    counts = cfg.param_counts()
    kinds = (["attn+mlp_first"] * cfg.first_dense_layers
             + cfg.layer_kinds() * cfg.n_periods())
    dqk = cfg.head_dim + (cfg.rope_head_dim if cfg.attn_type == "mla"
                          else 0)
    pair_ops = 2.0 * (dqk + cfg.vdim) * cfg.n_heads * batch
    attn_ops = sum(pair_ops * (prompt * cfg.n_image_tokens if k == "xattn"
                               else prompt * (prompt + 1) / 2)
                   for k in kinds if k.startswith("attn") or k == "xattn")
    n_x = kinds.count("xattn")
    kv_w = 2 * D * cfg.kv_heads * cfg.head_dim
    per_token = cfg.active_params() - counts["embed"] - counts["head"]
    products = 2.0 * batch * (per_token * prompt
                              + n_x * kv_w * (cfg.n_image_tokens - prompt))
    n_moe = sum(k.endswith("+moe") for k in kinds)
    untouched = n_moe * (cfg.n_experts - touched) * 3 * D \
        * (cfg.d_expert or cfg.d_ff) * 2
    return products + attn_ops + 2.0 * D * V * K * batch, \
        weight_bytes + cache_bytes - untouched


def format_table(cells: list[RooflineCell]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':9s} {'kind':7s} "
           f"{'t_comp(ms)':>10s} {'t_mem(ms)':>10s} {'t_coll(ms)':>10s} "
           f"{'bound':>9s} {'MODEL/HLO':>9s} {'roofline%':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        lines.append(
            f"{c.arch:22s} {c.shape:12s} {c.mesh:9s} {c.kind:7s} "
            f"{c.t_compute*1e3:10.3f} {c.t_memory*1e3:10.3f} "
            f"{c.t_collective*1e3:10.3f} {c.bottleneck:>9s} "
            f"{c.flops_ratio:9.3f} {c.roofline_fraction*100:8.1f}%")
    return "\n".join(lines)


def save_cells(cells: list[RooflineCell], path: str) -> None:
    with open(path, "w") as f:
        json.dump([c.to_dict() for c in cells], f, indent=1)


def load_cells(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)
