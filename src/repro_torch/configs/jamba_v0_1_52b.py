"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Period of 8: attention at offset 4, mamba elsewhere; MoE every 2nd layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    moe_top_k=2,
    attn_layer_period=8,
    ssm_type="mamba",
    d_state=16,
    expand=2,
    conv_kernel=4,
    rope_theta=10000.0,
)
