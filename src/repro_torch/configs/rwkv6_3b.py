"""rwkv6-3b — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536. Heads = d_model/64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # 2560 / 64 rwkv head dim
    d_ff=8960,
    vocab_size=65536,
    attn_type="none",
    ssm_type="rwkv6",
    rwkv_head_dim=64,
)
