"""qwen3-0.6b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,            # qwen3 uses 128 even at d_model=1024
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
)
