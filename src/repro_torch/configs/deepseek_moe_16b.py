"""deepseek-moe-16b — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert size) vocab=102400,
MoE 64e top-6, first layer dense (d_ff 10944).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,            # dense first-layer MLP
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
)
