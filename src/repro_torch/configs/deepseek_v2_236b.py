"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H d_ff=1536 (expert size) vocab=102400, MoE 160e
top-6, first layer dense (d_ff 12288 dense MLP), q_lora_rank=1536.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: latent-shared; head count for Q
    d_head=128,            # qk_nope_head_dim
    d_ff=12288,            # dense first-layer MLP
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1536,
    first_dense_layers=1,
    rope_theta=10000.0,
)
