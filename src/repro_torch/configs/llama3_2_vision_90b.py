"""llama-3.2-vision-90b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; one cross-attn
layer per period of 5 (20 image layers). The vision encoder is a STUB:
input_specs() provides precomputed patch embeddings (B, 1024, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_period=5,
    n_image_tokens=1024,
    rope_theta=500000.0,
)
