"""lm-100m — the end-to-end example training target (examples/train_lm.py).

A ~100M-param llama-style model trainable for a few hundred steps on CPU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=8,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=1792,
    vocab_size=32768,
    dtype="float32",
    loss_chunk=128,
    attn_chunk=256,
)
