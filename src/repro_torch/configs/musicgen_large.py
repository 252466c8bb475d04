"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048, 4 codebooks with
the delay interleaving pattern. The EnCodec frontend is a STUB:
input_specs() provides the (B, S, 4) codebook token ids directly.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    rope_theta=10000.0,
)
