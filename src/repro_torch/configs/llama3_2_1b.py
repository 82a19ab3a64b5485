"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings. [hf:meta-llama/Llama-3.2-1B; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_2_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=5e5,
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
