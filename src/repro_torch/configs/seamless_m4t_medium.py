"""seamless-m4t-medium [audio]: enc-dec 12L+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 (padded to 256208 for 16-way TP). Audio frontend is a
STUB (input_specs supplies frame embeddings). [arXiv:2308.11596; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium",
    family="encdec",
    n_layers=12,          # decoder depth
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256208,    # padded
    vocab_size_real=256206,
    rope_theta=1e4,
    frontend="frames",
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
