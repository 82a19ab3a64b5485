"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 (padded 32016), parallel attention+SSM heads, ssm_state=16.
25 heads don't divide the 16-way model axis -> attention stays replicated
under the divisor rule (DESIGN.md §5). [arXiv:2411.13676; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1_5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32016,     # padded
    vocab_size_real=32001,
    ssm_state=16,
    ssm_expand=2,         # d_inner = 3200
    sliding_window=1024,  # Hymba uses SWA in most layers; long_500k runnable
    rope_theta=1e4,
    ssm_chunk=32,     # tuned: fewer assoc-scan levels (§Perf)
)
