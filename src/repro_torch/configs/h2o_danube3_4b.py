"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, llama+mistral mix with SWA. [arXiv:2401.16818; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube3_4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,   # SWA -> ring cache; long_500k runnable
    rope_theta=1e4,
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
