"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, 384 experts top-8 — trillion-parameter paper-table entry.
[arXiv:2501.kimi2; unverified]  (Spec'd as GQA; the real K2 uses MLA + a
shared expert — we follow the assignment sheet.)"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi_k2_1t_a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,           # per-expert FFN width
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    rope_theta=5e4,
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
