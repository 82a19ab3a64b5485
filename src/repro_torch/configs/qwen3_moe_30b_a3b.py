"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, 128 experts top-8, head_dim=128 override.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_30b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,            # per-expert FFN width
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1e6,
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
