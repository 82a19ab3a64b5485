"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral_nemo_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
