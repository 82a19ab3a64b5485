"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Vision frontend is a STUB (input_specs supplies patch embeddings); backbone =
Mistral-Nemo dims. [hf:mistralai/Pixtral-12B-2409; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral_12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    frontend="patches",
    fused_qkv=True,   # single bwd dx all-reduce under TP (§Perf)
)
