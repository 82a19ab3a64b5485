"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free, vocab=65024, ssm_state=16.
[arXiv:2410.05355; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,          # attention-free; unused
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,             # pure Mamba blocks, no MLP
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,       # d_inner = 8192
    ssm_conv=4,
    ssm_chunk=32,     # tuned: fewer assoc-scan levels (§Perf)
)
