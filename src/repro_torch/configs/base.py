"""Model / run configuration dataclasses shared by the whole framework."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned arch (configs/<id>.py)."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # Attention flavour
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 1e6

    # Encoder-decoder
    n_enc_layers: int = 0        # >0 -> encdec; n_layers is the decoder depth

    # Modality frontend stubs (DESIGN.md: input_specs supplies embeddings)
    frontend: str = "none"       # none | patches | frames

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    vocab_size_real: int = 0     # pre-padding vocab (0 -> vocab_size); data gen
                                 # samples targets below this bound

    # Numerics / memory policy
    dtype: str = "bfloat16"      # compute dtype
    param_dtype: str = "float32"
    remat: str = "block"         # none | block

    # Attention chunking (memory-efficient train/prefill path)
    q_chunk: int = 512

    # Fused QKV projection (one dot, one backward dx all-reduce under TP;
    # only engaged when (H + 2*KV) divides the model axis — see §Perf)
    fused_qkv: bool = False

    # SSM seq chunking + scan numerics (§Perf: the 4D (B,Q,Di,N) scan tensors
    # dominate the SSM memory term; bf16 halves them, h carry stays fp32)
    ssm_chunk: int = 128
    ssm_scan_dtype: str = "float32"

    # Per-layer structure.  The ten configs run every layer alike; a config
    # type with a layer pattern (configs/jamba2_mini.py) overrides these.
    # Class attributes, not fields: the fields stay the reference's.
    layer_period = 1          # layers in a period of the pattern (1: alike)
    use_rope = True           # RoPE on attention's q and k
    ssm_dt_norms = False      # RMSNorms on the Mamba mixer's dt, B and C
    renorm_gates = True       # top-k gates divided by their sum
    dropless = False          # every assignment computed (no capacity)

    def mixer(self, i: int) -> str:
        """Layer ``i``'s token mixer: "attn", "ssm" or "attn+ssm"."""
        return {"ssm": "ssm", "hybrid": "attn+ssm"}.get(self.family, "attn")

    def ffn(self, i: int) -> str:
        """Layer ``i``'s second branch: "moe", "mlp" or "none"."""
        if self.family == "moe":
            return "moe"
        return "mlp" if self.d_ff > 0 else "none"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.vocab_size_real == 0:
            object.__setattr__(self, "vocab_size_real", self.vocab_size)
        if self.family in ("ssm", "hybrid") and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe family requires n_experts and top_k")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM state or SWA ring cache.)"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D in rooflines)."""
        d, hd = self.d_model, self.head_dim
        h, kv = self.n_heads, self.n_kv_heads
        n = self.vocab_size * d                    # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size               # lm head
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        moe = 3 * d * self.d_ff * self.n_experts if self.n_experts else 0
        di, s, r = self.d_inner, self.ssm_state, self.dt_rank
        # in_proj + conv(w+b) + x_proj + dt_proj(w+b) + A_log + D + out_proj
        ssm = (d * 2 * di + self.ssm_conv * di + di + di * (r + 2 * s)
               + r * di + di + di * s + di + di * d) \
            if self.family in ("ssm", "hybrid") else 0
        if self.family == "ssm":
            per_layer = ssm + d                      # ln1 only (no MLP)
        elif self.family == "hybrid":
            per_layer = attn + ssm + mlp + 2 * d
        elif self.family == "moe":
            per_layer = attn + moe + d * self.n_experts + 2 * d
        else:
            per_layer = attn + mlp + 2 * d
        n += self.n_layers * per_layer
        n += d                                        # final_norm
        if self.is_encdec:
            # encoder layers + enc_norm + decoder cross-attention (+ lnx)
            n += self.n_enc_layers * (attn + mlp + 2 * d) + d
            n += self.n_layers * (attn + d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_all = 3 * self.d_model * self.d_ff * self.n_experts * self.n_layers
        moe_act = 3 * self.d_model * self.d_ff * self.top_k * self.n_layers
        return full - moe_all + moe_act


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop hyperparameters."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient accumulation
    zero1: bool = False          # shard optimizer state over the data axis
    grad_compression: str = "none"   # none | bf16 | int8
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    seed: int = 0
    sharding_mode: str = "tp"    # tp | fsdp (weights gathered per use; for
                                 # small dense models at big TP — §Perf E)
