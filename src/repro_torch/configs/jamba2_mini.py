"""AI21-Jamba2-Mini [jamba]: 32L d_model=4096, a 1:7 attention/Mamba-1
layer pattern (attention where i % 8 == 4: GQA 32H kv=8 of 128, no
positional encoding; Mamba-1 elsewhere: d_inner 8192, d_state 16,
dt_rank 256, conv 4, RMSNorms on dt, B and C), and 16 SwiGLU experts of
14336 with top-2 where i % 2 == 1 (dropless, gates not renormalised), a
dense SwiGLU of 14336 elsewhere.  vocab 65536, untied head.  52B total,
12B active.  [hf:ai21labs/AI21-Jamba2-Mini config.json; transformers'
JambaConfig / JambaSparseMoeBlock]

A port-only config: the JAX package has no layer pattern, so this one is
outside ``ARCH_IDS`` and reached through ``get_config("jamba2_mini")``.
"""

from __future__ import annotations

import dataclasses
import math

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class JambaConfig(ModelConfig):
    """A ``ModelConfig`` whose layers follow transformers' ``JambaConfig``:
    layer ``i`` attends where ``i % attn_layer_period ==
    attn_layer_offset`` (else a Mamba-1 mixer) and routes to experts where
    ``i % expert_layer_period == expert_layer_offset`` (else a dense
    SwiGLU)."""

    attn_layer_period: int = 8
    attn_layer_offset: int = 4
    expert_layer_period: int = 2
    expert_layer_offset: int = 1

    # Jamba's layer semantics: class constants, as ModelConfig's
    use_rope = False
    ssm_dt_norms = True
    renorm_gates = False
    dropless = True

    def __post_init__(self):
        super().__post_init__()
        if self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    @property
    def layer_period(self) -> int:
        return math.lcm(self.attn_layer_period, self.expert_layer_period)

    def mixer(self, i: int) -> str:
        return "attn" if i % self.attn_layer_period \
            == self.attn_layer_offset else "ssm"

    def ffn(self, i: int) -> str:
        return "moe" if i % self.expert_layer_period \
            == self.expert_layer_offset else "mlp"

    def _layer_params(self, i: int, active: bool) -> int:
        d, hd, h, kv = self.d_model, self.head_dim, self.n_heads, \
            self.n_kv_heads
        di, s, r, cw = self.d_inner, self.ssm_state, self.dt_rank, \
            self.ssm_conv
        n = 2 * d                                     # ln1, ln2
        if self.mixer(i) == "attn":
            n += d * h * hd + 2 * d * kv * hd + h * hd * d
        else:   # in_proj, conv (w + b), x_proj, dt_proj (w + b), A_log, D,
                # out_proj, the dt/B/C norms
            n += (d * 2 * di + cw * di + di + di * (r + 2 * s) + r * di + di
                  + di * s + di + di * d
                  + (r + 2 * s if self.ssm_dt_norms else 0))
        if self.ffn(i) == "moe":
            n += 3 * d * self.d_ff * (self.top_k if active
                                      else self.n_experts)
            n += d * self.n_experts                   # router
        else:
            n += 3 * d * self.d_ff
        return n

    def _count(self, active: bool) -> int:
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2) + d   # + final_norm
        return n + sum(self._layer_params(i, active)
                       for i in range(self.n_layers))

    def param_count(self) -> int:
        return self._count(False)

    def active_param_count(self) -> int:
        return self._count(True)


CONFIG = JambaConfig(
    name="jamba2_mini",
    family="jamba",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,           # per expert, and the dense layers' width
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_expand=2,         # d_inner = 8192
    ssm_conv=4,
    dt_rank=256,
    tie_embeddings=False,
    norm_eps=1e-6,
    dtype="bfloat16",
    param_dtype="bfloat16",
    ssm_chunk=32,         # measured on an H100 at 16 x 1,024 prompt tokens:
                          # a prefill-and-32-token step of 8 layers took
                          # 3.3 s at 128, 2.6 s at 32, 2.1 s at 8, 1.9 s at 4;
                          # at 8 a profiled step holds ~40,000 kernels, at
                          # 32 about half (a traced run's profile stays
                          # within minutes to write and read)
)
