"""Assigned-architecture configs. Each <id>.py exports CONFIG (full, exact
assignment) ; ``reduced(cfg)`` shrinks any config for CPU smoke tests while
preserving family structure (GQA grouping, MoE routing, SSM, SWA, enc-dec)."""

from __future__ import annotations

import dataclasses
import importlib

from .base import SHAPES, ModelConfig, ShapeCell, TrainConfig, shape_by_name

ARCH_IDS = (
    "falcon_mamba_7b",
    "mistral_nemo_12b",
    "deepseek_7b",
    "h2o_danube3_4b",
    "llama3_2_1b",
    "pixtral_12b",
    "qwen3_moe_30b_a3b",
    "kimi_k2_1t_a32b",
    "seamless_m4t_medium",
    "hymba_1_5b",
)


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
            vocab: int = 512) -> ModelConfig:
    """Family-preserving shrink for smoke tests."""
    kv = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    changes: dict = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab_size=vocab,
        vocab_size_real=0,
        dt_rank=0,
        q_chunk=64,
        ssm_chunk=32,
    )
    if cfg.n_experts:
        changes.update(n_experts=8, top_k=2)
    if cfg.ssm_state:
        changes.update(ssm_state=8)
    if cfg.sliding_window:
        changes.update(sliding_window=64)
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=layers)
    return dataclasses.replace(cfg, **changes)
