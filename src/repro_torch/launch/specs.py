"""Shape-only stand-ins for every (arch x shape) dry-run cell.

A PyTorch copy of ``repro.launch.specs``.  No storage anywhere: batches,
parameters and caches are tensors on the ``meta`` device, which carry a
shape and a dtype (the reference's ``ShapeDtypeStruct``).  Parameters come
from the model's own ``init_params`` on ``meta`` (``layers.ShapesOnly``
stands in for the generator, which cannot live there); an encoder-decoder
cache from its ``prefill`` run on ``meta`` tensors, as the reference shapes
it with ``jax.eval_shape``.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeCell

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """Host batch specs for train/prefill kinds (decode adds the cache)."""
    gb, s = shape.global_batch, shape.seq_len
    batch: dict = {"tokens": _sds((gb, s), torch.int32)}
    if cfg.frontend == "patches":
        batch["patches"] = _sds((gb, s // 8, cfg.d_model), torch.float32)
    if cfg.frontend == "frames":
        batch["frames"] = _sds((gb, s, cfg.d_model), torch.float32)
    return batch


def token_specs(cfg: ModelConfig, shape: ShapeCell) -> torch.Tensor:
    return _sds((shape.global_batch,), torch.int32)


def params_shape(bundle):
    """The model's ``ParamTree`` on ``meta``: every leaf's shape and dtype,
    no storage."""
    from ..models import encdec, transformer
    cfg = bundle.cfg
    return (encdec if cfg.is_encdec else transformer).init_params(
        0, cfg, META)


def cache_shape(bundle, cfg: ModelConfig, shape: ShapeCell, tp: int,
                p_shape=None) -> dict:
    """Shape-only decode cache for a cache of seq_len entries."""
    from ..models import encdec, transformer
    gb, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:  # cross-K/V sizes come from the encoder: shape prefill
        p_shape = p_shape if p_shape is not None else params_shape(bundle)
        batch = input_specs(cfg, shape)
        with torch.no_grad():
            _, cache = encdec.prefill(p_shape, batch["frames"],
                                      batch["tokens"], cfg, tp=tp,
                                      max_len=s)
        return cache
    return transformer.init_cache(cfg, gb, s, META, tp=tp)


def runnable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Is this (arch, shape) cell runnable? (long_500k needs sub-quadratic.)"""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full attention cannot decode at 524288 "
                       "context (DESIGN.md §6)")
    return True, ""
