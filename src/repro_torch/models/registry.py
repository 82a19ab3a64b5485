"""Model registry: ModelConfig -> a uniform bundle of functions on one
device.

A PyTorch copy of ``repro.models.registry``.  ``build(cfg, device=...)``
resolves the device once (``"cuda"`` by default, raising without a card);
every function of the bundle moves its batch there.  ``forward``,
``prefill`` and ``decode_step`` run under ``torch.no_grad()``; ``loss_fn``
records a graph where autograd is on and a parameter requires a gradient
(``train.train_loop.make_train_step``).  ``params`` is the ``ParamTree``
that ``init`` returns (or ``convert.lm_params_from_jax``).

Every function takes the reference's ``mesh=None``.  ``loss_fn``,
``forward``, ``prefill`` and ``decode_step`` run over a mesh (a
``launch.mesh`` ``DeviceMesh``, tensor parallel, or a
``distributed.parallel.Parallel``) for the dense and moe families:
``params`` are then the rank's local slices
(``distributed.sharding.shard_tree``), the batch its rows
(``data.loader.device_placer``); the loss is the whole batch's, the
logits the rank's rows over the full vocab, a cache the rank's block
(``cache_specs``).  Every other family's mesh forward raises (ROADMAP
§1).  ``prefill(tp=k)`` and ``init_cache(tp=k)`` give the reference's
caches with KV heads replicated up to ``k``.

Batch conventions (numpy arrays or tensors):
  decoder families : {"tokens": (B, S) int [, "patches": (B, P, D) (vlm)]}
  encdec           : {"frames": (B, S_enc, D), "tokens": (B, S) int}
  decode step      : token (B,) int + the cache dict
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..distributed.parallel import parallel_for
from . import encdec, transformer

AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    device: torch.device
    init: Callable[[int], Any]            # seed -> params
    loss_fn: Callable[..., tuple]         # (params, batch, mesh) -> loss, metrics
    forward: Callable[..., torch.Tensor]  # (params, batch, mesh) -> logits
    prefill: Callable[..., tuple]         # (params, batch, mesh, tp, max_len)
    decode_step: Callable[..., tuple]     # (params, cache, token, mesh)
    init_cache: Callable[..., dict]       # (batch, max_len, tp=1)


def _on(dev: torch.device, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _no_mesh(mesh, cfg) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{cfg.name} (encdec): a forward over a mesh is not ported yet "
            "(ROADMAP §1)")


def _decoder_bundle(cfg, dev: torch.device) -> ModelBundle:
    def init(seed):
        return transformer.init_params(seed, cfg, dev)

    def _prefix(batch):
        return batch.get("patches") if cfg.frontend == "patches" else None

    def loss_fn(params, batch, mesh=None):
        par = parallel_for(mesh, cfg)
        batch = _on(dev, batch)
        tokens = batch["tokens"]
        logits, aux = transformer.forward(params, tokens, cfg, par,
                                          prefix_embeddings=_prefix(batch))
        mask = batch.get("mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=dev)
                if mask is None else mask.float().clone())
        if cfg.frontend == "patches":  # no LM loss on the image prefix
            mask[:, :batch["patches"].shape[1]] = 0.0
        ce = transformer.lm_loss(logits[:, :-1], tokens[:, 1:], mask[:, 1:],
                                 par)
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def forward(params, batch, mesh=None):
        par = parallel_for(mesh, cfg)
        batch = _on(dev, batch)
        logits, _ = transformer.forward(params, batch["tokens"], cfg, par,
                                        prefix_embeddings=_prefix(batch))
        return logits if par is None else par.gather_vocab(logits)

    @torch.no_grad()
    def prefill(params, batch, mesh=None, tp=1, max_len=None):
        par = parallel_for(mesh, cfg)
        batch = _on(dev, batch)
        logits, cache = transformer.prefill(
            params, batch["tokens"], cfg, par, tp=tp, max_len=max_len,
            prefix_embeddings=_prefix(batch))
        return (logits if par is None else par.gather_vocab(logits)), cache

    @torch.no_grad()
    def decode_step(params, cache, token, mesh=None):
        par = parallel_for(mesh, cfg)
        logits, cache = transformer.decode_step(
            params, cache, torch.as_tensor(token, device=dev), cfg, par)
        return (logits if par is None else par.gather_vocab(logits)), cache

    def init_cache(batch, max_len, tp=1):
        return transformer.init_cache(cfg, batch, max_len, dev, tp=tp)

    return ModelBundle(cfg, dev, init, loss_fn, forward, prefill, decode_step,
                       init_cache)


def _encdec_bundle(cfg, dev: torch.device) -> ModelBundle:
    def init(seed):
        return encdec.init_params(seed, cfg, dev)

    def loss_fn(params, batch, mesh=None):
        _no_mesh(mesh, cfg)
        batch = _on(dev, batch)
        tokens = batch["tokens"]
        logits, aux = encdec.forward(params, batch["frames"], tokens, cfg)
        mask = batch.get("mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=dev)
                if mask is None else mask.float())
        ce = transformer.lm_loss(logits[:, :-1], tokens[:, 1:], mask[:, 1:])
        return ce, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def forward(params, batch, mesh=None):
        _no_mesh(mesh, cfg)
        batch = _on(dev, batch)
        logits, _ = encdec.forward(params, batch["frames"], batch["tokens"],
                                   cfg)
        return logits

    @torch.no_grad()
    def prefill(params, batch, mesh=None, tp=1, max_len=None):
        _no_mesh(mesh, cfg)
        batch = _on(dev, batch)
        return encdec.prefill(params, batch["frames"], batch["tokens"], cfg,
                              tp=tp, max_len=max_len)

    @torch.no_grad()
    def decode_step(params, cache, token, mesh=None):
        _no_mesh(mesh, cfg)
        return encdec.decode_step(params, cache,
                                  torch.as_tensor(token, device=dev), cfg)

    def init_cache(batch, max_len, tp=1):
        raise NotImplementedError(
            "encdec caches come from prefill (cross-K/V need encoder states)")

    return ModelBundle(cfg, dev, init, loss_fn, forward, prefill, decode_step,
                       init_cache)


def build(cfg, device: str | torch.device = DEFAULT_DEVICE) -> ModelBundle:
    """The bundle of ``cfg``'s family on ``device`` (raises for the card
    without one)."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        return _encdec_bundle(cfg, dev)
    return _decoder_bundle(cfg, dev)
