"""Carrying the JAX package's parameters across to the port.

``torch.randperm`` cannot reproduce JAX's PRNG, so a port service that must
answer like a reference service takes the reference's two permutations as
host arrays (``np.asarray(engine.sigma)``, ``np.asarray(engine.pi)``) and
signs with exactly those; classical MinHash takes the reference's (K, D)
permutation set the same way.  A trained hashed-feature model crosses as
its ``(w, bias)`` host arrays, so both packages predict from one set of
weights; an LM crosses as its parameter pytree of host arrays, both ways.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .device import resolve_device


def _as_permutation(p: np.ndarray, name: str) -> np.ndarray:
    p = np.asarray(p)
    if p.ndim != 1 or not np.issubdtype(p.dtype, np.integer):
        raise ValueError(f"{name} must be a 1-D integer array")
    if not np.array_equal(np.sort(p), np.arange(len(p))):
        raise ValueError(f"{name} is not a permutation of [0, {len(p)})")
    return p.astype(np.int32)


def permutations_from_jax(sigma: np.ndarray, pi: np.ndarray,
                          device: str | torch.device,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference (sigma, pi) host arrays -> the port's int32 tensors on
    ``device``; pass the pair as ``params=`` to ``SketchEngine`` or
    ``SimilaritySearchService``."""
    sigma = _as_permutation(sigma, "sigma")
    pi = _as_permutation(pi, "pi")
    if len(sigma) != len(pi):
        raise ValueError(f"sigma and pi differ in length: {len(sigma)} vs "
                         f"{len(pi)}")
    dev = resolve_device(device)
    return torch.tensor(sigma, device=dev), torch.tensor(pi, device=dev)


def k_permutations_from_jax(perms: np.ndarray, device: str | torch.device,
                            ) -> torch.Tensor:
    """Reference (K, D) permutation set (``repro.core.minhash.
    make_k_permutations``, as a host array) -> the port's int32 tensor on
    ``device``, for ``core.minhash``."""
    perms = np.asarray(perms)
    if perms.ndim != 2:
        raise ValueError(f"perms must be (K, D) (got shape {perms.shape})")
    rows = [_as_permutation(p, f"perms[{i}]") for i, p in enumerate(perms)]
    out = np.stack(rows) if rows else np.zeros(perms.shape, np.int32)
    return torch.tensor(out, device=resolve_device(device))


def logistic_from_jax(wb, device: str | torch.device,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference trained ``(w, bias)`` (``repro.core.linear_model.
    fit_logistic``'s, as host arrays) -> the port's float32 ``(w, bias)``
    on ``device``, for ``core.linear_model.predict_logistic``."""
    w, bias = (np.asarray(a) for a in wb)
    if w.ndim != 1 or bias.ndim != 0:
        raise ValueError(f"wb must be ((F,), ()) (got shapes {w.shape}, "
                         f"{bias.shape})")
    dev = resolve_device(device)
    return (torch.tensor(w, dtype=torch.float32, device=dev),
            torch.tensor(bias, dtype=torch.float32, device=dev))


def lm_params_from_jax(params: dict, cfg, device: str | torch.device):
    """Reference LM parameters (``repro.models.build(cfg).init(key)``'s
    pytree as host arrays, ``jax.tree.map(np.asarray, params)``, layers
    stacked on a leading L axis) -> the port's ``ParamTree`` on ``device``,
    one module a layer, for ``repro_torch.models.build(cfg)``'s functions.
    Decoder families and encdec alike.  The leaves come in the order the
    port's ``init`` makes them (``jax.tree`` sorts a dict's keys)."""
    from .models import encdec, transformer
    dev = resolve_device(device)
    depth = ({"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers}
             if cfg.is_encdec else {"layers": cfg.n_layers})
    for name, n_layers in depth.items():
        for leaf in _leaves(params.get(name, {})):
            if np.shape(leaf)[0] != n_layers:
                raise ValueError(f"{name}: {np.shape(leaf)[0]} layers "
                                 f"stacked, cfg has {n_layers}")
    n = sum(int(np.prod(np.shape(leaf))) for leaf in _leaves(params))
    if n != cfg.param_count():
        raise ValueError(f"{n} parameters, {cfg.name} has {cfg.param_count()}")
    meta = (encdec if cfg.is_encdec else transformer).init_params(
        0, cfg, "meta")

    def leaf(name: str, like: torch.Tensor) -> torch.Tensor:
        rel, i = reference_path(name)
        a = params
        for part in rel.split("/"):
            a = a[part]
        a = np.asarray(a) if i is None else np.asarray(a)[i]
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {a.shape}, {cfg.name} has "
                             f"{tuple(like.shape)}")
        return torch.tensor(a, device=dev)
    return meta.map(leaf)


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    return [x]


def lm_params_to_numpy(model: nn.Module) -> dict:
    """The port's ``ParamTree`` -> the reference's parameter pytree as host
    arrays, layers stacked on a leading L axis (each ``ModuleList``
    stacked): the inverse of ``lm_params_from_jax``.  Every array is a
    copy, so a later in-place update does not reach it."""
    if isinstance(model, nn.ModuleList):
        return _stack([lm_params_to_numpy(c) for c in model])
    out: dict = {n: p.detach().to("cpu", copy=True).numpy()
                 for n, p in model._parameters.items()}
    out.update({n: lm_params_to_numpy(c) for n, c in model._modules.items()})
    return out


def reference_path(name: str) -> tuple[str, int | None]:
    """A ``ParamTree`` leaf's ``named_parameters`` name -> (its path in
    ``lm_params_to_numpy``'s tree, its row on the stacked L axis or None):
    ``layers.3.attn.wq`` -> (``layers/attn/wq``, 3).  Only a
    ``ModuleList``'s children have integer names."""
    parts = name.split(".")
    rows = [int(p) for p in parts if p.isdigit()]
    return ("/".join(p for p in parts if not p.isdigit()),
            rows[0] if rows else None)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
