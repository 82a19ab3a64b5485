"""Shared layers of the LM stack: RMSNorm, RoPE, GQA attention (full or
sliding-window, chunked over queries), one-token decode attention, SwiGLU.

A PyTorch copy of ``repro.models.layers``.  Layers are functions over
parameter groups keyed as the reference's pytree (``p["wq"]``), held in a
``ParamTree``.  Parameters are stored in ``param_dtype`` (float32) and cast
to the compute dtype at each use, as the reference casts them; attention
scores, softmax and normalisation statistics stay in float32.  The JAX
package computes these layers in plain ``jnp`` (no Pallas kernel), so the
products here go to ``torch`` as the reference leaves them to XLA.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

Tensor = torch.Tensor
NEG_INF = -1e30


class ParamTree(nn.Module):
    """A parameter pytree as a module: a dict becomes a submodule, a tensor
    a parameter, any other module (a ``ModuleList`` of layers) stays
    itself.  Indexed as the reference's pytree: ``lp["attn"]["wq"]``.
    Parameters are made without ``requires_grad``, so serving builds no
    graph; the train step turns it on for its own backward pass."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                val = ParamTree(val)
            elif isinstance(val, Tensor):
                val = nn.Parameter(val, requires_grad=False)
            setattr(self, name, val)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def map(self, fn: Callable[[str, Tensor], Tensor]) -> "ParamTree":
        """A tree of the same structure whose leaf ``name`` (the dotted name
        ``named_parameters`` gives it) is ``fn(name, leaf)``."""
        return _map_tree(self, fn, "")


def _map_tree(mod: nn.Module, fn, prefix: str) -> nn.Module:
    if isinstance(mod, nn.ModuleList):
        return nn.ModuleList(_map_tree(c, fn, f"{prefix}{i}.")
                             for i, c in enumerate(mod))
    tree: dict = {n: fn(prefix + n, p) for n, p in mod._parameters.items()}
    tree.update({n: _map_tree(c, fn, f"{prefix}{n}.")
                 for n, c in mod._modules.items()})
    return ParamTree(tree)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

class ShapesOnly:
    """Stands in for a ``torch.Generator`` on the meta device, where none
    can live: ``normal_init`` draws nothing from it, so a model built from
    it has shapes and dtypes and no storage (``launch.specs.params_shape``).
    """
    device = torch.device("meta")


def generator(seed: int, device) -> "torch.Generator | ShapesOnly":
    """The generator a model's ``init_params`` draws from on ``device``
    (raises for the card without one), or ``ShapesOnly`` on ``meta``."""
    if torch.device(device).type == "meta":
        return ShapesOnly()
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def normal_init(gen: torch.Generator, shape: tuple[int, ...], scale: float,
                dtype: torch.dtype) -> Tensor:
    """N(0, scale^2) drawn in float32 from ``gen`` on its device.  torch
    cannot draw what ``jax.random`` draws: tests carry the reference's
    weights across with ``convert.lm_params_from_jax``."""
    if isinstance(gen, ShapesOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    dtype = x.dtype
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * rms).to(dtype) * weight.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half convention, float32 internals)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=64)
def _device_frequencies(head_dim: int, theta: float,
                        device: torch.device) -> Tensor:
    """``rope_frequencies`` on ``device``, uploaded once: a blocking upload
    in every decode step would make the host wait for the card."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _device_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (prefill: chunked over query blocks with a sliding KV window;
# decode: one token against a cache)
# ---------------------------------------------------------------------------

def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head H/KV times."""
    reps = n_heads // k.shape[2]
    if reps == 1:
        return k
    return torch.repeat_interleave(k, reps, dim=2)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: int, q_chunk: int) -> Tensor:
    """q: (B, S, H, hd); k, v: (B, S_kv, KV, hd) -> (B, S, H, hd).

    Queries go in chunks of ``q_chunk``; ``window > 0`` lets each query see
    the last ``window`` keys (SWA) and each chunk reads only a slice of
    ``window + q_chunk`` keys; ``window == 0`` reads every key.  The
    reference pads the last chunk to ``q_chunk``; here it is cut short, which
    changes no real row (the key slice is placed as for the padded chunk).
    """
    b, s, h, hd = q.shape
    s_kv = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / np.sqrt(hd)
    qc = min(q_chunk, s)
    slice_len = min(window + qc, s_kv) if window > 0 else s_kv
    outs = []
    for q_start in range(0, s, qc):
        q_blk = q[:, q_start: q_start + qc]
        k_start = min(max(q_start + qc - slice_len, 0),
                      max(s_kv - slice_len, 0))
        k_blk = k[:, k_start: k_start + slice_len]
        v_blk = v[:, k_start: k_start + slice_len]
        q_pos = torch.arange(q_start, q_start + q_blk.shape[1],
                             device=q.device)
        k_pos = torch.arange(k_start, k_start + slice_len, device=q.device)
        # the reference's float32 scores of compute-dtype operands
        scores = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(),
                              k_blk.float()) * scale
        mask = torch.ones(len(q_pos), slice_len, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v_blk))
    return torch.cat(outs, dim=1)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     entry_pos: Tensor, t: int, *, window: int) -> Tensor:
    """One-token attention against a cache.

    q: (B, H, hd); caches: (B, C, KVe, hd) with KVe | H; entry_pos: (C,)
    int32, the absolute position of each cache entry (-1 = empty, shared
    across the batch); t: the current position.  Serves linear caches (C =
    max_len) and SWA ring buffers (C = window) alike.
    """
    b, c, kve, hd = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, kve, h // kve, hd)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bkgd,bckd->bkgc", qg.float(),
                          k_cache.float()) * scale
    valid = (entry_pos >= 0) & (entry_pos <= t)
    if window > 0:
        valid &= entry_pos > t - window
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgc,bckd->bkgd", probs, v_cache)
    return out.reshape(b, h, hd)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + attention), shared by all families
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d ** -0.5
    out_scale = scale / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": normal_init(gen, (d, h, hd), scale, dtype),
        "wk": normal_init(gen, (d, kv, hd), scale, dtype),
        "wv": normal_init(gen, (d, kv, hd), scale, dtype),
        "wo": normal_init(gen, (h, hd, d), out_scale, dtype),
    }


def _project(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("...d,dhk->...hk", x, w)``; w already in x's dtype."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def qkv_project(p, x: Tensor, cfg) -> tuple[Tensor, Tensor, Tensor]:
    """x: (..., D) -> q (..., H, hd), k, v (..., KV, hd).

    ``cfg.fused_qkv`` runs one product with the concatenated ``wq|wk|wv``
    (the reference's ``_qkv_fused``).  Autograd through that product sums
    the three dx contributions in one product, as the reference's custom
    backward ``_qkv_fused_bwd`` does.  The parameters are the same either
    way.
    """
    dtype = x.dtype
    ws = [p[n].to(dtype) for n in ("wq", "wk", "wv")]
    if not getattr(cfg, "fused_qkv", False):
        return tuple(_project(x, w) for w in ws)
    d = x.shape[-1]
    qkv = x @ torch.cat([w.reshape(d, -1) for w in ws], dim=1)
    parts = qkv.split([w.shape[1] * w.shape[2] for w in ws], dim=-1)
    return tuple(part.unflatten(-1, w.shape[1:]) for part, w in zip(parts, ws))


def attention_block(p, x: Tensor, positions: Tensor, cfg, *,
                    causal: bool = True, window: int | None = None,
                    kv_override: tuple[Tensor, Tensor] | None = None,
                    par=None) -> Tensor:
    """x: (B, S, D) -> (B, S, D).  ``kv_override`` supplies cross-attention
    K/V (no rope, not causal).  With ``par`` (a ``distributed.parallel.
    Parallel`` whose query heads are split), the rank's heads of ``p``'s
    local slices, then ``wo``'s partial sums summed over ``model``."""
    dtype = x.dtype
    w = cfg.sliding_window if window is None else window
    if par is not None and par.q_split:
        xq = par.enter(x)
        if par.kv_split:
            q, k, v = qkv_project(p, xq, cfg)
        else:   # KV heads replicated: projected whole, each rank's taken
            q = _project(xq, p["wq"].to(dtype))
            k, v = (par.local_kv(par.enter(_project(x, p[n].to(dtype))))
                    for n in ("wk", "wv"))
        k = apply_rope(k, positions, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta)
    elif kv_override is None:
        q, k, v = qkv_project(p, x, cfg)
        k = apply_rope(k, positions, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta)
    else:
        q = _project(x, p["wq"].to(dtype))
        k, v = kv_override
    out = chunked_attention(q, k, v, causal=causal, window=w,
                            q_chunk=cfg.q_chunk)
    out = out.flatten(-2) @ p["wo"].to(dtype).flatten(0, 1)
    return par.exit(out) if par is not None and par.q_split else out


def project_kv(p, x: Tensor, positions: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """K/V projections (cache building, cross-attention memory)."""
    _, k, v = qkv_project(p, x, cfg)
    return k, v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    down_scale = f ** -0.5 / np.sqrt(2 * cfg.n_layers)
    return {
        "w_gate": normal_init(gen, (d, f), scale, dtype),
        "w_up": normal_init(gen, (d, f), scale, dtype),
        "w_down": normal_init(gen, (f, d), down_scale, dtype),
    }


def mlp_block(p, x: Tensor, par=None) -> Tensor:
    """SwiGLU; with ``par`` whose ff dim is split, column-parallel gate and
    up, row-parallel down, summed over ``model``."""
    dtype = x.dtype
    split = par is not None and par.ff_split
    if split:
        x = par.enter(x)
    gate = F.silu(x @ p["w_gate"].to(dtype))
    up = x @ p["w_up"].to(dtype)
    y = (gate * up) @ p["w_down"].to(dtype)
    return par.exit(y) if split else y
