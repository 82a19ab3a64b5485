"""Encoder-decoder backbone (the Seamless-M4T-medium assignment).

A PyTorch copy of ``repro.models.encdec``.  The audio frontend is a stub:
callers supply frame embeddings (B, S_enc, D).  Encoder: non-causal
self-attention + SwiGLU; decoder: causal self-attention + cross-attention +
SwiGLU.  The decode cache comes only from ``prefill`` (the cross K/V need
the encoder's states); ``decode_step`` writes its K/V slot in place, as
``transformer.decode_step`` does.  ``cfg.remat`` recomputes each layer of
both stacks in the backward pass, as ``transformer.remat`` says.

Every function takes ``par`` (a ``distributed.parallel.Parallel``, or
None): over a mesh the parameters are the rank's slices, the frames and
tokens its rows; the vocab-parallel embedding, head and loss, the
attention heads (self and cross) and the MLP split as in the decoder
families (``transformer``); FSDP gathers each layer of either stack at
its use; a cache holds the rank's heads of ``k``/``v`` and ``xk``/``xv``
(``cache_specs``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DEFAULT_DEVICE
from .layers import (ParamTree, _project, apply_rope, attention_block,
                     decode_attention, generator, init_attention, init_mlp,
                     mlp_block, normal_init, project_kv, rmsnorm)
from .transformer import (_cache_heads, _cache_kve, _dtype, _embed, _logits,
                          _pdtype, decode_self_attention, kv_eff_heads, remat)

Tensor = torch.Tensor


def init_enc_layer(gen: torch.Generator, cfg) -> dict:
    dt = _pdtype(cfg)
    ones = torch.ones(cfg.d_model, dtype=dt, device=gen.device)
    return {"ln1": ones, "attn": init_attention(gen, cfg, dt),
            "ln2": ones.clone(), "mlp": init_mlp(gen, cfg, dt)}


def init_dec_layer(gen: torch.Generator, cfg) -> dict:
    dt = _pdtype(cfg)
    ones = torch.ones(cfg.d_model, dtype=dt, device=gen.device)
    return {"ln1": ones, "attn": init_attention(gen, cfg, dt),
            "lnx": ones.clone(), "xattn": init_attention(gen, cfg, dt),
            "ln2": ones.clone(), "mlp": init_mlp(gen, cfg, dt)}


def params_from_tree(tree: dict) -> ParamTree:
    """``{"embed", "enc_layers", "dec_layers" (one dict a layer),
    "enc_norm", "final_norm", "lm_head"}`` of tensors -> the model's
    ``ParamTree``."""
    tree = dict(tree)
    for name in ("enc_layers", "dec_layers"):
        tree[name] = nn.ModuleList(ParamTree(lp) for lp in tree[name])
    return ParamTree(tree)


def init_params(seed: int, cfg, device: str | torch.device = DEFAULT_DEVICE
                ) -> ParamTree:
    """Random weights drawn on ``device`` from ``seed`` (raises for the card
    without one)."""
    gen = generator(seed, device)
    dev = gen.device
    dt = _pdtype(cfg)
    return params_from_tree({
        "enc_layers": [init_enc_layer(gen, cfg)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [init_dec_layer(gen, cfg) for _ in range(cfg.n_layers)],
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "enc_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        "lm_head": normal_init(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.d_model ** -0.5, dt),
    })


def _layer(lp, par, stack: str):
    """One layer's weights as the forward uses them (FSDP gathers them)."""
    return lp if par is None else par.weights(lp, stack)


def _enc_block(lp, x: Tensor, positions: Tensor, cfg, par=None) -> Tensor:
    lp = _layer(lp, par, "enc_layers")
    x = x + attention_block(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            positions, cfg, causal=False, window=0, par=par)
    return x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), par)


def encode(params, frames: Tensor, cfg, par=None) -> Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states."""
    x = frames.to(_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    block = remat(_enc_block, cfg)
    for lp in params["enc_layers"]:
        x = block(lp, x, positions, cfg, par)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp, x: Tensor, positions: Tensor, enc_out: Tensor, cfg,
               par) -> Tensor:
    x = x + attention_block(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            positions, cfg, causal=True, par=par)
    xk, xv = project_kv(lp["xattn"], enc_out, positions, cfg, par)
    x = x + attention_block(lp["xattn"], rmsnorm(x, lp["lnx"], cfg.norm_eps),
                            positions, cfg, causal=False, window=0,
                            kv_override=(xk, xv), par=par)
    return x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), par)


def _dec_block(lp, x: Tensor, positions: Tensor, enc_out: Tensor, cfg,
               par=None) -> Tensor:
    return _dec_layer(_layer(lp, par, "dec_layers"), x, positions, enc_out,
                      cfg, par)


def forward(params, frames: Tensor, tokens: Tensor, cfg, par=None
            ) -> tuple[Tensor, Tensor]:
    """Teacher-forced forward.  Returns (logits (B, S_dec, V), aux = 0);
    over a vocab-split mesh, the rank's vocab columns."""
    dt = _dtype(cfg)
    enc_out = encode(params, frames, cfg, par)
    x = _embed(params, tokens, dt, None, par)
    positions = torch.arange(tokens.shape[1], device=x.device)
    block = remat(_dec_block, cfg)
    for lp in params["dec_layers"]:
        x = block(lp, x, positions, enc_out, cfg, par)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, par), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def prefill(params, frames: Tensor, tokens: Tensor, cfg, *, tp: int = 1,
            max_len: int | None = None, par=None) -> tuple[Tensor, dict]:
    """Encode + run the decoder prompt; returns (last logits, cache); the
    self-attention cache holds ``kv_eff_heads(cfg, tp)`` KV heads (over a
    mesh, ``tp`` the model axis: the rank's block where they split)."""
    kve = kv_eff_heads(cfg, tp)
    if par is not None:
        par.check_cache(kve)
    dt = _dtype(cfg)
    enc_out = encode(params, frames, cfg, par)
    s = tokens.shape[1]
    max_len = max_len or s
    x = _embed(params, tokens, dt, None, par)
    positions = torch.arange(s, device=x.device)
    entries: dict[str, list] = {"k": [], "v": [], "xk": [], "xv": []}
    pad = (0, 0, 0, 0, 0, max_len - s)
    for lp in params["dec_layers"]:
        lp = _layer(lp, par, "dec_layers")
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        k, v = project_kv(lp["attn"], xn, positions, cfg)
        k = apply_rope(k, positions, cfg.rope_theta)
        entries["k"].append(F.pad(_cache_heads(k, kve, par), pad))
        entries["v"].append(F.pad(_cache_heads(v, kve, par), pad))
        xk, xv = project_kv(lp["xattn"], enc_out, positions, cfg)
        entries["xk"].append(xk)
        entries["xv"].append(xv)
        x = _dec_layer(lp, x, positions, enc_out, cfg, par)
    x_last = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x_last, cfg, par)

    cache = {name: torch.stack(ts) for name, ts in entries.items()}
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    pos0 = torch.arange(max_len, device=x.device)
    cache["entry_pos"] = torch.where(pos0 < s, pos0, -1).to(torch.int32)
    return logits, cache


def decode_step(params, cache: dict, token: Tensor, cfg, par=None
                ) -> tuple[Tensor, dict]:
    """One decoder token; the cross K/V stay as prefill left them."""
    dt = _dtype(cfg)
    t = int(cache["t"])
    slot = t % cache["k"].shape[2]
    entry_pos = cache["entry_pos"].clone()
    entry_pos[slot] = t
    x = _embed(params, token[:, None], dt, None, par)[:, 0]
    pos = torch.full((1,), t, device=x.device)
    kve = _cache_kve(cache["k"], par)
    s_enc = cache["xk"].shape[2]
    enc_pos = torch.arange(s_enc, device=x.device)
    xsplit = par is not None and par.xq_split
    for i, lp in enumerate(params["dec_layers"]):
        lp = _layer(lp, par, "dec_layers")
        x = x + decode_self_attention(
            lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cache["k"][i],
            cache["v"][i], entry_pos, slot, t, pos, kve, cfg, par, window=0)

        xp = lp["xattn"]
        qx = _project(rmsnorm(x, lp["lnx"], cfg.norm_eps), xp["wq"].to(dt))
        xk, xv = cache["xk"][i], cache["xv"][i]
        if xsplit and not par.xkv_split:   # whole KV: the rank's query heads'
            xk, xv = par.local_kv(xk), par.local_kv(xv)
        out = decode_attention(qx, xk, xv, enc_pos, s_enc, window=0)
        out = out.flatten(-2) @ xp["wo"].to(dt).flatten(0, 1)
        x = x + (par.exit(out) if xsplit else out)
        x = x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), par)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, par)

    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    new_cache["entry_pos"] = entry_pos
    return logits, new_cache
