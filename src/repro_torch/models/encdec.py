"""Encoder-decoder backbone (the Seamless-M4T-medium assignment).

A PyTorch copy of ``repro.models.encdec``.  The audio frontend is a stub:
callers supply frame embeddings (B, S_enc, D).  Encoder: non-causal
self-attention + SwiGLU; decoder: causal self-attention + cross-attention +
SwiGLU.  The decode cache comes only from ``prefill`` (the cross K/V need
the encoder's states); ``decode_step`` writes its K/V slot in place, as
``transformer.decode_step`` does.  ``cfg.remat`` recomputes each layer of
both stacks in the backward pass, as ``transformer.remat`` says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DEFAULT_DEVICE
from .layers import (ParamTree, _project, apply_rope, attention_block,
                     decode_attention, generator, init_attention, init_mlp,
                     mlp_block, normal_init, project_kv, rmsnorm)
from .transformer import _dtype, _pdtype, _repeat_kv_to, kv_eff_heads, remat

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


def _enc_block(lp, x: Tensor, positions: Tensor, cfg) -> Tensor:
    x = x + attention_block(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            positions, cfg, causal=False, window=0)
    return x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))


def encode(params, frames: Tensor, cfg) -> Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states."""
    x = frames.to(_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    block = remat(_enc_block, cfg)
    for lp in params["enc_layers"]:
        x = block(lp, x, positions, cfg)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(lp, x: Tensor, positions: Tensor, enc_out: Tensor, cfg
               ) -> Tensor:
    x = x + attention_block(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                            positions, cfg, causal=True)
    xk, xv = project_kv(lp["xattn"], enc_out, positions, cfg)
    x = x + attention_block(lp["xattn"], rmsnorm(x, lp["lnx"], cfg.norm_eps),
                            positions, cfg, causal=False, window=0,
                            kv_override=(xk, xv))
    return x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))


def forward(params, frames: Tensor, tokens: Tensor, cfg
            ) -> tuple[Tensor, Tensor]:
    """Teacher-forced forward.  Returns (logits (B, S_dec, V), aux = 0)."""
    dt = _dtype(cfg)
    enc_out = encode(params, frames, cfg)
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    positions = torch.arange(tokens.shape[1], device=x.device)
    block = remat(_dec_block, cfg)
    for lp in params["dec_layers"]:
        x = block(lp, x, positions, enc_out, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(dt), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def prefill(params, frames: Tensor, tokens: Tensor, cfg, *, tp: int = 1,
            max_len: int | None = None) -> tuple[Tensor, dict]:
    """Encode + run the decoder prompt; returns (last logits, cache); the
    self-attention cache holds ``kv_eff_heads(cfg, tp)`` KV heads."""
    kve = kv_eff_heads(cfg, tp)
    dt = _dtype(cfg)
    enc_out = encode(params, frames, cfg)
    s = tokens.shape[1]
    max_len = max_len or s
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    positions = torch.arange(s, device=x.device)
    entries: dict[str, list] = {"k": [], "v": [], "xk": [], "xv": []}
    pad = (0, 0, 0, 0, 0, max_len - s)
    for lp in params["dec_layers"]:
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        k, v = project_kv(lp["attn"], xn, positions, cfg)
        k = apply_rope(k, positions, cfg.rope_theta)
        entries["k"].append(F.pad(_repeat_kv_to(k, kve), pad))
        entries["v"].append(F.pad(_repeat_kv_to(v, kve), pad))
        xk, xv = project_kv(lp["xattn"], enc_out, positions, cfg)
        entries["xk"].append(xk)
        entries["xv"].append(xv)
        x = _dec_block(lp, x, positions, enc_out, cfg)
    x_last = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = x_last @ params["lm_head"].to(dt)

    cache = {name: torch.stack(ts) for name, ts in entries.items()}
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    pos0 = torch.arange(max_len, device=x.device)
    cache["entry_pos"] = torch.where(pos0 < s, pos0, -1).to(torch.int32)
    return logits, cache


def decode_step(params, cache: dict, token: Tensor, cfg
                ) -> tuple[Tensor, dict]:
    """One decoder token; the cross K/V stay as prefill left them."""
    dt = _dtype(cfg)
    t = int(cache["t"])
    slot = t % cache["k"].shape[2]
    entry_pos = cache["entry_pos"].clone()
    entry_pos[slot] = t
    x = F.embedding(token.long(), params["embed"]).to(dt)
    pos = torch.full((1,), t, device=x.device)
    s_enc = cache["xk"].shape[2]
    enc_pos = torch.arange(s_enc, device=x.device)
    for i, lp in enumerate(params["dec_layers"]):
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        ap = lp["attn"]
        q = _project(xn, ap["wq"].to(dt))
        k_new = _project(xn, ap["wk"].to(dt))
        v_new = _project(xn, ap["wv"].to(dt))
        q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], pos, cfg.rope_theta)[:, 0]
        k_c, v_c = cache["k"][i], cache["v"][i]
        kve = k_c.shape[-2]
        k_c[:, slot] = _repeat_kv_to(k_new, kve)
        v_c[:, slot] = _repeat_kv_to(v_new, kve)
        out = decode_attention(q, k_c, v_c, entry_pos, t, window=0)
        x = x + out.flatten(-2) @ ap["wo"].to(dt).flatten(0, 1)

        xp = lp["xattn"]
        qx = _project(rmsnorm(x, lp["lnx"], cfg.norm_eps), xp["wq"].to(dt))
        out = decode_attention(qx, cache["xk"][i], cache["xv"][i], enc_pos,
                               s_enc, window=0)
        x = x + out.flatten(-2) @ xp["wo"].to(dt).flatten(0, 1)
        x = x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(dt)

    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    new_cache["entry_pos"] = entry_pos
    return logits, new_cache
