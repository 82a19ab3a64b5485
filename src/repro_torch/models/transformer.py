"""Decoder-only LM assembly: forward, prefill and decode for every decoder
family (dense / moe / ssm / hybrid / vlm).

A PyTorch copy of ``repro.models.transformer``.  Where the reference stacks
layer parameters on a leading L axis for ``lax.scan``, the port keeps one
``ParamTree`` a layer in an ``nn.ModuleList`` and loops over them.  Caches
keep the reference's keys and shapes (``k``/``v``: (L, B, C, KVe, hd),
``entry_pos``: (C,), ``h``: (L, B, Di, N), ``conv``: (L, B, cw-1, Di),
``t``), so they compare one-to-one with the reference's.  Two differences
of form: ``t`` stays on the host (a 0-d int32 CPU tensor), so a decode step
never waits for the card to learn its slot; and ``decode_step`` writes the
new K/V slot and SSM state into the cache's tensors in place (the returned
dict shares them), where the reference returns new arrays.
``cfg.remat == "block"`` recomputes each layer's block in the backward
pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``) wherever autograd records the forward; the serving
path runs under ``torch.no_grad()``, where it has no effect.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DEFAULT_DEVICE, resolve_or_meta
from .layers import (ParamTree, _project, apply_rope, attention_block,
                     decode_attention, generator, init_attention, init_mlp,
                     mlp_block, normal_init, project_kv, qkv_project, rmsnorm)
from .moe import init_moe, moe_block
from .ssm import init_ssm, ssm_block, ssm_decode_step

Tensor = torch.Tensor


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def has_attention(cfg) -> bool:
    """Some layer attends."""
    return any("attn" in cfg.mixer(i) for i in range(cfg.n_layers))


def has_ssm(cfg) -> bool:
    """Some layer has a Mamba mixer."""
    return any("ssm" in cfg.mixer(i) for i in range(cfg.n_layers))


def n_layers_of(cfg, kind: str) -> int:
    """Layers whose mixer has ``kind`` ("attn", "ssm") or, for "moe",
    whose second branch routes to experts: the leading dim of that kind's
    cache tensors (all ``n_layers`` where every layer is alike)."""
    return sum(kind in (cfg.ffn(i) if kind == "moe" else cfg.mixer(i))
               for i in range(cfg.n_layers))


def kv_eff_heads(cfg, tp: int = 1) -> int:
    """Decode-cache KV head count: replicate KV heads up to the TP degree when
    that enables clean sharding (the reference's rule)."""
    kv, h = cfg.n_kv_heads, cfg.n_heads
    if kv % tp == 0:
        return kv
    if tp % kv == 0 and h % tp == 0:
        return tp
    return kv


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg, i: int = 0) -> dict:
    """Layer ``i``'s weights (its mixer and second branch by
    ``cfg.mixer(i)`` and ``cfg.ffn(i)``)."""
    dt = _pdtype(cfg)
    mixer, ffn = cfg.mixer(i), cfg.ffn(i)
    p: dict = {"ln1": torch.ones(cfg.d_model, dtype=dt, device=gen.device)}
    if "attn" in mixer:
        p["attn"] = init_attention(gen, cfg, dt)
    if "ssm" in mixer:
        p["ssm"] = init_ssm(gen, cfg, dt)
    if ffn == "moe":
        p["moe"] = init_moe(gen, cfg, dt)
        p["ln2"] = torch.ones(cfg.d_model, dtype=dt, device=gen.device)
    elif ffn == "mlp":
        p["mlp"] = init_mlp(gen, cfg, dt)
        p["ln2"] = torch.ones(cfg.d_model, dtype=dt, device=gen.device)
    return p


def params_from_tree(tree: dict) -> ParamTree:
    """``{"embed", "layers": [one dict a layer], "final_norm"[, "lm_head"]}``
    of tensors -> the model's ``ParamTree``."""
    tree = dict(tree)
    tree["layers"] = nn.ModuleList(ParamTree(lp) for lp in tree["layers"])
    return ParamTree(tree)


def init_params(seed: int, cfg, device: str | torch.device = DEFAULT_DEVICE
                ) -> ParamTree:
    """Random weights drawn on ``device`` from ``seed`` (raises for the card
    without one)."""
    gen = generator(seed, device)
    dev = gen.device
    dt = _pdtype(cfg)
    tree = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "layers": [init_layer(gen, cfg, i) for i in range(cfg.n_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size),
                                      cfg.d_model ** -0.5, dt)
    return params_from_tree(tree)


def _leaf(params, name: str, par=None) -> Tensor:
    """A top-level weight as the forward uses it (FSDP gathers it)."""
    return params[name] if par is None else par.leaf(params, name)


def _head(params, cfg, par=None) -> Tensor:
    return _leaf(params, "embed", par).T if cfg.tie_embeddings \
        else _leaf(params, "lm_head", par)


def _logits(params, x: Tensor, cfg, par=None) -> Tensor:
    """x @ the head; over a vocab-split mesh, the rank's vocab columns."""
    head = _head(params, cfg, par).to(x.dtype)
    return x @ head if par is None else par.logits(x, head)


def _embed(params, tokens: Tensor, dt: torch.dtype,
           prefix_embeddings: Tensor | None, par=None) -> Tensor:
    if par is not None and par.vocab_split:
        x = par.embed(params["embed"], tokens).to(dt)
    else:
        x = F.embedding(tokens.long(), _leaf(params, "embed", par)).to(dt)
    if prefix_embeddings is not None:  # VLM/multimodal stub: overwrite prefix
        p = prefix_embeddings.shape[1]
        x = torch.cat([prefix_embeddings.to(dt), x[:, p:]], dim=1)
    return x


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def remat(fn, cfg):
    """``fn`` recomputed in the backward pass when ``cfg.remat == "block"``
    and autograd records the call; ``fn`` itself otherwise."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def _ffn(lp, x: Tensor, cfg, par=None, layer: int = 0,
         counts: list | None = None) -> tuple[Tensor, Tensor | None]:
    """Layer ``layer``'s second residual branch on x: (B, S, D) or (B, D)
    -> (x, aux loss or None).  ``counts``: ``moe_block``'s list of each
    MoE layer's (E,) assignment counts."""
    kind = cfg.ffn(layer)
    if kind == "moe":
        y, aux = moe_block(lp["moe"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg,
                           par, counts=counts)
        return x + y, aux
    if kind == "mlp":
        return x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                             par), None
    return x, None


def block_forward(lp, x: Tensor, positions: Tensor, cfg, mesh=None,
                  layer: int = 0) -> tuple[Tensor, Tensor]:
    """Layer ``layer``, full sequence.  Returns (x, aux_loss).  ``mesh``:
    None, or the ``distributed.parallel.Parallel`` the model runs under
    (FSDP gathers the layer's weights here, so a remat recompute gathers
    them again)."""
    par = mesh
    if par is not None:
        lp = par.weights(lp, "layers")
    xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    delta = torch.zeros_like(x)
    mixer = cfg.mixer(layer)
    if "attn" in mixer:
        delta = delta + attention_block(lp["attn"], xn, positions, cfg,
                                        par=par)
    if "ssm" in mixer:
        y, _, _ = ssm_block(lp["ssm"], xn, cfg, par=par)
        delta = delta + y
    x, aux = _ffn(lp, x + delta, cfg, par, layer)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# Forward: tokens (B, S) [+ optional prefix embeddings] -> logits
# ---------------------------------------------------------------------------

def forward(params, tokens: Tensor, cfg, mesh=None,
            prefix_embeddings: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, V), aux_loss scalar).  Over a mesh
    (a ``DeviceMesh`` or a ``distributed.parallel.Parallel``), ``params``
    are the rank's local slices, ``tokens`` its rows, and the logits its
    vocab columns where the head is vocab-split."""
    from ..distributed.parallel import parallel_for
    par = parallel_for(mesh, cfg)
    dt = _dtype(cfg)
    x = _embed(params, tokens, dt, prefix_embeddings, par)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = remat(block_forward, cfg)
    for i, lp in enumerate(params["layers"]):
        x, a = block(lp, x, positions, cfg, par, i)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, par), aux


def lm_loss(logits: Tensor, targets: Tensor, mask: Tensor, mesh=None
            ) -> Tensor:
    """Next-token cross-entropy (caller supplies aligned targets/mask),
    float32.  Over a mesh (a ``Parallel``): the mean over the whole batch,
    vocab-parallel where the logits are vocab-split."""
    if mesh is not None:
        return mesh.lm_loss(logits, targets, mask)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_len(cfg, max_len: int) -> int:
    return min(cfg.sliding_window, max_len) if cfg.sliding_window > 0 \
        else max_len


def init_cache(cfg, batch: int, max_len: int,
               device: str | torch.device = DEFAULT_DEVICE, tp: int = 1
               ) -> dict:
    """Decode cache (zeros/empty).  max_len includes prompt + generation;
    ``kv_eff_heads(cfg, tp)`` KV heads; on ``meta``, shapes only.  K/V
    for the layers that attend, ``h``/``conv`` for those with a Mamba
    mixer (every layer where all are alike); with dropless experts,
    ``expert_load`` and ``expert_hits`` (``_count_experts``)."""
    kve = kv_eff_heads(cfg, tp)
    dev = resolve_or_meta(device)
    dt = _dtype(cfg)
    cache: dict = {"t": torch.tensor(0, dtype=torch.int32)}
    if has_attention(cfg):
        n = n_layers_of(cfg, "attn")
        shape = (n, batch, cache_len(cfg, max_len), kve, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["entry_pos"] = torch.full((shape[2],), -1, dtype=torch.int32,
                                        device=dev)
    if has_ssm(cfg):
        n = n_layers_of(cfg, "ssm")
        cache["h"] = torch.zeros(n, batch, cfg.d_inner, cfg.ssm_state,
                                 dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(n, batch, cfg.ssm_conv - 1, cfg.d_inner,
                                    dtype=dt, device=dev)
    if cfg.dropless:
        for name in ("expert_load", "expert_hits"):
            cache[name] = torch.zeros(n_layers_of(cfg, "moe"), cfg.n_experts,
                                      dtype=torch.int32, device=dev)
    return cache


def _count_experts(cache: dict, counts: list, decode: bool) -> None:
    """Fold one call's per-MoE-layer (E,) assignment counts into the
    cache, on the card: ``expert_load`` the assignments of the prompt and
    every decode step, ``expert_hits`` the decode steps that gave each
    expert a token."""
    step = torch.stack(counts).to(torch.int32)
    if not decode:
        cache["expert_load"] = step
        cache["expert_hits"] = torch.zeros_like(step)
        return
    cache["expert_load"] += step
    cache["expert_hits"] += (step > 0).to(torch.int32)


def _repeat_kv_to(k: Tensor, kve: int) -> Tensor:
    """(..., KV, hd) -> (..., KVe, hd) by replication (KVe % KV == 0)."""
    kv = k.shape[-2]
    if kv == kve:
        return k
    return torch.repeat_interleave(k, kve // kv, dim=-2)


# ---------------------------------------------------------------------------
# Prefill: run the prompt, build a decode-ready cache
# ---------------------------------------------------------------------------

def _ring(k: Tensor, c: int) -> Tensor:
    """(B, S, KVe, hd) -> the cache's (B, C, KVe, hd): with S >= C the last
    C entries at ring slots pos % C, else the S entries then zeros."""
    s = k.shape[1]
    if s < c:
        return F.pad(k, (0, 0, 0, 0, 0, c - s))
    slots = (s - c + torch.arange(c, device=k.device)) % c
    ring = k.new_zeros(k.shape[0], c, *k.shape[2:])
    ring[:, slots] = k[:, -c:]
    return ring


def _entry_pos(s: int, c: int, device) -> Tensor:
    """(C,) int32 absolute position of each cache slot after an S-token
    prompt (-1 = empty)."""
    pos0 = torch.arange(c, device=device)
    if s >= c:
        entry_pos = torch.zeros(c, dtype=torch.int32, device=device)
        entry_pos[(s - c + pos0) % c] = torch.arange(
            s - c, s, dtype=torch.int32, device=device)
        return entry_pos
    return torch.where(pos0 < s, pos0, -1).to(torch.int32)


def prefill(params, tokens: Tensor, cfg, mesh=None, *, tp: int = 1,
            max_len: int | None = None,
            prefix_embeddings: Tensor | None = None) -> tuple[Tensor, dict]:
    """Returns (last-position logits (B, V), cache).  The cache holds
    ``kv_eff_heads(cfg, tp)`` KV heads (each replicated up to the TP
    degree, as the reference's).  Over a mesh (``tp`` the model axis):
    the rank's rows, the logits of its vocab columns where the head is
    split, the rank's block of the cache's KV heads where they split
    over ``model`` and all of them where not, and its SSM channels
    (``cache_specs``)."""
    from ..distributed.parallel import parallel_for
    par = parallel_for(mesh, cfg)
    kve = kv_eff_heads(cfg, tp)
    if par is not None and has_attention(cfg):
        par.check_cache(kve)
    dt = _dtype(cfg)
    s = tokens.shape[1]
    c = cache_len(cfg, max_len or s)
    x = _embed(params, tokens, dt, prefix_embeddings, par)
    positions = torch.arange(s, device=x.device)
    entries: dict[str, list] = {}
    counts = [] if cfg.dropless else None
    for i, lp in enumerate(params["layers"]):
        if par is not None:
            lp = par.weights(lp, "layers")
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        delta = torch.zeros_like(x)
        mixer = cfg.mixer(i)
        if "attn" in mixer:
            delta = delta + attention_block(lp["attn"], xn, positions, cfg,
                                            par=par)
            k, v = project_kv(lp["attn"], xn, positions, cfg)
            if cfg.use_rope:
                k = apply_rope(k, positions, cfg.rope_theta)
            entries.setdefault("k", []).append(_ring(_cache_heads(k, kve, par),
                                                     c))
            entries.setdefault("v", []).append(_ring(_cache_heads(v, kve, par),
                                                     c))
        if "ssm" in mixer:
            y, h_fin, conv_tail = ssm_block(lp["ssm"], xn, cfg, par=par)
            delta = delta + y
            entries.setdefault("h", []).append(h_fin)
            entries.setdefault("conv", []).append(conv_tail)
        x, _ = _ffn(lp, x + delta, cfg, par, i, counts)

    x_last = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x_last, cfg, par)

    cache = {name: torch.stack(ts) for name, ts in entries.items()}
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    if has_attention(cfg):
        cache["entry_pos"] = _entry_pos(s, c, x.device)
    if counts is not None:
        _count_experts(cache, counts, decode=False)
    return logits, cache


def _cache_kve(k_cache: Tensor, par) -> int:
    """The global KV heads of a self-attention cache (L, B, C, heads, hd)
    of which this rank holds ``k_cache`` (one device: all of them)."""
    n = k_cache.shape[-2]
    return n if par is None else par.cache_kve(n)


def _cache_heads(k: Tensor, kve: int, par) -> Tensor:
    """(..., KV, hd) projected K or V -> the cache's heads (all ``kve`` on
    one device, the rank's block over a mesh)."""
    return _repeat_kv_to(k, kve) if par is None else par.cache_heads(k, kve)


# ---------------------------------------------------------------------------
# Decode: one token against the cache
# ---------------------------------------------------------------------------

def decode_step(params, cache: dict, token: Tensor, cfg, mesh=None
                ) -> tuple[Tensor, dict]:
    """token: (B,) int.  Returns (logits (B, V), the cache one step on).
    Over a mesh: the rank's rows and its block of the cache (``prefill``
    over the same mesh); the logits of its vocab columns where the head is
    split."""
    from ..distributed.parallel import parallel_for
    par = parallel_for(mesh, cfg)
    dt = _dtype(cfg)
    t = int(cache["t"])
    x = _embed(params, token[:, None], dt, None, par)[:, 0]    # (B, D)
    new_cache = dict(cache)
    if has_attention(cfg):
        slot = t % cache["k"].shape[2]
        entry_pos = cache["entry_pos"].clone()
        entry_pos[slot:slot + 1].fill_(t)   # a kernel; no copy from the host
        new_cache["entry_pos"] = entry_pos
        pos = torch.full((1,), t, device=x.device)
        kve = _cache_kve(cache["k"], par)

    counts = [] if cfg.dropless else None
    ai = si = 0                      # the layer's row of the K/V, h caches
    for i, lp in enumerate(params["layers"]):
        if par is not None:
            lp = par.weights(lp, "layers")
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        delta = torch.zeros_like(x)
        mixer = cfg.mixer(i)
        if "attn" in mixer:
            delta = delta + decode_self_attention(
                lp["attn"], xn, cache["k"][ai], cache["v"][ai], entry_pos,
                slot, t, pos, kve, cfg, par)
            ai += 1
        if "ssm" in mixer:
            y, h_new, conv_new = ssm_decode_step(
                lp["ssm"], xn, cache["h"][si], cache["conv"][si], cfg, par)
            delta = delta + y
            cache["h"][si] = h_new
            cache["conv"][si] = conv_new
            si += 1
        x, _ = _ffn(lp, x + delta, cfg, par, i, counts)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, par)
    if counts is not None:
        _count_experts(new_cache, counts, decode=True)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    return logits, new_cache


def decode_self_attention(ap, xn: Tensor, k_cache: Tensor, v_cache: Tensor,
                          entry_pos: Tensor, slot: int, t: int, pos: Tensor,
                          kve: int, cfg, par, window: int | None = None
                          ) -> Tensor:
    """One token's self-attention branch: writes its K/V into slot
    ``slot`` of one layer's caches (B, C, heads, hd) in place and returns
    the branch's output (B, D).  Over a mesh whose query heads split, the
    rank's heads against its block of the cache, or, where the cache's
    ``kve`` heads do not split, the heads its query heads read of the whole
    cache; ``wo``'s partial sums summed over ``model``.  Query heads that
    do not split run whole on every rank."""
    dt = xn.dtype
    split = par is not None and par.q_split
    if split and not par.kv_split:     # KV heads projected whole
        q = _project(xn, ap["wq"].to(dt))
        k_new, v_new = (_project(xn, ap[n].to(dt)) for n in ("wk", "wv"))
    else:
        q, k_new, v_new = qkv_project(ap, xn, cfg)
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], pos, cfg.rope_theta)[:, 0]
    k_cache[:, slot] = _cache_heads(k_new, kve, par)
    v_cache[:, slot] = _cache_heads(v_new, kve, par)
    if split and not par.cache_split(kve):
        k_cache, v_cache = par.local_kv(k_cache), par.local_kv(v_cache)
    out = decode_attention(q, k_cache, v_cache, entry_pos, t,
                           window=cfg.sliding_window if window is None
                           else window)
    out = out.flatten(-2) @ ap["wo"].to(dt).flatten(0, 1)
    return par.exit(out) if split else out
