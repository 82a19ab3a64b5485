"""Top-k mixture of experts at a fixed capacity (GShard drops), with
expert parallelism over a mesh.

A PyTorch copy of ``repro.models.moe``.  Over a mesh
(``distributed.parallel.Parallel`` with experts split over ``model``) the
block runs the reference's ``shard_map`` body with its collectives written
out.  The reference all-gathers the token features, which it shards over
``model``; here every model rank holds them whole already.  The tokens are
routed on the full features, sent through this rank's experts only (ids
``[rank * E/tp, (rank + 1) * E/tp)``) at the capacity of the data shard's
tokens, and the outputs summed over ``model``; the aux loss is the mean
over the data shards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import normal_init

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = d ** -0.5
    down_scale = f ** -0.5 / np.sqrt(2 * cfg.n_layers)
    return {
        "router": normal_init(gen, (d, e), scale, torch.float32),
        "e_gate": normal_init(gen, (e, d, f), scale, dtype),
        "e_up": normal_init(gen, (e, d, f), scale, dtype),
        "e_down": normal_init(gen, (e, f, d), down_scale, dtype),
    }


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(np.ceil(n_tokens * top_k / n_experts * factor))
    return max(8, -(-c // 8) * 8)


def _expert_ffn(xf: Tensor, idx: Tensor, gates: Tensor, wg: Tensor,
                wu: Tensor, wd: Tensor, *, capacity: int,
                e_offset: int = 0) -> Tensor:
    """Apply the local experts to their tokens at a fixed capacity.

    xf: (T, D); idx: (T, k) global expert ids; gates: (T, k); wg/wu:
    (El, D, F); wd: (El, F, D); e_offset: the first global id held here.
    Returns (T, D).  An assignment to a local expert is kept when its place
    among that expert's assignments, counted over the (T x k) assignments
    flattened token-major as the reference counts them, is under
    ``capacity``; a dropped one (or one to an expert held elsewhere) goes to
    one spare buffer row, cut off after.
    """
    t, k = idx.shape
    el = wg.shape[0]
    d = xf.shape[-1]
    dtype = xf.dtype

    lid = idx.reshape(-1) - e_offset                          # (T*k,)
    valid = (lid >= 0) & (lid < el)
    lid = torch.where(valid, lid, el)                         # el: not here
    pos = F.one_hot(lid, el + 1).cumsum(0) - 1                # place in expert
    pos = pos.gather(1, lid[:, None])[:, 0]
    keep = valid & (pos < capacity)
    slot = torch.where(keep, lid * capacity + pos, el * capacity)
    token_of = torch.arange(t, device=xf.device).repeat_interleave(k)

    buf = xf.new_zeros(el * capacity + 1, d)
    buf.index_add_(0, slot, xf[token_of])
    buf = buf[:-1].reshape(el, capacity, d)

    h = F.silu(torch.bmm(buf, wg.to(dtype))) * torch.bmm(buf, wu.to(dtype))
    out = torch.bmm(h, wd.to(dtype)).reshape(el * capacity, d)

    contrib = torch.where(keep, gates.reshape(-1), 0.0).to(dtype)
    picked = (out[slot.clamp(max=el * capacity - 1)]
              * contrib[:, None]).reshape(t, k, d)
    # a token's k contributions summed in assignment order, on every device
    # the same (an index_add_ on the card adds in no fixed order)
    y = torch.zeros(t, d, dtype=dtype, device=xf.device)
    for j in range(k):
        y = y + picked[:, j]
    return y


def _route(xf: Tensor, router_w: Tensor, e: int, k: int, par=None):
    """Top-k gates (renormalised) and the load-balance aux loss; with
    ``par``, the aux loss's means are over the whole batch."""
    logits = (xf @ router_w.to(xf.dtype)).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: larger first, the lower expert first on a tie; a
    # stable descending sort gives it on every device (torch.topk does not
    # promise an order for ties on the card)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    assign = F.one_hot(idx[:, 0], e).float().mean(0)
    mean_probs = probs.mean(0)
    if par is not None:
        assign, mean_probs = par.batch_mean(assign), par.batch_mean(mean_probs)
    aux = e * torch.mean(assign * mean_probs)
    return gates, idx, aux


def moe_block(p, x: Tensor, cfg, mesh=None) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) (or (B, D): one token a row) -> (y like x, aux_loss
    scalar).  The capacity counts the B * S tokens of the call (a data
    shard's tokens over a mesh, as the reference's ``b * s // n_data``).
    ``mesh``: None, or the ``Parallel`` the model runs under."""
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, x.shape[-1])
    par = mesh
    if par is not None and par.ep:
        el = e // par.tp
        # the features are replicated over ``model``, so the routing is too;
        # the local experts' outputs are partial sums, so their replicated
        # inputs' gradients sum over ``model``
        gates, idx, aux = _route(xf, p["router"], e, k)
        cap = _capacity(len(xf), e, k, cfg.capacity_factor)
        y = _expert_ffn(par.enter(xf), idx, par.enter(gates.to(x.dtype)),
                        p["e_gate"], p["e_up"], p["e_down"], capacity=cap,
                        e_offset=par.rank * el)
        # the reference sums aux over every mesh axis and divides by the
        # mesh size; the model axis's copies are equal, so that is the mean
        # over the data shards
        return par.exit(y).reshape(x.shape), par.batch_mean(aux)
    gates, idx, aux = _route(xf, p["router"], e, k, par)
    cap = _capacity(len(xf), e, k, cfg.capacity_factor)
    y = _expert_ffn(xf, idx, gates.to(x.dtype), p["e_gate"], p["e_up"],
                    p["e_down"], capacity=cap)
    return y.reshape(x.shape), aux
