"""Top-k mixture of experts at a fixed capacity (GShard drops), with
expert parallelism over a mesh; or, for a config with ``dropless`` set,
every assignment computed (one device).

A PyTorch copy of ``repro.models.moe``.  The capacity, each assignment's
place in its expert's queue and the aux loss belong to the reference's
token group (``Parallel.moe_axes``): a data shard where its experts split
over ``model``, else the whole batch.  Over a mesh a rank routes and runs
its own rows only; the group's count of assignments to each expert from
the rows before the rank's (``Parallel.moe_before``, an all-gather of E
ints where the group's rows lie on several ranks) offsets its places, so
it keeps and drops what the reference's group does.  With experts split
over ``model`` (``Parallel.ep``) the block runs the reference's
``shard_map`` body with its collectives written out.  The reference
all-gathers the token features, which it shards over ``model``; here
every model rank holds them whole already.  The tokens go through this
rank's experts only (ids ``[rank * E/tp, (rank + 1) * E/tp)``), and the
outputs are summed over ``model``.  The aux loss is the mean over the
groups of each group's.
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


def _places(idx: Tensor, el: int, capacity: int, e_offset: int = 0,
            before: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Each assignment's place in its expert's queue, counted over the
    (T x k) assignments flattened token-major as the reference counts
    them.  idx: (T, k) global expert ids; el experts held here from
    ``e_offset``; before: None, or (el,) the assignments to each of them
    from the token group's rows ahead of these, which queue first.
    Returns (lid, pos, keep), each (T*k,): the local id (``el`` for an
    expert held elsewhere), the place among these rows' assignments to
    the expert, and whether the group's place ``before + pos`` is under
    ``capacity``."""
    lid = idx.reshape(-1) - e_offset
    valid = (lid >= 0) & (lid < el)
    lid = torch.where(valid, lid, el)                         # el: not here
    pos = F.one_hot(lid, el + 1).cumsum(0).gather(1, lid[:, None])[:, 0] - 1
    place = pos if before is None else pos + F.pad(before, (0, 1))[lid]
    return lid, pos, valid & (place < capacity)


def _expert_ffn(xf: Tensor, idx: Tensor, gates: Tensor, wg: Tensor,
                wu: Tensor, wd: Tensor, *, capacity: int,
                e_offset: int = 0, before: Tensor | None = None) -> Tensor:
    """Apply the local experts to their tokens at a fixed capacity.

    xf: (T, D); idx: (T, k) global expert ids; gates: (T, k); wg/wu:
    (El, D, F); wd: (El, F, D); e_offset: the first global id held here;
    before: None, or (El,) the token group's assignments to each local
    expert from rows ahead of these (``_places``).  Returns (T, D).  A kept
    assignment goes to row ``pos`` of its expert's buffer (under
    min(capacity, T): an expert takes a token once); a dropped one (or one
    to an expert held elsewhere) to one spare row, cut off after.
    """
    t, k = idx.shape
    el = wg.shape[0]
    d = xf.shape[-1]
    dtype = xf.dtype

    lid, pos, keep = _places(idx, el, capacity, e_offset, before)
    rows = min(capacity, t)
    slot = torch.where(keep, lid * rows + pos, el * rows)
    token_of = torch.arange(t, device=xf.device).repeat_interleave(k)

    buf = xf.new_zeros(el * rows + 1, d)
    buf.index_add_(0, slot, xf[token_of])
    buf = buf[:-1].reshape(el, rows, d)

    h = F.silu(torch.bmm(buf, wg.to(dtype))) * torch.bmm(buf, wu.to(dtype))
    out = torch.bmm(h, wd.to(dtype)).reshape(el * rows, d)

    contrib = torch.where(keep, gates.reshape(-1), 0.0).to(dtype)
    picked = (out[slot.clamp(max=el * rows - 1)]
              * contrib[:, None]).reshape(t, k, d)
    # a token's k contributions summed in assignment order, on every device
    # the same (an index_add_ on the card adds in no fixed order)
    y = torch.zeros(t, d, dtype=dtype, device=xf.device)
    for j in range(k):
        y = y + picked[:, j]
    return y


def _dropless_ffn(xf: Tensor, idx: Tensor, gates: Tensor, wg: Tensor,
                  wu: Tensor, wd: Tensor) -> tuple[Tensor, Tensor]:
    """Every assignment through its expert, none dropped, at any T.

    xf: (T, D); idx, gates: (T, k); wg/wu: (E, D, F); wd: (E, F, D).
    The T*k assignments are sorted by expert (stably, so each expert's
    rows keep token order) and run as grouped products over each
    expert's run of rows (``torch._grouped_mm``).  The counts and the
    runs' ends stay on the device, so the host never waits for the card
    (``torch.bincount`` would: it reads the ids' range on the host).
    Returns (y (T, D): a token's k gated outputs summed in assignment
    order, counts (E,): the assignments to each expert)."""
    t, k = idx.shape
    dtype = xf.dtype
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(wg.shape[0], dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    ends = counts.cumsum(0).to(torch.int32)
    xs = xf[order // k]
    h = F.silu(torch._grouped_mm(xs, wg.to(dtype), offs=ends)) \
        * torch._grouped_mm(xs, wu.to(dtype), offs=ends)
    out = torch.empty_like(xs)
    out[order] = torch._grouped_mm(h, wd.to(dtype), offs=ends)
    picked = (out * gates.reshape(-1, 1).to(dtype)).reshape(t, k, -1)
    y = picked[:, 0]
    for j in range(1, k):
        y = y + picked[:, j]
    return y, counts


def _route(xf: Tensor, router_w: Tensor, e: int, k: int, par=None,
           renorm: bool = True):
    """Top-k gates (renormalised to sum to one unless ``renorm`` is False)
    and the load-balance aux loss; with ``par``, the aux loss's means are
    over the rank's token group, and the aux loss the mean over the
    groups."""
    logits = (xf @ router_w.to(xf.dtype)).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: larger first, the lower expert first on a tie; a
    # stable descending sort gives it on every device (torch.topk does not
    # promise an order for ties on the card)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    if renorm:
        gates = gates / gates.sum(-1, keepdim=True)
    assign = F.one_hot(idx[:, 0], e).float().mean(0)
    mean_probs = probs.mean(0)
    if par is not None:
        assign = par.moe_group_mean(assign)
        mean_probs = par.moe_group_mean(mean_probs)
    aux = e * torch.mean(assign * mean_probs)
    if par is not None:
        aux = par.moe_groups_mean(aux)
    return gates, idx, aux


def moe_block(p, x: Tensor, cfg, mesh=None, counts: list | None = None
              ) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) (or (B, D): one token a row) -> (y like x, aux_loss
    scalar).  One device: the B * S tokens of the call are one group.
    ``mesh``: None, or the ``Parallel`` the model runs under; x is the
    rank's rows.  ``cfg.dropless``: no capacity (one device only), and
    ``counts``, where given, gains the (E,) assignments to each expert."""
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, x.shape[-1])
    par = mesh
    gates, idx, aux = _route(xf, p["router"], e, k, par, cfg.renorm_gates)
    gates = gates.to(x.dtype)
    w = p["e_gate"], p["e_up"], p["e_down"]
    if cfg.dropless:
        y, n = _dropless_ffn(xf, idx, gates, *w)
        if counts is not None:
            counts.append(n)
        return y.reshape(x.shape), aux
    if par is None:
        cap = _capacity(len(xf), e, k, cfg.capacity_factor)
        return _expert_ffn(xf, idx, gates, *w, capacity=cap).reshape(
            x.shape), aux
    cap = _capacity(len(xf) * par.moe_ranks, e, k, cfg.capacity_factor)
    flat = idx.reshape(-1)
    before = par.moe_before(flat.new_zeros(e, dtype=torch.int32).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)))
    if not par.ep:
        y = _expert_ffn(xf, idx, gates, *w, capacity=cap, before=before)
        return y.reshape(x.shape), aux
    # the features are replicated over ``model``, so the routing is too;
    # the local experts' outputs are partial sums, so their replicated
    # inputs' gradients sum over ``model``
    el = e // par.tp
    lo = par.rank * el
    y = _expert_ffn(par.enter(xf), idx, par.enter(gates), *w, capacity=cap,
                    e_offset=lo, before=before[lo:lo + el])
    return par.exit(y).reshape(x.shape), aux
