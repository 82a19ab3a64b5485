"""Cross-rank reductions: the collectives of the mesh paths, the compressed
data-parallel gradient psum, and the mergeable top-k of the sharded query
plane.

Every collective the port issues over a mesh goes through the wrappers
here (``all_reduce``, ``all_gather``, ``reduce_scatter``, ``barrier``), one
mesh axis (a ``torch.distributed`` group) at a time; an axis of size 1
issues nothing.  Each wrapper counts its calls and the bytes it hands to the
backend by kind in ``obs`` (``mesh.all_reduce.calls``,
``mesh.all_reduce.bytes``, ...), so a caller can read what a step sent.
gloo carries every one of them on CUDA tensors as well as on the CPU's
(two ranks sharing one card), copying through the host inside the
backend; a backend that refuses one raises.

The autograd-aware forms carry the model's tensor parallelism, as the
reference's GSPMD and ``shard_map`` carry it:

* ``reduce_from``: all-reduce of partial sums in the forward, the gradient
  passed through (Megatron's ``g``: after a row-parallel product, a loss
  sum over the batch shards);
* ``copy_to``: the identity in the forward, the gradient all-reduced
  (Megatron's ``f``: a replicated activation entering column-parallel
  products);
* ``gather_from``: a sharded weight all-gathered at its use, the gradient
  reduce-scattered back to the shard (FSDP).

``compressed_psum`` is ``repro.distributed.collectives.compressed_psum``
over a mesh's axes: ``bf16`` casts, sums and casts back; ``int8``
quantises with one scale shared by the group (a MAX all-reduce), sums in
int32 and keeps the rounding error for the next step (error feedback).

``merge_topk`` merges padded per-shard top-k partials
(``store.planner.TopKPartial`` layout) into one, in the planner's own
(score desc, id asc) order, so S-shard answers equal the single-shard
ranking bit for bit.  A numpy copy of ``repro.distributed.collectives``'s.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import obs

TOPK_NEG_INF = np.float32(-np.inf)     # partial-row score padding


def merge_topk(scores_parts, ids_parts,
               top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge padded top-k partials from disjoint id sets into one partial.

    Each part is ``scores (Q, k_s) float32`` (``-inf`` = padding) plus
    ``ids (Q, k_s) int64`` (``-1`` = padding), rows ordered (score desc,
    id asc) — the ``QueryPlanner`` partial layout.  Selection here uses the
    same (score desc, id asc) order, which is exactly the single-shard
    planner's stable ranking (stable argsort over ascending union ids), so

        merge(shard partials) == single-shard top-k

    bit-for-bit.  The op is associative and commutative — parts may arrive
    in any order and merge in any grouping (a pairwise tree across hosts
    gives the same result as one flat concat) — because top-k under a strict
    total order is an associative reduction when id sets are disjoint.

    Returns ``(scores (Q, top_k), ids (Q, top_k))`` in partial layout.
    """
    scores = np.concatenate([np.asarray(s, np.float32)
                             for s in scores_parts], axis=1)
    ids = np.concatenate([np.asarray(i, np.int64)
                          for i in ids_parts], axis=1)
    q, m = scores.shape
    out_s = np.full((q, top_k), TOPK_NEG_INF, np.float32)
    out_i = np.full((q, top_k), -1, np.int64)
    if m == 0:
        return out_s, out_i
    take = min(top_k, m)
    # per-row lexsort: primary -score, secondary ascending id (padding rows
    # carry -inf scores and sink to the tail on their own)
    order = np.lexsort((ids, -scores))[:, :take]
    out_s[:, :take] = np.take_along_axis(scores, order, axis=1)
    out_i[:, :take] = np.take_along_axis(ids, order, axis=1)
    out_i[out_s <= TOPK_NEG_INF] = -1       # renormalize padding ids
    return out_s, out_i


# -- the wrappers ------------------------------------------------------------

def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _groups(mesh, axes):
    """The groups of ``axes`` (in order) with more than one rank."""
    from .sharding import mesh_shape
    shape = mesh_shape(mesh)
    return [mesh.get_group(a) for a in _axes(axes) if shape.get(a, 1) > 1]


def _count(kind: str, t: torch.Tensor) -> None:
    reg = obs.default()
    reg.counter(f"mesh.{kind}.calls").inc()
    reg.counter(f"mesh.{kind}.bytes").inc(t.numel() * t.element_size())


def counters() -> dict[str, int]:
    """The ``mesh.*`` counters of the process registry (calls and bytes by
    kind so far)."""
    return {k: v for k, v in obs.default().snapshot()["counters"].items()
            if k.startswith("mesh.")}


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (sum or max) over ``axes``, in place; returns ``t``."""
    groups = _groups(mesh, axes)
    buf = t if t.is_contiguous() else t.contiguous()
    for g in groups:
        _count("all_reduce", buf)
        dist.all_reduce(buf, op=_OPS[op], group=g)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along ``dim``, in the
    axis's rank order."""
    groups = _groups(mesh, axis)
    if not groups:
        return t
    (g,) = groups
    n = dist.get_world_size(g)
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(n)]
    _count("all_gather", t)
    dist.all_gather(outs, t, group=g)
    return torch.cat(outs, dim=dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """The sum over ``axis`` of ``t``, cut into equal blocks along ``dim``:
    the block of this rank's index along the axis."""
    groups = _groups(mesh, axis)
    if not groups:
        return t
    (g,) = groups
    n = dist.get_world_size(g)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    parts = [p.contiguous() for p in t.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    _count("reduce_scatter", t)
    dist.reduce_scatter(out, parts, group=g)
    return out


def barrier(mesh) -> None:
    """Every rank of ``mesh`` reaches this point (a one-element all-reduce
    over every axis)."""
    from .sharding import axis_names
    all_reduce(torch.zeros(1), mesh, axis_names(mesh))


# -- with gradients ----------------------------------------------------------

class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, _axes(axes)) if _groups(mesh, axes) \
        else x


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, _axes(axes)) if _groups(mesh, axes) else x


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, mesh, axis, dim) if _groups(mesh, axis) \
        else x


# -- compressed data-parallel gradient sums ----------------------------------

def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _psum_bf16(g: torch.Tensor, axes, mesh) -> torch.Tensor:
    return all_reduce(g.to(torch.bfloat16), mesh, axes).float()


def _psum_int8(g: torch.Tensor, err: torch.Tensor, axes, mesh
               ) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + err
    # shared scale across the reduction group (one extra scalar pmax) so the
    # int8 sum is exact in scale; per-shard scales would inject O(scale
    # variance) error that even error feedback only fixes in expectation
    scale = all_reduce(gf.abs().max(), mesh, axes, "max") / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale   # error feedback
    summed = all_reduce(q.to(torch.int32), mesh, axes).float()
    return summed * scale, new_err


def compressed_psum(grads, mode: str, axes, err_state=None, *, mesh):
    """Sum a gradient tree (dicts, lists, tensors) over ``mesh``'s
    ``axes`` with optional compression.  Returns (grads, new_err_state).
    torch rounds half to even, as ``jnp.round`` does."""
    if mode == "none":
        return _tree_map(lambda g: all_reduce(g.clone(), mesh, axes),
                         grads), err_state
    if mode == "bf16":
        return _tree_map(lambda g: _psum_bf16(g, axes, mesh), grads), \
            err_state
    if mode == "int8":
        if err_state is None:
            raise ValueError("int8 compression needs an error-feedback state")
        out = _tree_map(lambda g, e: _psum_int8(g, e, axes, mesh), grads,
                        err_state)
        return _pick(out, 0), _pick(out, 1)
    raise ValueError(f"unknown grad compression {mode!r}")


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def init_error_feedback(params):
    """Zeros (float32) shaped as each leaf of ``params`` (dicts, lists,
    tensors)."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
