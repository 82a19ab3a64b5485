"""Cost analysis of a traced PyTorch program: the counterpart of
``repro.analysis.hlo``.

There is no HLO here.  The reference parses the compiled HLO text of a
jitted step; PyTorch runs eagerly, so ``analyze(fn, *args, **kwargs)``
runs ``fn`` under a ``TorchDispatchMode`` that sees every aten operation
it issues (on ``meta`` tensors, a trace at full size that allocates and
computes nothing) and every collective the port's counted wrappers issue
(``distributed.collectives.watch``), and counts as the reference counts:

* products: 2 x output x contracted elements (``torch.utils.
  flop_counter``'s formulas: mm, bmm, addmm, baddbmm, convolutions,
  attention);
* elementwise operations: the output's element count, for the aten
  counterparts of the reference's ``_ELEMENTWISE_FLOP_OPS``; reductions:
  their operand's element count;
* ``bytes_naive``: every operation's operand and output bytes (views, which
  move nothing, excluded; a slice, which the reference's HLO copies, is
  charged 2 x its output);
* ``bytes``: the perfect-fusion proxy, charged only at the counterparts of
  the reference's ``_MATERIALIZING`` ops (operands + output), its slices (2
  x output) and writes into a slice (2 x the update), plus the program's
  inputs read once and outputs written once;
* collectives: the ring formulas over each call's group size g:
  all-reduce 2 (g - 1) / g x size, all-gather (g - 1) / g x the gathered
  output, reduce-scatter (g - 1) / g x the input.

A loop over layers runs once a trip, so every layer is counted: the
reference's scan-aware multipliers come for free.  ``HloCost`` keeps the
reference's fields; ``peak_temp_bytes`` is the most bytes that the
program's own operations held live at once (tracked per output tensor),
what ``launch.dryrun`` reports as ``temp_bytes``.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..distributed import collectives

# the aten counterparts of the reference's _ELEMENTWISE_FLOP_OPS (add,
# subtract, multiply, divide, power, maximum, minimum, tanh, exponential,
# log, rsqrt, sqrt, negate, abs, compare, select, and/or/xor, floor, ceil,
# round, expm1, log1p, logistic, cosine, sine), each with its in-place form
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "tanh",
    "exp", "log", "rsqrt", "sqrt", "neg", "abs", "eq", "ne", "lt", "le",
    "gt", "ge", "where", "bitwise_and", "bitwise_or", "bitwise_xor",
    "logical_and", "logical_or", "logical_xor", "logical_not", "floor",
    "ceil", "round", "expm1", "log1p", "sigmoid", "cos", "sin",
    "reciprocal", "clamp", "clamp_min", "clamp_max", "silu", "gelu",
    "softplus", "erf", "square",
}
_REDUCE = {"sum", "mean", "amax", "amin", "prod", "max", "min", "any",
           "all", "logsumexp", "norm", "linalg_vector_norm", "cumsum",
           "argmax", "argmin", "_softmax", "_log_softmax", "var_mean",
           "var", "std"}
# the counterparts of the reference's _MATERIALIZING (dot, convolution,
# scatter, gather, copy, transpose, concatenate, pad, reverse, sort, rng,
# reduce, reduce-window, select-and-scatter, cholesky, triangular-solve)
_MATERIALIZING = {
    "mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
    "convolution_backward", "_convolution", "scatter", "scatter_add",
    "scatter_reduce", "index_put", "index_add", "_index_put_impl",
    "gather", "index_select", "embedding", "embedding_dense_backward",
    "index", "copy", "_to_copy", "clone", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "sort", "topk", "rand", "randn",
    "randint", "bernoulli", "normal", "uniform", "cholesky",
    "linalg_cholesky_ex", "triangular_solve", "linalg_solve_triangular",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
} | _REDUCE
_SLICE = {"slice", "narrow", "select"}
_SLICE_WRITE = {"slice_scatter", "select_scatter"}


def _name(func) -> str:
    """``aten.add_.Tensor`` -> ``add`` (the in-place form shares the name)."""
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of a tree of lists, tuples, dicts and modules (a
    ``ParamTree``'s parameters), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class _Unkeyed(Exception):
    pass


def _key(tree):
    """A hashable stand-in for an operation's arguments: each tensor by its
    metadata, everything else as it is (raises ``_Unkeyed`` where that is
    not hashable)."""
    if isinstance(tree, torch.Tensor):
        return (tree.device.type, tree.dtype, tuple(tree.shape),
                tree.stride())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, *(_key(x) for x in tree))
    if isinstance(tree, dict):
        return ("dict", *((k, _key(v)) for k, v in tree.items()))
    try:
        hash(tree)
    except TypeError:
        raise _Unkeyed from None
    return tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def nbytes(tree) -> int:
    """The bytes of a tree's distinct tensors (``_tensors``)."""
    seen: dict[int, torch.Tensor] = {}
    for t in _tensors(tree):
        seen.setdefault(id(t), t)
    return sum(_nbytes(t) for t in seen.values())


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes: float              # perfect-fusion proxy (roofline memory term)
    bytes_naive: float        # every op's operand+output (upper bound)
    collective_bytes: float
    collective_breakdown: dict[str, float]
    n_collectives: int
    top_collectives: list = dataclasses.field(default_factory=list)
    # [(wire_bytes, kind, calls, type_str, hint)] descending
    peak_temp_bytes: float = 0.0


# the wrappers' kinds, by the reference's HLO names
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter"}


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """A rank's wire bytes for one collective of ``nbytes`` handed to the
    backend over a group of ``g``: the reference's ring formulas."""
    if g <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * (g - 1.0) / g * nbytes
    if kind == "all_gather":
        return (g - 1.0) / g * nbytes * g       # the gathered output
    if kind == "reduce_scatter":
        return (g - 1.0) / g * nbytes           # the input
    raise ValueError(f"unknown collective {kind!r}")


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_fused = 0.0
        self.bytes_naive = 0.0
        self.coll = 0.0
        self.breakdown: dict[str, float] = defaultdict(float)
        self.n_coll = 0
        self.colls: dict[tuple, list] = {}
        self.live = 0
        self.peak = 0
        # (op, arguments' metadata) -> its outputs' (shape, stride, dtype):
        # on meta tensors an output's metadata follows from the inputs', so
        # a repeated operation (a layer's, a scan chunk's) skips its meta
        # kernel (most are Python reference implementations, ~0.2 ms each)
        self.memo: dict = {}

    def collective(self, kind: str, t: torch.Tensor, g: int) -> None:
        wb = wire_bytes(kind, _nbytes(t), g)
        name = _KINDS[kind]
        self.coll += wb
        self.breakdown[name] += wb
        self.n_coll += 1
        key = (name, f"{str(t.dtype)[6:]}{list(t.shape)} g={g}")
        entry = self.colls.setdefault(key, [0.0, 0])
        entry[0] += wb
        entry[1] += 1

    def _dead(self, n: int) -> None:
        self.live -= n

    def _run(self, func, args, kwargs):
        if func.is_view or func._schema.is_mutable or not all(
                t.device.type == "meta" for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except _Unkeyed:
            return func(*args, **kwargs)
        meta = self.memo.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self.memo[key] = (out.shape, out.stride(), out.dtype)
            elif isinstance(out, (tuple, list)) and out and all(
                    isinstance(t, torch.Tensor) for t in out):
                self.memo[key] = [(t.shape, t.stride(), t.dtype)
                                  for t in out]
            return out
        if isinstance(meta, tuple):
            return torch.empty_strided(*meta[:2], dtype=meta[2],
                                       device="meta")
        return tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                     for sh, st, dt in meta)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        name = _name(func)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        elif name in _ELEMENTWISE:
            self.flops += sum(t.numel() for t in outs)
        elif name in _REDUCE and ins:
            self.flops += ins[0].numel()
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        if name in _SLICE:
            # a view here, a copy in the reference's HLO: the slice read
            # and written (not its whole operand, which a loop's slice of a
            # stacked buffer would charge once a trip)
            self.bytes_naive += 2.0 * out_bytes
            self.bytes_fused += 2.0 * out_bytes
            return out
        if func.is_view:
            return out
        self.bytes_naive += in_bytes + out_bytes
        if name in _SLICE_WRITE:
            self.bytes_fused += 2.0 * (_nbytes(ins[1]) if len(ins) > 1
                                       else out_bytes)
        elif name == "copy" and ins and ins[0]._base is not None:
            # a write into a slice of a buffer (a cache update): the
            # reference's dynamic-update-slice, 2 x the update
            self.bytes_fused += 2.0 * _nbytes(ins[1] if len(ins) > 1
                                              else ins[0])
        elif name in _MATERIALIZING:
            self.bytes_fused += in_bytes + out_bytes
        held = {id(t) for t in ins}
        for t in outs:
            if id(t) in held:
                continue                       # in place: nothing new
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._dead, n)
        self.peak = max(self.peak, self.live)
        return out


def analyze(fn, *args, **kwargs) -> HloCost:
    """Run ``fn(*args, **kwargs)`` once under the cost mode and return its
    counts (see the module docstring).  Pass ``meta`` tensors to trace at
    full size without memory or arithmetic."""
    mode = _CostMode()
    with collectives.watch(mode.collective), mode:
        out = fn(*args, **kwargs)
    # entry I/O: inputs read once, outputs written once (an output that is
    # an input updated in place counts once)
    mode.bytes_fused += nbytes((args, kwargs, out))
    top = sorted(((wb, kind, n, shape, "") for (kind, shape), (wb, n)
                  in mode.colls.items()), key=lambda e: -e[0])
    return HloCost(flops=float(mode.flops), bytes=float(mode.bytes_fused),
                   bytes_naive=float(mode.bytes_naive),
                   collective_bytes=mode.coll,
                   collective_breakdown=dict(mode.breakdown),
                   n_collectives=mode.n_coll, top_collectives=top[:20],
                   peak_temp_bytes=float(mode.peak))
