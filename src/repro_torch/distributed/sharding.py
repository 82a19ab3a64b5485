"""Logical-axis sharding rules: parameter paths -> specs, with the divisor
rule (a dim only shards if its size divides the axis) and batch specs.

A PyTorch copy of ``repro.distributed.sharding``, the rules kept as data.
A spec is a tuple with one entry a dim: an axis name, a tuple of axis names
(the first one major) or None (replicated); it compares equal to the JAX
package's ``PartitionSpec`` of the same entries.  The Megatron-style
layout: vocab/heads/ff/experts/d_inner shard over ``model``; the batch
shards over ``("pod", "data")``; everything else is replicated.  ZeRO-1
rewrites optimizer moments to additionally shard a replicated dim over
``data``.

The rules see the reference's tree: a ``ParamTree`` leaf named per layer
(``layers.3.attn.wq``) belongs to the stacked path ``layers/attn/wq``, whose
shape has the layer count in front (``convert.reference_path``).  So
``param_specs``, ``zero1_specs`` and ``fsdp_param_specs`` return a dict
keyed by those stacked paths, with the reference's specs.  A rank holds of
each leaf the slices ``local_slices`` gives; for a per-layer leaf that is
row ``i`` of its stacked path's slices, or nothing where the layer axis is
sharded away from the rank (ZeRO-1 moments of a stack of layers).

A mesh here is anything with named axes: a ``DeviceMesh`` of
``launch.mesh`` (``mesh_dim_names``), or a stand-in with a ``shape`` dict
and ``axis_names``, as the JAX package's rules also accept.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from ..convert import reference_path

Spec = tuple

# (path regex, spec template). Templates apply to the *trailing* dims; leading
# dims (e.g. the stacked-layer L axis) are padded with None. Matched top-down,
# first hit wins.
_RULES: tuple[tuple[str, tuple], ...] = (
    (r"embed$",               ("model", None)),
    (r"lm_head$",             (None, "model")),
    (r"attn/wq$",             (None, "model", None)),
    (r"attn/wk$",             (None, "model", None)),
    (r"attn/wv$",             (None, "model", None)),
    (r"attn/wo$",             ("model", None, None)),
    (r"xattn/wq$",            (None, "model", None)),
    (r"xattn/wk$",            (None, "model", None)),
    (r"xattn/wv$",            (None, "model", None)),
    (r"xattn/wo$",            ("model", None, None)),
    (r"mlp/w_gate$",          (None, "model")),
    (r"mlp/w_up$",            (None, "model")),
    (r"mlp/w_down$",          ("model", None)),
    (r"moe/router$",          (None, None)),
    (r"moe/e_gate$",          ("model", None, None)),
    (r"moe/e_up$",            ("model", None, None)),
    (r"moe/e_down$",          ("model", None, None)),
    (r"ssm/in_proj$",         (None, "model")),
    (r"ssm/conv_w$",          (None, "model")),
    (r"ssm/conv_b$",          ("model",)),
    (r"ssm/x_proj$",          ("model", None)),
    (r"ssm/dt_proj$",         (None, "model")),
    (r"ssm/dt_bias$",         ("model",)),
    (r"ssm/a_log$",           ("model", None)),
    (r"ssm/d_skip$",          ("model",)),
    (r"ssm/out_proj$",        ("model", None)),
)


# -- meshes ------------------------------------------------------------------

def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a stand-in."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    return int(np.prod(list(mesh_shape(mesh).values()), dtype=np.int64))


def _axes(ax) -> tuple[str, ...]:
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def _axes_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in _axes(axes) if a in shape],
                       dtype=np.int64))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def batch_spec(mesh, ndim: int = 2) -> Spec:
    return (batch_axes(mesh), *([None] * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what a rank holds of an array (``local_slices``)."""
    mesh: Any
    spec: Spec

    def slices(self, shape) -> tuple[slice, ...]:
        return local_slices(self.spec, shape, self.mesh)


# -- the rules ---------------------------------------------------------------

def _spec_for(path_s: str, shape: tuple[int, ...], mesh,
              tensor_axes="model") -> Spec:
    """``tensor_axes`` is what the 'model' slot of the templates maps to."""
    for pat, template in _RULES:
        if re.search(pat, path_s):
            spec = [None] * (len(shape) - len(template)) + list(template)
            # divisor rule: drop axes that don't divide the dim (or trivial
            # size-1 axes: sharding there is replication with extra noise)
            out = []
            for dim, ax in zip(shape, spec):
                if ax == "model":
                    ax = tensor_axes
                n = _axes_size(mesh, ax) if ax is not None else 1
                out.append(ax if ax is not None and n > 1 and dim % n == 0
                           else None)
            return tuple(out)
    return ()  # replicated (norms, biases, scalars)


def stacked_shapes(params) -> dict[str, tuple[int, ...]]:
    """The reference's leaf paths and shapes of a ``ParamTree``: a
    per-layer leaf's path gets the layer count in front."""
    shapes: dict[str, tuple[int, ...]] = {}
    for name, p in params.named_parameters():
        rel, i = reference_path(name)
        shapes[rel] = tuple(p.shape) if i is None else \
            (shapes.get(rel, (0,))[0] + 1, *p.shape)
    return shapes


def param_specs(params_shape, mesh, *, tensor_axes="model") -> dict[str, Spec]:
    """``{stacked path: spec}`` for a params tree (a ``ParamTree``, such as
    ``launch.specs.params_shape``'s, or ``stacked_shapes``' dict)."""
    return {p: _spec_for(p, s, mesh, tensor_axes)
            for p, s in _shapes(params_shape).items()}


def param_shardings(params_shape, mesh, *, tensor_axes="model"
                    ) -> dict[str, NamedSharding]:
    return {p: NamedSharding(mesh, s) for p, s in param_specs(
        params_shape, mesh, tensor_axes=tensor_axes).items()}


def fsdp_param_specs(params_shape, mesh, *, axis: str = "model",
                     min_size: int = 1 << 16) -> dict[str, Spec]:
    """FSDP/ZeRO-3 layout: shard the largest divisible dim of every big param
    over ``axis``; activations stay batch-sharded.  The step all-gathers
    each weight at its use."""
    n = mesh_shape(mesh).get(axis, 1)

    def spec(shape):
        if n <= 1 or int(np.prod(shape, dtype=np.int64)) < min_size:
            return ()
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % n == 0 and shape[i] >= n:
                out = [None] * len(shape)
                out[i] = axis
                return tuple(out)
        return ()

    return {p: spec(s) for p, s in _shapes(params_shape).items()}


def zero1_specs(params_shape, mesh) -> dict[str, Spec]:
    """Optimizer-moment specs: the param spec with the first shardable
    replicated dim additionally sharded over ``data`` (ZeRO-1)."""
    dsize = mesh_shape(mesh).get("data", 1)

    def upgrade(path, shape):
        base = _spec_for(path, shape, mesh)
        spec = list(base) + [None] * (len(shape) - len(base))
        for i, (dim, ax) in enumerate(zip(shape, spec)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                spec[i] = "data"
                break
        return tuple(spec)

    return {p: upgrade(p, s) for p, s in _shapes(params_shape).items()}


def _shapes(params_shape) -> dict[str, tuple[int, ...]]:
    if isinstance(params_shape, dict):                 # stacked_shapes'
        return {k: tuple(v) for k, v in params_shape.items()}
    return stacked_shapes(params_shape)


# Cache specs: leaves are (L, B, C, KVe, hd) / (L, B, Di, N) / (L, B, cw-1, Di)
# / (C,) / scalar t.
def cache_specs(cache_shape: dict, mesh, *, tensor_axes="model"
                ) -> dict[str, Spec]:
    baxes = batch_axes(mesh)
    if tensor_axes != "model":
        baxes = ()  # 2D tensor sharding consumes the data axes

    def mdl(dim: int):
        n = _axes_size(mesh, tensor_axes)
        return tensor_axes if n > 1 and dim % n == 0 else None

    def spec(name, shp):
        if name in ("k", "v", "xk", "xv"):   # (L, B, C, KVe|KV, hd)
            return (None, _maybe_batch(shp[1], baxes, mesh), None,
                    mdl(shp[3]), None)
        if name == "h":                      # (L, B, Di, N)
            return (None, _maybe_batch(shp[1], baxes, mesh), mdl(shp[2]),
                    None)
        if name == "conv":                   # (L, B, cw-1, Di)
            return (None, _maybe_batch(shp[1], baxes, mesh), None,
                    mdl(shp[3]))
        return ()                            # entry_pos, t

    return {k: spec(k, tuple(v.shape)) for k, v in cache_shape.items()}


def _maybe_batch(dim: int, baxes: tuple[str, ...], mesh):
    n = _axes_size(mesh, baxes) if baxes else 1
    return baxes if n > 1 and dim % n == 0 else None


def batch_shardings(batch_shape: dict, mesh) -> dict[str, NamedSharding]:
    """Input batch dict: leading dim shards over ('pod','data') when
    divisible."""
    baxes = batch_axes(mesh)

    def spec(x):
        ndim = len(x.shape)
        lead = _maybe_batch(x.shape[0], baxes, mesh) if ndim else None
        return NamedSharding(mesh, (lead, *([None] * (max(ndim, 1) - 1))))

    return {k: spec(v) for k, v in batch_shape.items()}


# -- what a rank holds -------------------------------------------------------

def coordinate(mesh) -> dict[str, int]:
    """This rank's index along each axis of ``mesh``."""
    return dict(zip(axis_names(mesh), mesh.get_coordinate()))


def local_slices(spec: Spec, shape, mesh, coord: dict | None = None
                 ) -> tuple[slice, ...]:
    """The slice of each dim of a ``shape`` array that the rank at
    ``coord`` (default: this process's) holds under ``spec``: a dim
    sharded over axes (a0, a1, ...) is cut into prod(sizes) equal blocks,
    and the rank holds block number (c0 * n1 + c1) * n2 + ..., the first
    axis major, as JAX places them."""
    sizes = mesh_shape(mesh)
    coord = coordinate(mesh) if coord is None else coord
    out = []
    for i, dim in enumerate(shape):
        axes = _axes(spec[i]) if i < len(spec) else ()
        n, block = 1, 0
        for a in axes:
            n, block = n * sizes[a], block * sizes[a] + coord[a]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        step = dim // n
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


def leaf_slices(sharding: NamedSharding, stacked_shape, layer: int | None
                ) -> tuple[slice, ...] | None:
    """What the rank holds of one leaf: the leaf itself (``layer`` None) or
    row ``layer`` of a stacked path.  None where the layer axis is sharded
    away from the rank."""
    sl = local_slices(sharding.spec, stacked_shape, sharding.mesh)
    if layer is None:
        return sl
    if not sl[0].start <= layer < sl[0].stop:
        return None
    return sl[1:]


def sharded_axes(spec: Spec) -> tuple[str, ...]:
    return tuple(a for ax in spec for a in _axes(ax))


def shard_tree(tree, shardings: dict[str, NamedSharding], *,
               zeros: bool = False):
    """A ``ParamTree`` of what this rank holds of ``tree``'s leaves (full,
    per layer) under ``shardings`` (``{stacked path: NamedSharding}``):
    copies of the local slices, or zeros of their shapes (``zeros``, for
    optimizer moments), float32 for zeros; an empty tensor for a layer the
    rank does not hold."""
    shapes = stacked_shapes(tree)

    def piece(name, p):
        rel, i = reference_path(name)
        sl = leaf_slices(shardings[rel], shapes[rel], i)
        if sl is None:
            return p.new_empty(0, dtype=torch.float32 if zeros else p.dtype)
        if zeros:
            shape = [s.stop - s.start for s in sl]
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        return p[sl].clone()
    return tree.map(piece)
