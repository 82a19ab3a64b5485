"""How one rank runs a model over a mesh: the layout of its parameters and
batch, and the collectives each layer issues.

The reference leaves its dense layers to GSPMD and runs the MoE body in a
``shard_map``.  torch has no partitioner, so the port writes the
collectives out, following ``sharding._RULES``:

* ``mode="tp"`` (tensor parallel over ``model``, the batch over the data
  axes): the embedding's vocab rows are sharded (a masked lookup, then an
  all-reduce); ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` are
  column-parallel, ``wo`` and ``w_down`` row-parallel, each followed by an
  all-reduce; the head (or the tied embedding) is vocab-parallel and the
  loss a vocab-parallel cross-entropy (all-reduces of the max and of the
  sum of exponentials; the logits are never gathered).  A leaf that the
  divisor rule leaves replicated is computed replicated: KV heads that do
  not divide the axis are projected whole and each rank takes the heads
  its query heads read.  Experts shard over ``model`` (expert parallelism,
  the reference's ``shard_map`` body).
* ``mode="fsdp"``: every big leaf sharded along its largest divisible dim
  (``fsdp_param_specs``) and all-gathered at its use, the batch sharded
  over every axis.

Parameters passed with a ``Parallel`` are the rank's local slices
(``sharding.shard_tree``); a batch is the rank's own rows
(``data.loader.device_placer``).  Activations are replicated over
``model``.  Only the dense and moe families have a mesh forward; the
others raise (ROADMAP §1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import collectives as col
from .sharding import (axis_names, batch_axes, coordinate, fsdp_param_specs,
                       mesh_shape, param_specs, stacked_shapes)

MESH_FAMILIES = ("dense", "moe")


class Parallel:
    """The layout and collectives of ``cfg``'s model on ``mesh`` for this
    rank (``mode`` "tp" or "fsdp")."""

    def __init__(self, mesh, cfg, mode: str = "tp"):
        if cfg.is_encdec or cfg.family not in MESH_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): a forward over a mesh is ported "
                f"for the {' and '.join(MESH_FAMILIES)} families only; the "
                "others come later (ROADMAP §1)")
        if mode not in ("tp", "fsdp"):
            raise ValueError(f"unknown sharding mode {mode!r}")
        from ..models import transformer
        self.mesh, self.cfg, self.mode = mesh, cfg, mode
        meta = transformer.init_params(0, cfg, "meta")
        self.names = tuple(n for n, _ in meta.named_parameters())
        self.shapes = stacked_shapes(meta)
        rules = param_specs if mode == "tp" else fsdp_param_specs
        self.specs = rules(self.shapes, mesh)
        if any(p.startswith("layers/") and s and s[0] is not None
               for p, s in self.specs.items()):
            raise NotImplementedError(
                "a layout that shards the stacked layer axis of a parameter")
        sizes = mesh_shape(mesh)
        self.batch_axes = batch_axes(mesh) if mode == "tp" \
            else axis_names(mesh)
        self.n_batch = 1
        for a in self.batch_axes:
            self.n_batch *= sizes[a]
        self.tp = sizes.get("model", 1) if mode == "tp" else 1

        def split(path, dim):
            spec = self.specs.get(path, ())
            return mode == "tp" and dim < len(spec) and spec[dim] == "model"
        self.q_split = split("layers/attn/wq", 2)
        self.kv_split = split("layers/attn/wk", 2)
        self.ff_split = split("layers/mlp/w_gate", 2)
        self.vocab_split = split("embed", 0)
        self.head_split = self.vocab_split if cfg.tie_embeddings \
            else split("lm_head", 1)
        self.ep = split("layers/moe/e_gate", 1)
        self.rank = coordinate(mesh).get("model", 0) if self.tp > 1 else 0

    # -- activations ------------------------------------------------------
    def enter(self, x):
        """A replicated activation entering column-parallel products."""
        return col.copy_to(x, self.mesh, "model") if self.tp > 1 else x

    def exit(self, y):
        """Partial sums of a row-parallel product, summed over ``model``."""
        return col.reduce_from(y, self.mesh, "model") if self.tp > 1 else y

    def batch_sum(self, x):
        """A sum over the rank's rows, summed over the batch shards."""
        return col.reduce_from(x, self.mesh, self.batch_axes)

    def batch_mean(self, x):
        """A mean over the rank's rows -> the mean over the whole batch
        (the shards hold equal row counts)."""
        return self.batch_sum(x) / self.n_batch

    # -- weights ----------------------------------------------------------
    def weights(self, tree, prefix: str):
        """FSDP: the leaves of ``tree`` (the subtree at the stacked path
        ``prefix``, e.g. one layer at ``layers``) all-gathered to their full
        shapes, as nested dicts; tensor parallel: ``tree`` itself."""
        if self.mode != "fsdp":
            return tree
        out: dict = {}
        for name, p in tree.named_parameters():
            parts = name.split(".")
            path = "/".join([prefix, *parts]) if prefix else "/".join(parts)
            spec = self.specs[path]
            if prefix == "layers":
                spec = spec[1:]
            node = out
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = self.gather(p, spec)
        return out

    def gather(self, p, spec):
        for dim, ax in enumerate(spec):
            if ax is not None:
                p = col.gather_from(p, self.mesh, ax, dim)
        return p

    def leaf(self, params, name: str):
        """A top-level leaf (``embed``, ``lm_head``) as the forward uses it."""
        p = params[name]
        return self.gather(p, self.specs[name]) if self.mode == "fsdp" else p

    # -- the vocab-parallel ends ------------------------------------------
    def vocab_range(self, n_local: int) -> tuple[int, int]:
        return self.rank * n_local, (self.rank + 1) * n_local

    def embed(self, table, tokens):
        """Rows of a vocab-sharded table: a masked lookup, then a sum over
        ``model``."""
        lo, hi = self.vocab_range(table.shape[0])
        tokens = tokens.long()
        valid = (tokens >= lo) & (tokens < hi)
        rows = F.embedding(torch.where(valid, tokens - lo, 0), table)
        return self.exit(rows * valid[..., None].to(rows.dtype))

    def logits(self, x, head):
        """x @ head: the rank's vocab columns where the head is split."""
        return (self.enter(x) if self.head_split else x) @ head

    def gather_vocab(self, logits):
        """The full vocab of vocab-sharded logits (serving; no gradient)."""
        if not self.head_split:
            return logits
        return col.all_gather(logits, self.mesh, "model", -1)

    def lm_loss(self, logits, targets, mask):
        """Next-token cross-entropy over the whole batch, float32, the mean
        of ``repro.models.transformer.lm_loss``: the rank's rows summed,
        then summed over the batch shards.  Vocab-sharded logits: the max
        and the sum of exponentials all-reduced over ``model``."""
        logits = logits.float()
        targets = targets.long()
        if self.head_split:
            lo, hi = self.vocab_range(logits.shape[-1])
            m = col.all_reduce(logits.detach().amax(-1), self.mesh, "model",
                               "max")
            sumexp = self.exit(torch.exp(logits - m[..., None]).sum(-1))
            valid = (targets >= lo) & (targets < hi)
            picked = logits.gather(-1, torch.where(
                valid, targets - lo, 0)[..., None])[..., 0]
            picked = self.exit(picked * valid)
            nll = torch.log(sumexp) + m - picked
        else:
            logp = F.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
        mask = mask.float()
        total = col.all_reduce(mask.sum(), self.mesh, self.batch_axes)
        return self.batch_sum((nll * mask).sum()) / total.clamp(min=1.0)

    # -- attention --------------------------------------------------------
    def heads(self) -> tuple[int, int]:
        """The global query heads of this rank."""
        n = self.cfg.n_heads // self.tp
        return self.rank * n, (self.rank + 1) * n

    def local_kv(self, k):
        """(..., KV, hd) projected whole -> the KV head each of this rank's
        query heads reads, (..., H/tp, hd)."""
        h0, h1 = self.heads()
        group = self.cfg.n_heads // k.shape[-2]
        idx = torch.arange(h0, h1, device=k.device) // group
        return k.index_select(-2, idx)

    def cache_heads(self, k, kve: int):
        """K or V as the rank projected it, (..., heads, hd), its own KV
        heads where ``wk`` is split, else all -> its block of the cache's
        ``kve`` heads (each KV head replicated up to ``kve``, as
        ``cache_specs`` shards them over ``model``)."""
        if self.tp == 1:
            return torch.repeat_interleave(k, kve // k.shape[-2], dim=-2)
        if not self.q_split or kve % self.tp:
            raise NotImplementedError(
                f"a cache of {kve} KV heads over a model axis of {self.tp} "
                "with query heads split "
                f"{'so' if self.q_split else 'not'}: pass tp = the model "
                "axis's size where the heads allow (ROADMAP §1)")
        n = kve // self.tp
        if self.kv_split:
            return torch.repeat_interleave(k, n // k.shape[-2], dim=-2)
        full = torch.repeat_interleave(k, kve // k.shape[-2], dim=-2)
        return full[..., self.rank * n:(self.rank + 1) * n, :]


def parallel_for(mesh, cfg, mode: str = "tp") -> Parallel | None:
    """None for no mesh; a ``Parallel`` as given; otherwise the
    tensor-parallel layout of ``cfg`` on ``mesh``."""
    if mesh is None or isinstance(mesh, Parallel):
        return mesh
    return Parallel(mesh, cfg, mode)
