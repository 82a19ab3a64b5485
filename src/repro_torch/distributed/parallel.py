"""How one rank runs a model over a mesh: the layout of its parameters and
batch, and the collectives each layer issues.

The reference leaves its dense layers to GSPMD and runs the MoE body in a
``shard_map``.  torch has no partitioner, so the port writes the
collectives out, following ``sharding._RULES``:

* ``mode="tp"`` (tensor parallel over ``model``, the batch over the data
  axes): the embedding's vocab rows are sharded (a masked lookup, then an
  all-reduce); ``wq``/``wk``/``wv`` (self- and cross-attention) and
  ``w_gate``/``w_up`` are column-parallel, ``wo`` and ``w_down``
  row-parallel, each followed by an all-reduce; the head (or the tied
  embedding) is vocab-parallel and the loss a vocab-parallel cross-entropy
  (all-reduces of the max and of the sum of exponentials; the logits are
  never gathered).  A leaf that the divisor rule leaves replicated is
  computed replicated: KV heads that do not divide the axis are projected
  whole and each rank takes the heads its query heads read; query heads
  that do not divide it (hymba's 25) run the whole attention on every
  rank, as does a decode cache whose heads do not split.  Experts shard
  over ``model`` (expert parallelism, the reference's ``shard_map`` body).
  The SSM shards its ``d_inner`` channels: ``x_proj`` and ``out_proj`` are
  row-parallel, ``dt_proj`` column-parallel, the scan and the caches the
  rank's channels; ``in_proj``'s stored block is a block of the
  concatenated ``[x | z]`` columns, so its product is all-gathered
  (``ssm_in``).
* ``mode="fsdp"``: every big leaf sharded along its largest divisible dim
  (``fsdp_param_specs``) and all-gathered at its use, the batch sharded
  over every axis.

In either mode an MoE keeps the reference's token groups (``moe_axes``):
its capacity, queue places and aux loss are a data shard's where the
experts split over ``model``, else the whole batch's, however the rows
lie on the ranks.

Parameters passed with a ``Parallel`` are the rank's local slices
(``sharding.shard_tree``); a batch is the rank's own rows
(``data.loader.device_placer``): the encoder's frames too.  Activations
are replicated over ``model``.  Every family runs over a mesh.

``tensor_axes`` is what the rules' ``model`` slot maps to
(``sharding.param_specs``): ``"model"``, or a tuple of axes whose product
splits the tensor dims, the first axis major, as the reference's dry run
lays out the batch-starved SSM decode over ``("data", "model")``; the
data axes then hold no batch (it is replicated over them), and every
``model`` collective above runs over the tuple.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import collectives as col
from .sharding import (axis_names, batch_axes, coordinate, fsdp_param_specs,
                       mesh_shape, param_specs, stacked_shapes)


class Parallel:
    """The layout and collectives of ``cfg``'s model on ``mesh`` for this
    rank (``mode`` "tp" or "fsdp")."""

    def __init__(self, mesh, cfg, mode: str = "tp", tensor_axes="model"):
        if cfg.layer_period != 1:
            raise NotImplementedError(
                f"{cfg.name}: its layers follow a pattern (mixer and FFN "
                f"differ by layer), which no mesh layout covers; run it on "
                f"one device (mesh=None)")
        if mode not in ("tp", "fsdp"):
            raise ValueError(f"unknown sharding mode {mode!r}")
        if mode == "fsdp" and tensor_axes != "model":
            raise ValueError("fsdp takes no tensor_axes")
        from ..models import encdec, transformer
        self.mesh, self.cfg, self.mode = mesh, cfg, mode
        model = encdec if cfg.is_encdec else transformer
        meta = model.init_params(0, cfg, "meta")
        self.names = tuple(n for n, _ in meta.named_parameters())
        self.shapes = stacked_shapes(meta)
        # the stacked prefixes: a leaf there has the layer count in front
        self.stacks = ("enc_layers", "dec_layers") if cfg.is_encdec \
            else ("layers",)
        self.specs = param_specs(self.shapes, mesh, tensor_axes=tensor_axes) \
            if mode == "tp" else fsdp_param_specs(self.shapes, mesh)
        if any(p.split("/")[0] in self.stacks and s and s[0] is not None
               for p, s in self.specs.items()):
            raise NotImplementedError(
                "a layout that shards the stacked layer axis of a parameter")
        sizes = mesh_shape(mesh)
        self.tensor_axes = tensor_axes
        self.axes = (tensor_axes,) if isinstance(tensor_axes, str) \
            else tuple(tensor_axes)
        if mode == "fsdp":
            self.batch_axes = axis_names(mesh)
        else:   # tensor dims over the data axes consume them
            self.batch_axes = tuple(a for a in batch_axes(mesh)
                                    if a not in self.axes)
        self.tp = math.prod(sizes.get(a, 1) for a in self.axes) \
            if mode == "tp" else 1

        def split(path, dim):
            spec = self.specs.get(path, ())
            return mode == "tp" and dim < len(spec) and \
                spec[dim] == tensor_axes
        body = self.stacks[-1]        # the decoder's stack
        self.q_split = split(f"{body}/attn/wq", 2)
        self.kv_split = split(f"{body}/attn/wk", 2)
        self.xq_split = split("dec_layers/xattn/wq", 2)
        self.xkv_split = split("dec_layers/xattn/wk", 2)
        self.ff_split = split(f"{body}/mlp/w_gate", 2)
        self.ssm_split = split("layers/ssm/out_proj", 1)
        if split("layers/ssm/in_proj", 2) != self.ssm_split:
            raise NotImplementedError(
                f"in_proj's 2 x {cfg.d_inner} columns split over a model "
                f"axis of {self.tp} while the {cfg.d_inner} SSM channels "
                "do not")
        self.vocab_split = split("embed", 0)
        self.head_split = self.vocab_split if cfg.tie_embeddings \
            else split("lm_head", 1)
        self.ep = split("layers/moe/e_gate", 1)
        self.moe_axes = self._moe_axes(sizes) if cfg.n_experts else ()
        self.moe_ranks = math.prod(sizes[a] for a in self.moe_axes)
        # the rank's block of the tensor axes' product, the first major
        coord = coordinate(mesh) if self.tp > 1 else {}
        self.rank = 0
        for a in self.axes:
            self.rank = self.rank * sizes.get(a, 1) + coord.get(a, 0)
        # the KV heads of a decode cache over this mesh (``cache_specs``
        # splits them over ``model`` where they divide it), and those of
        # a cache built with any other ``tp``
        self.kve = transformer.kv_eff_heads(cfg, self.tp)
        self.kves = {transformer.kv_eff_heads(cfg, t)
                     for t in range(1, cfg.n_heads + 1)}

    # -- activations ------------------------------------------------------
    def enter(self, x):
        """A replicated activation entering column-parallel products."""
        return col.copy_to(x, self.mesh, self.axes) if self.tp > 1 else x

    def exit(self, y):
        """Partial sums of a row-parallel product, summed over ``model``."""
        return col.reduce_from(y, self.mesh, self.axes) if self.tp > 1 \
            else y

    def batch_sum(self, x):
        """A sum over the rank's rows, summed over the batch shards."""
        return col.reduce_from(x, self.mesh, self.batch_axes)

    # -- the MoE's token groups ------------------------------------------
    def _moe_axes(self, sizes) -> tuple[str, ...]:
        """The reference's MoE token groups (``repro.models.moe.moe_block``)
        follow the mesh alone, whatever the layout: one a data shard (the
        rows of the non-``model`` axes' block) where its experts split over
        ``model`` (a model axis of tp > 1 dividing n_experts and d_model),
        else the whole batch.  Returns the axes over which a group's rows
        lie on ranks holding different rows (the rank's rows are a block of
        its group's, the first axis major)."""
        tp = sizes.get("model", 1)
        e, d = self.cfg.n_experts, self.cfg.d_model
        if not (tp > 1 and e % tp == 0 and d % tp == 0):
            return self.batch_axes
        shard_axes = [a for a in axis_names(self.mesh)
                      if a != "model" and sizes[a] > 1]
        if any(a not in self.batch_axes for a in shard_axes) or (
                "model" in self.batch_axes
                and self.batch_axes[-1] != "model"):
            raise NotImplementedError(
                f"MoE token groups of the data shards over rows laid out "
                f"over {self.batch_axes}")
        return tuple(a for a in self.batch_axes if a == "model")

    def moe_group_mean(self, x):
        """A mean over the rank's rows -> the mean over its token group's."""
        return col.reduce_from(x, self.mesh, self.moe_axes) / self.moe_ranks

    def moe_groups_mean(self, x):
        """A value of the rank's token group -> the mean over the groups
        (the batch axes the groups differ along)."""
        axes = tuple(a for a in self.batch_axes if a not in self.moe_axes)
        n = math.prod(mesh_shape(self.mesh)[a] for a in axes)
        return col.reduce_from(x, self.mesh, axes) / n

    def moe_before(self, counts):
        """(E,) int32 assignments to each expert from the rank's rows ->
        those from its token group's rows before the rank's, in the
        batch's row order (an all-gather over each of ``moe_axes`` wider
        than one rank; none where the rank's rows are its group's)."""
        if self.moe_ranks == 1:
            return torch.zeros_like(counts)
        every = col.all_gather(counts[None], self.mesh, self.moe_axes, 0)
        coord, sizes = coordinate(self.mesh), mesh_shape(self.mesh)
        i = 0
        for a in self.moe_axes:
            i = i * sizes[a] + coord[a]
        return every[:i].sum(0, dtype=counts.dtype)

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
            if prefix in self.stacks:
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
        return col.all_gather(logits, self.mesh, self.axes, -1)

    def lm_loss(self, logits, targets, mask):
        """Next-token cross-entropy over the whole batch, float32, the mean
        of ``repro.models.transformer.lm_loss``: the rank's rows summed,
        then summed over the batch shards.  Vocab-sharded logits: the max
        and the sum of exponentials all-reduced over ``model``."""
        logits = logits.float()
        targets = targets.long()
        if self.head_split:
            lo, hi = self.vocab_range(logits.shape[-1])
            m = col.all_reduce(logits.detach().amax(-1), self.mesh,
                               self.axes, "max")
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

    def cache_split(self, kve: int) -> bool:
        """Whether a cache of ``kve`` heads splits over ``model``
        (``cache_specs``); where not, each rank holds every head."""
        return self.tp > 1 and kve % self.tp == 0

    def cache_heads(self, k, kve: int):
        """K or V as the rank projected it, (..., heads, hd), its own KV
        heads where ``wk`` is split, else all -> its block of the cache's
        ``kve`` heads (each KV head replicated up to ``kve``, as
        ``cache_specs`` shards them over ``model``), or all ``kve`` where
        they do not split.  A cache that does not split has heads that do
        not divide the axis, so ``wk`` was not split and ``k`` is whole."""
        n = kve // self.tp
        if self.kv_split and self.cache_split(kve):
            return torch.repeat_interleave(k, n // k.shape[-2], dim=-2)
        full = torch.repeat_interleave(k, kve // k.shape[-2], dim=-2)
        if not self.cache_split(kve):
            return full
        return full[..., self.rank * n:(self.rank + 1) * n, :]

    def held(self, kve: int) -> int:
        """The heads a rank holds of a cache of ``kve`` KV heads."""
        return kve // self.tp if self.cache_split(kve) else kve

    def check_cache(self, kve: int) -> None:
        """A cache of ``kve`` = ``kv_eff_heads(cfg, tp)`` heads, built over
        this mesh, must be one whose layout ``cache_kve`` reads back from
        the heads a rank holds: any ``tp`` but one whose held count is
        also that of another ``tp``'s cache (that of ``tp`` = the model
        axis is taken)."""
        if self.tp > 1 and self.cache_kve(self.held(kve)) != kve:
            raise ValueError(
                f"a cache of {kve} KV heads over a model axis of {self.tp} "
                f"holds {self.held(kve)} a rank, as one of "
                f"{self.cache_kve(self.held(kve))} does: pass tp={self.tp}")

    def cache_kve(self, held: int) -> int:
        """The global KV heads of a cache of which this rank holds ``held``
        heads a layer (``prefill`` over this mesh built it): the one
        ``kv_eff_heads(cfg, tp)`` over every ``tp`` whose rank holds
        ``held``, or, where several do, that of ``tp`` = the model axis."""
        if self.tp == 1:
            return held
        kves = {k for k in self.kves if self.held(k) == held}
        if self.kve in kves:
            return self.kve
        if len(kves) != 1:
            raise ValueError(
                f"a cache of {held} KV heads a rank over a model axis of "
                f"{self.tp} is one of {sorted(kves)} KV heads: its layout "
                f"cannot be read back (prefill with tp={self.tp})")
        return kves.pop()

    # -- the SSM ----------------------------------------------------------
    def ssm_in(self, x, w):
        """``x @ in_proj`` -> (xs, z), each of this rank's ``d_inner / tp``
        channels (``ssm_split``), where ``w`` is the rank's stored block of
        in_proj's concatenated ``[x | z]`` columns (block r of 2 x d_inner,
        not channel block r of each half: at tp = 2 rank 0 stores all of
        x's columns, rank 1 all of z's).  The layout stays the reference's;
        the rank's (rows, 2 d_inner / tp) products are all-gathered over
        ``model`` and its channels of each half taken; their gradient is
        reduce-scattered back."""
        x = self.enter(x)
        di = self.cfg.d_inner
        lo, hi = self.rank * di // self.tp, (self.rank + 1) * di // self.tp
        xz = col.gather_from(x @ w, self.mesh, self.axes, x.dim() - 1)
        return xz[..., lo:hi], xz[..., di + lo:di + hi]


def parallel_for(mesh, cfg, mode: str = "tp") -> Parallel | None:
    """None for no mesh; a ``Parallel`` as given; otherwise the
    tensor-parallel layout of ``cfg`` on ``mesh``."""
    if mesh is None or isinstance(mesh, Parallel):
        return mesh
    return Parallel(mesh, cfg, mode)
