"""Fault-tolerant training loop: microbatch accumulation, preemption
handling, straggler monitoring, auto-restore, async checkpoints, on one
device or over a mesh.

A PyTorch copy of ``repro.train.train_loop``.  The step runs eagerly on the
bundle's device (no ``jit``, no donation) and updates the parameters and
moments in place.  Over a mesh (``make_train_step(bundle, tc, mesh)``) the
step takes the rank's local slices and rows and issues its collectives
itself, as the reference's GSPMD step issues them:

* gradients sum in float32 over the batch axes (``grad_compression="bf16"``
  then casts them, as the reference's step does; ``"int8"`` is ignored, as
  there);
* ``tc.zero1``: the moments are additionally sharded over ``data``
  (``zero1_specs``): those gradients are reduce-scattered over ``data``,
  each rank updates its block, and the parameters are all-gathered after;
* ``sharding_mode="fsdp"``: weights gathered at their use, the batch over
  every axis (``distributed.parallel``);
* the global norm sums each leaf's squares over the axes it is sharded on,
  a replicated leaf once, so the clip is the single device's.

``train_state_shardings`` gives the layouts, and ``jit_train_step`` the
step with its layouts fixed (torch has nothing to jit): it cuts the rank's
rows from a host batch.  ``mesh_gradients`` gives what a rank's step hands
its update, to hold against one device's gradients.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator

import torch

from ..data.loader import device_placer
from ..distributed import collectives as col
from ..distributed.parallel import Parallel
from ..distributed.sharding import (NamedSharding, axis_names,
                                    batch_shardings, fsdp_param_specs,
                                    local_slices, mesh_size, param_specs,
                                    shard_tree, sharded_axes, zero1_specs)
from . import checkpoint as ckpt
from .optimizer import (OptState, adamw_update, clip_to, init_opt_state,
                        leaf_update, step_scalars)


def loss_and_grads(bundle, params, batch, mesh=None
                   ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """(loss, metrics, the loss's gradient a parameter in
    ``params.parameters()`` order; zeros for a parameter the loss does not
    reach, as ``jax.grad`` gives).  The parameters require a gradient only
    for this backward pass, so serving with them builds no graph.  Over a
    mesh, the rank's part of the gradient of the whole batch's loss."""
    leaves = list(params.parameters())
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = bundle.loss_fn(params, batch, mesh)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        list(grads)


def make_train_step(bundle, tc, mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).  Over a
    mesh: the rank's local slices (``init_train_state``) and rows."""
    par = None if mesh is None else Parallel(
        mesh, bundle.cfg, tc.sharding_mode)
    update = adamw_update if par is None else _MeshUpdate(par, tc)

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = _gradients(bundle, tc, par, update, params,
                                          batch)
        if tc.grad_compression == "bf16":
            # halve the mantissa before the optimizer, as the reference does
            grads = [g.to(torch.bfloat16) for g in grads]
        params, opt_state, stats = update(params, grads, opt_state, tc)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def _gradients(bundle, tc, par, update, params, batch):
    """(loss, metrics, gradients) of a step: over ``tc.microbatches`` if
    more than one, and over a mesh (``par``) summed by ``update.reduce``."""
    if tc.microbatches > 1:
        n = tc.microbatches
        rows = len(batch["tokens"])
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split "
                             f"into {n} microbatches")
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params.parameters()]
        loss = torch.zeros((), dtype=torch.float32, device=bundle.device)
        for i in range(n):
            lo, hi = i * rows // n, (i + 1) * rows // n
            part = {k: v[lo:hi] for k, v in batch.items()}
            mloss, _, mgrads = loss_and_grads(bundle, params, part, par)
            for acc, g in zip(grads, mgrads):
                acc.add_(g)
            loss = loss + mloss
        grads = [g / n for g in grads]
        loss = loss / n
        metrics = {}
    else:
        loss, metrics, grads = loss_and_grads(bundle, params, batch, par)
    if par is not None:
        grads = update.reduce(params, grads)
    return loss, metrics, grads


def mesh_gradients(bundle, tc, mesh, params, batch
                   ) -> list[tuple[str, tuple[slice, ...], torch.Tensor]]:
    """What a step of ``jit_train_step(bundle, tc, mesh)`` hands its update
    on this rank, before the clip and any compression, to hold against one
    device's gradients: (leaf name, the slices of the whole leaf it covers,
    the gradient summed in float32 over the batch axes) for each piece of a
    leaf that the rank updates.  ``batch``: the host batch."""
    par = Parallel(mesh, bundle.cfg, tc.sharding_mode)
    update = _MeshUpdate(par, tc)
    rows = device_placer(mesh, batch_layout(tc, mesh))(batch)
    _, _, grads = _gradients(bundle, tc, par, update, params, rows)
    return [(name, sl, g) for (name, sl), g
            in zip(update.regions(params), grads, strict=True)]


def train_state_shardings(params_shape, tc, mesh):
    """(param shardings, ``OptState`` of shardings), each a dict
    ``{stacked path: NamedSharding}``.  ZeRO-1 shards the moments over
    ``data`` on top of the model layout; ``sharding_mode="fsdp"`` switches
    the whole layout to gathered weights (moments colocate with the
    parameters = ZeRO-3)."""
    if tc.sharding_mode == "fsdp":
        p_specs = mom_specs = fsdp_param_specs(params_shape, mesh)
    else:
        p_specs = param_specs(params_shape, mesh)
        mom_specs = zero1_specs(params_shape, mesh) if tc.zero1 else p_specs
    p_shard = {k: NamedSharding(mesh, v) for k, v in p_specs.items()}
    mom = {k: NamedSharding(mesh, v) for k, v in mom_specs.items()}
    return p_shard, OptState(NamedSharding(mesh, ()), mom, dict(mom))


def init_train_state(params, tc, mesh):
    """The rank's (parameters, ``OptState``) from a full parameter tree
    drawn alike on every rank: its slices of the parameters and zeros of
    its moments' shapes."""
    p_shard, o_shard = train_state_shardings(params, tc, mesh)
    local = shard_tree(params, p_shard)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(params.parameters()).device)
    return local, OptState(step, shard_tree(params, o_shard.mu, zeros=True),
                           shard_tree(params, o_shard.nu, zeros=True))


def batch_layout(tc, mesh) -> Callable:
    """The batch's shardings under ``tc``: over the batch axes (``tp``) or
    over every axis (``fsdp``: weights are gathered per use; leaving the
    model axis off the batch would repeat its compute on every model
    rank)."""
    if tc.sharding_mode != "fsdp":
        return batch_shardings
    axes = axis_names(mesh)
    n_all = mesh_size(mesh)

    def shardings(batch, mesh):
        def spec(x):
            ndim = len(x.shape)
            lead = axes if ndim and x.shape[0] % n_all == 0 else None
            return NamedSharding(mesh, (lead, *([None] * (max(ndim, 1) - 1))))
        return {k: spec(v) for k, v in batch.items()}
    return shardings


def jit_train_step(bundle, tc, mesh) -> Callable:
    """The mesh step with its layouts fixed: (the rank's params, the rank's
    ``OptState``, a host batch) -> (params, opt_state, metrics); the rank's
    rows are cut from the host batch by ``batch_layout``.  The layouts
    follow from ``bundle.cfg``, ``tc`` and the mesh, so the reference's
    ``params_shape`` and ``batch_shape`` (which its ``jax.jit`` needs) are
    not taken."""
    step = make_train_step(bundle, tc, mesh)
    place = device_placer(mesh, batch_layout(tc, mesh))
    return lambda params, opt_state, batch: step(params, opt_state,
                                                 place(batch))


@dataclasses.dataclass
class _Group:
    """One stacked path of the reference's tree: its leaves' places in
    ``parameters()`` order (layer order), its global stacked shape, the
    axes its gradient is summed over, and, under ZeRO-1, the stacked dim
    sharded over ``data`` and this rank's block of it."""
    leaves: list
    layered: bool
    sync: tuple
    norm_axes: tuple
    zero_dim: int | None
    block: slice | None

    def _narrow(self, p, dim):
        return p.narrow(dim, self.block.start, self.block.stop
                        - self.block.start)

    def owned(self) -> list:
        """The leaves this rank updates (a layer axis sharded over ``data``
        leaves it only its block of layers)."""
        if self.layered and self.zero_dim == 0:
            return self.leaves[self.block]
        return self.leaves

    def region(self, p):
        """The part of a held leaf this rank updates."""
        if self.zero_dim is None or (self.layered and self.zero_dim == 0):
            return p
        return self._narrow(p, self.zero_dim - self.layered)

    def reduce(self, grads: list, mesh) -> list:
        """The gradients of ``owned()``'s regions, summed."""
        if self.zero_dim is None:
            return [col.all_reduce(grads[i], mesh, self.sync)
                    for i in self.leaves]
        stacked = torch.stack([grads[i] for i in self.leaves]) \
            if self.layered else grads[self.leaves[0]]
        block = col.reduce_scatter(stacked, mesh, "data", self.zero_dim)
        block = col.all_reduce(block, mesh, self.sync)
        return list(block) if self.layered else [block]

    def gather(self, params: list, mesh) -> None:
        """Every rank's updated blocks all-gathered over ``data`` into the
        full parameters."""
        if self.zero_dim is None:
            return
        ps = [params[i] for i in self.leaves]
        blocks = torch.stack([self.region(params[i]) for i in self.owned()]) \
            if self.layered else self.region(ps[0]).contiguous()
        full = col.all_gather(blocks, mesh, "data", self.zero_dim)
        for p, f in zip(ps, full if self.layered else [full]):
            p.copy_(f)


class _MeshUpdate:
    """The mesh step's gradient sums and AdamW update, one stacked path of
    the reference's tree (a group of per-layer leaves) at a time.  The
    groups index the leaves in the order ``init`` makes them (so does
    ``convert.lm_params_from_jax``)."""

    def __init__(self, par: Parallel, tc):
        from ..convert import reference_path
        self.par, self.mesh = par, par.mesh
        _, o_shard = train_state_shardings(par.shapes, tc, self.mesh)
        paths = [reference_path(n) for n in par.names]
        self.groups = []
        for path, shape in par.shapes.items():
            leaves = [i for i, (rel, _) in enumerate(paths) if rel == path]
            mspec = o_shard.mu[path].spec
            zero = [j for j, ax in enumerate(mspec) if ax == "data"]
            self.groups.append(_Group(
                leaves, paths[leaves[0]][1] is not None,
                sync=tuple(a for a in par.batch_axes
                           if a not in sharded_axes(par.specs[path])
                           and not (zero and a == "data")),
                norm_axes=tuple(sorted(set(sharded_axes(mspec)))),
                zero_dim=zero[0] if zero else None,
                block=local_slices(mspec, shape, self.mesh)[zero[0]]
                if zero else None))

    def _leaves(self, params) -> list:
        names = tuple(n for n, _ in params.named_parameters())
        if names != self.par.names:
            raise ValueError(
                "a parameter tree whose leaves are not those of "
                f"{self.par.cfg.name}'s ``init``, in its order (build it "
                "with ``init``, ``convert.lm_params_from_jax`` or "
                "``init_train_state``)")
        return list(params.parameters())

    def regions(self, params) -> list[tuple[str, tuple[slice, ...]]]:
        """(leaf name, the slices of the whole leaf) of each piece this rank
        updates, in the order of ``reduce``'s gradients."""
        self._leaves(params)
        out = []
        for path, grp in zip(self.par.shapes, self.groups):
            sl = list(local_slices(self.par.specs[path],
                                   self.par.shapes[path], self.mesh))
            if grp.zero_dim is not None and not (grp.layered
                                                 and grp.zero_dim == 0):
                sl[grp.zero_dim] = grp.block
            sl = tuple(sl[1:] if grp.layered else sl)
            out += [(self.par.names[i], sl) for i in grp.owned()]
        return out

    def reduce(self, params, grads: list) -> list:
        """Each gradient summed in float32 over the batch axes it is
        replicated on (a ZeRO-1 group's reduce-scattered over ``data`` to
        this rank's block): the gradients of the regions this rank
        updates, group by group."""
        self._leaves(params)
        grads = [g.float() for g in grads]
        return [g for grp in self.groups
                for g in grp.reduce(grads, self.mesh)]

    @torch.no_grad()
    def __call__(self, params, grads: list, state: OptState, tc):
        groups = self.groups
        ps = self._leaves(params)
        mu, nu = list(state.mu.parameters()), list(state.nu.parameters())
        pieces = [(grp.region(ps[i]), mu[i], nu[i], grp.norm_axes)
                  for grp in groups for i in grp.owned()]
        grads = [g.float() for g in grads]
        # the global norm: each piece's squares summed over the axes its
        # gradient is sharded on, a replicated piece counted once
        partial: dict = {}
        for (*_, axes), g in zip(pieces, grads, strict=True):
            partial[axes] = partial.get(axes, 0) + torch.sum(torch.square(g))
        gnorm = torch.sqrt(sum(col.all_reduce(partial[a], self.mesh, a)
                               for a in sorted(partial)))
        if tc.grad_clip > 0:
            grads = clip_to(grads, gnorm, tc.grad_clip)
        step, lr, bc1, bc2 = step_scalars(state.step, tc)
        for (p, m, v, _), g in zip(pieces, grads):
            leaf_update(p, m, v, g, lr, bc1, bc2, tc)
        for grp in groups:
            grp.gather(ps, self.mesh)
        return params, OptState(step, state.mu, state.nu), {
            "lr": lr, "grad_norm": gnorm}


@dataclasses.dataclass
class StragglerMonitor:
    """EMA step-time tracker; flags slow steps (on real fleets this feeds the
    scheduler to drain slow hosts; here it logs)."""

    alpha: float = 0.1
    threshold: float = 2.0
    ema: float | None = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        self.flagged += int(slow)
        return slow


class TrainLoop:
    """Restartable loop: restores the latest committed checkpoint, checkpoints
    periodically (async), and checkpoints immediately on SIGTERM/SIGINT.
    The handlers are installed for ``run`` and the previous ones put back
    when it returns.  With ``mesh``, every rank runs the loop on the same
    host batches: it keeps its slices of the drawn parameters, restores its
    slices whatever mesh saved, and saves together with the others (rank 0
    writes)."""

    def __init__(self, bundle, tc, data_iter: Iterator[dict], workdir: str,
                 mesh=None, log: Callable[[str], None] = print):
        self.bundle, self.tc, self.data = bundle, tc, data_iter
        self.workdir, self.mesh, self.log = workdir, mesh, log
        self.monitor = StragglerMonitor()
        self._stop = False

    def stop(self) -> None:
        """Save at the next step boundary and return (what a signal does)."""
        self._stop = True

    def _stopping(self) -> bool:
        """Over a mesh, every rank stops when one was asked to (they save
        together)."""
        if self.mesh is None:
            return self._stop
        flag = torch.tensor(float(self._stop))
        return bool(col.all_reduce(flag, self.mesh, axis_names(self.mesh),
                                   "max"))

    def _install_signals(self) -> dict:
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, lambda *_: self.stop())
            except ValueError:
                pass  # not on main thread (tests)
        return previous

    def run(self, start_params=None) -> dict:
        tc, mesh = self.tc, self.mesh
        params = start_params if start_params is not None else \
            self.bundle.init(tc.seed)
        shardings = None
        if mesh is None:
            state = {"params": params, "opt": init_opt_state(params)}
            step_fn = make_train_step(self.bundle, tc)
        else:   # every rank drew the same full tree; each keeps its slices
            p_shard, o_shard = train_state_shardings(params, tc, mesh)
            shardings = {"params": p_shard, "opt": o_shard}
            local, opt_state = init_train_state(params, tc, mesh)
            state = {"params": local, "opt": opt_state}
            del params
            step_fn = jit_train_step(self.bundle, tc, mesh)

        start = 0
        if ckpt.latest_step(self.workdir) is not None:
            start, state = ckpt.restore_checkpoint(self.workdir, state,
                                                   shardings=shardings)
            self.log(f"[train] restored step {start} from {self.workdir}")

        manager = ckpt.CheckpointManager(
            self.workdir, every=tc.checkpoint_every, keep=tc.keep_checkpoints,
            shardings=shardings)
        previous = self._install_signals()
        try:
            params, opt_state = state["params"], state["opt"]
            history = []
            t_prev = time.perf_counter()
            for step in range(start, tc.total_steps):
                if self._stopping():
                    self.log(f"[train] preemption signal at step {step}; "
                             "saving")
                    manager.maybe_save(step, {"params": params,
                                              "opt": opt_state}, force=True)
                    manager.wait()
                    break
                batch = next(self.data)
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t_prev
                t_prev = time.perf_counter()
                if self.monitor.observe(dt):
                    self.log(f"[train] straggler: step {step} took "
                             f"{dt:.2f}s (ema {self.monitor.ema:.2f}s)")
                history.append(loss)
                if (step + 1) % max(tc.total_steps // 10, 1) == 0:
                    self.log(f"[train] step {step + 1}/{tc.total_steps} "
                             f"loss {loss:.4f} ({dt * 1e3:.0f} ms/step)")
                manager.maybe_save(step + 1, {"params": params,
                                              "opt": opt_state})
            else:
                manager.maybe_save(tc.total_steps,
                                   {"params": params, "opt": opt_state},
                                   force=True)
            manager.wait()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        return {"params": params, "opt": opt_state, "losses": history,
                "stragglers": self.monitor.flagged}
