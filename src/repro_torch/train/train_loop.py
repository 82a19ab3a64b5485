"""Fault-tolerant training loop on one device: microbatch accumulation,
preemption handling, straggler monitoring, auto-restore, async checkpoints.

A PyTorch copy of ``repro.train.train_loop`` without the mesh: the step
runs eagerly on the bundle's device (no ``jit``, no donation) and updates
the parameters and moments in place.  ``train_state_shardings`` and
``jit_train_step`` come with the mesh paths (ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator

import torch

from . import checkpoint as ckpt
from .optimizer import OptState, adamw_update, init_opt_state


def loss_and_grads(bundle, params, batch
                   ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """(loss, metrics, the loss's gradient a parameter in
    ``params.parameters()`` order; zeros for a parameter the loss does not
    reach, as ``jax.grad`` gives).  The parameters require a gradient only
    for this backward pass, so serving with them builds no graph."""
    leaves = list(params.parameters())
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = bundle.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        list(grads)


def make_train_step(bundle, tc, mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    if mesh is not None:
        raise NotImplementedError(
            "a train step over a mesh is not ported yet: it comes with the "
            "mesh paths (ROADMAP §1)")

    def train_step(params, opt_state: OptState, batch):
        if tc.microbatches > 1:
            n = tc.microbatches
            rows = len(batch["tokens"])
            if rows % n:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {n} microbatches")
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in params.parameters()]
            loss = torch.zeros((), dtype=torch.float32, device=bundle.device)
            for i in range(n):
                lo, hi = i * rows // n, (i + 1) * rows // n
                part = {k: v[lo:hi] for k, v in batch.items()}
                mloss, _, mgrads = loss_and_grads(bundle, params, part)
                for acc, g in zip(grads, mgrads):
                    acc.add_(g)
                loss = loss + mloss
            grads = [g / n for g in grads]
            loss = loss / n
            metrics = {}
        else:
            loss, metrics, grads = loss_and_grads(bundle, params, batch)
        if tc.grad_compression == "bf16":
            # halve the mantissa before the optimizer, as the reference does
            grads = [g.to(torch.bfloat16) for g in grads]
        params, opt_state, stats = adamw_update(params, grads, opt_state, tc)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


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
    when it returns."""

    def __init__(self, bundle, tc, data_iter: Iterator[dict], workdir: str,
                 mesh=None, log: Callable[[str], None] = print):
        self.bundle, self.tc, self.data = bundle, tc, data_iter
        self.workdir, self.mesh, self.log = workdir, mesh, log
        self.monitor = StragglerMonitor()
        self._stop = False

    def stop(self) -> None:
        """Save at the next step boundary and return (what a signal does)."""
        self._stop = True

    def _install_signals(self) -> dict:
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, lambda *_: self.stop())
            except ValueError:
                pass  # not on main thread (tests)
        return previous

    def run(self, start_params=None) -> dict:
        tc = self.tc
        params = start_params if start_params is not None else \
            self.bundle.init(tc.seed)
        opt_state = init_opt_state(params)
        state = {"params": params, "opt": opt_state}

        start = 0
        if ckpt.latest_step(self.workdir) is not None:
            start, state = ckpt.restore_checkpoint(self.workdir, state)
            self.log(f"[train] restored step {start} from {self.workdir}")

        step_fn = make_train_step(self.bundle, tc, self.mesh)
        manager = ckpt.CheckpointManager(
            self.workdir, every=tc.checkpoint_every, keep=tc.keep_checkpoints)
        previous = self._install_signals()
        try:
            params, opt_state = state["params"], state["opt"]
            history = []
            t_prev = time.perf_counter()
            for step in range(start, tc.total_steps):
                if self._stop:
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
