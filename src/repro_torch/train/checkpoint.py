"""Atomic, async checkpointing in the JAX package's layout.

A PyTorch copy of ``repro.train.checkpoint``.  Layout:

    <dir>/step_000123/
        manifest.json        leaf paths, shapes, dtypes, step
        t_<idx>.npy          one file per leaf (on the host)
        COMMIT               written last; restore ignores dirs without it

The leaves are the reference's: a ``ParamTree`` is saved as the
reference's parameter pytree, layers stacked on a leading L axis
(``convert.lm_params_to_numpy``), an ``OptState`` as its three fields, and
the leaves are ordered and named as ``jax.tree_util`` flattens that tree
(dict keys sorted, ``params/layers/attn/wq``, ``opt/.mu/embed``).  So a
checkpoint written by either package restores in the other.  Restores
build new tensors in the target tree's structure, on ``device`` or each
target leaf's own.  Async saves run on a single background thread; the
next save joins the previous one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn

from ..convert import lm_params_to_numpy, reference_path
from ..device import resolve_device
from .optimizer import OptState


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _path_str(path: tuple[str, ...]) -> str:
    """The reference's leaf path (``distributed.sharding._path_str``): a
    dict key prints as itself, a named-tuple field as ``.name``."""
    return "/".join(path)


def host_tree(tree):
    """``tree`` (dicts, ``OptState``\\ s, ``ParamTree``\\ s, tensors, arrays)
    as the reference's pytree of host arrays; tensors are copied."""
    if isinstance(tree, OptState):
        return OptState(*(host_tree(x) for x in tree))
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, nn.Module):
        return lm_params_to_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    return np.asarray(tree)


def _flatten(tree, path: tuple[str, ...] = ()) -> list[tuple[str, object]]:
    """(path, leaf) in ``jax.tree_util``'s order: dict keys sorted, a
    named tuple's fields in order."""
    if isinstance(tree, OptState):
        return [leaf for name, x in zip(tree._fields, tree)
                for leaf in _flatten(x, path + ("." + name,))]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], path + (str(k),))]
    return [(_path_str(path), tree)]


def save_checkpoint(base: str, step: int, tree) -> str:
    """Blocking save. Returns the committed directory."""
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(host_tree(tree))):
        arr = np.asarray(leaf)
        fname = f"t_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
        manifest["leaves"].append({
            "path": path, "file": fname,
            "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def committed_steps(base: str) -> list[int]:
    if not os.path.isdir(base):
        return []
    steps = []
    for name in os.listdir(base):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(base, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(base: str) -> int | None:
    steps = committed_steps(base)
    return steps[-1] if steps else None


def restore_checkpoint(base: str, target_tree, *, step: int | None = None,
                       device: str | torch.device | None = None):
    """Restore into the structure of ``target_tree``: new tensors of each
    target leaf's dtype, on ``device`` (default: the target leaf's own;
    ``"cuda"`` raises without a card).  Returns (step, tree)."""
    dev = resolve_device(device) if device is not None else None
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path: str, shape: tuple[int, ...]) -> np.ndarray:
        arr = np.load(os.path.join(d, by_path[path]["file"]),
                      allow_pickle=False)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {path}: {arr.shape} vs "
                             f"{tuple(shape)}")
        return arr

    def tensor(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(arr).to(dev or ref.device, ref.dtype,
                                        copy=True)

    def restore(tree, path: tuple[str, ...]):
        if isinstance(tree, OptState):
            return OptState(*(restore(x, path + ("." + name,))
                              for name, x in zip(tree._fields, tree)))
        if isinstance(tree, dict):
            return {k: restore(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, nn.Module):
            # a stacked leaf's shape: (layers,) + one layer's shape
            shapes: dict[str, tuple] = {}
            for name, p in tree.named_parameters():
                rel, i = reference_path(name)
                shapes[rel] = tuple(p.shape) if i is None else \
                    (shapes.get(rel, (0,))[0] + 1, *p.shape)
            arrays = {rel: load(_path_str(path + (rel,)), shape)
                      for rel, shape in shapes.items()}

            def leaf(name, p):
                rel, i = reference_path(name)
                return tensor(arrays[rel] if i is None else arrays[rel][i], p)
            return tree.map(leaf)
        return tensor(load(_path_str(path), tuple(tree.shape)), tree)

    return step, restore(target_tree, ())


def prune_checkpoints(base: str, keep: int) -> None:
    steps = committed_steps(base)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


class CheckpointManager:
    """Periodic async checkpointing with retention.  A step already saved
    is not saved again (the loop's forced save at its end often follows a
    periodic save of the same step)."""

    def __init__(self, base: str, *, every: int, keep: int = 3,
                 async_save: bool = True):
        self.base = base
        self.every = max(every, 1)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._saved: int | None = None

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def maybe_save(self, step: int, tree, *, force: bool = False) -> bool:
        if (not force and step % self.every != 0) or step == self._saved:
            return False
        self.wait()
        # copy to the host on the caller thread: the step after this one
        # updates the parameters and moments in place
        host = host_tree(tree)

        def work():
            save_checkpoint(self.base, step, host)
            prune_checkpoints(self.base, self.keep)

        def background():
            try:
                work()
            except BaseException as e:   # re-raised by the next wait()
                self._error = e

        self._saved = step
        if self.async_save:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()
        else:
            work()
        return True
