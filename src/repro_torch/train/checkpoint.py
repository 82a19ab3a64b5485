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

Sharded state (elastic restarts: save on one mesh, restore on another):
``shardings`` mirrors the tree with a ``{stacked path: NamedSharding}``
dict for a ``ParamTree`` and a ``NamedSharding`` for a tensor
(``train_loop.train_state_shardings``).  A save all-gathers every leaf
(every rank takes part) and rank 0 writes the same files a single device
writes; a restore reads each file memory-mapped and keeps the rank's
slice.
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
from ..distributed import collectives as col
from ..distributed.sharding import (NamedSharding, leaf_slices,
                                    stacked_shapes)
from .optimizer import OptState


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _path_str(path: tuple[str, ...]) -> str:
    """The reference's leaf path (``distributed.sharding._path_str``): a
    dict key prints as itself, a named-tuple field as ``.name``."""
    return "/".join(path)


def host_tree(tree, shardings=None):
    """``tree`` (dicts, ``OptState``\\ s, ``ParamTree``\\ s, tensors, arrays)
    as the reference's pytree of host arrays; tensors are copied.  With
    ``shardings``, the rank's slices are all-gathered first (a collective:
    every rank calls it) and only rank 0 gets the arrays (others None)."""
    if shardings is not None:
        return _gathered(tree, shardings, _writer())
    if isinstance(tree, OptState):
        return OptState(*(host_tree(x) for x in tree))
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, nn.Module):
        return lm_params_to_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    return np.asarray(tree)


def _writer() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _full(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """A rank's block of an array all-gathered to the whole array."""
    for dim, ax in enumerate(sharding.spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        for a in reversed(axes):        # the minor axis first
            local = col.all_gather(local.contiguous(), sharding.mesh, a, dim)
    return local


def _gathered(tree, shardings, keep: bool):
    if isinstance(tree, OptState):
        return OptState(*(_gathered(x, sh, keep)
                          for x, sh in zip(tree, shardings)))
    if isinstance(tree, dict):
        return {k: _gathered(v, shardings[k], keep) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        full = _full(tree.detach(), shardings)
        return full.to("cpu", copy=True).numpy() if keep else None
    groups: dict[str, list] = {}
    for name, p in tree.named_parameters():
        rel, i = reference_path(name)
        groups.setdefault(rel, []).append((i, p.detach()))
    out: dict = {}
    for rel, leaves in groups.items():
        if leaves[0][0] is None:
            local = leaves[0][1]
        else:       # the layers this rank holds, stacked
            local = torch.stack([p for _, p in leaves if p.numel()
                                 or not _layer_sharded(shardings[rel])])
        full = _full(local, shardings[rel])
        node = out
        *parents, leaf = rel.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = full.to("cpu", copy=True).numpy() if keep else None
    return out


def _layer_sharded(sharding: NamedSharding) -> bool:
    return bool(sharding.spec) and sharding.spec[0] is not None


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


def save_checkpoint(base: str, step: int, tree, *, shardings=None) -> str:
    """Blocking save. Returns the committed directory.  With
    ``shardings``, every rank calls it, rank 0 writes, and all return once
    the directory is committed."""
    final = _step_dir(base, step)
    if shardings is not None:
        host = host_tree(tree, shardings)
        if _writer():
            save_checkpoint(base, step, host)
        col.barrier(next(_mesh_of(shardings)))
        return final
    os.makedirs(base, exist_ok=True)
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


def _mesh_of(shardings):
    if isinstance(shardings, NamedSharding):
        yield shardings.mesh
    elif isinstance(shardings, (dict, tuple)):
        for v in (shardings.values() if isinstance(shardings, dict)
                  else shardings):
            yield from _mesh_of(v)


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
                       device: str | torch.device | None = None,
                       shardings=None):
    """Restore into the structure of ``target_tree``: new tensors of each
    target leaf's dtype, on ``device`` (default: the target leaf's own;
    ``"cuda"`` raises without a card).  ``shardings`` (the tree's layout,
    see the module's docstring) restores the rank's slices onto the
    current mesh, whatever mesh saved the files; the target leaves are the
    rank's slices then.  Returns (step, tree)."""
    dev = resolve_device(device) if device is not None else None
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path: str, shape: tuple[int, ...] | None) -> np.ndarray:
        arr = np.load(os.path.join(d, by_path[path]["file"]),
                      mmap_mode="c", allow_pickle=False)
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {path}: {arr.shape} vs "
                             f"{tuple(shape)}")
        return arr

    def tensor(arr, ref: torch.Tensor) -> torch.Tensor:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch: {arr.shape} vs "
                             f"{tuple(ref.shape)}")
        return torch.from_numpy(arr).to(dev or ref.device, ref.dtype,
                                        copy=True).contiguous()

    def restore(tree, path: tuple[str, ...], sh):
        if isinstance(tree, OptState):
            return OptState(*(restore(x, path + ("." + name,),
                                      None if sh is None else s)
                              for name, x, s in zip(tree._fields, tree,
                                                    sh or tree)))
        if isinstance(tree, dict):
            return {k: restore(v, path + (str(k),),
                               None if sh is None else sh[k])
                    for k, v in tree.items()}
        if isinstance(tree, nn.Module):
            shapes = None if sh is not None else stacked_shapes(tree)
            arrays: dict[str, np.ndarray] = {}

            def leaf(name, p):
                rel, i = reference_path(name)
                if rel not in arrays:
                    arrays[rel] = load(_path_str(path + (rel,)),
                                       None if shapes is None
                                       else shapes[rel])
                arr = arrays[rel]
                if sh is None:
                    return tensor(arr if i is None else arr[i], p)
                sl = leaf_slices(sh[rel], arr.shape, i)
                if sl is None:          # a layer this rank does not hold
                    return p.new_empty(0)
                return tensor((arr if i is None else arr[i])[sl], p)
            return tree.map(leaf)
        arr = load(_path_str(path), None if sh is not None
                   else tuple(tree.shape))
        return tensor(arr if sh is None else arr[sh.slices(arr.shape)],
                      tree)

    return step, restore(target_tree, (), shardings)


def prune_checkpoints(base: str, keep: int) -> None:
    steps = committed_steps(base)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


class CheckpointManager:
    """Periodic async checkpointing with retention.  A step already saved
    is not saved again (the loop's forced save at its end often follows a
    periodic save of the same step).  With ``shardings`` every rank calls
    ``maybe_save`` alike; the state is gathered on the callers' thread and
    rank 0 writes."""

    def __init__(self, base: str, *, every: int, keep: int = 3,
                 async_save: bool = True, shardings=None):
        self.base = base
        self.shardings = shardings
        self.every = max(every, 1)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._saved: int | None = None

    def wait(self) -> None:
        """Join the save in flight; raise what it raised.  With
        ``shardings`` every rank calls it alike, and all return once rank
        0's save is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.shardings is not None:
            col.barrier(next(_mesh_of(self.shardings)))
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def maybe_save(self, step: int, tree, *, force: bool = False) -> bool:
        if (not force and step % self.every != 0) or step == self._saved:
            return False
        self.wait()
        # copy to the host on the caller thread: the step after this one
        # updates the parameters and moments in place
        host = host_tree(tree, self.shardings)

        def work():
            if self.shardings is None or _writer():
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
            background()
            self.wait()
        return True
