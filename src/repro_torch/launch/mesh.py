"""Meshes over the ranks of a ``torch.distributed`` process group.

A PyTorch copy of ``repro.launch.mesh``.  A mesh is a ``DeviceMesh`` with
named dims over the process group's ranks, one rank a device: the
reference's ``jax.make_mesh`` over the visible devices.  Building one
touches process-group state, so these are functions, and importing this
module does nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device

# the production layouts, as data: 16 x 16 = 256 chips a pod; multi_pod
# stacks 2 pods = 512 chips
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        # one process and no group yet: a one-rank group of this process
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    n, have = int(torch.tensor(shape).prod()), dist.get_world_size()
    if n != have:
        raise ValueError(f"need {n} devices, have {have}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = DEFAULT_DEVICE):
    """16x16 = 256 ranks per pod; multi_pod stacks 2 pods = 512 ranks.
    Raises where the process group has another number of ranks."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return _make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str | torch.device = DEFAULT_DEVICE):
    """A ``(data, model)`` mesh over the process group's ranks (tests,
    examples; ``launch.ranks.RankPool`` starts them), on ``device``
    (``"cuda"`` raises without a card).  The group must have exactly
    ``data * model`` ranks; with no group yet, this process makes a
    one-rank group."""
    return _make_mesh((data, model), ("data", "model"), device)
