"""AdamW with warmup-cosine schedule and global-norm clipping.

A PyTorch copy of ``repro.train.optimizer``, with the reference's formula
and rounding: float32 moments, the bias corrections in float32, the weight
decay inside the step's ``delta``.  ``mu`` and ``nu`` are ``ParamTree``\\ s
that mirror the parameters (``params.map``), so a checkpoint names them as
the reference names its ``OptState``; ``step`` is a 0-d int32 tensor on the
parameters' device.

A tree here is a ``ParamTree`` (its ``parameters()`` in order), a dict
(its values, nested) or a sequence of tensors.  Gradients come as a
sequence in ``params.parameters()`` order.  ``adamw_update`` writes the new
parameters and moments into the given tensors and returns the same
objects, where the reference returns new arrays.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch import nn

Tensor = torch.Tensor


class OptState(NamedTuple):
    step: Tensor         # () int32
    mu: nn.Module        # first moment,  float32, mirrors params
    nu: nn.Module        # second moment, float32, mirrors params


def leaves(tree) -> list[Tensor]:
    """The tensors of ``tree`` in order."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, Tensor):
        return [tree]
    return [x for v in tree for x in leaves(v)]


def init_opt_state(params) -> OptState:
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(params.parameters()).device)
    return OptState(step, params.map(zeros), params.map(zeros))


def lr_schedule(step: Tensor, tc) -> Tensor:
    """Linear warmup -> cosine decay to 10%, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float
                        ) -> tuple[list[Tensor], Tensor]:
    norm = global_norm(grads)
    return clip_to(grads, norm, max_norm), norm


def clip_to(grads: Sequence[Tensor], norm: Tensor, max_norm: float
            ) -> list[Tensor]:
    """``grads`` scaled so that their global ``norm`` is at most
    ``max_norm``."""
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [g * scale for g in grads]


def step_scalars(step: Tensor, tc) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(the new step, its lr, the two bias corrections)."""
    step = step + 1
    bc1, bc2 = (1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                         device=step.device), step.float())
                for b in (tc.beta1, tc.beta2))
    return step, lr_schedule(step, tc), bc1, bc2


def leaf_update(p: Tensor, m: Tensor, v: Tensor, g: Tensor, lr: Tensor,
                bc1: Tensor, bc2: Tensor, tc) -> None:
    """One leaf's AdamW step, in place (``p`` may be a view)."""
    b1, b2 = tc.beta1, tc.beta2
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    mhat = m / bc1
    vhat = v / bc2
    pf = p.float()
    delta = mhat / (torch.sqrt(vhat) + tc.eps) + tc.weight_decay * pf
    p.copy_((pf - lr * delta).to(p.dtype))


@torch.no_grad()
def adamw_update(params, grads: Sequence[Tensor], state: OptState, tc
                 ) -> tuple[nn.Module, OptState, dict]:
    """One AdamW step, in place.  Returns (params, new_state, stats)."""
    grads = [g.float() for g in grads]
    if tc.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    else:
        gnorm = global_norm(grads)
    step, lr, bc1, bc2 = step_scalars(state.step, tc)
    for p, m, v, g in zip(params.parameters(), state.mu.parameters(),
                          state.nu.parameters(), grads, strict=True):
        leaf_update(p, m, v, g, lr, bc1, bc2, tc)
    return params, OptState(step, state.mu, state.nu), {"lr": lr,
                                                         "grad_norm": gnorm}
