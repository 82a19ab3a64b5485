"""Linear models on b-bit C-MinHash features — the paper's "large-scale
learning" application (Li, Shrivastava, Moore, Koenig, NIPS 2011: K = 512/1024
hashes as features; the paper's Sec. 1 motivates exactly this use).  The
counterpart of ``repro.core.linear_model``.

Logistic regression over the one-hot b-bit feature map (K * 2^b dims),
trained with full-batch Adam on the signatures' device.  The one-hot matrix
is never built: a row's logit is the sum of the K weights its codes pick,
``w.view(K, 2^b)[k, code_k]``, a gather of N x K weights instead of an
(N, K * 2^b) float32 product (17 GB at N = 32,768, K = 512, b = 8).
"""

from __future__ import annotations

import dataclasses

import torch

from .bbit import lowest_b_bits
from .estimators import match_mean


@dataclasses.dataclass(frozen=True)
class HashedLinearConfig:
    b: int = 4             # bits kept per hash
    l2: float = 1e-4
    lr: float = 0.05
    steps: int = 300


def code_index(sigs: torch.Tensor, b: int) -> torch.Tensor:
    """(N, K) signatures -> (K, N) int64 low-b-bit codes: row k indexes
    hash k's 2^b weights, ``w.view(K, 2^b)[k]``."""
    return lowest_b_bits(sigs, b).T.long().contiguous()


def _logits(w: torch.Tensor, bias: torch.Tensor,
            codes: torch.Tensor) -> torch.Tensor:
    """``bbit_features(sigs, b) @ w + bias`` without the one-hot matrix:
    each row sums the K weights its codes pick (a gather, whose gradient
    is a scatter-add into the picked weights)."""
    k = codes.shape[0]
    return w.view(k, -1).gather(1, codes).sum(dim=0) + bias


def fit_logistic(sigs: torch.Tensor, labels: torch.Tensor,
                 cfg: HashedLinearConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """sigs: (N, K) int32 signatures; labels: (N,) in {0,1}.
    Returns (weights (K*2^b,), bias ()) float32 on the signatures' device.

    Loss: mean cross-entropy + ``cfg.l2 * sum(w^2)`` (w only, not the
    bias); the reference's Adam update (beta 0.9/0.999, eps 1e-8, bias
    correction with a float32 step count)."""
    dev = sigs.device
    codes = code_index(sigs, cfg.b)
    y = labels.to(dev, torch.float32)
    w = torch.zeros(sigs.shape[1] << cfg.b, dtype=torch.float32, device=dev,
                    requires_grad=True)
    bias = torch.zeros((), dtype=torch.float32, device=dev,
                       requires_grad=True)
    params = (w, bias)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    t = torch.zeros((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(cfg.steps):
        logits = _logits(w, bias, codes)
        ce = torch.mean(torch.logaddexp(zero, logits) - y * logits)
        loss = ce + cfg.l2 * torch.sum(w * w)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            t += 1
            c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
            for p, mm, vv, g in zip(params, m, v, grads):
                mm.mul_(0.9).add_(0.1 * g)
                vv.mul_(0.999).add_(0.001 * g * g)
                p.sub_(cfg.lr * (mm / c1) / (torch.sqrt(vv / c2) + 1e-8))
    return w.detach(), bias.detach()


def predict_logistic(wb, sigs: torch.Tensor, b: int) -> torch.Tensor:
    """Class-1 probability for each signature row."""
    w, bias = wb
    with torch.no_grad():
        return torch.sigmoid(_logits(w, bias, code_index(sigs, b)))


def accuracy(wb, sigs: torch.Tensor, labels: torch.Tensor, b: int) -> float:
    p = predict_logistic(wb, sigs, b)
    hit = (p > 0.5) == (labels.to(p.device) > 0.5)
    return float(match_mean(hit))
