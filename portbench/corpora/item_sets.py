"""Users as sets of rated items (a Jaccard kNN data set of the
ann-benchmarks kind).

``active_items`` distinct item ids are drawn from ``[0, universe)``, and
ranked by a Zipf-like popularity ``rank^-popularity_alpha``.  A user's set
size is ``size_min + floor(exp(N(log(size_median - size_min),
size_sigma)))``, capped at ``size_max``: the law's quantiles, so that
every seed draws the same sizes in another order; its items are drawn by popularity
without replacement (exponential keys divided by the weight, the smallest
keys win: Efraimidis and Spirakis).  Near-copies redraw ``fraction`` of a
user's items.

Drawn on ``device`` from one ``torch.Generator``, a block of users at a
time (one sort of ``block x active_items`` keys).
"""

from __future__ import annotations

import math

import torch

from portbench.rows import trimmed, unique_rows

_BLOCK_ELEMS = 1 << 25


class Corpus:
    def __init__(self, params: dict, d: int, gen: torch.Generator,
                 device: torch.device):
        if params["universe"] > d:
            raise ValueError("item ids must lie below d")
        self.p = params
        self.gen = gen
        self.device = device
        a = params["active_items"]
        self.items = torch.randperm(params["universe"], generator=gen,
                                    device=device)[:a].to(torch.int32)
        rank = torch.arange(1, a + 1, dtype=torch.float64, device=device)
        self.weight = (rank ** -params["popularity_alpha"]).to(torch.float32)

    def sizes(self, n: int) -> torch.Tensor:
        """(n,) set sizes: the law's quantiles at (i + 1/2) / n, in an
        order drawn from the seed, so every seed has the same sizes."""
        p = self.p
        u = (torch.arange(n, dtype=torch.float64, device=self.device)
             + 0.5) / max(n, 1)
        excess = torch.exp(math.log(p["size_median"] - p["size_min"])
                           + p["size_sigma"] * torch.special.ndtri(u))
        size = (p["size_min"] + excess.floor()).clamp(max=p["size_max"])
        order = torch.randperm(n, generator=self.gen, device=self.device)
        return size.to(torch.int64)[order]

    def _pick(self, sizes: torch.Tensor) -> torch.Tensor:
        """(n,) set sizes -> (n, max size) int32 item ids, -1 padded."""
        n = sizes.numel()
        a = self.weight.numel()
        width = int(sizes.max()) if n else 0
        out = torch.full((n, width), -1, dtype=torch.int32,
                         device=self.device)
        block = max(1, _BLOCK_ELEMS // a)
        cols = torch.arange(width, device=self.device)
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            u = torch.rand((hi - lo, a), generator=self.gen,
                           device=self.device)
            keys = -torch.log1p(-u) / self.weight
            order = keys.argsort(dim=1, stable=True)[:, :width]
            picked = self.items[order]
            out[lo:hi] = torch.where(cols < sizes[lo:hi, None], picked, -1)
        return out

    def draw(self, n: int) -> torch.Tensor:
        """(n, widest) int32 item ids of fresh users, -1 padded."""
        return self._pick(self.sizes(n))

    def edit(self, src: torch.Tensor, fraction: float) -> torch.Tensor:
        """Near-copies: ``int(size * fraction)`` of each user's items
        replaced by fresh draws by popularity."""
        n, width = src.shape
        size = (src >= 0).sum(dim=1)
        m = (size.double() * fraction).floor().to(torch.int64)
        if not n or not int(m.max()):
            return src.clone()
        keys = torch.rand((n, width), generator=self.gen, device=self.device)
        keys = torch.where(src >= 0, keys, 2.0)
        order = keys.argsort(dim=1)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(width, device=self.device)
                      .expand(n, -1).contiguous())
        fresh = self._pick(torch.full((n,), width, dtype=torch.int64,
                                      device=self.device))
        return torch.where(rank < m[:, None], fresh, src)

    def sets(self, src: torch.Tensor) -> torch.Tensor:
        """(n, widest) int32 sorted distinct items of each user, -1 after."""
        return trimmed(unique_rows(src)).contiguous()
