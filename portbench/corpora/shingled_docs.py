"""Web pages as sets of token n-gram shingles.

A page is ``doc_len`` tokens drawn from the Zipf law that numpy's
``Generator.zipf(alpha)`` samples, folded onto ``[2, vocab)`` (ranks wrap
modulo ``vocab - 2``).  Its set is the page's n-gram rolling hashes
(``h = h * P1 + t * P2``, wrapping) taken modulo ``d``.  Near-copies
resample ``edit_fraction`` of a page's token positions.

Everything is drawn on ``device`` in a few large calls from one
``torch.Generator``: the tokens by inverse CDF from one uniform draw, the
edit positions by sorting one uniform draw a row.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.rows import unique_rows

_P1 = 11400714819323198485
_P2 = 14029467366897019727
_MOD = (1 << 31) - 1          # the hash is kept modulo 2^31 (its low bits)
_FOLDS = 256                  # Zipf ranks summed exactly up to 256 folds


def folded_zipf_pmf(vocab: int, alpha: float) -> np.ndarray:
    """P(token = 2 + t) for t in [0, vocab - 2): the Zipf(alpha) rank law
    folded modulo ``vocab - 2``.  Ranks past ``_FOLDS`` folds (under 5% of
    the mass at alpha 1.2) are spread evenly."""
    m = vocab - 2
    t = np.arange(1, m + 1, dtype=np.float64)
    pmf = np.zeros(m)
    for j in range(_FOLDS):
        pmf += (t + j * m) ** -alpha
    head = pmf.sum()
    # the tail's mass, sum_{n > F m} n^-alpha, by the integral
    tail = (_FOLDS * m + 0.5) ** (1.0 - alpha) / (alpha - 1.0)
    pmf += tail / m
    return pmf / (head + tail)


class Corpus:
    def __init__(self, params: dict, d: int, gen: torch.Generator,
                 device: torch.device):
        if d >= 1 << 31:
            raise ValueError("shingled_docs keeps hashes modulo 2^31: d must "
                             "be below 2^31")
        self.p = params
        self.d = d
        self.gen = gen
        self.device = device
        cdf = np.cumsum(folded_zipf_pmf(params["vocab"], params["zipf_alpha"]))
        cdf[-1] = 1.0
        self._cdf = torch.tensor(cdf, dtype=torch.float64, device=device)

    def _tokens(self, n: int) -> torch.Tensor:
        u = torch.rand(n, generator=self.gen, dtype=torch.float64,
                       device=self.device)
        t = torch.searchsorted(self._cdf, u, right=True)
        return (2 + t.clamp(max=self._cdf.numel() - 1)).to(torch.int32)

    def draw(self, n: int) -> torch.Tensor:
        """(n, doc_len) int32 tokens of fresh pages."""
        return self._tokens(n * self.p["doc_len"]).reshape(n, self.p["doc_len"])

    def edit(self, src: torch.Tensor, fraction: float) -> torch.Tensor:
        """Near-copies of ``src``'s pages: ``int(doc_len * fraction)``
        distinct token positions of each resampled."""
        n, length = src.shape
        m = int(length * fraction)
        out = src.clone()
        if m and n:
            keys = torch.rand((n, length), generator=self.gen,
                              device=self.device)
            pos = keys.argsort(dim=1)[:, :m]
            out.scatter_(1, pos, self._tokens(n * m).reshape(n, m))
        return out

    def sets(self, src: torch.Tensor) -> torch.Tensor:
        """(n, doc_len - shingle_n + 1) int32 sorted unique shingles of each
        page, -1 after them."""
        k = self.p["shingle_n"]
        t = src.to(torch.int64)
        width = t.shape[1] - k + 1
        p1, p2 = _P1 & _MOD, _P2 & _MOD
        h = torch.zeros((t.shape[0], width), dtype=torch.int64,
                        device=t.device)
        for i in range(k):
            h = (h * p1 + t[:, i: i + width] * p2) & _MOD
        return unique_rows(h % self.d)

