"""Plain reference of C-MinHash top-k search, for the configurations that
serve ``SimilaritySearchService.query_sparse``.

It imports nothing of the program and takes nothing it made: the sets and
the two permutations come from the harness, which hands the same ones to
the service.  Plain torch, in blocks, on whatever device the sets are on.

The semantics it holds the service to:

* A set's code ``q`` (q = 1..K) is ``min_j pi[(sigma[x_j] - q) mod D]``
  over its entries ``x_j`` (C-MinHash-(sigma, pi), the paper's
  Algorithm 3); the index stores each code's low ``b`` bits (all of them
  at b = 32), packed little-endian, ``32 / b`` codes to a uint32 word.
* Bands: K = n_bands x rows_per_band consecutive stored codes.  An indexed
  set is a candidate of a query when they agree on every code of at least
  one band.
* A query with a candidate is answered from its candidates, one with none
  from the whole index.  Score = (equal stored codes) / K as float32;
  the top_k by score descending, ties to the smaller id; ids -1 and
  scores 0 pad a row with fewer than top_k candidates.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 2 ** 31 - 1
_ELEMS = 1 << 25            # elements of the largest gather temporary
_CMP_ELEMS = 1 << 28        # elements of the largest compare temporary
# odd 64-bit multipliers of the band fingerprint (any fixed odd numbers)
_MULT = [int(m) | 1 for m in np.random.default_rng(20240607).integers(
    1, 2 ** 62, size=64, dtype=np.int64)]


def signatures(sets: torch.Tensor, sigma: torch.Tensor, pi: torch.Tensor,
               k: int) -> torch.Tensor:
    """(n, w) int32 sets, -1 padded -> (n, k) int32 codes; a set with no
    entry gets ``SENTINEL`` throughout.  Rows are taken in order of length,
    so a block pads only to its own widest."""
    d = pi.numel()
    dev = sets.device
    n = sets.shape[0]
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    length = (sets >= 0).sum(dim=1)
    order = length.argsort()
    lens = np.maximum(length[order].cpu().numpy(), 1)
    q = torch.arange(1, k + 1, device=dev)
    sig = sigma.to(torch.int64)
    pi32 = pi.to(torch.int32)
    lo = 0
    while lo < n:
        # the longest block from lo whose widest row keeps under _ELEMS
        cost = lens[lo:] * np.arange(1, n - lo + 1) * k
        hi = lo + max(1, int(np.searchsorted(cost, _ELEMS, side="right")))
        sel = order[lo:hi]
        # entries first (padding may sit anywhere in a row), then trimmed
        x = sets[sel].sort(dim=1, descending=True).values[
            :, : int(lens[hi - 1])].to(torch.int64)
        pos = torch.remainder(sig[x.clamp(min=0)][:, :, None] - q, d)
        val = torch.where(x[:, :, None] >= 0, pi32[pos], SENTINEL)
        out[sel] = val.amin(dim=1)
        lo = hi
    return out


def stored(codes: torch.Tensor, b: int) -> torch.Tensor:
    """The low ``b`` bits of each code, as the index keeps them (int64)."""
    c = codes.to(torch.int64) & 0xFFFFFFFF
    return c if b == 32 else c & ((1 << b) - 1)


def packed_words(codes: torch.Tensor, b: int) -> np.ndarray:
    """(n, k) codes -> (n, ceil(k / (32 / b))) host uint32 words."""
    c = stored(codes, b)
    n, k = c.shape
    per = 32 // b
    width = -(-k // per)
    c = torch.nn.functional.pad(c, (0, width * per - k))
    shifts = torch.arange(per, device=c.device) * b
    words = (c.reshape(n, width, per) << shifts).sum(dim=-1)
    return words.cpu().numpy().astype(np.uint32)


class Index:
    """The reference's banded index over its own stored codes."""

    def __init__(self, codes: torch.Tensor, *, n_bands: int,
                 rows_per_band: int, b: int):
        if n_bands * rows_per_band != codes.shape[1]:
            raise ValueError("n_bands * rows_per_band must equal K")
        if rows_per_band > len(_MULT):
            raise ValueError(f"at most {len(_MULT)} rows a band")
        self.k = codes.shape[1]
        self.b = b
        self.n_bands = n_bands
        self.r = rows_per_band
        self.codes = stored(codes, b)
        self.n = codes.shape[0]
        keys = self._band_keys(self.codes)                  # (n, bands)
        self.sorted_keys, self.order = keys.t().contiguous().sort(dim=1)

    def _bands(self, c: torch.Tensor) -> torch.Tensor:
        return c.reshape(c.shape[0], self.n_bands, self.r)

    def _band_keys(self, c: torch.Tensor) -> torch.Tensor:
        mult = torch.tensor(_MULT[: self.r], dtype=torch.int64,
                            device=c.device)
        return ((self._bands(c) + 1) * mult).sum(dim=-1)   # wraps mod 2^64

    def candidates(self, qcodes: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(Q, K) stored query codes -> (rows, items) of every distinct
        (query, candidate) pair, ordered by row then item, and (Q,) the
        size of the largest band group each query hits."""
        qn = qcodes.shape[0]
        dev = qcodes.device
        qk = self._band_keys(qcodes).t().contiguous()       # (bands, Q)
        rows, items = [], []
        largest = torch.zeros(qn, dtype=torch.int64, device=dev)
        for band in range(self.n_bands):
            sk = self.sorted_keys[band]
            lo = torch.searchsorted(sk, qk[band], right=False)
            hi = torch.searchsorted(sk, qk[band], right=True)
            cnt = hi - lo
            largest = torch.maximum(largest, cnt)
            if not int(cnt.sum()):
                continue
            r = torch.repeat_interleave(torch.arange(qn, device=dev), cnt)
            start = torch.repeat_interleave(lo, cnt)
            first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
            it = self.order[band][start + torch.arange(r.numel(),
                                                       device=dev) - first]
            # a fingerprint match counts only where the band's codes agree
            same = (self._bands(qcodes)[r, band]
                    == self._bands(self.codes)[it, band]).all(dim=1)
            rows.append(r[same])
            items.append(it[same])
        if not rows:
            empty = torch.zeros(0, dtype=torch.int64, device=dev)
            return empty, empty, largest
        pair = torch.unique(torch.cat(rows) * self.n + torch.cat(items))
        return pair // self.n, pair % self.n, largest

    def answers(self, qcodes_raw: torch.Tensor, top_k: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(Q, K) query codes -> host (ids (Q, top_k) int64, scores (Q,
        top_k) float32, has_candidates (Q,) bool, largest band group hit
        (Q,) int64)."""
        qc = stored(qcodes_raw, self.b)
        qn = qc.shape[0]
        dev = qc.device
        ids = torch.full((qn, top_k), -1, dtype=torch.int64, device=dev)
        cnt = torch.full((qn, top_k), -1, dtype=torch.int64, device=dev)
        rows, items, largest = self.candidates(qc)
        has = torch.zeros(qn, dtype=torch.bool, device=dev)
        has[rows] = True
        if rows.numel():
            c = torch.empty_like(rows)
            step = max(1, _ELEMS // self.k)
            for lo in range(0, rows.numel(), step):
                r, it = rows[lo: lo + step], items[lo: lo + step]
                c[lo: lo + step] = (qc[r] == self.codes[it]).sum(dim=1)
            # within a row: count descending, then id ascending
            span = (self.k + 1) * self.n
            key = rows * span + (self.k - c) * self.n + items
            key, idx = key.sort()
            r, it, cc = rows[idx], items[idx], c[idx]
            start = torch.searchsorted(r, r, right=False)
            rank = torch.arange(r.numel(), device=dev) - start
            keep = rank < top_k
            ids[r[keep], rank[keep]] = it[keep]
            cnt[r[keep], rank[keep]] = cc[keep]
        brute = torch.nonzero(~has).flatten()
        if brute.numel():
            b_ids, b_cnt = self.brute(qc[brute], top_k)
            ids[brute] = b_ids
            cnt[brute] = b_cnt
        hit = cnt >= 0
        scores = torch.where(hit, cnt.to(torch.float32) / self.k,
                             torch.zeros((), dtype=torch.float32,
                                         device=dev))
        ids = torch.where(hit, ids, -1)
        return (ids.cpu().numpy(), scores.cpu().numpy(), has.cpu().numpy(),
                largest.cpu().numpy())

    def brute(self, qc: torch.Tensor, top_k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k of every query over the whole index: (ids, counts), -1
        padded past the index's size."""
        qn = qc.shape[0]
        n = self.n
        dev = qc.device
        kk = min(top_k, n)
        ids = torch.full((qn, top_k), -1, dtype=torch.int64, device=dev)
        cnt = torch.full((qn, top_k), -1, dtype=torch.int64, device=dev)
        qb = max(1, min(qn, _CMP_ELEMS // (n * self.k)))
        nb = max(1, _CMP_ELEMS // (qb * self.k))
        rev = (n - 1 - torch.arange(n, device=dev))
        for lo in range(0, qn, qb):
            q = qc[lo: lo + qb]
            counts = torch.empty((q.shape[0], n), dtype=torch.int64,
                                 device=dev)
            for c0 in range(0, n, nb):
                counts[:, c0: c0 + nb] = (q[:, None, :] == self.codes[
                    None, c0: c0 + nb, :]).sum(dim=-1)
            key = counts * n + rev              # count desc, then id asc
            top = key.topk(kk, dim=1, sorted=True).values
            ids[lo: lo + qb, :kk] = n - 1 - top % n
            cnt[lo: lo + qb, :kk] = top // n
        return ids, cnt
