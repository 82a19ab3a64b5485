"""Batched query planner: candidates -> dedupe -> one scoring call -> top-k.

The planner turns ragged per-query candidate lists (-1 padded rows from
``BandedLSHTable.lookup``) into one dense scoring problem on the device:
the batch's candidate union is scored against all queries in one collision
call, and each query ranks only its own candidates.

Results come out as **mergeable partials** (``TopKPartial``): padded
(Q, top_k) score/id pairs ordered by (score desc, id asc), with ``NEG_INF``
score / ``-1`` id padding, the layout ``distributed.collectives.merge_topk``
consumes.  Queries whose candidate row is empty fall back to brute force
over the whole index; in the sharded plane that decision is global, so
``partial_topk_packed`` reports per-row candidate presence instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_device_words, u32_to_device
from ..kernels import ops
from ..obs import trace as obs_trace
from .packed import PackedSignatureBuffer, pack_host

NEG_INF = np.float32(-np.inf)


def dedupe_union(cand_rows: np.ndarray) -> np.ndarray:
    """(Q, C) -1-padded candidate ids -> sorted unique union (U,) int64."""
    flat = cand_rows.reshape(-1)
    return np.unique(flat[flat >= 0]).astype(np.int64)


def candidate_mask(cand_rows: np.ndarray,
                   union_ids: np.ndarray) -> np.ndarray:
    """(Q, U) bool: union column u is a candidate of query q."""
    q = cand_rows.shape[0]
    mask = np.zeros((q, len(union_ids)), bool)
    rows, cols = np.nonzero(cand_rows >= 0)
    pos = np.searchsorted(union_ids, cand_rows[rows, cols])
    mask[rows, pos] = True
    return mask


@dataclasses.dataclass
class TopKPartial:
    """A mergeable top-k fragment: rows ordered (score desc, id asc),
    padded with ``NEG_INF`` score / ``-1`` id; ``has_candidates`` records
    which rows had >= 1 LSH candidate in this fragment."""

    ids: np.ndarray               # (Q, top_k) int64, -1 padded
    scores: np.ndarray            # (Q, top_k) float32, NEG_INF padded
    has_candidates: np.ndarray    # (Q,) bool

    @classmethod
    def from_device(cls, ids, scores, has) -> "TopKPartial":
        """Partial from the fused query path's host triple, normalized to
        the planner's dtypes and made writable."""
        return cls(np.array(ids, np.int64), np.array(scores, np.float32),
                   np.array(has, bool))


def finalize_topk(part: TopKPartial) -> tuple[np.ndarray, np.ndarray]:
    """Partial -> the public (ids [-1 pad], scores [0.0 pad]) contract."""
    hit = part.scores > NEG_INF
    ids = np.where(hit, part.ids, np.int64(-1))
    scores = np.where(hit, part.scores, np.float32(0.0)).astype(np.float32)
    return ids, scores


class QueryPlanner:
    def __init__(self, buffer: PackedSignatureBuffer):
        self.buffer = buffer

    def topk(self, qsigs: np.ndarray, cand_rows: np.ndarray,
             top_k: int) -> tuple[np.ndarray, np.ndarray]:
        """Score and rank candidates for (Q, K) int32 query signatures,
        packed on the host, then ``topk_packed``.  ``cand_rows``: (Q, C)
        int64 candidate ids per query, -1 padded.  Returns (ids (Q, top_k)
        int64 [-1 pad], scores (Q, top_k) float32)."""
        return self.topk_packed(pack_host(qsigs, self.buffer.cfg.b),
                                cand_rows, top_k)

    def topk_packed(self, qwords: np.ndarray, cand_rows: np.ndarray,
                    top_k: int) -> tuple[np.ndarray, np.ndarray]:
        """Rank candidates for (Q, W) uint32 query words: candidate-leg
        partial, then the brute-force leg for rows with no candidates."""
        part = self.partial_topk_packed(qwords, cand_rows, top_k)
        if self.buffer.size:
            em = np.flatnonzero(~part.has_candidates)
            if len(em):
                brute = self.brute_partial_packed(qwords[em], top_k)
                part.ids[em] = brute.ids
                part.scores[em] = brute.scores
        return finalize_topk(part)

    def partial_topk_packed(self, qwords: np.ndarray, cand_rows: np.ndarray,
                            top_k: int) -> TopKPartial:
        """Candidate-restricted partial: rows without candidates stay fully
        padded (no local brute-force fallback — that decision is global)."""
        q = qwords.shape[0]
        ids = np.full((q, top_k), -1, np.int64)
        scores = np.full((q, top_k), NEG_INF, np.float32)
        has = np.asarray(cand_rows >= 0).any(axis=1) if cand_rows.size \
            else np.zeros(q, bool)
        ne = np.flatnonzero(has)
        if len(ne) and self.buffer.size:
            rows = cand_rows[ne]
            union_ids = dedupe_union(rows)
            words_n = u32_to_device(self.buffer.gather(union_ids),
                                    self.buffer.device)
            ids[ne], scores[ne] = self._rank(
                qwords[ne], union_ids, words_n,
                candidate_mask(rows, union_ids), top_k)
        return TopKPartial(ids, scores, has)

    def brute_partial_packed(self, qwords, top_k: int) -> TopKPartial:
        """Brute-force partial: every stored item scored for every row,
        against the resident device words.  ``qwords`` is a host array or
        a tensor; a tensor on the buffer's device is padded and scored
        there, with no host copy.  ``has_candidates`` is False throughout.
        Query rows are padded to the next power of two (repeating row 0),
        as in the reference, so the scoring shapes take few distinct
        values; the pad rows' results are sliced off.

        Under a traced query its legs are spans of the process's tracer:
        ``query.fallback.pad`` (tagged ``rows`` and ``padded``, the rows
        kernel 4 scores), then ``_rank``'s ``query.fallback.count``,
        ``.sort`` and ``.copy_out``."""
        q = qwords.shape[0]
        ids = np.full((q, top_k), -1, np.int64)
        scores = np.full((q, top_k), NEG_INF, np.float32)
        if self.buffer.size and q:
            union_ids = np.arange(self.buffer.size, dtype=np.int64)
            n_pad = (1 << (q - 1).bit_length()) - q
            with obs_trace.default().child("query.fallback.pad") as span:
                if span.sampled:
                    span.tag("rows", q).tag("padded", q + n_pad)
                qp = as_device_words(qwords, self.buffer.device)
                if n_pad:
                    qp = torch.cat([qp, qp[:1].expand(n_pad, -1)])
            ids_p, scores_p = self._rank(qp, union_ids,
                                         self.buffer.device_words(), None,
                                         top_k, legs="query.fallback")
            ids, scores = ids_p[:q], scores_p[:q]
        return TopKPartial(ids, scores, np.zeros(q, bool))

    def _rank(self, qwords, union_ids: np.ndarray,
              words_n: torch.Tensor, mask: np.ndarray | None,
              top_k: int, *, legs: str | None = None,
              ) -> tuple[np.ndarray, np.ndarray]:
        """Score (Q', U) on the device and select top-k per row from the
        masked columns (mask=None: all columns).  A stable sort on -count
        over ascending ``union_ids`` breaks ties by the smaller id, the
        reference's stable argsort on -score: score = count / k is
        monotone in count.  Returns partial-layout rows.  ``legs`` names
        the spans of the count, the sort and the copies to the host
        (``<legs>.count``, ``.sort``, ``.copy_out``); None opens none."""
        cfg = self.buffer.cfg
        dev = words_n.device
        q = qwords.shape[0]
        tracer = obs_trace.default()

        def leg(name: str):
            return obs_trace.NULL_SPAN if legs is None \
                else tracer.child(f"{legs}.{name}")

        with leg("count"):
            counts = ops.packed_collision_counts(
                as_device_words(qwords, dev).contiguous(), words_n, cfg.k,
                cfg.b)
        if mask is not None:
            counts = torch.where(torch.tensor(mask, device=dev), counts, -1)
        kk = min(top_k, counts.shape[1])
        with leg("sort"):
            order = torch.sort(-counts, dim=1, stable=True).indices[:, :kk]
            top = torch.gather(counts, 1, order)
        with leg("copy_out"):
            top = top.cpu().numpy()
            order = order.cpu().numpy()
        hit = top >= 0
        ids = np.full((q, top_k), -1, np.int64)
        scores = np.full((q, top_k), NEG_INF, np.float32)
        ids[:, :kk] = np.where(hit, union_ids[order], -1)
        scores[:, :kk] = np.where(
            hit, top.astype(np.float32) / np.float32(cfg.k), NEG_INF)
        return ids, scores
