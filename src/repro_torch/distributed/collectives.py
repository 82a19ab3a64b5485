"""Cross-shard reduction: the mergeable top-k of the sharded query plane.

``merge_topk`` merges padded per-shard top-k partials
(``store.planner.TopKPartial`` layout) into one, in the planner's own
(score desc, id asc) order, so S-shard answers equal the single-shard
ranking bit for bit.  A numpy copy of ``repro.distributed.collectives``'s.
"""

from __future__ import annotations

import numpy as np

TOPK_NEG_INF = np.float32(-np.inf)     # partial-row score padding


def merge_topk(scores_parts, ids_parts,
               top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge padded top-k partials from disjoint id sets into one partial.

    Each part is ``scores (Q, k_s) float32`` (``-inf`` = padding) plus
    ``ids (Q, k_s) int64`` (``-1`` = padding), rows ordered (score desc,
    id asc) — the ``QueryPlanner`` partial layout.  Selection here uses the
    same (score desc, id asc) order, which is exactly the single-shard
    planner's stable ranking (stable argsort over ascending union ids), so

        merge(shard partials) == single-shard top-k

    bit-for-bit.  The op is associative and commutative — parts may arrive
    in any order and merge in any grouping (a pairwise tree across hosts
    gives the same result as one flat concat) — because top-k under a strict
    total order is an associative reduction when id sets are disjoint.

    Returns ``(scores (Q, top_k), ids (Q, top_k))`` in partial layout.
    """
    scores = np.concatenate([np.asarray(s, np.float32)
                             for s in scores_parts], axis=1)
    ids = np.concatenate([np.asarray(i, np.int64)
                          for i in ids_parts], axis=1)
    q, m = scores.shape
    out_s = np.full((q, top_k), TOPK_NEG_INF, np.float32)
    out_i = np.full((q, top_k), -1, np.int64)
    if m == 0:
        return out_s, out_i
    take = min(top_k, m)
    # per-row lexsort: primary -score, secondary ascending id (padding rows
    # carry -inf scores and sink to the tail on their own)
    order = np.lexsort((ids, -scores))[:, :take]
    out_s[:, :take] = np.take_along_axis(scores, order, axis=1)
    out_i[:, :take] = np.take_along_axis(ids, order, axis=1)
    out_i[out_s <= TOPK_NEG_INF] = -1       # renormalize padding ids
    return out_s, out_i
