"""Serving example on the PyTorch port: batched near-neighbor search over
C-MinHash signatures.

Builds an index over a corpus and serves batched queries (the paper's
approximate-near-neighbor application, Sec. 1). Reports recall@k against
brute-force Jaccard and end-to-end batch latency.

    PYTHONPATH=src python examples/similarity_search_torch.py \\
        [--docs 400 --queries 64 --b 32 --device cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np                                              # noqa: E402

from repro_torch.data.shingle import batch_shingles             # noqa: E402
from repro_torch.data.synthetic import corpus_with_duplicates   # noqa: E402
from repro_torch.serve.search import SearchConfig, \
    SimilaritySearchService                                     # noqa: E402


def _true_jaccard_rows(idx_a, idx_all):
    sa = [set(r[r >= 0].tolist()) for r in idx_a]
    sb = [set(r[r >= 0].tolist()) for r in idx_all]
    out = np.zeros((len(sa), len(sb)), np.float32)
    for i, A in enumerate(sa):
        for j, B in enumerate(sb):
            u = len(A | B)
            out[i, j] = len(A & B) / u if u else 0.0
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=400)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--b", type=int, default=32,
                    help="stored bits per hash (1, 2: raw-signature path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    docs, _ = corpus_with_duplicates(args.docs, vocab=30_000, doc_len=256,
                                     dup_fraction=0.5, cluster_size=2, seed=1)
    idx = batch_shingles(docs, n=3, d=1 << 14)
    svc = SimilaritySearchService(SearchConfig(
        d=1 << 14, k=256, n_bands=64, rows_per_band=4, b=args.b,
        device=args.device))
    t0 = time.perf_counter()
    svc.add_sparse(idx)
    print(f"indexed {svc.size} docs in {time.perf_counter() - t0:.2f}s "
          f"(2 permutations, K=256, b={args.b}, "
          f"{'packed' if svc.packed_ingest else 'raw'} ingest, "
          f"{svc.cfg.device})")

    # batched queries: the docs themselves (self + twin should rank top)
    q = idx[: args.queries]
    t0 = time.perf_counter()
    ids, scores = svc.query_sparse(q, top_k=args.topk)
    dt = time.perf_counter() - t0
    print(f"served {args.queries} queries in {dt * 1e3:.1f} ms "
          f"({args.queries / dt:.0f} q/s)")

    truth = _true_jaccard_rows(q, idx)
    hit = total = 0
    for qi in range(args.queries):
        order = np.argsort(-truth[qi])
        best_other = order[order != qi][0]
        if truth[qi, best_other] >= 0.3:        # a real near neighbor exists
            total += 1
            hit += int(best_other in ids[qi])
    print(f"recall@{args.topk} of true nearest neighbor (J>=0.3): "
          f"{hit}/{total} = {hit / max(total, 1) * 100:.0f}%")
    print(f"top-1 self-retrieval: "
          f"{(ids[:, 0] == np.arange(args.queries)).mean() * 100:.0f}%")


if __name__ == "__main__":
    main()
