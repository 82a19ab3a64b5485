"""Near-duplicate removal with C-MinHash + LSH on the PyTorch port.

Generates a corpus with planted near-duplicate clusters, dedups it with the
2-permutation sketch engine (one launch of the sparse signing kernel on a
card), and reports pair precision/recall against the planted truth.

    PYTHONPATH=src python examples/dedup_pipeline_torch.py [--docs 300] [--device cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

from repro_torch.data.dedup import (DedupConfig, dedup_corpus,  # noqa: E402
                                    dedup_metrics)
from repro_torch.data.synthetic import corpus_with_duplicates   # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=300)
    ap.add_argument("--dup-fraction", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    docs, labels = corpus_with_duplicates(
        args.docs, vocab=30_000, doc_len=256,
        dup_fraction=args.dup_fraction, seed=0)
    cfg = DedupConfig(d=1 << 14, k=256, n_bands=64, rows_per_band=4,
                      threshold=0.5)
    print(f"dedup: {args.docs} docs, shingle universe 2^14, K={cfg.k}, "
          f"{cfg.n_bands}x{cfg.rows_per_band} bands (2 permutations total) "
          f"on {args.device}")
    t0 = time.perf_counter()
    res = dedup_corpus(docs, cfg, device=args.device)
    dt = time.perf_counter() - t0
    m = dedup_metrics(res, labels)
    print(f"  kept {m['kept']}/{m['total']} docs "
          f"({res.n_candidates} candidates, {res.n_verified} verified)")
    print(f"  pair precision = {m['precision']:.3f}, recall = {m['recall']:.3f}")
    print(f"  {args.docs / dt:.0f} docs/s end-to-end on {args.device}")


if __name__ == "__main__":
    main()
