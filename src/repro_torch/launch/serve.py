"""Similarity-search serving launcher for the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --docs 400

Builds a synthetic corpus with planted near-duplicates, ingests it through
the pipelined fused sign -> pack path and answers one query batch of
indexed documents, printing the same ``[serve] ingest ...`` and
``[serve] search ...`` lines as ``python -m repro.launch.serve --mode
search``.  ``--device cuda`` (the default) needs a card and raises without
one; ``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.shingle import batch_shingles
from repro_torch.data.synthetic import corpus_with_duplicates
from repro_torch.serve.search import SearchConfig, SimilaritySearchService


def serve_search(args) -> None:
    docs, _ = corpus_with_duplicates(args.docs, vocab=30_000, doc_len=256,
                                     dup_fraction=0.4, seed=0)
    idx = batch_shingles(docs, n=3, d=1 << 14)
    with SimilaritySearchService(SearchConfig(
            d=1 << 14, k=256, n_bands=64, rows_per_band=4,
            n_shards=args.shards, partition=args.partition,
            probe_impl=args.probe, query_impl=args.query_impl,
            device=args.device)) as svc:
        bs = max(1, min(args.ingest_batch, len(idx)))
        t0 = time.perf_counter()
        with svc.pipeline(depth=args.pipeline_depth) as pipe:
            for lo in range(0, len(idx), bs):
                pipe.submit(idx[lo: lo + bs])
        t_ingest = time.perf_counter() - t0
        tm = pipe.timings
        print(f"[serve] ingest {svc.size} docs in {t_ingest * 1e3:.1f} ms "
              f"(depth={args.pipeline_depth}, "
              f"{svc.size / t_ingest:.0f} docs/s; sign={tm['sign_s'] * 1e3:.0f}ms "
              f"wait={tm['wait_s'] * 1e3:.0f}ms "
              f"scatter={tm['scatter_s'] * 1e3:.0f}ms)")
        t0 = time.perf_counter()
        ids, scores = svc.query_sparse(idx[: args.batch], top_k=5)
        dt = time.perf_counter() - t0
        sizes = svc.store.shard_sizes().tolist()
        print(f"[serve] search over {svc.size} docs "
              f"({args.shards} shard(s) {sizes}, probe={args.probe}, "
              f"query={args.query_impl}, transport=inproc, "
              f"device={svc.engine.device}): "
              f"{args.batch} queries in {dt * 1e3:.1f} ms; top-1 self-hit "
              f"{(ids[:, 0] == np.arange(args.batch)).mean() * 100:.0f}%")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["search"], default="search",
                    help="search serving (LM serving is not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--docs", type=int, default=400)
    ap.add_argument("--shards", type=int, default=1,
                    help="index partitions (in process)")
    ap.add_argument("--partition", choices=["round_robin", "hash"],
                    default="round_robin")
    ap.add_argument("--probe", choices=["auto", "numpy", "device"],
                    default="auto",
                    help="probe backend of the host query walk")
    ap.add_argument("--query-impl", choices=["auto", "host"], default="auto",
                    help="auto = the fused device pipeline; host = the host "
                         "fold + planner walk")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ingest batches signed-but-unscattered in flight "
                         "(1 = serial sign -> scatter)")
    ap.add_argument("--ingest-batch", type=int, default=128,
                    help="documents per ingest pipeline batch")
    args = ap.parse_args()
    serve_search(args)


if __name__ == "__main__":
    main()
