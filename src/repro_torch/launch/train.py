"""Training launcher for one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
        --reduced --steps 50 --dedup --workdir runs/train_llama

The flags and ``[launch]`` lines of ``python -m repro.launch.train``, plus
``--device`` (``cuda``, the default, needs a card and raises without one;
``cpu`` runs the port's plain PyTorch path).  ``--dedup`` first dedups a
400-document synthetic corpus with ``data.dedup.dedup_corpus`` on the
device (C-MinHash at D = 2^14, K = 256: one launch of the sparse signing
kernel on the card), then trains on the kept documents through
``deduped_token_batches`` and ``PrefetchIterator``.  Without ``--reduced``
the published config trains at full width.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.data.dedup import DedupConfig, dedup_corpus
from repro_torch.data.loader import PrefetchIterator, deduped_token_batches
from repro_torch.data.synthetic import corpus_with_duplicates, token_batches
from repro_torch.models import build
from repro_torch.train.train_loop import TrainLoop


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), dedup and train; returns
    ``TrainLoop.run``'s dict and ``"dedup"``, the ``DedupResult`` (or
    None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--dedup", action="store_true",
                    help="run the C-MinHash dedup pipeline first")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16"])
    ap.add_argument("--workdir", default="runs/train")
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    bundle = build(cfg, device=args.device)
    print(f"[launch] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'FULL'})")

    res = None
    if args.dedup:
        docs, _ = corpus_with_duplicates(
            400, vocab=cfg.vocab_size_real, doc_len=max(args.seq, 128),
            dup_fraction=0.25, seed=0)
        res = dedup_corpus(docs, DedupConfig(
            d=1 << 14, k=256, n_bands=64, rows_per_band=4, threshold=0.5),
            device=bundle.device)
        print(f"[launch] dedup kept {len(res.keep)}/{len(docs)} docs")
        data = deduped_token_batches(docs, res.keep, args.batch, args.seq,
                                     vocab=cfg.vocab_size_real)
    else:
        data = token_batches(cfg.vocab_size_real, args.batch, args.seq)

    tc = TrainConfig(total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression,
                     checkpoint_every=max(args.steps // 4, 1))
    out = TrainLoop(bundle, tc, PrefetchIterator(data), args.workdir).run()
    if out["losses"]:
        print(f"[launch] final loss {np.mean(out['losses'][-5:]):.4f}, "
              f"stragglers flagged: {out['stragglers']}")
    return dict(out, dedup=res)


if __name__ == "__main__":
    main()
