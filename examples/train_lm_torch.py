"""End-to-end training on the PyTorch port: C-MinHash dedup ->
fault-tolerant LM training, on the card (``--device cuda``, the default) or
the CPU.  The twin of ``examples/train_lm.py``.

Default is a quick run (~25M params, 40 steps). ``--model 100m --steps 300``
runs the full exercise.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 40] \
        [--model small] [--device cpu]
"""

import argparse
import dataclasses
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np                                             # noqa: E402

from repro_torch.configs import get_config, reduced            # noqa: E402
from repro_torch.configs.base import TrainConfig               # noqa: E402
from repro_torch.data.dedup import DedupConfig, dedup_corpus   # noqa: E402
from repro_torch.data.loader import PrefetchIterator, \
    deduped_token_batches                                       # noqa: E402
from repro_torch.data.synthetic import corpus_with_duplicates  # noqa: E402
from repro_torch.models import build                            # noqa: E402
from repro_torch.train.train_loop import TrainLoop              # noqa: E402

MODELS = {
    # ~25M params: quick demo
    "small": dict(layers=6, d_model=384, vocab=8192),
    # ~110M params: the "real" run
    "100m": dict(layers=12, d_model=768, vocab=32000),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--model", choices=MODELS, default="small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a card) or cpu")
    args = ap.parse_args()

    m = MODELS[args.model]
    cfg = reduced(get_config("llama3_2_1b"), layers=m["layers"],
                  d_model=m["d_model"], vocab=m["vocab"])
    cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4,
                              head_dim=m["d_model"] // 8,
                              d_ff=4 * m["d_model"], q_chunk=128)
    bundle = build(cfg, device=args.device)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size})")

    # stage 1: dedup the corpus with the paper's 2-permutation sketch
    docs, _ = corpus_with_duplicates(400, vocab=cfg.vocab_size_real,
                                     doc_len=512, dup_fraction=0.25, seed=0)
    res = dedup_corpus(docs, DedupConfig(d=1 << 14, k=256, n_bands=64,
                                         rows_per_band=4, threshold=0.5),
                       device=bundle.device)
    print(f"dedup: kept {len(res.keep)}/{len(docs)} documents")

    # stage 2: fault-tolerant training on the deduped stream
    data = PrefetchIterator(deduped_token_batches(
        docs, res.keep, args.batch, args.seq, vocab=cfg.vocab_size_real))
    tc = TrainConfig(total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     learning_rate=3e-4,
                     checkpoint_every=max(args.steps // 4, 1))
    workdir = args.workdir or tempfile.mkdtemp(prefix="cminhash_lm_")
    print(f"workdir: {workdir} (re-run with --workdir to resume)")
    out = TrainLoop(bundle, tc, data, workdir).run()
    losses = out["losses"]
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"loss: first-{k}-avg {np.mean(losses[:k]):.4f} -> "
              f"last-{k}-avg {np.mean(losses[-k:]):.4f}")


if __name__ == "__main__":
    main()
