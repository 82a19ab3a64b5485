"""Large-scale learning on b-bit C-MinHash features with the PyTorch port
(Li et al., NIPS 2011 — the application the paper's Sec. 1 cites for
K = 512/1024).

Two classes of binary vectors with class-dependent feature patterns; a
logistic model on K*2^b one-hot hashed features separates them while touching
only 2 permutations and b bits per hash.  Training gathers the weights the
codes pick, so the one-hot matrix is never built.

    PYTHONPATH=src python examples/hash_features_classifier_torch.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

from repro_torch.core.engine import SketchConfig, SketchEngine   # noqa: E402
from repro_torch.core.linear_model import (HashedLinearConfig,   # noqa: E402
                                           accuracy, fit_logistic)


def make_data(rng, n, templates, flip=0.02):
    """Samples = class template + per-sample feature flips."""
    t0, t1 = templates
    y = rng.integers(0, 2, n)
    x = np.where(y[:, None] == 0, t0, t1)
    x = x ^ (rng.random((n, len(t0))) < flip)
    return x.astype(np.int8), y.astype(np.int32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--train", type=int, default=512)
    ap.add_argument("--test", type=int, default=256)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    d, k = 4096, 256
    templates = (rng.random(d) < 0.05, rng.random(d) < 0.05)
    x_train, y_train = make_data(rng, args.train, templates)
    x_test, y_test = make_data(rng, args.test, templates)

    engine = SketchEngine(SketchConfig(d=d, k=k, seed=7), device=args.device)
    s_train = engine.signatures_dense(x_train)
    s_test = engine.signatures_dense(x_test)
    y_train = torch.from_numpy(y_train).to(engine.device)
    y_test = torch.from_numpy(y_test).to(engine.device)

    print(f"K={k} hashes from 2 permutations "
          f"({engine.parameter_bytes / 1024:.0f} KiB of hash parameters) "
          f"on {args.device}")
    print(f"{'b':>3} {'features':>9} {'bytes/doc':>9} {'test acc':>8}")
    for b in (1, 2, 4, 8):
        cfg = HashedLinearConfig(b=b)
        wb = fit_logistic(s_train, y_train, cfg)
        acc = accuracy(wb, s_test, y_test, b)
        print(f"{b:>3} {k * (1 << b):>9} {k * b // 8:>9} {acc:>8.3f}")
    print("(raw representation would be", d // 8, "bytes/doc)")


if __name__ == "__main__":
    main()
