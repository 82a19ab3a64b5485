"""Quickstart on the PyTorch port: estimate Jaccard similarity with two
permutations.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np              # noqa: E402
import torch                    # noqa: E402

from repro_torch.core.engine import SketchConfig, SketchEngine    # noqa: E402
from repro_torch.core.estimators import (jaccard_from_signatures,  # noqa: E402
                                         true_jaccard_dense)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    d, k = 4096, 512

    # two binary vectors with ~70% overlap
    v = (rng.random(d) < 0.08).astype(np.int8)
    w = v.copy()
    flip = rng.random(d) < 0.02
    w[flip] = 1 - w[flip]
    batch = np.stack([v, w])

    engine = SketchEngine(SketchConfig(d=d, k=k, seed=42),
                          device=args.device)
    sigs = engine.signatures_dense(batch)           # (2, K) int32

    est = float(jaccard_from_signatures(sigs[0], sigs[1]))
    truth = float(true_jaccard_dense(torch.from_numpy(v),
                                     torch.from_numpy(w)))
    print(f"C-MinHash-(sigma,pi) with K={k} hashes from TWO permutations "
          f"on {engine.device}")
    print(f"  estimated J = {est:.4f}")
    print(f"  true      J = {truth:.4f}")
    print(f"  |error|     = {abs(est - truth):.4f}")
    print(f"  hashing parameter memory: {engine.parameter_bytes / 1024:.0f} KiB "
          f"(classical MinHash would need "
          f"{SketchEngine.classical_parameter_bytes(d, k) / 2**20:.1f} MiB)")


if __name__ == "__main__":
    main()
