"""SketchEngine — batched C-MinHash signing on one device.

Holds the paper's two permutations on the device and routes every batch
through the kernel front door (``kernels.dispatch``).  ``sign_packed`` is
the fused ingest path: words leave the kernel already truncated to b bits
and packed, so the (B, K) int32 form never reaches the host.

One card, no mesh.  Dense (B, D) rows go to the int8 or the bit-packed
kernel (``dispatch.select_dense_impl``), sparse index lists to the
window-min kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels import dispatch
from ..obs import metrics as obs_metrics
from .permutations import make_two_permutations

@dataclasses.dataclass(frozen=True)
class SketchConfig:
    d: int                      # universe size (shingle space)
    k: int = 1024               # signature length
    use_sigma: bool = True      # C-MinHash-(sigma,pi) vs -(0,pi)
    seed: int = 0               # torch.Generator seed when no params given


class SketchEngine:
    """Batched signer on ``device``.  ``params=(sigma, pi)`` signs with
    given permutations (e.g. ``convert.permutations_from_jax``); otherwise
    they are drawn from ``torch.Generator().manual_seed(cfg.seed)``."""

    def __init__(self, cfg: SketchConfig, *,
                 device: str | torch.device = DEFAULT_DEVICE,
                 params: tuple[torch.Tensor, torch.Tensor] | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            sigma, pi = make_two_permutations(gen, cfg.d, device=self.device)
        else:
            sigma, pi = (p.to(self.device, torch.int32).contiguous()
                         for p in params)
            ident = torch.arange(cfg.d, dtype=torch.int32,
                                 device=self.device)
            if sigma.shape != (cfg.d,) or pi.shape != (cfg.d,) or not all(
                    torch.equal(p.sort().values, ident) for p in (sigma, pi)):
                raise ValueError(f"params must be two permutations of "
                                 f"[0, {cfg.d})")
        self.pi = pi
        self.sigma = sigma if cfg.use_sigma else None
        reg = obs_metrics.default()
        self._c_dense = reg.counter("engine.sign.dense")
        self._c_sparse = reg.counter("engine.sign.sparse")
        self._c_rows = reg.counter("engine.sign.rows")

    def _on_device(self, data) -> torch.Tensor:
        if isinstance(data, torch.Tensor):
            return data.to(self.device)
        return torch.tensor(np.asarray(data), device=self.device)

    def signatures_dense(self, v, *,
                         pack_b: int | None = None) -> torch.Tensor:
        """(B, D) binary rows -> (B, K) int32 signatures ((B, W) int32
        packed words when ``pack_b`` is set), on the device."""
        self._c_dense.inc()
        self._c_rows.inc(len(v))
        return dispatch.signatures_dense(
            self._on_device(v), self.pi, self.cfg.k, self.sigma,
            pack_b=pack_b)

    def signatures_sparse(self, idx, *,
                          pack_b: int | None = None) -> torch.Tensor:
        """(B, NNZ) padded index lists -> (B, K) int32 signatures ((B, W)
        int32 packed words when ``pack_b`` is set), on the device."""
        self._c_sparse.inc()
        self._c_rows.inc(len(idx))
        return dispatch.signatures_sparse(
            self._on_device(idx), self.pi, self.cfg.k, self.sigma,
            pack_b=pack_b)

    def sign_packed(self, data, b: int, *,
                    layout: str = "sparse") -> torch.Tensor:
        """Fused sign -> pack: data -> (B, ceil(K/(32/b))) int32 words,
        bit-identical to ``pack_codes(signatures_<layout>(data), b)``."""
        if layout == "dense":
            return self.signatures_dense(data, pack_b=b)
        if layout == "sparse":
            return self.signatures_sparse(data, pack_b=b)
        raise ValueError(f"unknown layout {layout!r}")

    def sign(self, data, *, layout: str = "sparse",
             pack_b: int | None = None) -> torch.Tensor:
        """One signing front door.  Returns a device tensor without
        synchronising: CUDA launches are asynchronous, so the kernel runs
        while the caller goes on, until someone copies the result to the
        host.  ``serve.search.IngestPipeline`` overlaps exactly that gap."""
        if pack_b is not None:
            return self.sign_packed(data, pack_b, layout=layout)
        if layout == "dense":
            return self.signatures_dense(data)
        if layout == "sparse":
            return self.signatures_sparse(data)
        raise ValueError(f"unknown layout {layout!r}")

    @functools.cached_property
    def parameter_bytes(self) -> int:
        """Memory for the hashing parameters — the paper's headline win."""
        n = 2 if self.sigma is not None else 1
        return n * self.cfg.d * 4

    @staticmethod
    def classical_parameter_bytes(d: int, k: int) -> int:
        """What Algorithm 1 would need instead: K permutations of D."""
        return k * d * 4
