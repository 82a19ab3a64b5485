"""SketchEngine — batched C-MinHash signing, on one device or over a mesh.

Holds the paper's two permutations on the device and routes every batch
through the kernel front door (``kernels.dispatch``).  ``sign_packed`` is
the fused ingest path: words leave the kernel already truncated to b bits
and packed, so the (B, K) int32 form never reaches the host.  Dense (B, D)
rows go to the int8 or the bit-packed kernel
(``dispatch.select_dense_impl``), sparse index lists to the window-min
kernel.

Over a mesh (a ``DeviceMesh`` of ``launch.mesh``, one rank a device) the
rows split over the batch axes ``("pod", "data")``, as the reference
shards them, with pi and sigma the same on every rank.  A call is then
collective: every rank of the mesh calls it with the same host batch,
signs its block of rows (``sharding.local_slices``) on its own device
through the kernels, and the ranks' words are all-gathered over the batch
axes (``collectives.all_gather``, counted), so every rank returns the
whole (B, K) or (B, W).  A batch whose rows the batch axes do not divide
raises ``ValueError``, as the reference's ``device_put`` does.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..distributed import collectives as col
from ..distributed import sharding
from ..kernels import dispatch
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .permutations import make_two_permutations

@dataclasses.dataclass(frozen=True)
class SketchConfig:
    d: int                      # universe size (shingle space)
    k: int = 1024               # signature length
    use_sigma: bool = True      # C-MinHash-(sigma,pi) vs -(0,pi)
    autotune_measure: bool = False  # sweep-and-cache the launch geometry
                                    # on an autotune cache miss
    seed: int = 0               # torch.Generator seed when no params given


class SketchEngine:
    """Batched signer on ``device``.  ``params=(sigma, pi)`` signs with
    given permutations (e.g. ``convert.permutations_from_jax``); otherwise
    they are drawn from ``torch.Generator().manual_seed(cfg.seed)``, the
    same on every rank.  ``mesh=None`` signs on this device alone; with a
    mesh every signing call is collective (see the module docstring)."""

    def __init__(self, cfg: SketchConfig, mesh=None, *,
                 device: str | torch.device = DEFAULT_DEVICE,
                 params: tuple[torch.Tensor, torch.Tensor] | None = None):
        self.cfg = cfg
        self.mesh = mesh
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
        self._tracer = obs_trace.default()

    @functools.cached_property
    def local(self) -> "SketchEngine":
        """This engine without its mesh: the same pi, sigma and device, and
        no collective; its words equal the mesh's row for row (a caller
        whose batches differ between ranks, such as a stream's coalescer,
        signs with it)."""
        if self.mesh is None:
            return self
        solo = copy.copy(self)
        solo.mesh = None
        return solo

    def _on_device(self, data) -> torch.Tensor:
        """The rows this rank signs (all of them without a mesh), on the
        device.  Under a traced span the copy is its ``.upload`` leg (tagged
        with its bytes): ``query.sign.upload`` where a query signs."""
        if self.mesh is not None:
            rows = sharding.local_slices(
                (sharding.batch_axes(self.mesh),), (len(data),),
                self.mesh)[0]
            data = data[rows]
        with self._tracer.child(".upload") as span:
            if isinstance(data, torch.Tensor):
                out = data.to(self.device)
            else:
                out = torch.tensor(np.asarray(data), device=self.device)
            if span.sampled:
                span.tag("bytes", out.nbytes)
        return out

    def _gathered(self, out: torch.Tensor) -> torch.Tensor:
        """The ranks' rows of ``out`` in batch order (a mesh), or ``out``."""
        if self.mesh is None:
            return out
        return col.all_gather(out, self.mesh, sharding.batch_axes(self.mesh),
                              0)

    def signatures_dense(self, v, *,
                         pack_b: int | None = None) -> torch.Tensor:
        """(B, D) binary rows -> (B, K) int32 signatures ((B, W) int32
        packed words when ``pack_b`` is set), on the device."""
        self._c_dense.inc()
        self._c_rows.inc(len(v))
        return self._gathered(dispatch.signatures_dense(
            self._on_device(v), self.pi, self.cfg.k, self.sigma,
            pack_b=pack_b, autotune_measure=self.cfg.autotune_measure))

    def signatures_sparse(self, idx, *,
                          pack_b: int | None = None) -> torch.Tensor:
        """(B, NNZ) padded index lists -> (B, K) int32 signatures ((B, W)
        int32 packed words when ``pack_b`` is set), on the device."""
        self._c_sparse.inc()
        self._c_rows.inc(len(idx))
        return self._gathered(dispatch.signatures_sparse(
            self._on_device(idx), self.pi, self.cfg.k, self.sigma,
            pack_b=pack_b, autotune_measure=self.cfg.autotune_measure))

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
        host.  ``serve.search.IngestPipeline`` overlaps exactly that gap.
        (Over a mesh the all-gather waits for the rank's words.)"""
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
