"""Batched similarity-search service over C-MinHash signatures, on a card.

The index and query path is owned by the sharded SketchStore plane:
signatures live as b-bit packed words partitioned across ``n_shards``
in-process shards, LSH bucketing is open-addressing host state per shard,
and a query batch is answered with one band-hash fold broadcast to every
shard, per-shard probe + scoring on the device, and a mergeable top-k
reduction.  ``n_shards`` changes where items live, never what a query
answers.

Ingest runs the fused sign -> pack path: words leave the signing kernel
packed (``SketchEngine.sign``) and are indexed from the words directly.
``IngestPipeline`` adds double-buffering on top: CUDA launches return at
once, so batch N+1's signing runs on the card while batch N scatters into
the shards on the host; the copy of batch N's words to the host is the one
synchronisation.

Ported: the in-process plane with packed (word-aligned) banding, for
sparse index lists and dense (B, D) rows.  The tcp transport, replicas and
streaming are later slices (ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..core.engine import SketchConfig, SketchEngine
from ..device import DEFAULT_DEVICE, u32_to_host
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..store import ShardedSketchStore, StoreConfig

TRANSPORTS = ("inproc",)
LAYOUTS = ("sparse", "dense")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    d: int = 1 << 16
    k: int = 256
    n_bands: int = 32
    rows_per_band: int = 8
    seed: int = 0
    b: int = 32                 # stored bits per hash (32 = exact scoring)
    n_slots: int = 2048         # initial LSH table slots per band (per shard)
    bucket_width: int = 8       # initial postings per bucket
    n_shards: int = 1           # index partitions (1 = single-store path)
    partition: str = "round_robin"   # or "hash" (see store/sharded.py)
    probe_impl: str = "auto"    # host-walk probe backend: numpy | device
    query_impl: str = "auto"    # query pipeline: auto (device) | host
    transport: str = "inproc"   # shard backend (only inproc is ported)
    device: str = DEFAULT_DEVICE


class SimilaritySearchService:
    def __init__(self, cfg: SearchConfig, *,
                 params: tuple[torch.Tensor, torch.Tensor] | None = None):
        """``params=(sigma, pi)`` signs with given permutations (e.g. the
        reference's, via ``convert.permutations_from_jax``)."""
        if cfg.n_bands * cfg.rows_per_band != cfg.k:
            raise ValueError("n_bands * rows_per_band must equal k")
        if cfg.transport not in TRANSPORTS:
            raise NotImplementedError(
                f"transport={cfg.transport!r} is not ported yet (ROADMAP.md, "
                "'Modules still to port', tcp transport); use 'inproc'")
        if cfg.rows_per_band % (32 // cfg.b):
            raise NotImplementedError(
                "raw-signature ingest (rows_per_band % (32/b) != 0) is not "
                "ported yet (ROADMAP.md); pick word-aligned bands")
        self.cfg = cfg
        self.engine = SketchEngine(SketchConfig(d=cfg.d, k=cfg.k,
                                                seed=cfg.seed),
                                   device=cfg.device, params=params)
        store_cfg = StoreConfig(k=cfg.k, n_bands=cfg.n_bands,
                                rows_per_band=cfg.rows_per_band, b=cfg.b,
                                n_slots=cfg.n_slots,
                                bucket_width=cfg.bucket_width)
        self.store = ShardedSketchStore(
            store_cfg, n_shards=cfg.n_shards, partition=cfg.partition,
            probe_impl=cfg.probe_impl, query_impl=cfg.query_impl,
            device=cfg.device)
        self._tracer = obs_trace.default()
        reg = obs_metrics.default()
        self._h_query = reg.histogram("service.query")
        self._h_sign = reg.histogram("service.sign")

    def _sign(self, data, layout: str) -> torch.Tensor:
        """Launch signing for one batch (asynchronous): packed words on the
        device."""
        return self.engine.sign(data, layout=layout, pack_b=self.cfg.b)

    def _scatter(self, words: np.ndarray) -> None:
        self.store.add_packed(words)

    # -- indexing ----------------------------------------------------------
    def add_sparse(self, idx: np.ndarray) -> None:
        self._scatter(u32_to_host(self._sign(idx, "sparse")))

    def add_dense(self, v: np.ndarray) -> None:
        self._scatter(u32_to_host(self._sign(v, "dense")))

    def pipeline(self, *, depth: int = 2,
                 layout: str = "sparse") -> "IngestPipeline":
        """A double-buffered ingest session over this service's store."""
        return IngestPipeline(self, depth=depth, layout=layout)

    @property
    def size(self) -> int:
        return self.store.size

    # -- querying ----------------------------------------------------------
    def query_sparse(self, idx: np.ndarray, top_k: int = 10):
        """(Q, NNZ) padded shingle lists -> (ids (Q, top_k) int64 [-1 pad],
        scores (Q, top_k) float32).  Rows with no bucket hit in any shard
        fall back to brute force over the whole index."""
        return self._traced_query(idx, "sparse", top_k)

    def query_dense(self, v: np.ndarray, top_k: int = 10):
        """(Q, D) binary rows -> the same answers as ``query_sparse`` of
        their set positions."""
        return self._traced_query(v, "dense", top_k)

    def _traced_query(self, data, layout: str, top_k: int):
        """The traced front door: the root span opens here, the sign leg is
        its first child, and the store's fold, probe, score and merge nest
        beneath it."""
        t_wall = time.perf_counter()
        with self._tracer.span("query") as root:
            root.tag("n", len(data)).tag("top_k", top_k)
            if self.store.size <= 0:
                raise ValueError(
                    "query on an empty index: add documents before querying "
                    "(the brute-force fallback has nothing to score)")
            t0 = time.perf_counter()
            with self._tracer.span("query.sign"):
                qwords = self._sign(data, layout)     # stays on the device
            self._h_sign.observe(time.perf_counter() - t0)
            out = self.store.query_packed(qwords, top_k)
        self._h_query.observe(time.perf_counter() - t_wall)
        return out

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self.store.close()

    def __enter__(self) -> "SimilaritySearchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class IngestPipeline:
    """Double-buffered ingest: sign batch N+1 while batch N scatters.

    ``submit(batch)`` launches signing for the batch (asynchronous: no host
    copy) and enqueues the device tensor; once ``depth`` batches are in
    flight the oldest is drained: its words are copied to the host (waiting
    only for whatever device work is still outstanding) and scattered into
    the shards.  ``depth=1`` is the serial path.  Scatter order always
    equals submit order, so for any depth the store state is bit-identical
    to serial ingestion of the same batches.

    The wall-time split lives in the registry as per-batch histograms
    ``ingest.sign`` (launch), ``ingest.wait`` (device sync), ``ingest.scatter``
    (store writes) and ``ingest.wall``; ``timings`` sums them for this
    pipeline.
    """

    _STAGES = ("sign", "wait", "scatter", "wall")

    def __init__(self, service: SimilaritySearchService, *, depth: int = 2,
                 layout: str = "sparse"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        self.service = service
        self.depth = depth
        self.layout = layout
        self._inflight: collections.deque = collections.deque()
        reg = obs_metrics.default()
        self._h = {s: reg.histogram(f"ingest.{s}") for s in self._STAGES}
        self._base = {s: self._h[s].sum for s in self._STAGES}
        self.n_batches = 0
        self.n_items = 0

    @property
    def timings(self) -> dict:
        out = {f"{s}_s": self._h[s].sum - self._base[s]
               for s in self._STAGES}
        out["n_batches"] = self.n_batches
        out["n_items"] = self.n_items
        return out

    def __len__(self) -> int:
        return len(self._inflight)

    def submit(self, batch) -> None:
        """Sign one batch (asynchronously) and scatter whatever is due."""
        t0 = time.perf_counter()
        signed = self.service._sign(batch, self.layout)
        self._h["sign"].observe(time.perf_counter() - t0)
        self._inflight.append((signed, len(batch)))
        while len(self._inflight) >= self.depth:
            self._drain_one()
        self._h["wall"].observe(time.perf_counter() - t0)

    def _drain_one(self) -> None:
        signed, n = self._inflight.popleft()
        t0 = time.perf_counter()
        host = u32_to_host(signed)         # sync: outstanding device work
        t1 = time.perf_counter()
        self.service._scatter(host)
        self._h["wait"].observe(t1 - t0)
        self._h["scatter"].observe(time.perf_counter() - t1)
        self.n_batches += 1
        self.n_items += n

    def flush(self) -> None:
        """Drain every in-flight batch (the pipeline stays usable)."""
        t0 = time.perf_counter()
        while self._inflight:
            self._drain_one()
        self._h["wall"].observe(time.perf_counter() - t0)

    def __enter__(self) -> "IngestPipeline":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.flush()
