"""Batched similarity-search service over C-MinHash signatures, on a card.

The index and query path is owned by the sharded SketchStore plane:
signatures live as b-bit packed words partitioned across ``n_shards``
in-process shards, LSH bucketing is open-addressing host state per shard,
and a query batch is answered with one band-hash fold broadcast to every
shard, per-shard probe + scoring on the device, and a mergeable top-k
reduction.  ``n_shards`` changes where items live, never what a query
answers.

Ingest runs the fused sign -> pack path whenever the banding is
word-aligned (``rows_per_band % (32/b) == 0``; always at the default b =
32): words leave the signing kernel packed (``SketchEngine.sign``) and are
indexed from the words directly.  Otherwise (b = 1 and 2 at the default
bands) the kernel returns raw (B, K) signatures, which the store bands on
the host and packs to b bits (``add``/``query``), as the JAX package does.
``IngestPipeline`` adds double-buffering on top: CUDA launches return at
once, so batch N+1's signing runs on the card while batch N scatters into
the shards on the host; the copy of batch N's output to the host is the one
synchronisation.

``transport`` picks where the shards live: ``"inproc"`` (default) runs
them in this process on ``device``; ``"tcp"`` spawns one shard worker
process per shard on localhost (``repro_torch.transport``), each with its
store on ``device`` (its own CUDA context on the same card), and talks the
framed wire protocol: the same answers bit for bit.  The coordinator still
signs and folds on the card; each batch's hashes and words cross to the
host once for the wire.  tcp services own their workers: call ``close()``
(or use the service as a context manager) to shut them down.

``n_replicas > 1`` or a ``journal_dir`` (tcp only) builds the replicated
plane (``repro_torch.replica``): R workers a shard on ``device``, a
write-ahead ingest journal and, by default, the supervisor that respawns
a dead worker on ``device``, replays the journal into it, checks its
digest against a live peer and brings it back.  ``stream()`` opens the
streaming front end (``serve.stream``): single queries in, coalesced
batches through the same query path.

Ported: the in-process, tcp and replicated planes and the streaming front
end, for sparse index lists and dense (B, D) rows.
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

TRANSPORTS = ("inproc", "tcp")
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
    transport: str = "inproc"   # shard backend: inproc | tcp (worker procs)
    query_timeout_s: float = 30.0    # fan-out deadline (tcp transport)
    hedge: bool = False         # hedged shard reads (tcp transport)
    hedge_delay_ms: float | None = None  # fixed hedge delay; None = derived
    # replication (tcp transport; see repro_torch.replica): R workers a
    # shard, a write-ahead ingest journal, and a self-healing supervisor.
    # At n_replicas=1 with no journal the unreplicated plane is built
    n_replicas: int = 1         # replica lanes per shard
    journal_dir: str | None = None   # write-ahead ingest journal directory
    supervisor: bool = True     # self-heal dead replicas (n_replicas > 1)
    device: str = DEFAULT_DEVICE


class SimilaritySearchService:
    def __init__(self, cfg: SearchConfig, *,
                 params: tuple[torch.Tensor, torch.Tensor] | None = None,
                 store: ShardedSketchStore | None = None,
                 workers=None):
        """``params=(sigma, pi)`` signs with given permutations (e.g. the
        reference's, via ``convert.permutations_from_jax``); ``store``
        serves a pre-built plane (e.g. ``ShardedSketchStore.load`` of a
        snapshot, or ``connect_sharded`` over spawned workers, whose
        handles ``workers`` hands over for ``close()``) instead of
        building one per ``cfg.transport``."""
        if cfg.n_bands * cfg.rows_per_band != cfg.k:
            raise ValueError("n_bands * rows_per_band must equal k")
        if cfg.transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS} "
                             f"(got {cfg.transport!r})")
        self.cfg = cfg
        self.engine = SketchEngine(SketchConfig(d=cfg.d, k=cfg.k,
                                                seed=cfg.seed),
                                   device=cfg.device, params=params)
        store_cfg = StoreConfig(k=cfg.k, n_bands=cfg.n_bands,
                                rows_per_band=cfg.rows_per_band, b=cfg.b,
                                n_slots=cfg.n_slots,
                                bucket_width=cfg.bucket_width)
        self._workers: list = list(workers) if workers else []
        self._supervisor = None
        if store is not None:
            self.store = store
        elif cfg.transport == "tcp" and (cfg.n_replicas > 1
                                         or cfg.journal_dir is not None):
            self.store = self._build_replicated(store_cfg)
        elif cfg.transport == "tcp":
            self.store = self._build_tcp(store_cfg)
        else:
            self.store = ShardedSketchStore(
                store_cfg, n_shards=cfg.n_shards, partition=cfg.partition,
                probe_impl=cfg.probe_impl, query_impl=cfg.query_impl,
                device=cfg.device)
        self._tracer = obs_trace.default()
        reg = obs_metrics.default()
        self._h_query = reg.histogram("service.query")
        self._h_sign = reg.histogram("service.sign")

    def _build_tcp(self, store_cfg: StoreConfig) -> ShardedSketchStore:
        """One shard worker process per shard, each with its store on
        ``cfg.device``, and the coordinator's plane over them."""
        from ..transport import HedgePolicy, connect_sharded, spawn_workers
        cfg = self.cfg
        self._workers = spawn_workers(store_cfg, cfg.n_shards,
                                      device=cfg.device,
                                      probe_impl=cfg.probe_impl,
                                      query_impl=cfg.query_impl)
        hedge = None
        if cfg.hedge:
            # hedge_delay_ms=0.0 is a valid fixed delay (hedge at once)
            hedge = HedgePolicy() if cfg.hedge_delay_ms is None \
                else HedgePolicy(delay_s=cfg.hedge_delay_ms / 1e3)
        try:
            return connect_sharded(
                [h.address for h in self._workers], store_cfg,
                partition=cfg.partition, query_impl=cfg.query_impl,
                timeout=cfg.query_timeout_s, hedge=hedge, device=cfg.device)
        except BaseException:
            for h in self._workers:        # no orphan worker processes
                h.terminate()
            raise

    def _build_replicated(self, store_cfg: StoreConfig):
        """The replicated tcp plane: an S x R worker grid on ``cfg.device``,
        a write-ahead ingest journal, and (by default) the supervisor,
        which respawns on the same device.  Hedging is always armed here
        (the failure-triggered hedge IS the in-round read failover to a
        sibling replica), with ``hedge_delay_ms`` as a fixed-delay
        override."""
        import os

        from ..replica import (IngestJournal, Supervisor, connect_replicated,
                               spawn_replicated)
        from ..transport import HedgePolicy
        cfg = self.cfg
        journal = None
        if cfg.journal_dir is not None:
            journal = IngestJournal(
                os.path.join(cfg.journal_dir, "ingest.journal"))
        grid = spawn_replicated(store_cfg, cfg.n_shards,
                                max(cfg.n_replicas, 1), device=cfg.device,
                                probe_impl=cfg.probe_impl,
                                query_impl=cfg.query_impl)
        self._workers = [h for row in grid for h in row]
        hedge = True if cfg.hedge_delay_ms is None \
            else HedgePolicy(delay_s=cfg.hedge_delay_ms / 1e3)
        try:
            store = connect_replicated(
                grid, store_cfg, journal=journal,
                partition=cfg.partition, query_impl=cfg.query_impl,
                timeout=cfg.query_timeout_s, hedge=hedge, device=cfg.device)
        except BaseException:
            if journal is not None:
                journal.close()
            for h in self._workers:        # no orphan worker processes
                h.terminate()
            raise
        if cfg.supervisor and cfg.n_replicas > 1:
            self._supervisor = Supervisor(store, device=cfg.device,
                                          probe_impl=cfg.probe_impl,
                                          query_impl=cfg.query_impl)
            self._supervisor.start()
        return store

    # -- the fused fast path -----------------------------------------------
    @property
    def packed_ingest(self) -> bool:
        """Whether the fused sign -> pack path serves this config (band
        boundaries fall on word boundaries; always true at b = 32)."""
        return self.cfg.rows_per_band % (32 // self.cfg.b) == 0

    def _sign(self, data, layout: str) -> torch.Tensor:
        """Launch signing for one batch (asynchronous): packed words on the
        device on the fused path, raw signatures otherwise."""
        pack_b = self.cfg.b if self.packed_ingest else None
        return self.engine.sign(data, layout=layout, pack_b=pack_b)

    def _scatter(self, signed: np.ndarray) -> None:
        """Index one signed batch, as the host copy holds it (uint32 bits
        of the kernel's int32 output)."""
        if self.packed_ingest:
            self.store.add_packed(signed)
        else:
            self.store.add(np.asarray(signed).view(np.int32))

    # -- indexing ----------------------------------------------------------
    def add_sparse(self, idx: np.ndarray) -> None:
        self._scatter(u32_to_host(self._sign(idx, "sparse")))

    def add_dense(self, v: np.ndarray) -> None:
        self._scatter(u32_to_host(self._sign(v, "dense")))

    def pipeline(self, *, depth: int = 2,
                 layout: str = "sparse") -> "IngestPipeline":
        """A double-buffered ingest session over this service's store."""
        return IngestPipeline(self, depth=depth, layout=layout)

    def stream(self, **kw):
        """A streaming front end over this service: single queries in,
        coalesced batches through the pipelined query path (see
        ``serve.stream.StreamingQueryService`` for the knobs)."""
        from .stream import StreamConfig, StreamingQueryService
        return StreamingQueryService(self, StreamConfig(**kw))

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
        beneath it.  Packed words stay on the device; raw signatures come
        to the host, where the store folds their band keys."""
        t_wall = time.perf_counter()
        with self._tracer.span("query") as root:
            root.tag("n", len(data)).tag("top_k", top_k)
            t0 = time.perf_counter()
            with self._tracer.span("query.sign"):
                qsigned = self._sign(data, layout)
                if not self.packed_ingest:
                    qsigned = qsigned.cpu().numpy()
            self._h_sign.observe(time.perf_counter() - t0)
            out = self._query(qsigned, top_k)
        self._h_query.observe(time.perf_counter() - t_wall)
        return out

    def _query(self, qsigned, top_k: int):
        """Returns (ids (Q, top_k) int64 [-1 pad], scores (Q, top_k) f32).

        Queries with no bucket hit in any shard fall back to brute force
        over the whole index, independently per query."""
        if self.store.size <= 0:
            raise ValueError(
                "query on an empty index: add documents before querying "
                "(the brute-force fallback has nothing to score)")
        if self.packed_ingest:
            return self.store.query_packed(qsigned, top_k)
        return self.store.query(qsigned, top_k)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Shut the shard workers down (tcp transport: SHUTDOWN over the
        wire, then a hard stop for any that did not exit); idempotent.

        The supervisor stops FIRST, or it would take the shutdown for a
        mass failure and respawn every worker the teardown just stopped;
        workers it respawned are not in the spawned list, so every lane's
        handle is stopped too.  The journal closes last."""
        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        if self._workers:
            from ..transport import shutdown_plane
            shutdown_plane(self.store, self._workers)
            for rset in getattr(self.store, "shards", []):
                for lane in getattr(rset, "lanes", []):
                    if lane.handle is not None:
                        lane.handle.terminate()
            self._workers = []
        else:
            self.store.close()
        journal = getattr(self.store, "journal", None)
        if journal is not None:
            journal.close()

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
