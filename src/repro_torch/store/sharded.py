"""ShardedSketchStore — the partitioned serving plane over SketchStore.

Items are partitioned across S shards, each a full ``SketchStore``.  A
query batch is folded to band hashes **once** (the fold kernel), and every
shard gets the hashes and the query words where the coordinator holds
them (``BandHashes``, ``QueryWords``): an in-process shard's probe reads
the hashes where the fold wrote them, and a host copy of each is made at
most once a batch, for the shards that need one.  Each shard answers with
a mergeable ``TopKPartial`` (local ids mapped to global);
``distributed.collectives.merge_topk`` reduces the S partials to the
global top-k, so S-shard answers equal the single-shard store's bit for
bit.  A row brute-forces only when it has no candidate in *any* shard,
and the fallback leg is itself a per-shard brute partial + merge.

Raw (B, K) signature batches (``add``/``query``) band on the host: the
coordinator folds a query batch's keys once, uploads them once, and every
shard probes the device copy (the host copy serves the spill leg).

Where a shard lives is behind the ``ShardBackend`` protocol:

  * ``InProcessShard`` — the shard's ``SketchStore`` in this process, on
    the plane's device;
  * ``transport.client.RemoteShard`` — the same operations against a shard
    worker process over the framed tcp wire protocol.  The hashes and
    words cross the seam as host arrays (``BandHashes.host()``,
    ``QueryWords.host()``: one device-to-host copy of each a batch, shared
    by every remote shard), and the worker uploads them once to its own
    device.

The coordinator keeps only cfg, partition and gid maps and never scores
anything itself, so the backends are interchangeable per shard and the
answers are bit-identical either way.  The query path is split into
``start_query``/``start_brute`` (submit) and ``Pending.result()``
(gather), so remote shards all compute concurrently under the client's
fan-out loop; in-process shards evaluate lazily at gather time.

``save``/``load`` snapshot the whole plane to a directory: one
``SketchStore`` npz per shard plus a manifest (cfg, n_shards, partition,
gid maps), in the JAX package's format.

Partitioning: ``"round_robin"`` (global id mod S) or ``"hash"``
(Fibonacci-hash of the global id).  Global ids are assigned in arrival
order, and both partitioners append gids in ascending order, so a shard's
local rank order is its global id order and the merge is exact.
"""

from __future__ import annotations

import json
import os
import time
from typing import Protocol

import numpy as np
import torch

from ..device import (DEFAULT_DEVICE, as_host_sigs, as_host_words,
                      resolve_device)
from ..distributed.collectives import merge_topk
from ..kernels.query_fused import BandHashes, QueryWords
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ._growth import grown
from .planner import TopKPartial, finalize_topk
from .store import (QUERY_IMPLS, SketchStore, StoreConfig,
                    check_packed_banding, query_operands)

_GOLD = np.uint64(0x9E3779B97F4A7C15)    # Fibonacci hashing multiplier

PARTITIONS = ("round_robin", "hash")

MANIFEST_FILE = "manifest.npz"


def shard_snapshot_path(dirpath: str, shard: int) -> str:
    """Per-shard ``SketchStore`` snapshot inside a plane snapshot dir."""
    return os.path.join(dirpath, f"shard_{shard}.npz")


def shard_partial_hist_name(shard: int) -> str:
    """Registry name of shard ``i``'s reply-latency histogram, the
    per-shard skew signal (the transport's hedge delay derives from the
    same observations, on a private per-connection copy)."""
    return f"query.shard{shard}.partial"


# -- the backend seam ---------------------------------------------------------

class Pending(Protocol):
    """Handle for one submitted per-shard leg.  ``lazy`` is True when the
    leg does no work until ``result()`` is read (in process); a remote
    leg runs on its worker whether or not its reply is read."""

    lazy: bool
    latency_s: float | None

    def result(self): ...


class ShardBackend(Protocol):
    """One shard of the serving plane, wherever it lives.

    Writes route a partitioned host batch (local ids are assigned
    shard-side in arrival order) and are a submit/gather pair like queries
    (``start_add``), so S shards index concurrently; query legs take the
    batch's ``BandHashes`` and ``QueryWords`` and answer in local ids (the
    coordinator owns the gid maps)."""

    def add(self, sigs: np.ndarray) -> int: ...
    def add_packed(self, words: np.ndarray) -> int: ...
    def start_add(self, batch: np.ndarray, *, packed: bool) -> Pending: ...
    def start_query(self, hashes: BandHashes, qwords: QueryWords,
                    top_k: int, mode: str) -> Pending: ...
    def start_brute(self, qwords: QueryWords, top_k: int) -> Pending: ...
    def stats(self) -> dict: ...
    def save(self, path: str) -> None: ...
    def close(self) -> None: ...


class _Lazy:
    """In-process pending leg: evaluated at gather time.  ``lazy`` is the
    write path's no-work-until-read guarantee: a lazy ADD never gathered
    never touched its store, which keeps a clean first failure from
    poisoning the plane (``_scatter``)."""

    lazy = True

    def __init__(self, fn):
        self._fn = fn
        self.latency_s: float | None = None

    def result(self):
        t0 = time.perf_counter()
        try:
            return self._fn()
        finally:
            self.latency_s = time.perf_counter() - t0


class InProcessShard:
    """One shard: a local ``SketchStore``, built from ``cfg`` on ``device``
    or given as ``store`` (whose knobs are set only where passed)."""

    def __init__(self, cfg: StoreConfig | None = None, *,
                 device: str | torch.device = DEFAULT_DEVICE,
                 probe_impl: str | None = None,
                 query_impl: str | None = None,
                 store: SketchStore | None = None):
        if store is None:
            if cfg is None:
                raise ValueError("InProcessShard needs cfg or store")
            store = SketchStore(cfg, device=device,
                                probe_impl=probe_impl or "auto",
                                query_impl=query_impl or "auto")
        else:                            # never clobber a configured store
            if probe_impl is not None:
                store.probe_impl = probe_impl
            if query_impl is not None:
                store.query_impl = query_impl
        self.store = store

    def _add(self, fn, batch) -> int:
        # tag exceptions that left the store partially mutated (append
        # landed, insert raised) so the coordinator knows a retry would
        # duplicate
        before = (self.store.size, self.store.table.n_items)
        try:
            return len(fn(batch))
        except BaseException as e:
            if (self.store.size, self.store.table.n_items) != before:
                e.dirty = True
            raise

    def add(self, sigs: np.ndarray) -> int:
        return self._add(self.store.add, sigs)

    def add_packed(self, words: np.ndarray) -> int:
        return self._add(self.store.add_packed, words)

    def start_add(self, batch: np.ndarray, *, packed: bool = False) -> _Lazy:
        # routes through self.add/add_packed (not the store directly) so
        # subclass overrides keep intercepting the write path
        fn = self.add_packed if packed else self.add
        return _Lazy(lambda: fn(batch))

    def start_query(self, hashes: BandHashes, qwords: QueryWords,
                    top_k: int, mode: str) -> _Lazy:
        return _Lazy(lambda: self.store.partial_topk_packed_hashed(
            hashes, qwords.dev, top_k, mode=mode))

    def start_brute(self, qwords: QueryWords, top_k: int) -> _Lazy:
        return _Lazy(lambda: self.store.planner.brute_partial_packed(
            qwords.dev, top_k))

    def stats(self) -> dict:
        return {"size": self.store.size, "n_spilled": self.store.n_spilled,
                "n_rebuilds": self.store.n_rebuilds,
                "probe_impl": self.store.probe_impl,
                "query_impl": self.store.query_impl}

    def save(self, path: str) -> None:
        self.store.save(path)

    def close(self) -> None:
        pass


class ShardedSketchStore:
    """S-way partitioned SketchStore with exact global top-k.

    ``backends`` runs the plane over given shards (``RemoteShard``s from
    ``transport.client``, or the loaded ones ``ShardedSketchStore.load``
    hands in); the default builds ``InProcessShard``s on ``device``, which
    is also where the coordinator folds a query batch."""

    def __init__(self, cfg: StoreConfig, n_shards: int = 1, *,
                 partition: str = "round_robin", probe_impl: str = "auto",
                 query_impl: str = "auto",
                 device: str | torch.device = DEFAULT_DEVICE,
                 backends: list | None = None):
        if backends is not None:
            if not backends:
                raise ValueError("backends must be non-empty")
            n_shards = len(backends)
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        if partition not in PARTITIONS:
            raise ValueError(f"partition must be one of {PARTITIONS} "
                             f"(got {partition!r})")
        if query_impl not in QUERY_IMPLS:
            raise ValueError(f"query_impl must be one of {QUERY_IMPLS} "
                             f"(got {query_impl!r})")
        self.cfg = cfg
        self.n_shards = n_shards
        self.partition = partition
        self.query_impl = query_impl
        self.device = resolve_device(device)
        self.shards = backends if backends is not None else [
            InProcessShard(cfg, device=self.device, probe_impl=probe_impl,
                           query_impl=query_impl)
            for _ in range(n_shards)]
        self._gid_buf = [np.zeros(8, np.int64) for _ in range(n_shards)]
        self._gid_len = [0] * n_shards
        self.n_items = 0
        self.last_timings: dict[str, int] = {}
        self._failed: str | None = None
        reg = obs_metrics.default()
        self._h_fold = reg.histogram("query.fold")
        self._h_broadcast = reg.histogram("query.broadcast")
        self._h_partial = reg.histogram("query.partial")
        self._h_merge = reg.histogram("query.merge")
        self._h_query = reg.histogram("query.wall")
        self._h_shard = [reg.histogram(shard_partial_hist_name(i))
                         for i in range(n_shards)]
        self._tracer = obs_trace.default()

    # -- sizing ------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.n_items

    @property
    def n_spilled(self) -> int:
        return sum(s.stats()["n_spilled"] for s in self.shards)

    def shard_sizes(self) -> np.ndarray:
        return np.asarray([s.stats()["size"] for s in self.shards], np.int64)

    def obs_snapshot(self) -> dict:
        """One merged registry snapshot for the whole plane: this process's
        registry plus every remote worker's (the ``obs`` JSON of its STATS
        reply), reduced with ``merge_snapshots``.  In-process shards share
        this process's registry, so their stats carry no ``obs`` and
        nothing is counted twice.  Each worker snapshot is merged under a
        ``shard{i}.replica{r}.`` prefix (``label_snapshot``: which worker's
        counters moved), and raw on the shard's first lane only, so the
        plane-wide totals mean one lane a shard at any replication.
        Backends with ``stats_all`` (replica sets) give one snapshot for
        each live lane."""
        snaps = [obs_metrics.default().snapshot()]
        for i, sh in enumerate(self.shards):
            stats_all = getattr(sh, "stats_all", None)
            if stats_all is not None:
                per_lane = stats_all()
            else:
                stats = sh.stats()
                per_lane = [(int(stats.get("replica", 0)), stats)]
            for k, (r, stats) in enumerate(per_lane):
                blob = stats.get("obs")
                if not blob:
                    continue
                snap = json.loads(blob) if isinstance(blob, str) else blob
                if k == 0:
                    snaps.append(snap)
                snaps.append(obs_metrics.label_snapshot(
                    snap, f"shard{i}.replica{r}."))
        return obs_metrics.merge_snapshots(*snaps)

    def _gids(self, shard: int) -> np.ndarray:
        return self._gid_buf[shard][: self._gid_len[shard]]

    # -- partitioning ------------------------------------------------------
    def _shard_of(self, gids: np.ndarray) -> np.ndarray:
        if self.partition == "round_robin":
            return gids % self.n_shards
        with np.errstate(over="ignore"):
            h = gids.astype(np.uint64) * _GOLD
        return ((h >> np.uint64(33)) % np.uint64(self.n_shards)) \
            .astype(np.int64)

    def _check_consistent(self) -> None:
        if self._failed:
            raise RuntimeError(
                f"plane is inconsistent after a failed add ({self._failed}); "
                "rebuild it or reload from the last snapshot")

    def _scatter(self, batch: np.ndarray, *, packed: bool) -> np.ndarray:
        """Assign global ids, fan the batch's slices out to every shard
        (submit all, then gather), record the maps.

        A batch is all-or-nothing at the coordinator: if a shard indexed
        its slice while another failed, or a failing shard reports a
        partial write (``e.dirty``), or the fan-out broke after frames hit
        the wire (``e.unknown_outcome``: nobody can prove which workers
        processed their slice), a retry would re-issue the same gids, so
        the plane is marked inconsistent and refuses further reads and
        writes.  Every pending is consumed, since a remote slice runs on
        its worker whether or not its reply is read; lazy in-process
        pendings after a failure are skipped (never evaluated, so never
        written).  A failure that provably left every shard unwritten
        leaves the plane usable."""
        self._check_consistent()
        n = len(batch)
        gids = np.arange(self.n_items, self.n_items + n, dtype=np.int64)
        owner = self._shard_of(gids)
        pend = []
        for s in range(self.n_shards):
            sel = np.flatnonzero(owner == s)
            if len(sel):
                pend.append((s, sel, self.shards[s].start_add(
                    batch[sel], packed=packed)))
        wrote_any = False
        sure_clean = True
        first_err: BaseException | None = None
        for s, sel, p in pend:
            if first_err is not None and getattr(p, "lazy", False):
                continue
            try:
                added = p.result()
                wrote_any = True
                if added != len(sel):
                    raise RuntimeError(
                        f"shard {s} indexed {added} of {len(sel)} rows")
            except BaseException as e:
                if getattr(e, "dirty", False) or \
                        getattr(e, "unknown_outcome", False):
                    sure_clean = False
                if first_err is None:
                    first_err = e
                continue
            need = self._gid_len[s] + len(sel)
            self._gid_buf[s] = grown(self._gid_buf[s], need)
            self._gid_buf[s][self._gid_len[s]: need] = gids[sel]
            self._gid_len[s] = need
        if first_err is not None:
            if wrote_any or not sure_clean:
                self._failed = f"{type(first_err).__name__} mid-batch"
            raise first_err
        self.n_items += n
        return gids

    # -- writes ------------------------------------------------------------
    def add(self, sigs) -> np.ndarray:
        """Partition + index a (B, K) int32 signature batch; returns the
        global ids (assigned in arrival order, as one SketchStore does)."""
        return self._scatter(as_host_sigs(sigs), packed=False)

    def add_packed(self, words) -> np.ndarray:
        """``add`` for a (B, W) uint32 packed-word batch."""
        return self._scatter(as_host_words(words), packed=True)

    # -- reads -------------------------------------------------------------
    def _to_global(self, shard: int, part: TopKPartial) -> TopKPartial:
        """Map a shard partial's local ids to global ids (monotone map, so
        rows stay in (score desc, id asc) order)."""
        gid = self._gids(shard)
        if not len(gid):
            return part
        hit = part.ids >= 0
        ids = np.where(hit, gid[np.where(hit, part.ids, 0)], np.int64(-1))
        return TopKPartial(ids, part.scores, part.has_candidates)

    def _fanout(self, start) -> list[TopKPartial]:
        """One submit/gather round over all shards.  Each shard's reply
        latency lands in ``query.shard{i}.partial``: for a remote shard the
        offset from fan-out start to its reply landing, for an in-process
        shard its leg's runtime.  The broadcast span is ambient while legs
        are submitted, so remote workers' spans nest under it."""
        t0 = time.perf_counter()
        with self._tracer.span("query.broadcast"):
            pend = [start(sh) for sh in self.shards]
        t1 = time.perf_counter()
        with self._tracer.span("query.partial"):
            parts = [self._to_global(s, p.result())
                     for s, p in enumerate(pend)]
        self._h_broadcast.observe(t1 - t0)
        self._h_partial.observe(time.perf_counter() - t1)
        for s, p in enumerate(pend):
            lat = getattr(p, "latency_s", None)
            if lat is not None:
                self._h_shard[s].observe(lat)
        return parts

    def _merged_query(self, hashes: BandHashes, qwords, top_k: int,
                      mode: str, fold_s: float,
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard candidate partials -> merge -> global brute-force leg
        for rows with no candidates anywhere (their query words indexed
        where they lie: on the device unless ``query_impl="host"``).
        ``qwords`` is wrapped once (``QueryWords``), so remote shards share
        one host copy of the batch's words, and the fallback leg slices
        its rows from that copy.  ``last_timings["n_fallback"]`` is the
        batch's count of brute-force rows.

        Spans: ``query.candidates`` is the candidate round and
        ``query.fallback`` the brute round (its rows' slice, the round,
        and the scatter of its answers), each a ``query.broadcast`` that
        submits the shards' legs (lazy in process; for remote shards the
        host copies and the frames' encoding), a ``query.partial`` that
        gathers them (in process the probe, the scorer and the copy of each
        partial to the host, split by ``kernels.dispatch.query_fused`` and
        the planner; remote, the wait for the replies) and a
        ``query.merge`` that reduces the partials on the host."""
        wall_t0 = time.perf_counter()
        self._h_fold.observe(fold_s)
        qwords = QueryWords(qwords)
        with self._tracer.span("query.candidates"):
            parts = self._fanout(
                lambda sh: sh.start_query(hashes, qwords, top_k, mode))
            has_any = np.zeros(len(qwords), bool)
            for p in parts:
                has_any |= p.has_candidates
            t0 = time.perf_counter()
            with self._tracer.span("query.merge"):
                scores, ids = merge_topk([p.scores for p in parts],
                                         [p.ids for p in parts], top_k)
            merge_s = time.perf_counter() - t0
        em = np.flatnonzero(~has_any)
        if len(em) and self.n_items:
            with self._tracer.span("query.fallback"):
                qrows = qwords.rows(em)
                brute = self._fanout(
                    lambda sh: sh.start_brute(qrows, top_k))
                t0 = time.perf_counter()
                with self._tracer.span("query.merge"):
                    b_scores, b_ids = merge_topk(
                        [p.scores for p in brute], [p.ids for p in brute],
                        top_k)
                scores[em] = b_scores
                ids[em] = b_ids
                merge_s += time.perf_counter() - t0
        self.last_timings = {"n_fallback": len(em)}
        self._h_merge.observe(merge_s)
        self._h_query.observe(time.perf_counter() - wall_t0)
        return finalize_topk(TopKPartial(ids, scores, has_any))

    def query(self, qsigs, top_k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """(Q, K) signatures -> (ids (Q, top_k) [-1 pad], scores (Q, top_k)),
        identical to single-shard ``SketchStore.query`` on the same items.

        The coordinator folds the band keys on the host, once, and uploads
        them once for every shard; it uploads the signatures and packs the
        query words on the device, as the reference packs them on its own
        (with ``query_impl="host"`` both stay on the host): the single
        store's ``query_operands``.  The shards probe the device keys and
        keep the host copy for the spill leg."""
        self._check_queryable("query()")
        return self._folded_query("sig", top_k, sigs=as_host_sigs(qsigs))

    def query_packed(self, qwords,
                     top_k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """(Q, W) packed query words (a device tensor or a host array) ->
        (ids (Q, top_k) [-1 pad], scores (Q, top_k)).  The coordinator
        folds band hashes once (the fold kernel, or the host uint64 loop
        when ``query_impl="host"``) and hands them to every shard.

        ``query.fold`` times the fold's launch: the hashes stay on the
        device, so the span no longer waits for the card (the fold's device
        time lands in the first shard's ``query.partial``)."""
        self._check_queryable("query_packed()")
        check_packed_banding(self.cfg)
        return self._folded_query("packed", top_k, words=qwords)

    def _folded_query(self, mode: str, top_k: int, **batch,
                      ) -> tuple[np.ndarray, np.ndarray]:
        """The batch's hashes and words where the shards read them
        (``query_operands``: on the device, or on the host for the host
        walk), under ``query.fold``, then ``_merged_query``."""
        with self._tracer.span("store.query"):
            t0 = time.perf_counter()
            with self._tracer.span("query.fold"):
                hashes, qwords = query_operands(
                    self.cfg, self.device, host=self.query_impl == "host",
                    **batch)
            return self._merged_query(hashes, qwords, top_k, mode,
                                      time.perf_counter() - t0)

    def _check_queryable(self, op: str) -> None:
        self._check_consistent()
        if not self.cfg.store_signatures:
            raise RuntimeError(f"{op} needs stored signatures; this store "
                               "was built with store_signatures=False")

    def candidate_pairs(self) -> np.ndarray:
        """Dedup-path pairs, single-shard only: a partitioned index never
        co-buckets items from different shards, so cross-shard pairs would
        be silently missed.  Run dedup on a 1-shard store."""
        if self.n_shards != 1:
            raise NotImplementedError(
                "candidate_pairs() is exact only at n_shards=1 (cross-shard "
                "pairs never share a shard-local bucket); run dedup on a "
                "single-shard store")
        if not isinstance(self.shards[0], InProcessShard):
            raise NotImplementedError(
                "candidate_pairs() needs the shard's table in-process; "
                "load the snapshot into an InProcessShard store for dedup")
        return self.shards[0].store.candidate_pairs()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        for sh in self.shards:
            sh.close()

    # -- snapshots ---------------------------------------------------------
    def save(self, dirpath: str) -> None:
        """Snapshot the plane: a ``SketchStore`` npz per shard
        (``shard_snapshot_path``) and the manifest (cfg, n_shards,
        partition, gid maps)."""
        self._check_consistent()
        os.makedirs(dirpath, exist_ok=True)
        for i, sh in enumerate(self.shards):
            sh.save(shard_snapshot_path(dirpath, i))
        ints, thr = self.cfg.to_manifest()
        gids = {f"gids_{i}": self._gids(i) for i in range(self.n_shards)}
        np.savez(os.path.join(dirpath, MANIFEST_FILE),
                 n_shards=self.n_shards, n_items=self.n_items,
                 partition=self.partition, cfg=ints, cfg_thresholds=thr,
                 **gids)

    @classmethod
    def load(cls, dirpath: str, *, backends: list | None = None,
             probe_impl: str = "auto", query_impl: str = "auto",
             device: str | torch.device = DEFAULT_DEVICE,
             ) -> "ShardedSketchStore":
        """Restore a plane snapshot: every shard loaded onto ``device`` in
        an ``InProcessShard``, or, with ``backends`` (shards already
        restored from the same snapshot), only the coordinator state (cfg,
        partition, gid maps)."""
        with np.load(os.path.join(dirpath, MANIFEST_FILE)) as z:
            n_shards = int(z["n_shards"])
            n_items = int(z["n_items"])
            partition = str(z["partition"])
            cfg = StoreConfig.from_manifest(z["cfg"], z["cfg_thresholds"])
            gids = [np.asarray(z[f"gids_{i}"], np.int64)
                    for i in range(n_shards)]
        if backends is None:
            backends = [
                InProcessShard(store=SketchStore.load(
                    shard_snapshot_path(dirpath, i), device=device),
                    probe_impl=probe_impl, query_impl=query_impl)
                for i in range(n_shards)]
        elif len(backends) != n_shards:
            raise ValueError(f"snapshot has {n_shards} shards, got "
                             f"{len(backends)} backends")
        store = cls(cfg, n_shards, partition=partition, backends=backends,
                    query_impl=query_impl, device=device)
        for i, g in enumerate(gids):
            store._gid_buf[i] = grown(store._gid_buf[i], len(g))
            store._gid_buf[i][: len(g)] = g
            store._gid_len[i] = len(g)
        store.n_items = n_items
        return store
