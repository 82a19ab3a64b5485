"""ShardedSketchStore — the partitioned serving plane over SketchStore.

Items are partitioned across S in-process shards, each a full
``SketchStore`` on the plane's device.  A query batch is folded to band
hashes **once** (the fold kernel), and every shard gets the hashes and
the query words as the device tensors (``BandHashes``: the probe reads the
hashes where the fold wrote them; a host copy is made once a batch, and
only for a shard with spilled keys or on the host walk).  Each shard
answers with a mergeable ``TopKPartial`` (local ids mapped to global);
``distributed.collectives.merge_topk`` reduces the S partials to the global
top-k, so S-shard answers equal the single-shard store's bit for bit.  A row
brute-forces only when it has no candidate in *any* shard, and the fallback
leg is itself a per-shard brute partial + merge.

The query path is split into ``start_query``/``start_brute`` (submit) and
``Pending.result()`` (gather), evaluated lazily at gather time, as the
reference's in-process backend does.  Shards in other processes (the tcp
transport) are not ported yet (ROADMAP.md).

Partitioning: ``"round_robin"`` (global id mod S) or ``"hash"``
(Fibonacci-hash of the global id).  Global ids are assigned in arrival
order, and both partitioners append gids in ascending order, so a shard's
local rank order is its global id order and the merge is exact.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.lsh import band_hashes_packed
from ..device import (DEFAULT_DEVICE, as_device_words, as_host_words,
                      resolve_device, take_rows)
from ..distributed.collectives import merge_topk
from ..kernels.query_fused import BandHashes
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ._growth import grown
from .planner import TopKPartial, finalize_topk
from .store import QUERY_IMPLS, SketchStore, StoreConfig, check_packed_banding

_GOLD = np.uint64(0x9E3779B97F4A7C15)    # Fibonacci hashing multiplier

PARTITIONS = ("round_robin", "hash")


class _Lazy:
    """In-process pending leg: evaluated at gather time."""

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
    """One shard: a local ``SketchStore``."""

    def __init__(self, cfg: StoreConfig, *, device: torch.device,
                 probe_impl: str = "auto", query_impl: str = "auto"):
        self.store = SketchStore(cfg, device=device, probe_impl=probe_impl,
                                 query_impl=query_impl)

    def add_packed(self, words: np.ndarray) -> int:
        return len(self.store.add_packed(words))

    def start_add(self, batch: np.ndarray) -> _Lazy:
        return _Lazy(lambda: self.add_packed(batch))

    def start_query(self, hashes: BandHashes, qwords,
                    top_k: int) -> _Lazy:
        return _Lazy(lambda: self.store.partial_topk_packed_hashed(
            hashes, qwords, top_k))

    def start_brute(self, qwords, top_k: int) -> _Lazy:
        return _Lazy(lambda: self.store.planner.brute_partial_packed(
            qwords, top_k))

    def stats(self) -> dict:
        return {"size": self.store.size, "n_spilled": self.store.n_spilled,
                "n_rebuilds": self.store.n_rebuilds,
                "probe_impl": self.store.probe_impl,
                "query_impl": self.store.query_impl}

    def close(self) -> None:
        pass


class ShardedSketchStore:
    """S-way partitioned SketchStore with exact global top-k, in process."""

    def __init__(self, cfg: StoreConfig, n_shards: int = 1, *,
                 partition: str = "round_robin", probe_impl: str = "auto",
                 query_impl: str = "auto",
                 device: str | torch.device = DEFAULT_DEVICE):
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        if partition not in PARTITIONS:
            raise ValueError(f"partition must be one of {PARTITIONS} "
                             f"(got {partition!r})")
        if query_impl not in QUERY_IMPLS:
            raise ValueError(f"query_impl must be one of {QUERY_IMPLS} "
                             f"(got {query_impl!r})")
        check_packed_banding(cfg)
        self.cfg = cfg
        self.n_shards = n_shards
        self.partition = partition
        self.query_impl = query_impl
        self.device = resolve_device(device)
        self.shards = [InProcessShard(cfg, device=self.device,
                                      probe_impl=probe_impl,
                                      query_impl=query_impl)
                       for _ in range(n_shards)]
        self._gid_buf = [np.zeros(8, np.int64) for _ in range(n_shards)]
        self._gid_len = [0] * n_shards
        self.n_items = 0
        self.last_timings: dict[str, float] = {}
        self._failed: str | None = None
        reg = obs_metrics.default()
        self._h_fold = reg.histogram("query.fold")
        self._h_broadcast = reg.histogram("query.broadcast")
        self._h_partial = reg.histogram("query.partial")
        self._h_merge = reg.histogram("query.merge")
        self._h_query = reg.histogram("query.wall")
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
                "rebuild it")

    def add_packed(self, words) -> np.ndarray:
        """Partition + index a (B, W) uint32 packed-word batch; returns the
        global ids (assigned in arrival order, as one SketchStore does).

        A batch is all-or-nothing: if a shard fails after another indexed
        its slice, the plane is marked inconsistent and refuses further
        reads and writes instead of double-indexing on a retry."""
        self._check_consistent()
        batch = as_host_words(words)
        n = len(batch)
        gids = np.arange(self.n_items, self.n_items + n, dtype=np.int64)
        owner = self._shard_of(gids)
        pend = []
        for s in range(self.n_shards):
            sel = np.flatnonzero(owner == s)
            if len(sel):
                pend.append((s, sel, self.shards[s].start_add(batch[sel])))
        wrote_any = False
        for s, sel, p in pend:
            try:
                added = p.result()
            except BaseException as e:
                if wrote_any:
                    self._failed = f"{type(e).__name__} mid-batch"
                raise
            wrote_any = True
            if added != len(sel):
                self._failed = f"shard {s} indexed {added} of {len(sel)}"
                raise RuntimeError(self._failed)
            need = self._gid_len[s] + len(sel)
            self._gid_buf[s] = grown(self._gid_buf[s], need)
            self._gid_buf[s][self._gid_len[s]: need] = gids[sel]
            self._gid_len[s] = need
        self.n_items += n
        return gids

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

    def _fanout(self, start, tally: dict) -> list[TopKPartial]:
        """One submit/gather round over all shards, timed into ``tally``."""
        t0 = time.perf_counter()
        with self._tracer.span("query.broadcast"):
            pend = [start(sh) for sh in self.shards]
        t1 = time.perf_counter()
        with self._tracer.span("query.partial"):
            parts = [self._to_global(s, p.result())
                     for s, p in enumerate(pend)]
        t2 = time.perf_counter()
        tally["broadcast_s"] += t1 - t0
        tally["partial_s"] += t2 - t1
        self._h_broadcast.observe(t1 - t0)
        self._h_partial.observe(t2 - t1)
        return parts

    def _merged_query(self, hashes: BandHashes, qwords, top_k: int,
                      fold_s: float) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard candidate partials -> merge -> global brute-force leg
        for rows with no candidates anywhere (their query words indexed
        where they lie: on the device unless ``query_impl="host"``).

        Spans: ``query.broadcast`` submits the shards' legs (lazy, so it
        costs next to nothing in process), ``query.partial`` gathers them
        (the probe, the scorer and the copy of each partial to the host),
        ``query.merge`` reduces the partials on the host."""
        wall_t0 = time.perf_counter()
        tally = {"fold_s": fold_s, "broadcast_s": 0.0, "partial_s": 0.0,
                 "merge_s": 0.0}
        self._h_fold.observe(fold_s)
        parts = self._fanout(
            lambda sh: sh.start_query(hashes, qwords, top_k), tally)
        has_any = np.zeros(len(qwords), bool)
        for p in parts:
            has_any |= p.has_candidates
        t0 = time.perf_counter()
        with self._tracer.span("query.merge"):
            scores, ids = merge_topk([p.scores for p in parts],
                                     [p.ids for p in parts], top_k)
        tally["merge_s"] += time.perf_counter() - t0
        em = np.flatnonzero(~has_any)
        if len(em) and self.n_items:
            brute = self._fanout(
                lambda sh: sh.start_brute(take_rows(qwords, em), top_k),
                tally)
            t0 = time.perf_counter()
            with self._tracer.span("query.merge"):
                b_scores, b_ids = merge_topk([p.scores for p in brute],
                                             [p.ids for p in brute], top_k)
            scores[em] = b_scores
            ids[em] = b_ids
            tally["merge_s"] += time.perf_counter() - t0
        tally["n_fallback"] = len(em)
        self.last_timings = tally
        self._h_merge.observe(tally["merge_s"])
        self._h_query.observe(time.perf_counter() - wall_t0)
        return finalize_topk(TopKPartial(ids, scores, has_any))

    def query_packed(self, qwords,
                     top_k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """(Q, W) packed query words (a device tensor or a host array) ->
        (ids (Q, top_k) [-1 pad], scores (Q, top_k)).  The coordinator
        folds band hashes once (the fold kernel, or the host uint64 loop
        when ``query_impl="host"``) and hands them to every shard.

        ``query.fold`` times the fold's launch: the hashes stay on the
        device, so the span no longer waits for the card (the fold's device
        time lands in the first shard's ``query.partial``)."""
        self._check_consistent()
        with self._tracer.span("store.query"):
            t0 = time.perf_counter()
            with self._tracer.span("query.fold"):
                qwords, hashes = self._fold_packed(qwords)
            fold_s = time.perf_counter() - t0
            return self._merged_query(hashes, qwords, top_k, fold_s)

    def _fold_packed(self, qwords) -> tuple[object, BandHashes]:
        """The query words where the shards read them, and their hashes:
        device words and device hashes, or host ones for the host walk."""
        if self.query_impl != "host":
            from ..kernels.dispatch import fold_hashes
            qdev = as_device_words(qwords, self.device)
            return qdev, BandHashes(fold_hashes(qdev,
                                                n_bands=self.cfg.n_bands))
        qnp = as_host_words(qwords)
        return qnp, BandHashes(host=band_hashes_packed(qnp,
                                                       self.cfg.n_bands))

    def close(self) -> None:
        for sh in self.shards:
            sh.close()
