"""SketchStore — packed signature storage + vectorized LSH on one device.

Owns a ``PackedSignatureBuffer`` (b-bit columnar signature storage), a
``BandedLSHTable`` (open-addressing bucket arrays) and a ``QueryPlanner``.
``add_packed`` appends a packed-word batch and indexes it on the host;
``query_packed`` answers a query batch with top-k (id, score) pairs through
the fused device pipeline (fold -> probe -> score), with the brute-force
fallback for rows that have no candidate.

The table auto-rebuilds (doubling) when open addressing degrades: slot load
factor above ``rebuild_load_factor``, or spilled entries above
``rebuild_spill_fraction`` of postings.  Probe-exhaustion spills double
``n_slots``; bucket-overflow spills double ``bucket_width``.

Ported: the packed path.  Raw-signature ``add``/``query``, the dedup
``candidate_pairs`` and snapshots (``save``/``load``/``digest``) wait for
later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.lsh import band_hashes_packed
from ..device import (DEFAULT_DEVICE, as_device_words, as_host_words,
                      resolve_device, take_rows)
from ..kernels.packfmt import PACK_BITS
from ..kernels.query_fused import BandHashes
from ..obs import metrics as obs_metrics
from .packed import PackedConfig, PackedSignatureBuffer
from .planner import QueryPlanner, TopKPartial, finalize_topk
from .table import PROBE_IMPLS, BandedLSHTable

# "auto": the fused device pipeline (CUDA kernels on a CUDA store, their
# plain versions on a CPU store); "host": the host fold + planner walk
QUERY_IMPLS = ("auto", "host")


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    k: int                          # signature length
    n_bands: int                    # LSH bands; k = n_bands * rows_per_band
    rows_per_band: int
    b: int = 32                     # stored bits per hash (32 = exact)
    n_slots: int = 2048             # initial open-addressing slots per band
    bucket_width: int = 8           # initial postings per bucket
    max_probes: int = 16            # quadratic-probe chain bound
    capacity: int = 1024            # initial packed-buffer item capacity
    rebuild_load_factor: float = 0.7
    rebuild_spill_fraction: float = 0.01
    auto_rebuild: bool = True

    def __post_init__(self):
        if self.n_bands * self.rows_per_band != self.k:
            raise ValueError("n_bands * rows_per_band must equal k")
        if self.b not in PACK_BITS:
            raise ValueError(f"b must be one of {PACK_BITS} (got {self.b})")

    @classmethod
    def sized_for(cls, n_items: int, *, target_load: float = 0.5,
                  **kw) -> "StoreConfig":
        """Config pre-sized for a known corpus: slots for ~``target_load``
        per band and buffer capacity for ``n_items``."""
        n_slots = max(2048, 1 << int(np.ceil(
            np.log2(max(n_items, 1) / target_load))))
        kw.setdefault("n_slots", n_slots)
        kw.setdefault("capacity", max(n_items, 8))
        return cls(**kw)


def check_packed_banding(cfg: StoreConfig) -> None:
    """Packed banding needs every band to start on a word boundary."""
    cpw = 32 // cfg.b
    if cfg.rows_per_band % cpw:
        raise ValueError(
            f"packed banding needs rows_per_band % (32/b) == 0 (got "
            f"rows_per_band={cfg.rows_per_band}, b={cfg.b}); raw-signature "
            "ingest is not ported yet (ROADMAP.md)")


class SketchStore:
    def __init__(self, cfg: StoreConfig, *,
                 device: str | torch.device = DEFAULT_DEVICE,
                 probe_impl: str = "auto", query_impl: str = "auto"):
        if query_impl not in QUERY_IMPLS:
            raise ValueError(f"query_impl must be one of {QUERY_IMPLS} "
                             f"(got {query_impl!r})")
        if probe_impl not in PROBE_IMPLS:
            raise ValueError(f"probe_impl must be one of {PROBE_IMPLS} "
                             f"(got {probe_impl!r})")
        check_packed_banding(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.probe_impl = probe_impl
        self.query_impl = query_impl
        self.buffer = PackedSignatureBuffer(
            PackedConfig(k=cfg.k, b=cfg.b, capacity=cfg.capacity),
            self.device)
        self.table = BandedLSHTable(cfg.n_bands, n_slots=cfg.n_slots,
                                    bucket_width=cfg.bucket_width,
                                    max_probes=cfg.max_probes,
                                    device=self.device)
        self.planner = QueryPlanner(self.buffer)
        self.n_rebuilds = 0

    # -- sizing ------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.buffer.size

    @property
    def n_spilled(self) -> int:
        return self.table.n_spilled

    # -- writes ------------------------------------------------------------
    def add_packed(self, words) -> np.ndarray:
        """Append + index a (B, W) uint32 packed-word batch; returns the new
        ids.  The words are stored verbatim and band-indexed from the words
        on the host (``band_hashes_packed``)."""
        words = as_host_words(words)
        self._pregrow(len(words))
        ids = self.buffer.append_packed(words)
        self.table.insert(band_hashes_packed(words, self.cfg.n_bands), ids)
        if self.cfg.auto_rebuild:
            self._maybe_rebuild()
        return ids

    # growth cap: beyond it the spill list is the right representation
    _MAX_BUCKET_WIDTH = 256

    def _slot_cap(self, n_items: int | None = None) -> int:
        if n_items is None:
            n_items = self.table.n_items
        target = max(self.cfg.n_slots, 4 * max(n_items, 1))
        return 1 << (target - 1).bit_length()

    def _pregrow(self, n_new: int) -> None:
        """Grow slots geometrically ahead of the projected post-batch load,
        so a batch lands in a table at sane load instead of spilling and
        replaying once per doubling."""
        if not self.cfg.auto_rebuild or n_new <= 0:
            return
        t = self.table
        projected = t.n_items + n_new
        need = projected / self.cfg.rebuild_load_factor
        cap = self._slot_cap(projected)
        ns = t.n_slots
        while ns < need and ns < cap:
            ns *= 2
        if ns > t.n_slots:
            self.rebuild(n_slots=min(ns, cap))

    def _maybe_rebuild(self) -> None:
        for _ in range(32):
            t = self.table
            postings_cap = t.n_items * t.n_bands
            too_full = t.load_factor > self.cfg.rebuild_load_factor
            too_spilled = t.n_spilled > max(
                32, self.cfg.rebuild_spill_fraction * postings_cap)
            if not (too_full or too_spilled):
                return
            grow_w = (too_spilled and not too_full and
                      t.n_spill_overflow > t.n_spill_probe)
            if grow_w:
                if t.bucket_width >= self._MAX_BUCKET_WIDTH:
                    return                 # oversized cluster: leave it spilled
                self.rebuild(bucket_width=min(t.bucket_width * 2,
                                              self._MAX_BUCKET_WIDTH))
            else:
                if t.n_slots >= self._slot_cap():
                    return
                self.rebuild(n_slots=min(t.n_slots * 2, self._slot_cap()))

    def rebuild(self, n_slots: int | None = None,
                bucket_width: int | None = None,
                max_probes: int | None = None) -> None:
        t0 = time.perf_counter()
        self.table.rebuild(n_slots=n_slots, bucket_width=bucket_width,
                           max_probes=max_probes)
        self.n_rebuilds += 1
        reg = obs_metrics.default()
        reg.counter("store.rebuilds").inc()
        reg.histogram("store.rebuild").observe(time.perf_counter() - t0)

    # -- reads -------------------------------------------------------------
    def candidate_rows_hashed(self, hashes: np.ndarray, *,
                              spill_cap: int | None = None) -> np.ndarray:
        """(Q, n_bands) uint64 band hashes -> (Q, C) candidate ids, -1 pad
        (bucket postings, then matching spilled entries)."""
        cand = self.table.lookup(hashes, impl=self.probe_impl) \
            .astype(np.int64)
        spill = self.table.spilled_candidates(hashes, cap=spill_cap)
        if spill.shape[1]:
            cand = np.concatenate([cand, spill], axis=1)
        return cand

    def candidate_rows_packed(self, qwords, *,
                              spill_cap: int | None = None) -> np.ndarray:
        """``candidate_rows_hashed`` for (Q, W) packed query words."""
        qwords = as_host_words(qwords)
        hashes = band_hashes_packed(qwords, self.cfg.n_bands)
        return self.candidate_rows_hashed(hashes, spill_cap=spill_cap)

    def _resolve_query_impl(self) -> str:
        """The fused pipeline needs power-of-two ``n_slots`` (for the
        device-side meta) and a non-empty buffer; else the host walk."""
        if self.query_impl == "host":
            return "host"
        ns = self.table.n_slots
        if (ns & (ns - 1)) or not self.buffer.size:
            return "host"
        return "device"

    def _fused_partial(self, qwords, top_k: int, *,
                       hashes: BandHashes | None) -> TopKPartial:
        """Run the fused pipeline over the resident state and wrap it as a
        planner partial.  ``hashes=None`` folds inside the probe kernel;
        shard workers pass the coordinator's ``BandHashes``, whose device
        tensor the probe reads.  Spilled keys stay a host leg, invoked only
        when the spill is non-empty (the one reader of host hashes)."""
        from ..kernels import dispatch
        spill = None
        if self.table.n_spilled:
            spill = lambda h: self.table.spilled_candidates(h, cap=top_k)
        ids, scores, has = dispatch.query_fused(
            self.table.device_records(), self.buffer.device_words(),
            as_device_words(qwords, self.device),
            n_bands=self.cfg.n_bands, n_slots=self.table.n_slots,
            max_probes=self.table.max_probes, k=self.cfg.k, b=self.cfg.b,
            top_k=top_k, hashes=hashes, spill_lookup=spill)
        return TopKPartial.from_device(ids, scores, has)

    def partial_topk_packed_hashed(self, hashes: BandHashes, qwords,
                                   top_k: int) -> TopKPartial:
        """Per-shard candidate partial from pre-folded band hashes: device
        probe + score, or the host walk (on ``hashes.host()``) when the
        query knob or the table's geometry says so."""
        if self._resolve_query_impl() == "host":
            return self.planner.partial_topk_packed(
                as_host_words(qwords),
                self.candidate_rows_hashed(hashes.host(), spill_cap=top_k),
                top_k)
        return self._fused_partial(qwords, top_k, hashes=hashes)

    def query_packed(self, qwords,
                     top_k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """(Q, W) packed query words -> (ids (Q, top_k) [-1 pad], scores
        (Q, top_k)): fold -> probe -> score fused on the device, then the
        brute-force fallback for rows with no candidate."""
        if self._resolve_query_impl() == "host":
            qnp = as_host_words(qwords)
            return self.planner.topk_packed(
                qnp, self.candidate_rows_packed(qnp, spill_cap=top_k), top_k)
        qdev = as_device_words(qwords, self.device)
        part = self._fused_partial(qdev, top_k, hashes=None)
        em = np.flatnonzero(~part.has_candidates)
        if len(em):
            brute = self.planner.brute_partial_packed(take_rows(qdev, em),
                                                      top_k)
            part.ids[em] = brute.ids
            part.scores[em] = brute.scores
        return finalize_topk(part)
