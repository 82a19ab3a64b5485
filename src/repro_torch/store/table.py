"""Vectorized banded LSH table: fixed-capacity open-addressing bucket arrays.

Replaces the per-item ``defaultdict`` bucketing that made index build and
candidate generation O(N * n_bands) Python dict operations.  Each band is an
open-addressing array of fused bucket records:

    records (n_bands, n_slots, 2 + bucket_width)  int32

where ``records[b, s, :2]`` holds the two halves of the uint64 band hash that
owns slot ``s`` (both -1 = unused) and ``records[b, s, 2:]`` holds the posting
item ids (-1 padded).  Fusing key and postings means a query probe costs ONE
gather — key compare and candidate ids come from the same cache line.

Quadratic (triangular) probing bounded by ``max_probes`` resolves hash->slot;
inserts are batched (all B * n_bands entries probe simultaneously, one
vectorized pass per probe distance) and lookups are early-terminating gathers
with no per-item Python.  Entries that cannot be placed (probe chain
exhausted, or bucket full) go to a spill list; ``rebuild()`` reallocates at
larger geometry and replays every recorded band hash, draining the spill.

The all-ones hash value doubles as the empty-slot sentinel; entries hashing
to it (P ~ 2^-64) are routed to the spill list, so exactness is preserved.

Host numpy state as in ``repro.store.table``; ``device_records`` is the
torch copy on the table's device that the probe kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch

# probe chain + empty-slot sentinel are owned by the probe-kernel module so
# the host walk and the device kernel can never diverge
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.lsh_probe import SENTINEL_KEY, probe_offset
from ..obs import metrics as obs_metrics
from ._growth import grown

_HASH_BUF_MIN = 64

PROBE_IMPLS = ("auto", "numpy", "device")


def _halves(keys: np.ndarray) -> np.ndarray:
    """(E,) uint64 -> (E, 2) int32 bit-pattern halves (native endianness)."""
    return np.ascontiguousarray(keys).view(np.int32).reshape(-1, 2)


class BandedLSHTable:
    @staticmethod
    def _offset(t: int) -> int:
        """The shared quadratic probe chain (kernels.lsh_probe.probe_offset).
        Insert and lookup walk the same sequence, and slots are never freed,
        so stop-at-first-unused stays a correct absence test."""
        return probe_offset(t)

    def __init__(self, n_bands: int, n_slots: int = 2048,
                 bucket_width: int = 8, max_probes: int = 16, *,
                 device: str | torch.device = DEFAULT_DEVICE):
        if n_slots <= 0 or bucket_width <= 0 or max_probes <= 0:
            raise ValueError("n_slots, bucket_width, max_probes must be > 0")
        self.n_bands = n_bands
        self.n_slots = n_slots
        self.bucket_width = bucket_width
        self.max_probes = max_probes
        self.device = resolve_device(device)
        reg = obs_metrics.default()
        self._c_spill_probe = reg.counter("table.spill.probe")
        self._c_spill_overflow = reg.counter("table.spill.overflow")
        self._h_probe_depth = reg.histogram("table.probe_depth")
        self._alloc()
        # replay log for rebuild(): every inserted (item, band) hash
        self._hashes = np.zeros((_HASH_BUF_MIN, n_bands), np.uint64)
        self.n_items = 0

    def _alloc(self) -> None:
        nb, ns, w = self.n_bands, self.n_slots, self.bucket_width
        self._records_version = getattr(self, "_records_version", 0) + 1
        self._dev_records = None          # (version, tensor) upload cache
        self.records = np.full((nb, ns, 2 + w), -1, np.int32)
        self.counts = np.zeros((nb, ns), np.int32)
        # spill storage: amortized-doubling buffers (appends are in-place)
        self._sb_buf = np.zeros(_HASH_BUF_MIN, np.int32)
        self._sk_buf = np.zeros(_HASH_BUF_MIN, np.uint64)
        self._si_buf = np.zeros(_HASH_BUF_MIN, np.int64)
        self._spill_len = 0
        self._used_slots = 0        # incremental; avoids used.sum() scans
        self.n_spill_probe = 0      # probe chain exhausted (table too full)
        self.n_spill_overflow = 0   # bucket full (width too small)

    @property
    def _spill_band(self) -> np.ndarray:
        return self._sb_buf[: self._spill_len]

    @property
    def _spill_key(self) -> np.ndarray:
        return self._sk_buf[: self._spill_len]

    @property
    def _spill_id(self) -> np.ndarray:
        return self._si_buf[: self._spill_len]

    # -- stats -------------------------------------------------------------
    @property
    def n_spilled(self) -> int:
        return len(self._spill_id)

    @property
    def load_factor(self) -> float:
        return self._used_slots / (self.n_bands * self.n_slots)

    # -- insert ------------------------------------------------------------
    def insert(self, hashes: np.ndarray, ids: np.ndarray) -> None:
        """Insert a batch: hashes (B, n_bands) uint64, ids (B,) item ids.

        Ids must be contiguous and append-ordered (``n_items .. n_items+B``):
        ``rebuild()`` replays the hash log with ``arange`` ids, so anything
        else would be silently renumbered on the first rebuild."""
        hashes = np.asarray(hashes, np.uint64)
        ids = np.asarray(ids, np.int64)
        b = hashes.shape[0]
        if hashes.shape != (b, self.n_bands) or ids.shape != (b,):
            raise ValueError("hashes must be (B, n_bands), ids (B,)")
        if b and not np.array_equal(
                ids, np.arange(self.n_items, self.n_items + b)):
            raise ValueError(
                f"ids must be contiguous append order "
                f"[{self.n_items}, {self.n_items + b}) — rebuild() replays "
                f"the hash log with arange ids")
        need = self.n_items + b
        self._hashes = grown(self._hashes, need)
        self._hashes[self.n_items: need] = hashes
        self.n_items = need
        self._insert(hashes, ids)

    def _insert(self, hashes: np.ndarray, ids: np.ndarray) -> None:
        """Batched probe-and-place, compacted per probe step.

        All B * n_bands entries probe simultaneously, one vectorized pass
        per probe distance — and entries that land (claim a slot or match
        their key's bucket) are dropped from the working set before the next
        pass, so pass t costs O(still-unplaced), not O(B * n_bands).  At
        sane load factors pass 0 places the vast majority of entries and
        the total work is ~1.3x one pass over the batch, which is what
        makes one-shot index builds run at memory speed instead of
        max_probes full-batch sweeps.
        """
        self._records_version += 1        # records mutate: device copy stale
        nb, ns, w = self.n_bands, self.n_slots, self.bucket_width
        b = hashes.shape[0]
        ent_band = np.tile(np.arange(nb, dtype=np.int64), b)
        ent_key = hashes.reshape(-1)
        ent_id = np.repeat(ids, nb)
        flat = self.records.reshape(nb * ns, 2 + w)        # view

        # sentinel-valued hashes -> spill; everything else enters the probe
        # loop as the compacted working set (original entry order preserved,
        # so first-wins claims and bucket append order match the
        # one-entry-at-a-time semantics)
        live = np.flatnonzero(ent_key != SENTINEL_KEY)
        band, key, eid = ent_band[live], ent_key[live], ent_id[live]
        half = _halves(key)                            # (A, 2) int32 copy
        key64 = half.view(np.int64)[:, 0]              # bit pattern as int64
        base = (key % np.uint64(ns)).astype(np.int64)

        for t in range(self.max_probes):
            if not len(band):
                break
            slot = (base + self._offset(t)) % ns
            lin = band * ns + slot
            k64 = flat[lin, :2].view(np.int64)[:, 0]   # one gather: slot keys
            # claim empty slots: first unplaced entry per slot wins (keys are
            # never the all-ones sentinel here, so k64 == -1 <=> slot unused)
            cl = np.flatnonzero(k64 == -1)
            if len(cl):
                _, first = np.unique(lin[cl], return_index=True)
                winners = cl[first]
                wb, ws = band[winners], slot[winners]
                self.records[wb, ws, 0] = half[winners, 0]
                self.records[wb, ws, 1] = half[winners, 1]
                self._used_slots += len(winners)
                # re-read: winners + same-key entries land this probe step
                k64 = flat[lin, :2].view(np.int64)[:, 0]
            match = k64 == key64
            m = np.flatnonzero(match)
            if len(m):
                m = m[np.argsort(lin[m], kind="stable")]
                ls = lin[m]
                new_grp = np.r_[True, ls[1:] != ls[:-1]]
                grp_start = np.flatnonzero(new_grp)
                rank = np.arange(len(m)) - grp_start[np.cumsum(new_grp) - 1]
                pos = self.counts[band[m], slot[m]] + rank
                fits = pos < w
                f = m[fits]
                self.records[band[f], slot[f], 2 + pos[fits]] = \
                    eid[f].astype(np.int32)
                sizes = np.diff(np.r_[grp_start, len(m)])
                gb, gs = band[m[grp_start]], slot[m[grp_start]]
                self.counts[gb, gs] = np.minimum(
                    self.counts[gb, gs] + sizes, w).astype(np.int32)
                over = m[~fits]
                if len(over):
                    self._spill(band[over], key[over], eid[over])
                    self.n_spill_overflow += len(over)
                    self._c_spill_overflow.inc(len(over))
                keep = ~match
                band, key, eid = band[keep], key[keep], eid[keep]
                half, key64, base = half[keep], key64[keep], base[keep]

        if len(band):                      # probe chain exhausted
            self._spill(band, key, eid)
            self.n_spill_probe += len(band)
            self._c_spill_probe.inc(len(band))
        sent = np.flatnonzero(ent_key == SENTINEL_KEY)
        if len(sent):
            self._spill(ent_band[sent], ent_key[sent], ent_id[sent])
            self.n_spill_probe += len(sent)
            self._c_spill_probe.inc(len(sent))

    def _spill(self, band, key, eid) -> None:
        need = self._spill_len + len(eid)
        self._sb_buf = grown(self._sb_buf, need)
        self._sk_buf = grown(self._sk_buf, need)
        self._si_buf = grown(self._si_buf, need)
        s = self._spill_len
        self._sb_buf[s: need] = band
        self._sk_buf[s: need] = key
        self._si_buf[s: need] = eid
        self._spill_len = need

    # -- lookup ------------------------------------------------------------
    def device_records(self) -> torch.Tensor:
        """(n_bands * n_slots, 2 + W) int32 copy of the fused records on the
        table's device, cached by mutation version — the table uploads once
        per build/rebuild and query batches probe the resident copy
        (kernels/lsh_probe.py)."""
        cached = self._dev_records
        if cached is None or cached[0] != self._records_version:
            self._dev_records = None          # free the stale copy first
            flat = self.records.reshape(-1, 2 + self.bucket_width)
            self._dev_records = (self._records_version,
                                 torch.tensor(flat, device=self.device))
        return self._dev_records[1]

    def lookup(self, hashes: np.ndarray, *, impl: str = "numpy") -> np.ndarray:
        """(Q, n_bands) band hashes -> (Q, n_bands * bucket_width) candidate
        item ids, -1 padded.  One fused record gather per probe — key compare
        and posting ids share the cache line.  The batched hot path.

        ``impl`` selects the probe backend: ``"numpy"`` is this host loop
        (the CPU-tuned reference), ``"device"`` runs the probe kernel over
        ``device_records()`` via ``kernels.dispatch.lsh_probe``, and
        ``"auto"`` is the device probe on a CUDA table and numpy otherwise.
        All backends return identical candidates."""
        if impl not in PROBE_IMPLS:
            raise ValueError(f"impl must be one of {PROBE_IMPLS} (got "
                             f"{impl!r})")
        hashes = np.asarray(hashes, np.uint64)
        if impl == "auto":
            impl = "device" if self.device.type == "cuda" else "numpy"
        if impl == "device":
            from ..kernels import dispatch
            return dispatch.lsh_probe(
                self.device_records(), hashes, n_slots=self.n_slots,
                max_probes=self.max_probes)
        q, nb = hashes.shape
        ns, w = self.n_slots, self.bucket_width
        key = np.ascontiguousarray(hashes.reshape(-1))
        key64 = key.view(np.int64)                 # bit pattern as int64
        band_off = np.tile(np.arange(nb, dtype=np.int64) * ns, q)
        base = (key % np.uint64(ns)).astype(np.int64)
        flat = self.records.reshape(nb * ns, 2 + w)        # view
        # probe 0 resolves ~1/(1-load) of entries: build the result
        # contiguously (no fancy scatter), then chase the rare chains.
        # the adjacent key halves of a gathered record row read as one int64
        # (-1 = unused sentinel), so each probe is one gather + two compares
        rec = flat[band_off + base]                        # (E, 2+W) gather
        k64 = rec[:, :2].view(np.int64)[:, 0]
        hit = k64 == key64
        out = np.where(hit[:, None], rec[:, 2:], np.int32(-1))
        active = np.flatnonzero(~hit & (k64 != -1) & (key != SENTINEL_KEY))
        # probe-depth histogram: depth d = entries that needed d gathers
        # (the ~1/(1-load) expectation made measurable; bucket values are
        # small ints, not seconds, but the log buckets resolve 1..max_probes)
        n_act = len(active)
        if q * nb - n_act:
            self._h_probe_depth.observe_n(1.0, q * nb - n_act)
        for t in range(1, self.max_probes):
            if not len(active):
                break
            rec = flat[band_off[active] + (base[active] + self._offset(t)) % ns]
            k64 = rec[:, :2].view(np.int64)[:, 0]
            hit = k64 == key64[active]
            out[active[hit]] = rec[hit, 2:]
            active = active[~hit & (k64 != -1)]
            if n_act - len(active):
                self._h_probe_depth.observe_n(float(t + 1),
                                              n_act - len(active))
            n_act = len(active)
        if n_act:                       # chain exhausted: counted at the cap
            self._h_probe_depth.observe_n(float(self.max_probes), n_act)
        return out.reshape(q, nb * w)

    def spilled_candidates(self, hashes: np.ndarray, *,
                           cap: int | None = None) -> np.ndarray:
        """(Q, n_bands) band hashes -> (Q, M) spilled item ids whose recorded
        (band, key) matches the query, -1 padded, unique-per-row (an id
        spilled in several matching bands appears once).  M = max unique
        matches over the batch, 0 wide when nothing matches.  Preserves the
        LSH contract for spilled entries: a returned id still shares a band
        bucket key with the query.  Rare path — the spill list is small by
        construction.

        ``cap`` bounds each matched spilled (band, key) *group* to its
        ``cap`` smallest ids, so one hot spilled key (an oversized duplicate
        cluster left spilled by the growth caps) cannot widen (Q, M) for
        every query in the batch: row width is bounded by n_bands * cap
        whatever the group sizes.  The cap is per group, never across
        groups — candidates from differently-keyed groups are never dropped
        in favor of smaller ids elsewhere, so capping only loses candidates
        *inside* an oversized group.  Query paths pass ``cap=top_k``: hot
        groups are in practice near-duplicate clusters whose members tie in
        score, ties break toward smaller ids, and the group's ``top_k``
        smallest are exactly the tie-winners.  The trade is explicit: a
        spilled group with > cap members whose scores do NOT tie can lose a
        higher-scoring larger id (and, sharded, per-shard caps keep
        per-shard smallest — the only window where S-shard and 1-shard
        answers may differ).  ``cap=None`` is exact."""
        q = len(hashes)
        if not len(self._spill_id):
            return np.zeros((q, 0), np.int64)
        rows: list[list[int]] = [[] for _ in range(q)]
        for band in np.unique(self._spill_band):
            sel = self._spill_band == band
            order = np.argsort(self._spill_key[sel], kind="stable")
            keys = self._spill_key[sel][order]
            ids = self._spill_id[sel][order]
            col = hashes[:, band]
            lo = np.searchsorted(keys, col, "left")
            hi = np.searchsorted(keys, col, "right")
            for qi in np.flatnonzero(hi > lo):
                grp = ids[lo[qi]: hi[qi]]      # one (band, key) group
                if cap is not None and len(grp) > cap:
                    grp = np.sort(grp)[:cap]
                rows[qi].extend(grp.tolist())
        uniq = [np.unique(np.asarray(r, np.int64)) for r in rows]
        m = max(len(u) for u in uniq)
        out = np.full((q, m), -1, np.int64)
        for qi, u in enumerate(uniq):
            out[qi, : len(u)] = u
        return out

    # -- compaction --------------------------------------------------------
    def rebuild(self, n_slots: int | None = None,
                bucket_width: int | None = None,
                max_probes: int | None = None) -> None:
        """Reallocate at new geometry and replay every recorded hash.

        Drains the spill: every item ends up bucketed (or re-spilled if the
        new geometry is still too small)."""
        self.n_slots = n_slots or self.n_slots
        self.bucket_width = bucket_width or self.bucket_width
        self.max_probes = max_probes or self.max_probes
        self._alloc()
        if self.n_items:
            self._insert(self._hashes[: self.n_items],
                         np.arange(self.n_items, dtype=np.int64))

