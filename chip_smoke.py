#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the similarity-search serving
path (sparse and dense input) and the paper's Fig. 7 experiment on one
NVIDIA card, with its hand-written kernels (six CUDA sources).

    python3 chip_smoke.py              # from the root of a checkout

Phases; any failure raises and exits non-zero, and no result line is
printed then:

1. Build the six CUDA sources in ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print nvcc's register report.
2. Main path at full size, through the service a user calls: SearchConfig
   defaults (D = 2^16, K = 256, 32 bands x 8 rows, b = 32, n_slots 2048
   growing by rebuild, bucket width 8, one in-process shard) on
   ``device="cuda"``.  Ingest 262,144 synthetic documents in 4096-document
   batches through ``IngestPipeline(depth=2)``, then answer one batch of
   1024 indexed + 64 fresh documents (top_k = 5).  Every kernel's launch
   count is set to 0 just before this phase and read just after it; each
   must be > 0, and the collision kernel must have launched once per
   brute-force fallback call (one launch over the whole index).  Top-1
   self-hit on the indexed rows must be 100%, and some rows must take the
   brute-force fallback.  Then the same batch through the shard's own
   ``SketchStore.query_packed`` (the library's single-store query), its
   counts set to 0 just before and read just after (``store_path``): it
   must answer as the service did, with one launch of the fold + probe
   kernel a batch and none of the probe from hashes.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it: outputs must be equal (tolerance 0, all
   integers).  Times are medians of CUDA-event timings after warm-up.
   ``ms`` (as ``plain_ms`` and ``library_ms``) times the call as a caller
   makes it, the wrapper's host work included; ``device_ms`` has the card
   spin ~0.25 ms before each start event, so the host's work overlaps the
   spin and the events time the device's work alone (a run whose enqueue
   outlasts the spin is dropped; a kernel with no device-only time this
   way fails the run).
   ``bound_ms`` is the larger of bytes / 3.35 TB/s and operations / the
   int32 rate (132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7e12 op/s, half
   the lanes behind the published 67 TFLOP/s float32 figure of the H100
   SXM), counted from this run's inputs.  ``library_ms`` is the collision
   count as one PyTorch call, ``K - torch.cdist(a.double(), b.double(),
   p=0)`` (float64 holds the int32 codes exactly; checked equal), timed
   here only; no single PyTorch call computes the others, so theirs is
   null.  The probe runs from the fold's hashes on the card
   (``lsh_probe``) and, folding the query words itself, as one launch
   (``fold_probe``); its bound counts the function's own bytes (8 a hash
   or R * 4 a band's words, 8 a probe step this run's walks take, W * 4 a
   hit, the output), and the dependent reads of the earlier and the
   current probe over this run's walks are printed beside it; then the fold -> candidates leg
   as the service's shard runs it is timed.  The collision kernel is timed
   at the fallback's real call, the pow2-padded fallback rows against all
   262,144 indexed rows in one launch on the stored words, and on one
   16,384-row block of unpacked codes (the shape the earlier blocked
   fallback launched 16 times); its bound counts one integer compare a
   pair of codes (a pair of words at b < 32), the compare being the only
   part of the count that needs the integer pipe.
4. One more query batch under ``torch.profiler``: the device-busy share
   of its wall time and device time by kernel (the timeline goes to
   ``chiprun_out/query_trace.json``).
5. The card against the port's own CPU path on the first 4096 documents:
   ids and scores must be identical.
6. Dense serving path: a fresh service with the same defaults ingests the
   first 65,536 documents as dense 0/1 int8 rows (16 batches of 4096 x
   2^16, built on the host) through ``pipeline(layout="dense", depth=2)``
   (auto: the bit-packed kernel), then answers the 1088-row query batch as
   dense rows five times.  Counts are set to 0 just before and read just
   after; the bit-packed kernel must have launched once per ingest and
   query batch, and the collision kernel once per fallback call.
   Every ingested word must equal the sparse signing of the same
   documents, ``query_dense`` must answer as ``query_sparse`` of the same
   documents, and top-1 self-hit must be 100%.  One more dense query batch
   runs under the profiler, as in phase 4
   (``chiprun_out/query_trace_dense.json``).
7. Paper path, Fig. 7 (``benchmarks/bench_mae.py``'s four corpora at D =
   2048, 4096 documents each, K in {64, 256, 512}): C-MinHash-(0,pi) and
   -(sigma,pi) through ``ops.cminhash_signatures`` (auto: the int8
   kernel), classical MinHash through ``core.minhash.minhash_dense``,
   estimates from the collision kernel, exact Jaccard over all pairs as an
   exact float32 product (TF32 off).  Prints each method's MAE per
   (corpus, K); nothing statistical gates the run.  Counted as phase 6.
8. The two dense kernels against their plain versions: the int8 kernel
   at the paper's shape and, forced, at the service's shape with pack_b =
   32; the bit-packed kernel at the service's shape and at D = 2048.
   Tolerance 0; timed and bounded as in phase 3.  Both are bounded by the
   function's work on this run's rows: each input byte (or word) read
   once, and one min per set bit per hash.  The int8 kernel's B*K*D
   masked mins are its algorithm's cost, not the function's, and are
   recorded beside as ``dense_algorithm_ops``.  No single PyTorch call
   computes the dense min-reduce, so ``library_ms`` is null.  The int8
   kernel is also timed on the imageA corpus at each of Fig. 7's K, and
   the sum over phase 7's 24 launches (8 at each K) is printed; so is the
   collision kernel at Fig. 7's 4096 x 4096 x K on those signatures
   (checked against its plain version and ``K - cdist(p=0)``, timed with
   both, summed over phase 7's 36 launches).
9. The card against the CPU on a 512-document dense subset.

``launches`` in the kernels line is the sum over the four counted paths
(phase 2's service and store paths, phases 6 and 7).

The second-to-last line is nvidia-smi's name and power limit of the card;
the last is ``{"ok": true, "device": {...}}``.  Details, nvcc's full
output included, go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --compare [--baseline DIR]

runs only a comparison of the signing and collision kernels, through their
wrappers: the sparse, dense int8 and bit-packed signing kernels at the
serving batch, at Fig. 7's shapes and at the dense service's, with the
per-call table placement of ``csrc/window_fold.cuh`` and each placement
forced through the kernels' test entry point; the collision kernel at the
serving fallback (b = 32 and 8), one 16,384-row block and Fig. 7's 4096 x
4096 x K; with ``--baseline``, each of them also on a build of
``DIR/src/repro_torch/csrc``'s source of it (an earlier checkout) behind
the same wrapper.  Each variant is checked against the plain version and
timed both ways; the collision kernel's count loop is profiled in SASS
(instructions a compare, by opcode).  Then the query side at the main
path's full-size shapes (a 2^19-slot, 32-band table of 262,144 documents,
1088 x 32 x 8 query codes): the fold, the probe from the fold's hashes,
the fold -> candidates leg as the service's shard runs it (fold, probe;
DIR's sources on the earlier operand-row interface: fold, hashes to the
host, ``probe_operands``, upload, probe) and as the single store runs it (one
fold + probe launch; DIR's: fold, ``meta_from_hashes``, probe); each also
timed with L2 flushed before every run.  Output:
``chiprun_out/compare.json`` and ``chiprun_out/collision.sass``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 500_000         # ~0.25 ms at the H100's 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BATCH = 4096
N_QUERY_INDEXED = 1024
N_QUERY_FRESH = 64
TOP_K = 5
N_DENSE = 65_536              # documents ingested as dense rows
PAPER_D = 2048
PAPER_DOCS = 4096
PAPER_KS = (64, 256, 512)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2, spin: bool = False,
            flush: torch.Tensor | None = None) -> float | None:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    the host's work to launch it included.

    With ``spin`` the card spins for ~0.25 ms (``torch.cuda._sleep``)
    before the start event of each run, so the host's work to launch
    ``fn`` (the wrapper's checks, the allocation, the ctypes call) overlaps
    the spin and the events time the device's work alone, as long as that
    enqueue takes less than the spin.  A run whose enqueue outlasts it (the
    card has passed the start event when ``fn`` returns: a long enqueue,
    or an ``fn`` that waits for the card) holds host work, and is dropped;
    if half the runs or more are, ``fn`` has no device-only time this way
    and the result is None.  With ``flush`` (a tensor larger than the 50 MB
    L2) the card rewrites it before each run, so ``fn`` finds its inputs in
    device memory, not in L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.add_(1)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        overran = spin and start.query()
        end.record()
        end.synchronize()
        if not overran:
            times.append(start.elapsed_time(end))
    return statistics.median(times) if 2 * len(times) > reps else None


def both_ms(fn, reps: int, host_bound_ok: bool = False
            ) -> tuple[float, float | None]:
    """(``ms``, ``device_ms``) of ``fn``: with the host's launch work, and
    without it.  A device time that cannot be separated from the host's
    work (``time_ms`` gives None) fails the run unless ``host_bound_ok``."""
    ms, device_ms = time_ms(fn, reps), time_ms(fn, reps, spin=True)
    require(device_ms is not None or host_bound_ok,
            "device time: the enqueue outlasted the card's spin")
    return ms, device_ms


def fmt_ms(ms: float | None) -> str:
    return "host-bound" if ms is None else f"{ms:.4f}"


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    require(a.shape == b.shape and a.dtype == b.dtype,
            f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
            f"{b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def corpus(n_docs: int):
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    docs, _ = corpus_with_duplicates(n_docs, vocab=30_000, doc_len=256,
                                     dup_fraction=0.4, seed=0)
    idx = batch_shingles(docs, n=3, d=1 << 16)
    fresh, _ = corpus_with_duplicates(N_QUERY_FRESH, vocab=30_000,
                                      doc_len=256, dup_fraction=0.4, seed=1)
    fresh_idx = batch_shingles(fresh, n=3, d=1 << 16, max_nnz=idx.shape[1])
    return idx, fresh_idx


def kernels():
    from repro_torch.kernels import (cminhash_kernel, cminhash_packed,
                                     cminhash_sparse, collision_kernel,
                                     lsh_probe, query_fused)
    return {"cminhash_sparse": cminhash_sparse.KERNEL,
            "fold": query_fused.KERNEL,
            "lsh_probe": lsh_probe.KERNEL,
            "fold_probe": query_fused.FOLD_PROBE_KERNEL,
            "collision": collision_kernel.KERNEL,
            "cminhash_dense": cminhash_kernel.KERNEL,
            "cminhash_packed": cminhash_packed.KERNEL}


def zero_counts(ks) -> None:
    for k in ks.values():
        k.launches = 0


def read_counts(ks) -> dict:
    return {n: k.launches for n, k in ks.items()}


def dense_rows(idx: np.ndarray, d: int = 1 << 16) -> np.ndarray:
    """Padded index lists -> (B, d) int8 0/1 rows, as a user holds them."""
    v = np.zeros((len(idx), d), np.int8)
    rows = np.repeat(np.arange(len(idx)), idx.shape[1])
    flat = idx.reshape(-1)
    ok = flat >= 0
    v[rows[ok], flat[ok]] = 1
    return v


def ingest(svc, idx, batch: int) -> float:
    t0 = time.perf_counter()
    with svc.pipeline(depth=2) as pipe:
        for lo in range(0, len(idx), batch):
            pipe.submit(idx[lo: lo + batch])
    return time.perf_counter() - t0


def main_path(idx, fresh_idx, report: dict):
    """Phase 2: the serving path at full size, counted and checked."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ks = kernels()
    svc = SimilaritySearchService(SearchConfig(device="cuda"))
    qidx = np.concatenate([idx[:N_QUERY_INDEXED], fresh_idx])
    zero_counts(ks)
    # --- the main path: ingest + query batches -----------------------------
    t_ingest = ingest(svc, idx, BATCH)
    after_ingest = {n: k.launches for n, k in ks.items()}
    lat = []
    for _ in range(5):
        before = {n: k.launches for n, k in ks.items()}
        t0 = time.perf_counter()
        ids, scores = svc.query_sparse(qidx, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    per_query = {n: launches[n] - before[n] for n in ks}
    n_batches = -(-len(idx) // BATCH)
    store = svc.store.shards[0].store
    n_fallback = svc.store.last_timings["n_fallback"]
    self_hit = float((ids[:N_QUERY_INDEXED, 0]
                      == np.arange(N_QUERY_INDEXED)).mean())
    report["main_path"] = {
        "docs": len(idx), "ingest_s": t_ingest,
        "ingest_docs_per_s": len(idx) / t_ingest,
        "query_rows": len(qidx),
        "query_latency_s_first": lat[0],
        "query_latency_s_median_next4": statistics.median(lat[1:]),
        "query_latency_s_all": lat, "top1_self_hit": self_hit,
        "fallback_rows": n_fallback, "n_slots": store.table.n_slots,
        "bucket_width": store.table.bucket_width,
        "n_spilled": store.n_spilled, "n_rebuilds": store.n_rebuilds,
        "records_bytes": store.table.records.nbytes,
        "words_bytes": store.buffer.size * store.buffer.cfg.n_words * 4,
        "launches": launches,
        "launches_per_ingest_batch": {n: after_ingest[n] / n_batches
                                      for n in ks},
        "launches_per_query_batch": per_query,
        "registry": obs_metrics.default().snapshot(),
    }
    print(f"[main] ingest {len(idx)} docs in {t_ingest:.3f} s "
          f"({len(idx) / t_ingest:.0f} docs/s, {n_batches} batches of "
          f"{BATCH}); n_slots={store.table.n_slots} "
          f"bucket_width={store.table.bucket_width} "
          f"spilled={store.n_spilled} rebuilds={store.n_rebuilds}")
    print(f"[main] query batch of {len(qidx)} rows: first "
          f"{lat[0] * 1e3:.3f} ms, median of next 4 "
          f"{statistics.median(lat[1:]) * 1e3:.3f} ms; top-1 self-hit "
          f"{self_hit * 100:.2f}%; fallback rows {n_fallback}")
    print(f"[main] launches {launches}; per query batch {per_query}")
    require(ids.shape == (len(qidx), TOP_K) and scores.dtype == np.float32,
            "answer shape")
    require(bool(np.isfinite(scores).all()), "finite scores")
    require(self_hit == 1.0, f"top-1 self-hit {self_hit}")
    require(n_fallback > 0, "some rows take the brute-force fallback")
    for n in ("cminhash_sparse", "fold", "lsh_probe", "collision"):
        require(launches[n] > 0,
                f"kernel {n} launched on the main path ({launches[n]})")
    store_path(svc, qidx, ids, scores, report)
    n_shards = len(svc.store.shards)
    require(per_query["collision"] == n_shards
            and launches["collision"] == len(lat) * n_shards,
            f"collision kernel launched once per brute-force fallback call "
            f"({launches['collision']} launches for {len(lat)} query batches "
            f"x {n_shards} shard)")
    return svc, qidx


def store_path(svc, qidx, ids, scores, report: dict) -> None:
    """Phase 2, second leg: the same query batch through the main path's
    shard store, ``SketchStore.query_packed``, the library's single-store
    query (fold and probe in one launch of the probe kernel), counted apart
    from the service.  It must answer as the service did."""
    ks = kernels()
    store = svc.store.shards[0].store
    qwords = svc.engine.sign(qidx, layout="sparse", pack_b=svc.cfg.b)
    torch.cuda.synchronize()
    zero_counts(ks)
    # --- the store path: query batches --------------------------------------
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        s_ids, s_scores = store.query_packed(qwords, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    report["store_path"] = {"query_rows": len(qidx),
                            "query_latency_s_all": lat,
                            "n_spilled": store.n_spilled,
                            "launches": launches}
    print(f"[store] SketchStore.query_packed, {len(qidx)} rows: "
          + ", ".join(f"{t * 1e3:.3f}" for t in lat)
          + f" ms; launches {launches}")
    require(np.array_equal(s_ids, ids) and np.array_equal(s_scores, scores),
            "the store's own query answers as the service")
    require(launches["fold_probe"] == len(lat) and launches["lsh_probe"] == 0,
            f"the store's query probes in one fold + probe launch a batch "
            f"({launches['fold_probe']} for {len(lat)} batches)")


def kernel_checks(svc, idx, qidx, report: dict) -> list[dict]:
    """Phase 3: every kernel vs its plain version at the main path's
    shapes, timed."""
    from repro_torch.core.lsh import band_hashes_packed
    from repro_torch.core.permutations import apply_permutation_sparse
    from repro_torch.device import u32_to_host
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.kernels import collision_kernel as kc
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import lsh_probe as kp
    from repro_torch.kernels import query_fused as kq
    from repro_torch.kernels.packfmt import pack_codes, unpack_codes
    dev = svc.engine.device
    cfg = svc.cfg
    store = svc.store.shards[0].store
    out = []

    def entry(*args, **kw):
        out.append(kernel_entry(*args, **kw))

    # 1. sparse window-min signing, one 4096-document ingest batch
    sidx = apply_permutation_sparse(torch.tensor(idx[:BATCH], device=dev),
                                    svc.engine.sigma).to(torch.int32)
    sidx = sidx.contiguous()
    pi, k = svc.engine.pi, cfg.k
    got = ks.cminhash_sparse_kernel(sidx, pi, k, pack_b=cfg.b)
    want = ks.cminhash_sparse_plain(sidx, pi, k, pack_b=cfg.b)
    for pack_b in (None, 1, 2, 4, 8, 16):      # the other epilogues
        a = ks.cminhash_sparse_kernel(sidx, pi, k, pack_b=pack_b)
        require(torch.equal(a, ks.cminhash_sparse_plain(sidx, pi, k,
                                                        pack_b=pack_b)),
                f"cminhash_sparse pack_b={pack_b}")
    wrap = sidx + pi.numel() * torch.randint_like(sidx, 0, 3) * (sidx >= 0)
    require(torch.equal(ks.cminhash_sparse_kernel(wrap, pi, k, pack_b=cfg.b),
                        want), "cminhash_sparse indices >= D wrap mod D")
    require(torch.equal(
        ks.cminhash_sparse_kernel(sidx, pi, k, shift_offset=0),
        ks.cminhash_sparse_plain(sidx, pi, k, shift_offset=0)),
        "cminhash_sparse shift_offset=0")
    big_d = (1 << 16) + 3                       # past the uint16 range
    gen = torch.Generator().manual_seed(1)
    pi_big = torch.randperm(big_d, generator=gen).to(torch.int32).to(dev)
    idx_big = torch.randint(-1, big_d, (257, 77), generator=gen,
                            dtype=torch.int32).to(dev)
    require(torch.equal(ks.cminhash_sparse_kernel(idx_big, pi_big, 200),
                        ks.cminhash_sparse_plain(idx_big, pi_big, 200)),
            "cminhash_sparse D > 2^16")
    ms, dev_ms = both_ms(lambda: ks.cminhash_sparse_kernel(
        sidx, pi, k, pack_b=cfg.b), 20)
    plain_ms = time_ms(lambda: ks.cminhash_sparse_plain(sidx, pi, k,
                                                        pack_b=cfg.b), 5)
    n_valid = int((sidx >= 0).sum().item())
    entry("cminhash_sparse", "src/repro_torch/csrc/cminhash_sparse.cu",
          "src/repro/kernels/cminhash_sparse.py:186", got, want, ms,
          plain_ms, sidx.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
          n_valid * k, dev_ms,
          {"shape": list(sidx.shape)})

    # 2. band-hash fold, the coordinator's query batch
    qwords = svc.engine.sign(qidx, layout="sparse", pack_b=cfg.b)
    rows = kq.words_to_rows(qwords, cfg.n_bands).contiguous()
    folded = got = kq.fold_rows_kernel(rows)
    want = kq.fold_rows_plain(rows)
    require(np.array_equal(kq.hashes_to_host(got), band_hashes_packed(
        u32_to_host(qwords), cfg.n_bands)), "fold vs host uint64 fold")
    sig = torch.randint(-2**31, 2**31 - 1, rows.shape, dtype=torch.int32,
                        device=dev)
    require(torch.equal(kq.fold_rows_kernel(sig, sign_extend=True),
                        kq.fold_rows_plain(sig, sign_extend=True)),
            "fold sign_extend")
    moved = torch.cat([rows.new_zeros(1), rows.reshape(-1)])[1:]
    require(torch.equal(kq.fold_rows_kernel(moved.view(rows.shape)), want),
            "fold, rows off the 16-byte boundary (scalar loads)")
    ms, dev_ms = both_ms(lambda: kq.fold_rows_kernel(rows), 50)
    plain_ms = time_ms(lambda: kq.fold_rows_plain(rows), 10)
    entry("fold", "src/repro_torch/csrc/fold.cu",
          "src/repro/kernels/query_fused.py:164", got, want, ms, plain_ms,
          rows.numel() * 4 + got.numel() * 8, rows.numel() * 5, dev_ms,
          {"shape": list(rows.shape)})

    # 3. probe over the full-size resident records, from the fold's hashes
    # where the fold left them
    records = store.table.device_records()
    ns, mp = store.table.n_slots, store.table.max_probes
    got = kp.lsh_probe_hashes_kernel(records, folded, n_slots=ns,
                                     max_probes=mp)
    want = kp.lsh_probe_hashes_plain(records, folded, n_slots=ns,
                                     max_probes=mp)
    ms, dev_ms = both_ms(lambda: kp.lsh_probe_hashes_kernel(
        records, folded, n_slots=ns, max_probes=mp), 50)
    plain_ms = time_ms(lambda: kp.lsh_probe_hashes_plain(
        records, folded, n_slots=ns, max_probes=mp), 5)
    # the function's bytes: 8 a hash, 8 key bytes per probe step this run's
    # walks take, the W posting ids of each hit, the output
    w = records.shape[1] - 2
    walk = probe_walk(records, kp.hash_operands(folded, ns), ns, mp)
    e = folded.numel()
    walk_bytes = walk["probe_steps"] * 8 + walk["hits"] * w * 4
    entry("lsh_probe", "src/repro_torch/csrc/lsh_probe.cu",
          "src/repro/kernels/lsh_probe.py:137", got, want, ms, plain_ms,
          e * 8 + walk_bytes + got.numel() * 4, walk["probe_steps"] * 3,
          dev_ms, {"shape": [e, w], "records_shape": list(records.shape),
                   **walk})
    print(f"[kernel] lsh_probe walk: {walk['probe_steps']} steps for {e} "
          f"entries (most {walk['steps_max']}), {walk['hits']} hits; "
          f"dependent round trips, mean / most: thread an entry "
          f"{walk['round_trips_thread_an_entry']['mean']:.3f} / "
          f"{walk['round_trips_thread_an_entry']['max']}, group walk "
          f"{walk['round_trips_group_walk']['mean']:.3f} / "
          f"{walk['round_trips_group_walk']['max']}")

    # 3b. fold + probe in one launch, from the query words (the store's own
    # query)
    fused = kq.fold_probe_kernel(records, rows, n_slots=ns, max_probes=mp)
    require(torch.equal(fused, got), "fold + probe == probe of the fold")
    ms, dev_ms = both_ms(lambda: kq.fold_probe_kernel(
        records, rows, n_slots=ns, max_probes=mp), 50)
    plain_ms = time_ms(lambda: kq.fold_probe_plain(
        records, rows, n_slots=ns, max_probes=mp), 5)
    entry("fold_probe", "src/repro_torch/csrc/lsh_probe.cu",
          "src/repro/kernels/lsh_probe.py:137", fused,
          kq.fold_probe_plain(records, rows, n_slots=ns, max_probes=mp), ms,
          plain_ms, rows.numel() * 4 + walk_bytes + fused.numel() * 4,
          walk["probe_steps"] * 3 + rows.numel() * 5, dev_ms,
          {"shape": list(rows.shape) + [w],
           "also_replaces": "src/repro/kernels/query_fused.py:164"})

    # the fold -> candidates leg as the main path's shard runs it: words on
    # the card to candidate ids on the card
    leg_ms, leg_dev_ms = both_ms(lambda: kp.lsh_probe_hashes_kernel(
        records, dispatch.fold_hashes(qwords, n_bands=cfg.n_bands),
        n_slots=ns, max_probes=mp), 50)
    report["query_leg"] = {"service_ms": leg_ms,
                           "service_device_ms": leg_dev_ms}
    print(f"[kernel] fold -> candidates leg as the service runs it: "
          f"{leg_ms:.4f} ms, device {leg_dev_ms:.4f} ms")

    # 4. collision counts: the brute-force fallback's call, the
    # pow2-padded fallback rows against the whole index in one launch, on
    # the words as the index stores them; and one 16,384-row block of
    # unpacked codes, the shape the earlier blocked fallback launched
    n_fb = report["main_path"]["fallback_rows"]
    q_pad = 1 << (n_fb - 1).bit_length()
    wq = qwords[N_QUERY_INDEXED:]
    wq = torch.cat([wq, wq[:1].expand(max(q_pad - len(wq), 0), -1)])
    wq = wq[:q_pad].contiguous()
    words = store.buffer.device_words()
    b = cfg.b
    got = kc.packed_collision_counts_kernel(wq, words, k, b)
    want = torch.cat([kc.packed_collision_counts_plain(
        wq, words[lo: lo + 16384], k, b)
        for lo in range(0, len(words), 16384)], dim=1)
    qfb = unpack_codes(wq, k, b).contiguous()
    block = unpack_codes(words[:16384], k, b).contiguous()
    require(torch.equal(kc.collision_counts_kernel(qfb, block),
                        kc.collision_counts_plain(qfb, block)),
            "collision one 16,384-row block")
    ragged = kc.collision_counts_kernel(qfb[:37, :130].contiguous(),
                                        block[:1001, :130].contiguous())
    require(torch.equal(ragged, kc.collision_counts_plain(
        qfb[:37, :130], block[:1001, :130])), "collision ragged edges")
    for pb in (1, 2, 4, 8, 16):                 # the other pack widths
        pq, pn = pack_codes(qfb, pb), pack_codes(block[:4099], pb)
        require(torch.equal(kc.packed_collision_counts_kernel(pq, pn, k, pb),
                            kc.packed_collision_counts_plain(pq, pn, k, pb)),
                f"collision b={pb}")
    qd, nd = unpack_codes(wq, k, b).double(), unpack_codes(words, k, b).double()

    def library():
        return k - torch.cdist(qd, nd, p=0)
    require(torch.equal(library().to(torch.int32), want),
            "collision: K - cdist(p=0) == the plain version")
    ms, dev_ms = both_ms(lambda: kc.packed_collision_counts_kernel(
        wq, words, k, b), 20)
    blk_ms, blk_dev_ms = both_ms(lambda: kc.collision_counts_kernel(
        qfb, block), 20)
    plain_ms = time_ms(lambda: kc.packed_collision_counts_plain(
        wq, words, k, b), 3, warmup=1)
    library_ms = time_ms(library, 3, warmup=1)
    qn, nn, nw = wq.shape[0], words.shape[0], words.shape[1]
    entry("collision", "src/repro_torch/csrc/collision.cu",
          "src/repro/kernels/collision_kernel.py:37", got, want, ms,
          plain_ms, (qn + nn) * nw * 4 + qn * nn * 4,
          collision_ops(qn, nn, k, b), dev_ms,
          {"shape": [qn, nn, k], "b": b, "launches_per_brute_call": 1,
           "block_16384_ms": blk_ms, "block_16384_device_ms": blk_dev_ms,
           "block_16384_bound_ms": bound_ms(
               (qn + 16384) * k * 4 + qn * 16384 * 4,
               collision_ops(qn, 16384, k, 32))[0]},
          library_ms=library_ms)
    print(f"[kernel] collision one 16,384-row block of int32 codes: "
          f"{blk_ms:.4f} ms, device {blk_dev_ms:.4f} ms")
    return out


def collision_ops(q: int, n: int, k: int, b: int) -> int:
    """The collision count's operations: one integer compare a pair of
    codes at b = 32, one a pair of words (32/b codes) below."""
    return q * n * (k if b == 32 else -(-k // (32 // b)))


def kernel_entry(name, source, replaces, got, want, ms, plain_ms, nbytes,
                 ops, device_ms, extra=None, library_ms=None) -> dict:
    """One kernel's checked, timed and bounded row (launches are filled in
    from the counted paths at the end)."""
    err = max_abs_err(got, want)
    require(err == 0.0 and torch.equal(got, want),
            f"{name}: kernel != plain version (max abs err {err})")
    b_ms, b_by = bound_ms(nbytes, ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None,
           "max_abs_err": err, "equal": True, "ms": ms, "kernel_ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms, "bytes": nbytes, "operations": ops}
    row.update(extra or {})
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    shape = f" {row['shape']}" if "shape" in row else ""
    print(f"[kernel] {name}{shape}: equal, {ms:.4f} ms, device "
          f"{device_ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}{lib})")
    return row


def trace_query(svc, qdata, report: dict, layout: str = "sparse") -> None:
    """Phase 4 (and the dense path's trace): one query batch under
    torch.profiler.  Device busy time is the union of the trace's kernel,
    memcpy and memset intervals, so no operator is counted twice with the
    kernels it launched."""
    from torch.profiler import ProfilerActivity, profile
    query = svc.query_sparse if layout == "sparse" else svc.query_dense
    tag = "" if layout == "sparse" else f"_{layout}"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query(qdata, top_k=TOP_K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(ROOT, "chiprun_out", f"query_trace{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for start, stop, name in device:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + stop - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    report[f"query_trace{tag}"] = {
        "wall_us": wall_us, "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us,
        "device_events": len(device),
        "top_device_time_us": [{"name": n, "us": t} for n, t in top]}
    require(busy_us > 0, "the profiler recorded device activity")
    print(f"[trace] {layout} query batch: wall {wall_us / 1e3:.3f} ms, "
          f"device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us * 100:.1f}%) over "
          f"{len(device)} device events; top: "
          + ", ".join(f"{n[:48]} {t / 1e3:.3f} ms" for n, t in top[:4]))


def probe_walk(records, meta, n_slots, max_probes) -> dict:
    """The early-exit walk over these operands: probe steps read and hits,
    and the dependent memory reads each design of the probe needs for it:
    a thread an entry (the earlier kernel: the operand row, one key read a
    step, the hit's ids) and the group walk (``csrc/lsh_probe.cu``: the
    hash, one read of four steps' keys, the hit's ids)."""
    lin, base = meta[:, 0].long(), meta[:, 1].long()
    active = meta[:, 4] != 0
    steps = torch.zeros(meta.shape[0], dtype=torch.long, device=meta.device)
    hit_any = torch.zeros_like(active)
    for t in range(max_probes):
        if not bool(active.any()):
            break
        steps += active.long()
        rec = records[lin + (base + t * (t + 1) // 2) % n_slots]
        hit = active & (rec[:, 0] == meta[:, 2]) & (rec[:, 1] == meta[:, 3])
        unused = (rec[:, 0] == -1) & (rec[:, 1] == -1)
        hit_any |= hit
        active = active & ~hit & ~unused
    old = 1 + steps + hit_any.long()
    new = 1 + (steps + 3) // 4 + hit_any.long()

    def stats(trips):
        return {"mean": float(trips.double().mean()),
                "max": int(trips.max()) if trips.numel() else 0}
    return {"probe_steps": int(steps.sum()), "hits": int(hit_any.sum()),
            "steps_max": int(steps.max()) if steps.numel() else 0,
            "steps_hist": torch.bincount(steps).tolist(),
            "round_trips_thread_an_entry": stats(old),
            "round_trips_group_walk": stats(new)}


def card_vs_cpu(idx, fresh_idx, report: dict) -> None:
    """Phase 5: the same service on the card and on the CPU."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    sub = idx[:4096]
    q = np.concatenate([sub[:256], fresh_idx])
    answers = []
    for device in ("cuda", "cpu"):
        svc = SimilaritySearchService(SearchConfig(device=device))
        ingest(svc, sub, 1024)
        answers.append(svc.query_sparse(q, top_k=TOP_K))
        fb = svc.store.last_timings["n_fallback"]
    (ci, cs), (pi_, ps) = answers
    require(np.array_equal(ci, pi_) and np.array_equal(cs, ps),
            "card and CPU answers differ on the 4096-document subset")
    report["card_vs_cpu"] = {"docs": len(sub), "query_rows": len(q),
                             "fallback_rows": fb, "identical": True}
    print(f"[card-vs-cpu] {len(sub)} docs, {len(q)} queries "
          f"({fb} fallback rows): ids and scores identical")


def dense_path(idx, fresh_idx, report: dict):
    """Phase 6: dense rows through the service a user calls, counted."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ks = kernels()
    n = min(N_DENSE, len(idx))
    t0 = time.perf_counter()
    batches = [dense_rows(idx[lo: lo + BATCH]) for lo in range(0, n, BATCH)]
    qidx = np.concatenate([idx[:N_QUERY_INDEXED], fresh_idx])
    qv = dense_rows(qidx)
    build_s = time.perf_counter() - t0
    svc = SimilaritySearchService(SearchConfig(device="cuda"))
    zero_counts(ks)
    # --- the dense path: ingest + query batches ----------------------------
    t0 = time.perf_counter()
    with svc.pipeline(depth=2, layout="dense") as pipe:
        for v in batches:
            pipe.submit(v)
    t_ingest = time.perf_counter() - t0
    split = pipe.timings
    after_ingest = read_counts(ks)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        ids, scores = svc.query_dense(qv, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    store = svc.store.shards[0].store
    words = store.buffer.device_words()
    for lo in range(0, n, BATCH):
        sparse = svc.engine.sign(idx[lo: lo + BATCH], layout="sparse",
                                 pack_b=svc.cfg.b)
        require(torch.equal(words[lo: lo + BATCH], sparse),
                f"dense words of documents {lo}..{lo + BATCH} equal the "
                "sparse signing")
    sids, sscores = svc.query_sparse(qidx, top_k=TOP_K)
    require(np.array_equal(ids, sids) and np.array_equal(scores, sscores),
            "query_dense answers as query_sparse of the same documents")
    self_hit = float((ids[:N_QUERY_INDEXED, 0]
                      == np.arange(N_QUERY_INDEXED)).mean())
    n_fallback = svc.store.last_timings["n_fallback"]
    report["dense_path"] = {
        "docs": n, "batches": len(batches), "rows_bytes_per_batch":
        batches[0].nbytes, "host_rows_build_s": build_s,
        "ingest_s": t_ingest, "ingest_docs_per_s": n / t_ingest,
        "ingest_split_s": split, "query_rows": len(qv),
        "query_latency_s_first": lat[0],
        "query_latency_s_median_next4": statistics.median(lat[1:]),
        "query_latency_s_all": lat, "top1_self_hit": self_hit,
        "fallback_rows": n_fallback, "launches": launches,
        "launches_ingest": after_ingest, "words_equal_sparse": True,
        "answers_equal_sparse": True}
    print(f"[dense] ingest {n} docs as {len(batches)} batches of "
          f"{BATCH} x {batches[0].shape[1]} int8 rows in {t_ingest:.3f} s "
          f"({n / t_ingest:.0f} docs/s; rows built on the host in "
          f"{build_s:.2f} s beforehand); sign (copy in, permute, pack, "
          f"launch) {split['sign_s']:.3f} s, wait {split['wait_s']:.3f} s, "
          f"scatter {split['scatter_s']:.3f} s")
    print(f"[dense] query batch of {len(qv)} dense rows: first "
          f"{lat[0] * 1e3:.3f} ms, median of next 4 "
          f"{statistics.median(lat[1:]) * 1e3:.3f} ms; top-1 self-hit "
          f"{self_hit * 100:.2f}%; fallback rows {n_fallback}")
    print(f"[dense] launches {launches}; words of all {n} documents equal "
          "the sparse signing; query_dense == query_sparse")
    require(ids.shape == (len(qv), TOP_K), "dense answer shape")
    require(bool(np.isfinite(scores).all()), "finite dense scores")
    require(self_hit == 1.0, f"dense top-1 self-hit {self_hit}")
    trace_query(svc, qv, report, layout="dense")
    require(after_ingest["cminhash_packed"] == len(batches)
            and launches["cminhash_packed"] == len(batches) + len(lat),
            f"bit-packed kernel launched once per ingest and query batch "
            f"({launches['cminhash_packed']} for {len(batches)} + "
            f"{len(lat)})")
    require(launches["collision"] == len(lat) * len(svc.store.shards),
            f"collision kernel launched once per brute-force fallback call "
            f"({launches['collision']} for {len(lat)} query batches)")
    for name in ("cminhash_packed", "fold", "lsh_probe"):
        require(launches[name] > 0,
                f"kernel {name} launched on the dense path")
    return svc, batches[0]


def paper_path(report: dict) -> dict:
    """Phase 7: Fig. 7 on the card, counted.  Returns the corpora."""
    from repro_torch.core.estimators import true_jaccard_dense
    from repro_torch.core.minhash import make_k_permutations, minhash_dense
    from repro_torch.core.permutations import make_two_permutations
    from repro_torch.data.synthetic import (imagelike_binary_dataset,
                                            textlike_binary_dataset)
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False   # exact integer counts
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ks = kernels()
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    corpora = {
        "textA": textlike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                         mean_nnz=80),
        "textB": textlike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                         mean_nnz=250),
        "imageA": imagelike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                           block=16),
        "imageB": imagelike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                           block=64, p_on=0.5)}
    data_s = time.perf_counter() - t0
    iu = torch.triu_indices(PAPER_DOCS, PAPER_DOCS, 1, device=dev)
    rows = []
    zero_counts(ks)
    # --- the paper path ----------------------------------------------------
    t0 = time.perf_counter()
    for name, data in corpora.items():
        v = torch.from_numpy(data).to(dev)
        vf = v.float()
        inter = vf @ vf.T                      # exact: counts < 2^24
        cnt = vf.sum(dim=1)
        union = cnt[:, None] + cnt[None, :] - inter
        truth = torch.where(union > 0, inter / union.clamp(min=1),
                            torch.zeros_like(union))
        for k in PAPER_KS:
            gen = torch.Generator().manual_seed(k)
            sigma, pi = make_two_permutations(gen, PAPER_D, device=dev)
            perms = make_k_permutations(gen, PAPER_D, k, device=dev)
            sigs = {"MH": minhash_dense(v, perms),
                    "C0pi": ops.cminhash_signatures(v, pi, k),
                    "Csigmapi": ops.cminhash_signatures(v, pi, k, sigma)}
            row = {"corpus": name, "k": k}
            for method, sig in sigs.items():
                est = ops.estimated_jaccard_matrix(sig, sig)
                err = (est - truth)[iu[0], iu[1]].abs().double()
                row[method] = float(err.mean())
                require(bool(torch.isfinite(est).all())
                        and 0.0 <= row[method] <= 1.0,
                        f"paper {name} K={k} {method} estimates")
            row["win_pct"] = (row["MH"] - row["Csigmapi"]) / row["MH"] * 100
            rows.append(row)
            print(f"[paper] fig7_mae_{name}_K{k}: MH={row['MH']:.4f} "
                  f"C0pi={row['C0pi']:.4f} Csigmapi={row['Csigmapi']:.4f} "
                  f"win={row['win_pct']:.1f}%")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    n_sign = len(corpora) * len(PAPER_KS) * 2
    report["paper_path"] = {
        "d": PAPER_D, "docs": PAPER_DOCS, "ks": list(PAPER_KS),
        "data_s": data_s, "wall_s": wall, "rows": rows,
        "nnz_mean": {n: float(c.sum(1).mean()) for n, c in corpora.items()},
        "launches": launches}
    print(f"[paper] {len(rows)} (corpus, K) cells in {wall:.3f} s "
          f"(corpora built in {data_s:.1f} s); launches {launches}")
    require(launches["cminhash_dense"] == n_sign,
            f"int8 kernel launched for every C-MinHash set "
            f"({launches['cminhash_dense']} of {n_sign})")
    require(launches["collision"] == 3 * len(rows),
            "collision kernel launched for every method")
    return corpora


def dense_kernel_checks(svc, batch: np.ndarray, corpora: dict,
                        report: dict) -> tuple[list, list]:
    """Phase 8: the two dense kernels against their plain versions.
    Returns the kernels line's rows (the int8 kernel at the paper's shape,
    the bit-packed one at the service's) and the rows of the other two
    shapes."""
    from repro_torch.core.permutations import (apply_permutation_dense,
                                               make_two_permutations)
    from repro_torch.kernels import cminhash_kernel as kd
    from repro_torch.kernels import cminhash_packed as kpk
    from repro_torch.kernels import collision_kernel as kc
    dev = svc.engine.device
    out = []
    sources = {"cminhash_dense": ("src/repro_torch/csrc/cminhash_dense.cu",
                                  "src/repro/kernels/cminhash_kernel.py:77"),
               "cminhash_packed": ("src/repro_torch/csrc/cminhash_packed.cu",
                                   "src/repro/kernels/cminhash_packed.py:95")}

    def dense_int8(v, pi, k, pack_b, reps, plain_reps):
        got = kd.cminhash_dense_kernel(v, pi, k, pack_b=pack_b)
        want = kd.cminhash_dense_plain(v, pi, k, pack_b=pack_b)
        ms, dev_ms = both_ms(lambda: kd.cminhash_dense_kernel(
            v, pi, k, pack_b=pack_b), reps)
        plain_ms = time_ms(lambda: kd.cminhash_dense_plain(
            v, pi, k, pack_b=pack_b), plain_reps, warmup=1)
        b, d = v.shape
        nnz = int((v > 0).sum().item())
        # the function's work, as the bit-packed kernel is bounded: read
        # each byte once, one min per set bit per hash; the dense
        # algorithm's B*K*D masked mins are its own cost, kept beside it
        return kernel_entry(
            "cminhash_dense", *sources["cminhash_dense"], got, want, ms,
            plain_ms, b * d + d * 4 + got.numel() * 4, nnz * k + b * d,
            dev_ms, {"shape": [b, d, k], "pack_b": pack_b, "set_bits": nnz,
             "dense_algorithm_ops": b * k * d})

    def packed(v, pi, k, pack_b, reps, plain_reps):
        words = kpk.pack_bits(v)
        got = kpk.cminhash_packed_kernel(words, pi, k, pack_b=pack_b)
        want = kpk.cminhash_packed_plain(words, pi, k, pack_b=pack_b)
        ms, dev_ms = both_ms(lambda: kpk.cminhash_packed_kernel(
            words, pi, k, pack_b=pack_b), reps)
        plain_ms = time_ms(lambda: kpk.cminhash_packed_plain(
            words, pi, k, pack_b=pack_b), plain_reps, warmup=1)
        pack_ms = time_ms(lambda: kpk.pack_bits(v), reps)
        b, nw = words.shape
        nnz = int((v > 0).sum().item())
        return kernel_entry(
            "cminhash_packed", *sources["cminhash_packed"], got, want, ms,
            plain_ms, words.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
            nnz * k + b * nw, dev_ms,
            {"shape": [b, v.shape[1], k], "pack_b": pack_b,
             "set_bits": nnz, "pack_bits_ms": pack_ms})

    # the paper's shape: the image-like corpus with the permutations the
    # paper path drew for it, sigma applied as dispatch does
    kp = PAPER_KS[-1]
    sigma_p, pi_p = make_two_permutations(torch.Generator().manual_seed(kp),
                                          PAPER_D, device=dev)
    vp = apply_permutation_dense(torch.from_numpy(corpora["imageA"]).to(dev),
                                 sigma_p)
    out.append(dense_int8(vp, pi_p, kp, None, 20, 3))
    # the service's shape: the dense path's first batch, sigma-permuted
    cfg = svc.cfg
    vs = apply_permutation_dense(torch.from_numpy(batch).to(dev),
                                 svc.engine.sigma)
    out.append(packed(vs, svc.engine.pi, cfg.k, cfg.b, 20, 3))
    extra = [dense_int8(vs, svc.engine.pi, cfg.k, cfg.b, 5, 2),
             packed(vp, pi_p, kp, None, 20, 3)]
    # the int8 kernel at each of Fig. 7's K on imageA, with the permutations
    # phase 7 drew for that K: phase 7 launches it 8 times at each K (four
    # corpora x two C-MinHash variants), so the launch-weighted sum stands in
    # imageA's time for every corpus
    imagea = torch.from_numpy(corpora["imageA"]).to(dev)
    sweep, fig7_collision = [], []
    for k in PAPER_KS:
        sigma_k, pi_k = make_two_permutations(
            torch.Generator().manual_seed(k), PAPER_D, device=dev)
        vk = apply_permutation_dense(imagea, sigma_k)
        sig = kd.cminhash_dense_kernel(vk, pi_k, k)
        require(torch.equal(sig, kd.cminhash_dense_plain(vk, pi_k, k)),
                f"cminhash_dense imageA K={k}")
        ms, dev_ms = both_ms(lambda: kd.cminhash_dense_kernel(vk, pi_k, k), 20)
        sweep.append({"k": k, "launches_in_phase_7": 2 * len(corpora),
                      "ms": ms, "device_ms": dev_ms})
        # the collision kernel at Fig. 7's 4096 x 4096 x K, on these codes
        counts = kc.collision_counts_kernel(sig, sig)
        require(torch.equal(counts, kc.collision_counts_plain(sig, sig)),
                f"collision imageA 4096 x 4096 x {k}")
        sd = sig.double()
        require(torch.equal((k - torch.cdist(sd, sd, p=0)).to(torch.int32),
                            counts), f"collision K - cdist(p=0), K={k}")
        c_ms, c_dev_ms = both_ms(lambda: kc.collision_counts_kernel(sig, sig),
                                 10)
        n = sig.shape[0]
        fig7_collision.append({
            "k": k, "shape": [n, n, k],
            "launches_in_phase_7": 3 * len(corpora), "ms": c_ms,
            "device_ms": c_dev_ms,
            "plain_ms": time_ms(lambda: kc.collision_counts_plain(sig, sig),
                                1, warmup=1),
            "library_ms": time_ms(lambda: k - torch.cdist(sd, sd, p=0), 3,
                                  warmup=1),
            "bound_ms": bound_ms(2 * n * k * 4 + n * n * 4,
                                 collision_ops(n, n, k, 32))[0]})
    weighted = {key: sum(r[key] * r["launches_in_phase_7"] for r in sweep)
                for key in ("ms", "device_ms")}
    report["fig7_int8_sweep"] = {"rows": sweep,
                                 "launch_weighted_ms": weighted["ms"],
                                 "launch_weighted_device_ms":
                                 weighted["device_ms"]}
    print("[kernel] cminhash_dense on imageA at Fig. 7's K: "
          + ", ".join(f"K={r['k']} {r['ms']:.4f} ms (device "
                      f"{r['device_ms']:.4f})" for r in sweep)
          + f"; summed over phase 7's "
          f"{sum(r['launches_in_phase_7'] for r in sweep)} launches "
          f"{weighted['ms']:.4f} ms (device {weighted['device_ms']:.4f})")
    weighted = {key: sum(r[key] * r["launches_in_phase_7"]
                         for r in fig7_collision)
                for key in ("ms", "device_ms")}
    report["fig7_collision"] = {"rows": fig7_collision,
                                "launch_weighted_ms": weighted["ms"],
                                "launch_weighted_device_ms":
                                weighted["device_ms"]}
    print("[kernel] collision at Fig. 7's 4096 x 4096 x K: "
          + ", ".join(f"K={r['k']} {r['ms']:.4f} ms (device "
                      f"{r['device_ms']:.4f}, bound {r['bound_ms']:.4f}, "
                      f"plain {r['plain_ms']:.4f}, library "
                      f"{r['library_ms']:.4f})" for r in fig7_collision)
          + f"; summed over phase 7's "
          f"{sum(r['launches_in_phase_7'] for r in fig7_collision)} launches "
          f"{weighted['ms']:.4f} ms (device {weighted['device_ms']:.4f})")
    words = kpk.pack_bits(vs[:512])
    for pack_b in (None, 1, 2, 4, 8, 16):      # the other epilogues
        require(torch.equal(
            kd.cminhash_dense_kernel(vp[:512], pi_p, kp, pack_b=pack_b),
            kd.cminhash_dense_plain(vp[:512], pi_p, kp, pack_b=pack_b)),
            f"cminhash_dense pack_b={pack_b}")
        require(torch.equal(
            kpk.cminhash_packed_kernel(words, svc.engine.pi, cfg.k,
                                       pack_b=pack_b),
            kpk.cminhash_packed_plain(words, svc.engine.pi, cfg.k,
                                      pack_b=pack_b)),
            f"cminhash_packed pack_b={pack_b}")
    require(torch.equal(
        kd.cminhash_dense_kernel(vp[:256], pi_p, kp, shift_offset=0),
        kd.cminhash_dense_plain(vp[:256], pi_p, kp, shift_offset=0)),
        "cminhash_dense shift_offset=0")
    require(torch.equal(
        kpk.cminhash_packed_kernel(words, svc.engine.pi, cfg.k,
                                   shift_offset=0),
        kpk.cminhash_packed_plain(words, svc.engine.pi, cfg.k,
                                  shift_offset=0)),
        "cminhash_packed shift_offset=0")
    return out, extra


def dense_card_vs_cpu(idx, fresh_idx, report: dict) -> None:
    """Phase 9: a 512-document dense subset on the card and on the CPU."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    v = dense_rows(idx[:512])
    q = np.concatenate([v[:128], dense_rows(fresh_idx)])
    answers = []
    for device in ("cuda", "cpu"):
        svc = SimilaritySearchService(SearchConfig(device=device))
        with svc.pipeline(depth=2, layout="dense") as pipe:
            for lo in range(0, len(v), 128):
                pipe.submit(v[lo: lo + 128])
        answers.append(svc.query_dense(q, top_k=TOP_K))
    (ci, cs), (pi_, ps) = answers
    require(np.array_equal(ci, pi_) and np.array_equal(cs, ps),
            "card and CPU dense answers differ on the 512-document subset")
    report["dense_card_vs_cpu"] = {"docs": len(v), "query_rows": len(q),
                                   "identical": True}
    print(f"[dense-card-vs-cpu] {len(v)} docs, {len(q)} dense queries: ids "
          "and scores identical")


PLACEMENTS = {0: "uint16 shared", 1: "int32 global", 2: "uint16 pairs"}
SIGNING = ("cminhash_sparse", "cminhash_dense", "cminhash_packed")
# The earlier collision interface: unpacked int32 codes, (a, b, out, Q, N, K)
UNPACKED_COLLISION_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
# The earlier probe interface: (records, (E, 5) operand rows, out, E,
# n_slots, max_probes, W)
OPERAND_ROW_PROBE_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 3)
QUERY_SOURCES = ("fold", "lsh_probe")


def build_baseline(baseline: str, names) -> dict[str, str]:
    """Build ``names`` from DIR/src/repro_torch/csrc with the port's flags,
    one nvcc each, all started together -> {name: library path}."""
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "src", "repro_torch", "build", "baseline")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(baseline, "src", "repro_torch", "csrc")
    libs = {name: os.path.join(out_dir, f"lib{name}.so") for name in names}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", libs[name],
         os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in names}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc baseline {name}:\n{log}")
    return libs


def collision_sass(report: dict) -> None:
    """The count loop of the b = 32 collision kernel (16-byte copies) in
    SASS: the instructions between the two barriers around one staged
    chunk, by opcode, and how many there are a compare (a pair of codes:
    an ``ISETP``).  A thread makes 512 compares a chunk (4 x 4 pairs of
    rows x 32 words); ptxas may schedule a few of them past the barrier.
    The whole listing goes to ``chiprun_out/collision.sass``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        "collision"))], capture_output=True, text=True, timeout=300,
        check=True).stdout
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "collision.sass"), "w") as f:
        f.write(sass)
    body = next(f for f in re.split(r"\n\s+Function : ", sass)
                if "CodeCountELi4E" in f.split("\n", 1)[0])
    ops = [m.group(2) for m in (re.match(
        r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        for line in body.splitlines()) if m]
    bars = [i for i, op in enumerate(ops) if op.startswith("BAR.SYNC")]
    seg = max((ops[i0 + 1: i1] for i0, i1 in zip(bars, bars[1:])),
              key=lambda x: sum(op == "FADD" for op in x))
    hist: dict = {}
    for op in seg:
        hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
    pairs = hist.get("ISETP", 0)
    report["collision_sass"] = {
        "compares_in_segment": pairs, "compares_per_chunk": 512,
        "instructions": len(seg), "per_compare": len(seg) / pairs,
        "opcodes": hist,
        "integer_pipe_per_compare": sum(v for k, v in hist.items() if k in (
            "ISETP", "IADD3", "LOP3", "SHF", "LEA", "SEL", "POPC", "VIADD",
            "IMNMX")) / pairs}
    print(f"[sass] collision count loop (b = 32, 16-byte copies): "
          f"{len(seg)} instructions for {pairs} of a chunk's 512 compares, "
          f"{len(seg) / pairs:.3f} a compare; "
          + ", ".join(f"{k} {v}" for k, v in sorted(
              hist.items(), key=lambda kv: -kv[1])[:8]))


def compare(baseline: str | None, report: dict) -> None:
    """``--compare``: the three signing kernels and the collision kernel
    through their wrappers.  Each signing kernel runs with the per-call
    placement and with each placement forced through the libraries' test
    entry point (``<name>_force_placement``); with ``--baseline DIR``, each
    of the four also runs bound to a build of DIR's source behind the same
    wrapper (a DIR collision.cu with the earlier unpacked interface is
    called as the earlier ``ops.packed_collision_counts`` called it: unpacked
    in blocks of 16,384 index rows, one launch each, then concatenated).
    Each variant is checked against the plain version, then timed in turns
    (forward, then reverse order; the median of each variant's per-round
    medians), with the host's launch work (``ms``) and without
    (``device_ms``).  Then the sparse kernel's time against the batch size
    (the slope is a document's work, the intercept what a launch costs),
    and the collision kernel's count loop in SASS."""
    import contextlib

    from repro_torch.core.permutations import (apply_permutation_dense,
                                               apply_permutation_sparse,
                                               make_two_permutations)
    from repro_torch.data.synthetic import imagelike_binary_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import cminhash_kernel as kd
    from repro_torch.kernels import cminhash_packed as kpk
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.kernels import collision_kernel as kc
    from repro_torch.kernels.packfmt import unpack_codes
    dev = torch.device("cuda")
    mods = {"cminhash_sparse": ks, "cminhash_dense": kd,
            "cminhash_packed": kpk, "collision": kc}
    base, unpacked_abi, query_libs = {}, False, {}
    if baseline:
        with open(os.path.join(baseline, "src", "repro_torch", "csrc",
                               "collision.cu")) as f:
            unpacked_abi = "int bits" not in f.read()
        libs = build_baseline(baseline, [*mods, *QUERY_SOURCES])
        query_libs = {n: libs.pop(n) for n in QUERY_SOURCES}
        for name, path in libs.items():
            args = (UNPACKED_COLLISION_ARGS if name == "collision"
                    and unpacked_abi else mods[name].KERNEL.argtypes)
            base[name] = _build.CudaKernel(name, args, library=path)

    @contextlib.contextmanager
    def variant(name, label):
        """The wrapper of ``name`` launching ``label``'s kernel."""
        mod = mods[name]
        current = mod.KERNEL
        force = (current.entry("force_placement", [ctypes.c_int])
                 if name in SIGNING else (lambda p: None))
        place = {v: k for k, v in PLACEMENTS.items()}.get(label, -1)
        if label == "baseline" and not (name == "collision" and unpacked_abi):
            mod.KERNEL = base[name]
        force(place)
        try:
            yield
        finally:
            force(-1)
            mod.KERNEL = current

    def unpacked_counts(a, b):
        """The earlier wrapper on the baseline's unpacked collision kernel."""
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                          device=dev)
        base["collision"].launch(dev, _build.ptr(a), _build.ptr(b),
                                 _build.ptr(out), a.shape[0], b.shape[0],
                                 a.shape[1])
        return out

    def collision_call(label, wq, wn, k, b):
        if label == "baseline" and unpacked_abi:
            uq = unpack_codes(wq, k, b).contiguous()
            return torch.cat([unpacked_counts(uq, unpack_codes(
                wn[lo: lo + 16384], k, b).contiguous())
                for lo in range(0, wn.shape[0], 16384)], dim=1)
        return kc.packed_collision_counts_kernel(wq, wn, k, b)

    # the serving batch: 4096 documents of the serving corpus, signed with
    # a seeded sigma/pi at D = 2^16, K = 256, b = 32; imageA at Fig. 7's D
    # and K, with the permutations phase 7 draws for each K; the serving
    # batch as dense int8 rows and as bit-packed words
    idx, _ = corpus(BATCH)
    sigma, pi = make_two_permutations(torch.Generator().manual_seed(0),
                                      1 << 16, device=dev)
    sidx = apply_permutation_sparse(torch.tensor(idx, device=dev),
                                    sigma).to(torch.int32).contiguous()
    vs = apply_permutation_dense(torch.from_numpy(dense_rows(idx)).to(dev),
                                 sigma).contiguous()
    imagea = torch.from_numpy(imagelike_binary_dataset(
        np.random.default_rng(0), PAPER_DOCS, PAPER_D, block=16)).to(dev)
    wrappers = {"cminhash_sparse": (ks.cminhash_sparse_kernel,
                                    ks.cminhash_sparse_plain),
                "cminhash_dense": (kd.cminhash_dense_kernel,
                                   kd.cminhash_dense_plain),
                "cminhash_packed": (kpk.cminhash_packed_kernel,
                                    kpk.cminhash_packed_plain)}
    cases = []                 # (name, shape, call(label) -> tensor, want)

    def signing(name, shape, x, p, k, pack_b):
        wrapper, plain = wrappers[name]
        cases.append((name, shape, lambda label: wrapper(x, p, k,
                                                         pack_b=pack_b),
                      plain(x, p, k, pack_b=pack_b)))

    signing("cminhash_sparse", "serving 4096 x 254, D 2^16, K 256, b 32",
            sidx, pi, 256, 32)
    for k in PAPER_KS:
        sigma_k, pi_k = make_two_permutations(
            torch.Generator().manual_seed(k), PAPER_D, device=dev)
        vk = apply_permutation_dense(imagea, sigma_k).contiguous()
        signing("cminhash_dense", f"imageA 4096 x 2048, K {k}", vk, pi_k, k,
                None)
        if k == PAPER_KS[-1]:
            signing("cminhash_packed", f"imageA 4096 x 2048, K {k}",
                    kpk.pack_bits(vk), pi_k, k, None)
    signing("cminhash_dense", "service 4096 x 2^16, K 256, b 32", vs, pi,
            256, 32)
    signing("cminhash_packed", "service 4096 x 2^16, K 256, b 32",
            kpk.pack_bits(vs), pi, 256, 32)

    # the collision kernel: the serving fallback (64 pow2-padded rows
    # against a 262,144-row index, K = 256, at b = 32 and b = 8), one
    # 16,384-row block, and Fig. 7's 4096 x 4096 x K; seeded codes (the
    # kernels' time does not depend on which codes match)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (32, 8):
        codes = torch.randint(0, 1 << 16, (64 + 262_144, 256), generator=gen,
                              device=dev, dtype=torch.int32)
        codes[64::4096] = codes[0]
        w = pack_codes_dev(codes, b)
        wq, wn = w[:64].contiguous(), w[64:].contiguous()
        cases.append(("collision", f"fallback 64 x 262,144 x 256, b {b}",
                      lambda label, wq=wq, wn=wn, b=b: collision_call(
                          label, wq, wn, 256, b),
                      torch.cat([kc.packed_collision_counts_plain(
                          wq, wn[lo: lo + 16384], 256, b)
                          for lo in range(0, wn.shape[0], 16384)], dim=1)))
        if b == 32:
            blk = wn[:16384].contiguous()
            cases.append(("collision", "one block 64 x 16,384 x 256, b 32",
                          lambda label, wq=wq, blk=blk: collision_call(
                              label, wq, blk, 256, 32),
                          kc.collision_counts_plain(wq, blk)))
    for k in PAPER_KS:
        a = torch.randint(0, 1 << 11, (PAPER_DOCS, k), generator=gen,
                          device=dev, dtype=torch.int32)
        cases.append(("collision", f"Fig. 7 4096 x 4096 x {k}",
                      lambda label, a=a, k=k: collision_call(label, a, a, k,
                                                             32),
                      kc.collision_counts_plain(a, a)))

    rows = []
    for name, shape, call, want in cases:
        labels = (["per-call choice", *PLACEMENTS.values()]
                  if name in SIGNING else ["kernel"]) + (
            ["baseline"] if base else [])
        status = {}
        for label in labels:
            with variant(name, label):
                try:
                    got = call(label)
                except RuntimeError as e:
                    status[label] = f"refused ({e})"
                    continue
            require(torch.equal(got, want), f"{name} {label} at {shape}")
            status[label] = "equal"
        run = [lbl for lbl in labels if status[lbl] == "equal"]
        times: dict = {lbl: {"ms": [], "device_ms": []} for lbl in run}
        for order in (run, run[::-1]):
            for label in order:
                with variant(name, label):
                    ms, dev_ms = both_ms(lambda: call(label), 20)
                times[label]["ms"].append(ms)
                times[label]["device_ms"].append(dev_ms)
        row = {"kernel": name, "shape": shape, "status": status,
               "ms": {lbl: statistics.median(t["ms"])
                      for lbl, t in times.items()},
               "device_ms": {lbl: statistics.median(t["device_ms"])
                             for lbl, t in times.items()},
               "rounds": times}
        rows.append(row)
        print(f"[compare] {name} {shape}: " + "; ".join(
            f"{lbl} {row['ms'][lbl]:.4f} ms (device "
            f"{row['device_ms'][lbl]:.4f})" if lbl in row["ms"]
            else f"{lbl} refused" for lbl in labels))
    report["compare"] = rows
    big, _ = corpus(4 * BATCH)
    scaling = []
    for b in (BATCH // 4, BATCH // 2, BATCH, 2 * BATCH, 4 * BATCH):
        x = apply_permutation_sparse(torch.tensor(big[:b], device=dev),
                                     sigma).to(torch.int32).contiguous()
        ms, dev_ms = both_ms(
            lambda: ks.cminhash_sparse_kernel(x, pi, 256, pack_b=32), 20)
        scaling.append({"docs": b, "ms": ms, "device_ms": dev_ms})
    report["sparse_scaling"] = scaling
    print("[compare] cminhash_sparse by batch: " + ", ".join(
        f"{r['docs']} docs {r['ms']:.4f} ms (device {r['device_ms']:.4f})"
        for r in scaling))
    collision_sass(report)
    compare_query(baseline, query_libs, report)


def query_case(n_docs: int):
    """The full-size table and a serving query batch, built directly: the
    corpus signed on the card in serving batches, its band hashes inserted
    in one call into a table at the geometry the main path's ingest grows
    to at 262,144 documents (2^19 slots, bucket width 8, 16 probes).
    Returns (table, query words on the card, n_bands)."""
    from repro_torch.core.lsh import band_hashes_packed
    from repro_torch.core.permutations import make_two_permutations
    from repro_torch.device import u32_to_host
    from repro_torch.kernels import dispatch
    from repro_torch.serve.search import SearchConfig
    from repro_torch.store.table import BandedLSHTable
    dev = torch.device("cuda")
    cfg = SearchConfig()
    sigma, pi = make_two_permutations(torch.Generator().manual_seed(0),
                                      cfg.d, device=dev)
    idx, fresh = corpus(n_docs)

    def sign(rows):
        return dispatch.signatures_sparse(torch.tensor(rows, device=dev), pi,
                                          cfg.k, sigma, pack_b=cfg.b)
    words = torch.cat([sign(idx[lo: lo + BATCH])
                       for lo in range(0, len(idx), BATCH)])
    table = BandedLSHTable(cfg.n_bands, n_slots=1 << 19,
                           bucket_width=cfg.bucket_width, max_probes=16,
                           device=dev)
    table.insert(band_hashes_packed(u32_to_host(words), cfg.n_bands),
                 np.arange(len(idx)))
    qwords = sign(np.concatenate([idx[:N_QUERY_INDEXED], fresh]))
    return table, qwords, cfg.n_bands


def compare_query(baseline: str | None, libs: dict, report: dict) -> None:
    """``--compare``, the query side: the fold, the probe and the fold ->
    candidates leg at the main path's full-size shapes (1088 x 32 x 8 query
    codes, a 2^19-slot, 32-band table of 262,144 documents).  With
    ``--baseline DIR``, beside each the previous ``fold.cu`` /
    ``lsh_probe.cu`` built from DIR, called as the earlier wrappers called
    them: a probe with the earlier operand-row interface gets its operands
    built as those wrappers built them, on the host (``probe_operands``,
    then an upload) in the service's leg and on the card
    (``meta_from_hashes``) in the single store's.  Each variant is
    checked against the plain version and timed in turns, with and
    without the host's launch work, and with L2 flushed."""
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import lsh_probe as kp
    from repro_torch.kernels import query_fused as kq
    dev = torch.device("cuda")
    table, qwords, nb = query_case(BATCH * 64)
    records = table.device_records()
    ns, mp = table.n_slots, table.max_probes
    w = records.shape[1] - 2
    rows = kq.words_to_rows(qwords, nb).contiguous()
    q, _, r = rows.shape
    hashes = kq.fold_rows_kernel(rows)
    meta = torch.tensor(kp.probe_operands(kq.hashes_to_host(hashes), ns),
                        device=dev)
    new = {"fold": lambda: kq.fold_rows_kernel(rows),
           "probe": lambda: kp.lsh_probe_hashes_kernel(
               records, hashes, n_slots=ns, max_probes=mp),
           "service leg": lambda: kp.lsh_probe_hashes_kernel(
               records, dispatch.fold_hashes(qwords, n_bands=nb),
               n_slots=ns, max_probes=mp),
           "store leg": lambda: kq.fold_probe_kernel(
               records, rows, n_slots=ns, max_probes=mp)}
    old = {}
    if libs:
        with open(os.path.join(baseline, "src", "repro_torch", "csrc",
                               "lsh_probe.cu")) as f:
            meta_abi = "const int* meta" in f.read()
        fold_k = _build.CudaKernel("fold", kq.KERNEL.argtypes,
                                   library=libs["fold"])

        def old_fold():
            out = torch.empty((q, nb), dtype=torch.int64, device=dev)
            fold_k.launch(dev, _build.ptr(rows), _build.ptr(out), q, nb, r, 0)
            return out
        if meta_abi:
            probe_k = _build.CudaKernel("lsh_probe", OPERAND_ROW_PROBE_ARGS,
                                        library=libs["lsh_probe"])

            def old_probe(m):
                out = torch.empty((m.shape[0], w), dtype=torch.int32,
                                  device=dev)
                probe_k.launch(dev, _build.ptr(records), _build.ptr(m),
                               _build.ptr(out), m.shape[0], ns, mp, w)
                return out
            old = {"fold": old_fold,
                   "probe": lambda: old_probe(meta),
                   "service leg": lambda: old_probe(torch.tensor(
                       kp.probe_operands(kq.hashes_to_host(old_fold()), ns),
                       device=dev)),
                   "store leg": lambda: old_probe(kq.meta_from_hashes(
                       old_fold(), n_slots=ns).contiguous())}
        else:
            probe_k = _build.CudaKernel("lsh_probe", kp.KERNEL.argtypes,
                                        library=libs["lsh_probe"])

            def old_probe(h):
                out = torch.empty((h.numel(), w), dtype=torch.int32,
                                  device=dev)
                probe_k.launch(dev, _build.ptr(records), _build.ptr(h),
                               _build.ptr(out), h.numel(), nb, ns, mp, w)
                return out
            old = {"fold": old_fold, "probe": lambda: old_probe(hashes),
                   "service leg": lambda: old_probe(old_fold())}
    want = {"fold": kq.fold_rows_plain(rows),
            "probe": kp.lsh_probe_hashes_plain(records, hashes, n_slots=ns,
                                               max_probes=mp)}
    want["service leg"] = want["store leg"] = want["probe"]
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    cases = [(case, {"new": fn, **({"old": old[case]} if case in old
                                   else {})}, want[case])
             for case, fn in new.items()]
    rows_out = []
    for case, variants, expect in cases:
        for label, call in variants.items():
            require(torch.equal(call(), expect), f"{case} ({label}) == plain")
        times = {lbl: {"ms": [], "device_ms": [], "cold_device_ms": []}
                 for lbl in variants}
        for order in (list(variants), list(variants)[::-1]):
            for label in order:
                t = times[label]
                # the earlier legs wait for the card or enqueue longer
                # than the spin: they have an as-called time only
                ms, dev_ms = both_ms(variants[label], 50, host_bound_ok=True)
                t["ms"].append(ms)
                t["device_ms"].append(dev_ms)
                t["cold_device_ms"].append(time_ms(variants[label], 30,
                                                   spin=True, flush=flush))
        row = {"case": case, "rounds": times,
               **{key: {lbl: None if None in t[key]
                        else statistics.median(t[key])
                        for lbl, t in times.items()}
                  for key in ("ms", "device_ms", "cold_device_ms")}}
        rows_out.append(row)
        print(f"[compare] {case}: " + "; ".join(
            f"{lbl} {row['ms'][lbl]:.4f} ms (device "
            f"{fmt_ms(row['device_ms'][lbl])}, L2 flushed "
            f"{fmt_ms(row['cold_device_ms'][lbl])})" for lbl in variants))
    walk = probe_walk(records, meta, ns, mp)
    report["compare_query"] = {"rows": rows_out, "shape": list(rows.shape),
                               "records_shape": list(records.shape),
                               "n_spilled": table.n_spilled, **walk}
    print(f"[compare] probe walk: {walk['probe_steps']} steps, "
          f"{walk['hits']} hits, steps by entry {walk['steps_hist']}")


def pack_codes_dev(codes: torch.Tensor, b: int) -> torch.Tensor:
    """``packfmt.pack_codes`` in row chunks, so its int64 temporaries stay
    small at the index's size."""
    from repro_torch.kernels.packfmt import pack_codes
    return torch.cat([pack_codes(codes[lo: lo + 16384], b)
                      for lo in range(0, codes.shape[0], 16384)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=262_144,
                    help="documents to ingest on the main path")
    ap.add_argument("--compare", action="store_true",
                    help="only compare the signing kernels' table "
                         "placements, the collision kernel, the fold, the "
                         "probe (and --baseline's builds)")
    ap.add_argument("--baseline", default=None,
                    help="with --compare: a checkout whose signing, "
                         "collision, fold and probe sources are timed "
                         "behind the same wrappers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    from repro_torch.kernels import _build
    t_all = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["build"] = built
    print(f"[build] {len(built)} kernels in {report['build_s']:.2f} s")
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    if args.compare:
        compare(args.baseline, report)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "compare.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
        print(card)
        return

    t0 = time.perf_counter()
    idx, fresh_idx = corpus(args.docs)
    report["corpus_s"] = time.perf_counter() - t0
    print(f"[data] {len(idx)} docs x {idx.shape[1]} shingles + "
          f"{len(fresh_idx)} fresh in {report['corpus_s']:.1f} s")

    svc, qidx = main_path(idx, fresh_idx, report)
    report["kernels"] = kernel_checks(svc, idx, qidx, report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace_query(svc, qidx, report)
    del svc
    torch.cuda.empty_cache()
    card_vs_cpu(idx, fresh_idx, report)

    svc, batch = dense_path(idx, fresh_idx, report)
    corpora = paper_path(report)
    rows, extra = dense_kernel_checks(svc, batch, corpora, report)
    report["kernels"] += rows
    report["kernel_extra"] = extra
    del svc, batch
    torch.cuda.empty_cache()
    dense_card_vs_cpu(idx, fresh_idx, report)

    paths = ("main_path", "store_path", "dense_path", "paper_path")
    for row in report["kernels"] + extra:
        row["launches"] = sum(report[p]["launches"][row["name"]]
                              for p in paths)
        row["launches_by_path"] = {p: report[p]["launches"][row["name"]]
                                   for p in paths}
    for row in report["kernels"]:
        require(row["launches"] > 0,
                f"kernel {row['name']} launched on a counted path")
    report["wall_s"] = time.perf_counter() - t_all
    print(f"[done] {report['wall_s']:.1f} s in all")
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "equal", "ms", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report["kernels"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
