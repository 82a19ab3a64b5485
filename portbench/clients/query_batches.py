"""Closed-loop query batches against the in-process search service.

Set-up builds, from the seed: the two permutations, the index's sets (a
``dup_fraction`` of them in clusters of ``cluster_size`` near-copies), a
pool of ``pool_batches`` query batches of ``batch`` rows (a
``near_copy_share`` of fresh near-copies of indexed sets, the rest novel
sets, in an order drawn from the seed), the service, its index through
``IngestPipeline``, and one answer of every pool batch (the warm-up).
The window then sends the pool's batches in order, one client, each after
the last one's answer came back.

The check (``check``) holds what the window answered to the
configuration's plain reference: the index that ingest built; in every
window answer, each row the reference's probe answers and a sample, drawn
from the seed, of the rows it sends to brute force; and the program's
count of rows that fell back to brute force.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench import rows as prow


def _host(sets: torch.Tensor) -> np.ndarray:
    """Device sets -> the (n, widest) int32 host array a caller sends."""
    return np.ascontiguousarray(prow.trimmed(sets).cpu().numpy())


class Client:
    def __init__(self, bench: Path, config: dict, traffic: dict, *,
                 seed: int, device: torch.device,
                 program: dict | None = None):
        """``program``: SearchConfig fields the service runs with in place
        of the configuration's (the control's lower precision); the
        reference keeps the configuration's."""
        self.bench = bench
        self.program = program or {}
        self.cfg = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.svc = None
        self.responses: list = []
        self.n_steps = 0

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.serve.search import (SearchConfig,
                                              SimilaritySearchService)
        cfg, tr, dev = self.cfg, self.traffic, self.device
        t0 = time.perf_counter()
        svc_cfg = dict(cfg["service"])
        d = svc_cfg["d"]
        gen = torch.Generator(dev).manual_seed(self.seed)
        self.sigma = torch.randperm(d, generator=gen, device=dev) \
            .to(torch.int32)
        self.pi = torch.randperm(d, generator=gen, device=dev) \
            .to(torch.int32)
        corpus_cfg = cfg["corpus"]
        corpus = harness.load_module(self.bench, "corpora",
                                     corpus_cfg["kind"]).Corpus(
            corpus_cfg, d, gen, dev)

        n = cfg["index_sets"]
        n_clusters = int(n * corpus_cfg.get("dup_fraction", 0.0)) \
            // corpus_cfg.get("cluster_size", 1)
        parts = []
        if n_clusters:
            base = corpus.draw(n_clusters)
            parts.append(corpus.edit(
                base.repeat_interleave(corpus_cfg["cluster_size"], dim=0),
                corpus_cfg["edit_fraction"]))
            del base
        parts.append(corpus.draw(n - sum(len(p) for p in parts)))
        src = prow.cat(parts)[torch.randperm(n, generator=gen, device=dev)]
        del parts
        index = corpus.sets(src)

        batch = tr["batch"]
        n_near = round(batch * tr.get("near_copy_share", 0.0))
        self.pool = []                  # host (batch, widest) int32 arrays
        for _ in range(tr["pool_batches"]):
            picks = torch.randint(0, n, (n_near,), generator=gen, device=dev)
            mix = prow.cat([corpus.edit(src[picks], tr["edit_fraction"]),
                            corpus.draw(batch - n_near)])
            mix = mix[torch.randperm(batch, generator=gen, device=dev)]
            self.pool.append(_host(corpus.sets(mix)))
        del src, corpus
        self.entries = [int((q >= 0).sum()) for q in self.pool]

        step = cfg["ingest_batch"]
        self.ingest = [_host(index[lo: lo + step])
                       for lo in range(0, n, step)]
        del index
        # rows of each pool batch the check compares besides those with
        # candidates, from the seed
        rng = np.random.default_rng(self.seed)
        m = min(batch, tr.get("check_rows_per_batch", batch))
        self.sample = [np.sort(rng.choice(batch, m, replace=False))
                       for _ in self.pool]

        if dev.type == "cuda":     # the peak from here on is the program's
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        self.svc = SimilaritySearchService(
            SearchConfig(**{**svc_cfg, **self.program}, device=str(dev)),
            params=(self.sigma, self.pi))
        with self.svc.pipeline(depth=cfg["ingest_depth"]) as pipe:
            for b in self.ingest:
                pipe.submit(b)
        t2 = time.perf_counter()
        self.top_k = tr["top_k"]
        for q in self.pool:             # every shape the window sends
            self.svc.query_sparse(q, top_k=self.top_k)
        self.n_steps = 0
        self.setup_phases = {"data_s": t1 - t0, "ingest_s": t2 - t1,
                             "warmup_s": time.perf_counter() - t2}

    # -- the window ------------------------------------------------------
    def step(self) -> int:
        """Send the next pool batch and wait for its answer: rows answered."""
        p = self.n_steps % len(self.pool)
        ids, scores = self.svc.query_sparse(self.pool[p], top_k=self.top_k)
        self.responses.append((p, ids, scores,
                               self.svc.store.last_timings["n_fallback"]))
        self.n_steps += 1
        return len(ids)

    def step_work(self) -> dict:
        """The last step's work, for the rooflines: its rows, their real
        entries and padded width, the rows the program reports it answered
        by brute force, and the index's rows."""
        p, _, _, n_fallback = self.responses[-1]
        q = self.pool[p]
        return {"rows": int(q.shape[0]), "entries": self.entries[p],
                "width": int(q.shape[1]), "fallback_rows": int(n_fallback),
                "index_rows": int(self.cfg["index_sets"])}

    # -- the check -------------------------------------------------------
    def release(self) -> None:
        """Keep what the check reads of the program (the index it built),
        then free the service and its device memory."""
        store = self.svc.store
        if len(store.shards) != 1:
            raise ValueError("the check reads one in-process shard")
        shard = store.shards[0].store
        self.index_words = np.asarray(shard.buffer.all_packed())
        self.program_state = {
            "n_slots": shard.table.n_slots,
            "bucket_width": shard.table.bucket_width,
            "n_spilled": shard.n_spilled, "n_rebuilds": shard.n_rebuilds,
            "fallback_rows_mean": float(np.mean([r[3] for r in
                                                 self.responses] or [0]))}
        self.svc.close()
        self.svc = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[tuple[str, int, int]]:
        """(name, value, limit) of every number compared with the
        reference; each limit is 0 (an exact comparison)."""
        ref = harness.load_module(self.bench, "references",
                                  self.cfg["reference"])
        svc = self.cfg["service"]
        k, b = svc["k"], svc["b"]
        dev = self.device
        index = prow.cat([torch.from_numpy(x).to(dev) for x in self.ingest])
        codes = ref.signatures(index, self.sigma, self.pi, k)
        want = ref.packed_words(codes, b)
        got = self.index_words
        index_wrong = len(want) if got.shape != want.shape else \
            int((got != want).any(axis=1).sum())
        idx = ref.Index(codes, n_bands=svc["n_bands"],
                        rows_per_band=svc["rows_per_band"], b=b)
        del index, codes
        answers, n_fallback, checked = [], [], []
        for q, sample in zip(self.pool, self.sample):
            qcodes = ref.signatures(torch.from_numpy(q).to(dev), self.sigma,
                                    self.pi, k)
            r, _, _ = idx.candidates(ref.stored(qcodes, b))
            has = torch.unique(r).cpu().numpy()
            n_fallback.append(len(q) - len(has))
            # every row the probe answers, and the sample of the rest
            rows = np.union1d(sample, has)
            ids, scores, _, _ = idx.answers(qcodes[torch.from_numpy(rows)
                                                   .to(dev)], self.top_k)
            answers.append((ids, scores))
            checked.append(rows)
        rows_wrong = fallback_off = 0
        for p, ids, scores, nf in self.responses:
            want_ids, want_scores = answers[p]
            s = checked[p]
            bad = (ids[s] != want_ids).any(axis=1) \
                | (scores[s] != want_scores).any(axis=1)
            rows_wrong += int(bad.sum())
            fallback_off += abs(int(nf) - n_fallback[p])
        self.checked = {"responses": len(self.responses),
                        "rows_compared": sum(len(checked[p])
                                             for p, *_ in self.responses)}
        return [("index_rows_wrong", index_wrong, 0),
                ("answer_rows_wrong", rows_wrong, 0),
                ("fallback_rows_off", fallback_off, 0)]
