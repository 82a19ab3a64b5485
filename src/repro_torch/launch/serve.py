"""Serving launcher for the card: LM generation and similarity search.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch llama3_2_1b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --docs 400

``--mode lm`` (the default) builds the reduced config of ``--arch``
(``configs.reduced``) with weights from seed 0, generates
``--new-tokens`` tokens for ``--batch`` random prompts of
``--prompt-len`` tokens and prints the same ``[serve] ...`` lines as
``python -m repro.launch.serve --mode lm``.

``--mode search`` builds a synthetic corpus with planted near-duplicates,
ingests it through the pipelined fused sign -> pack path and answers one
query batch of indexed documents, printing the same ``[serve] ingest
...`` and ``[serve] search ...`` lines as ``python -m repro.launch.serve
--mode search``.  ``--device cuda`` (the default) needs a card and raises
without one; ``--device cpu`` runs the plain PyTorch versions of the
kernels.

``--transport tcp`` spawns one shard worker process per shard, each with
its store on ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode search \
        --transport tcp --shards 3 --docs 400 --metrics-dump PATH

``--replicas R`` (tcp) runs R workers a shard, ``--journal-dir DIR`` keeps
the write-ahead ingest journal there, and the supervisor
(``--no-supervisor`` turns it off) respawns a dead worker on ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode search \
        --transport tcp --shards 2 --replicas 2 --journal-dir DIR \
        --docs 400 --device cpu

``--stream`` then streams ``--stream-queries`` single queries with Poisson
gaps at ``--stream-qps`` through ``svc.stream(...)`` and prints the
tickets' end-to-end p50 and p99.

``--metrics-dump PATH`` appends one JSONL snapshot of the process metrics
registry (+ drained trace spans, + the workers' STATS snapshots) every
``--metrics-interval`` seconds, plus a final line at shutdown; validate it
with ``python -m repro_torch.obs.dump --check PATH``.
``--trace-sample-rate`` sets the root-span sampling probability (sampled
traces ride the wire to tcp workers and come back stitched).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.data.shingle import batch_shingles
from repro_torch.data.synthetic import corpus_with_duplicates
from repro_torch.models import build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.dump import MetricsDumper
from repro_torch.serve.decode import generate
from repro_torch.serve.search import SearchConfig, SimilaritySearchService


class _WorkerSnapshots:
    """The dump's ``workers`` field: ``{"shard{i}.replica{r}": registry
    snapshot}`` of every tcp worker (its STATS ``obs``), fetched on
    connections of the dump thread's own, so it never shares a socket with
    the coordinator's fan-out.  In-process shards share this process's
    registry and add nothing."""

    def __init__(self):
        self.store = None
        self._conns: list | None = None

    def __call__(self) -> dict:
        if self.store is None:
            return {}
        if self._conns is None:
            from repro_torch.transport import ShardConnection
            conns = []
            for sh in self.store.shards:
                if hasattr(sh, "lanes"):
                    # a replica set's lanes as they stand now; a lane the
                    # supervisor later respawns is not followed
                    conns += [lane.conn for lane in sh.lanes]
                elif hasattr(sh, "conn"):
                    conns.append(sh.conn)
            self._conns = [ShardConnection(c.address, timeout=30)
                           for c in conns]
        from repro_torch.transport.wire import Message, MsgType
        out = {}
        for conn in self._conns:
            stats = conn.request(Message(MsgType.STATS, {})).fields
            out[f"shard{stats['shard']}.replica{stats['replica']}"] = \
                json.loads(stats["obs"])
        return {"workers": out}

    def close(self) -> None:
        for conn in self._conns or []:
            conn.close()


def serve_lm(args) -> None:
    cfg = reduced(get_config(args.arch))
    bundle = build(cfg, device=args.device)
    params = bundle.init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": np.asarray(
        rng.integers(0, cfg.vocab_size_real, (args.batch, args.prompt_len)),
        np.int32)}
    if cfg.frontend == "frames":
        batch["frames"] = rng.normal(
            size=(args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(
            size=(args.batch, args.prompt_len // 8, cfg.d_model)
        ).astype(np.float32)
    t0 = time.perf_counter()
    toks = generate(bundle, params, batch, max_new_tokens=args.new_tokens,
                    temperature=args.temperature)
    dt = time.perf_counter() - t0
    n = args.batch * args.new_tokens
    print(f"[serve] {cfg.name}: generated {n} tokens in {dt:.2f}s "
          f"({n / dt:.0f} tok/s, batch={args.batch})")
    print(f"[serve] sample: {toks[0][:16].tolist()}")


def serve_search(args) -> None:
    obs_trace.default().sample_rate = args.trace_sample_rate
    docs, _ = corpus_with_duplicates(args.docs, vocab=30_000, doc_len=256,
                                     dup_fraction=0.4, seed=0)
    idx = batch_shingles(docs, n=3, d=1 << 14)
    workers = _WorkerSnapshots()
    with contextlib.ExitStack() as stack:
        stack.callback(workers.close)
        # the dumper folds in the workers' STATS snapshots once the plane
        # is up, and writes its final line before the workers shut down
        dumper = stack.enter_context(MetricsDumper(
            args.metrics_dump, interval_s=args.metrics_interval,
            extra=workers)) if args.metrics_dump else None
        svc = stack.enter_context(SimilaritySearchService(SearchConfig(
            d=1 << 14, k=256, n_bands=64, rows_per_band=4,
            n_shards=args.shards, partition=args.partition,
            probe_impl=args.probe, query_impl=args.query_impl,
            transport=args.transport, query_timeout_s=args.query_timeout,
            hedge=args.hedge, hedge_delay_ms=args.hedge_delay_ms,
            n_replicas=args.replicas, journal_dir=args.journal_dir,
            supervisor=args.supervisor, device=args.device)))
        workers.store = svc.store
        bs = max(1, min(args.ingest_batch, len(idx)))
        t0 = time.perf_counter()
        with svc.pipeline(depth=args.pipeline_depth) as pipe:
            for lo in range(0, len(idx), bs):
                pipe.submit(idx[lo: lo + bs])
        t_ingest = time.perf_counter() - t0
        tm = pipe.timings
        print(f"[serve] ingest {svc.size} docs in {t_ingest * 1e3:.1f} ms "
              f"(depth={args.pipeline_depth}, "
              f"{svc.size / t_ingest:.0f} docs/s; sign={tm['sign_s'] * 1e3:.0f}ms "
              f"wait={tm['wait_s'] * 1e3:.0f}ms "
              f"scatter={tm['scatter_s'] * 1e3:.0f}ms)")
        t0 = time.perf_counter()
        ids, scores = svc.query_sparse(idx[: args.batch], top_k=5)
        dt = time.perf_counter() - t0
        sizes = svc.store.shard_sizes().tolist()
        print(f"[serve] search over {svc.size} docs "
              f"({args.shards} shard(s) {sizes}, probe={args.probe}, "
              f"query={args.query_impl}, transport={args.transport}, "
              f"device={svc.engine.device}): "
              f"{args.batch} queries in {dt * 1e3:.1f} ms; top-1 self-hit "
              f"{(ids[:, 0] == np.arange(args.batch)).mean() * 100:.0f}%")
        if args.stream:
            stream_demo(svc, idx, args)
        # one merged plane snapshot (coordinator + tcp workers): the
        # per-shard partial-latency split is the skew evidence
        snap = svc.store.obs_snapshot()
        shard_p50 = [obs_metrics.hist_quantile(
            snap["hists"].get(f"query.shard{i}.partial",
                              {"count": 0, "buckets": {}}), 0.5)
            for i in range(args.shards)]
        print(f"[serve] obs: {len(snap['counters'])} counters, "
              f"{len(snap['hists'])} hists; shard partial p50(ms) "
              f"{[round(p * 1e3, 2) for p in shard_p50]}")
        # the stitched trace (skipped when a dumper already drained the
        # ring: the spans are in the dump file then)
        tid = obs_trace.default().last_trace_id()
        spans = obs_trace.default().for_trace(tid) if tid is not None else []
        if spans:
            legs = sorted({(s["proc"], s["name"]) for s in spans})
            print(f"[serve] trace {tid:x}: {len(spans)} spans across "
                  f"{len({p for p, _ in legs})} proc(s): "
                  f"{', '.join(f'{p}/{n}' for p, n in legs)}")
        if dumper is not None:
            dumper.close()


def stream_demo(svc, idx, args) -> None:
    """Open-loop streaming: Poisson arrivals at ``--stream-qps`` through
    the admission queue.  The percentiles are each ticket's end-to-end
    latency (admission wait + batch wall), what an outside caller sees."""
    rng = np.random.default_rng(1)
    n_q = args.stream_queries
    qrows = idx[rng.integers(0, len(idx), n_q)]
    gaps = rng.exponential(1.0 / args.stream_qps, n_q)
    with svc.stream(max_batch=args.max_batch,
                    max_delay_ms=args.max_delay_ms,
                    depth=args.stream_depth) as stream:
        t0 = time.perf_counter()
        tickets = []
        for i in range(n_q):
            target = t0 + gaps[: i + 1].sum()
            # one clock read a step: the time left can run out between
            # two reads, and sleep refuses a negative length
            while (left := target - time.perf_counter()) > 0:
                time.sleep(min(left, 1e-3))
            tickets.append(stream.submit_sparse(qrows[i], top_k=5))
        for t in tickets:
            t.result(timeout=svc.cfg.query_timeout_s + 30)
        wall = time.perf_counter() - t0
    lat = np.sort([t.latency_s for t in tickets])
    print(f"[serve] stream: {n_q} queries at {args.stream_qps:.0f} "
          f"qps offered -> {n_q / wall:.0f} qps served "
          f"({stream.n_batches} batches, depth={args.stream_depth}, "
          f"hedge={'on' if args.hedge else 'off'}); e2e p50 "
          f"{lat[int(0.50 * (n_q - 1))] * 1e3:.2f} ms, p99 "
          f"{lat[int(0.99 * (n_q - 1))] * 1e3:.2f} ms")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "search"], default="lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--docs", type=int, default=400)
    ap.add_argument("--shards", type=int, default=1,
                    help="index partitions")
    ap.add_argument("--partition", choices=["round_robin", "hash"],
                    default="round_robin")
    ap.add_argument("--probe", choices=["auto", "numpy", "device"],
                    default="auto",
                    help="probe backend of the host query walk")
    ap.add_argument("--query-impl", choices=["auto", "host"], default="auto",
                    help="auto = the fused device pipeline; host = the host "
                         "fold + planner walk")
    ap.add_argument("--transport", choices=["inproc", "tcp"],
                    default="inproc",
                    help="shard backend: in-process shards or spawned tcp "
                         "shard workers, one per shard, on --device")
    ap.add_argument("--query-timeout", type=float, default=30.0,
                    dest="query_timeout",
                    help="query fan-out deadline in seconds (tcp transport; "
                         "TransportTimeout errors name this knob)")
    ap.add_argument("--hedge", action="store_true",
                    help="hedge slow shard reads on a second connection "
                         "(tcp transport; never changes results)")
    ap.add_argument("--hedge-delay-ms", type=float, default=None,
                    help="fixed hedge delay in ms (default: derived from "
                         "the shards' observed reply skew; 0 hedges at once)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica workers per shard (tcp transport; 1 = "
                         "the unreplicated plane)")
    ap.add_argument("--journal-dir", default=None,
                    help="directory for the write-ahead ingest journal "
                         "(tcp transport; replica resync replays it)")
    ap.add_argument("--supervisor", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="self-heal dead replicas: respawn on --device, "
                         "replay the journal, check the digest, rejoin "
                         "(--replicas > 1)")
    ap.add_argument("--stream", action="store_true",
                    help="run the open-loop streaming demo after ingest")
    ap.add_argument("--stream-qps", type=float, default=500.0,
                    help="offered Poisson arrival rate for --stream")
    ap.add_argument("--stream-queries", type=int, default=512,
                    help="queries to stream for --stream")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="admission queue flush size (--stream)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="admission queue flush deadline in ms (--stream)")
    ap.add_argument("--stream-depth", type=int, default=2,
                    help="streaming pipeline depth: batches in flight "
                         "(1 = serial; --stream)")
    ap.add_argument("--metrics-dump", metavar="PATH", default=None,
                    help="append periodic JSONL registry snapshots + trace "
                         "spans (+ tcp workers' snapshots) here while "
                         "serving; validate with `python -m "
                         "repro_torch.obs.dump --check PATH`")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="seconds between --metrics-dump lines")
    ap.add_argument("--trace-sample-rate", type=float, default=1.0,
                    help="probability a query batch opens a (cross-process) "
                         "trace; 0 disables tracing")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ingest batches signed-but-unscattered in flight "
                         "(1 = serial sign -> scatter)")
    ap.add_argument("--ingest-batch", type=int, default=128,
                    help="documents per ingest pipeline batch")
    args = ap.parse_args()
    if args.mode == "lm":
        serve_lm(args)
    else:
        serve_search(args)


if __name__ == "__main__":
    main()
