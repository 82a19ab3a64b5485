"""Shard worker process: one ``SketchStore`` on a device, behind a framed
TCP socket.

The port of ``repro.transport.server``, speaking the same wire protocol, so
a coordinator of either package serves over workers of either.  A worker is
the remote half of the ``ShardBackend`` split: it owns exactly the state an
``InProcessShard`` owns (one ``SketchStore``, here on ``device``: the card
by default) and serves the same operations over the wire: ADD batches, the
QUERY hash broadcast (candidates + partial top-k), the BRUTE fallback leg,
STATS, DIGEST, SNAPSHOT and a graceful SHUTDOWN.  All ranking code is the
store's own, which keeps tcp answers bit-identical to the in-process plane.

The wire carries host arrays; the seam to the card is here.  A QUERY's
uint64 hashes (two uint32 planes) and uint32 words are uploaded once each
to the store's device: the probe kernel reads the device hashes, the spill
leg the host ones (``BandHashes(dev, host=)``), and the worker launches no
fold.  BRUTE uploads the fallback rows' words and scores them with the
collision kernel.  Replies go back in the reference's dtypes (ids int64,
scores float32, has bool).  There is no fallback: a failed launch is a
handler exception, answered with an ERROR frame.

Workers start with the ``spawn`` context (a coordinator that has touched
CUDA cannot fork), each with its own CUDA context on the card, and boot
empty from a ``StoreConfig`` or from a per-shard snapshot written by
``ShardedSketchStore.save`` (either package's).  A worker asked for a card
it cannot reach fails at boot and ``spawn_workers`` reports it; it never
serves from the CPU unless ``device="cpu"`` was asked for.  The bound
address travels back to the parent over a one-shot pipe, so workers bind
port 0 and never race over port numbers.

Connections are served one thread each, so a coordinator may hold more
than one connection to a worker (hedged reads, ``client.HedgePolicy``);
the store is not thread-safe, so handling is serialized behind one
worker-wide lock.  A handler exception is answered with an ERROR frame
(the connection stays up); a decode failure also gets an ERROR frame and
drops the connection.  EOF returns the worker to ``accept``; only SHUTDOWN
(acked first) exits the process.

``spawn_workers(slow_shards=...)`` injects probabilistic latency before a
worker's QUERY/BRUTE handling, the reproducible "one slow shard" scenario
hedging is measured on.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import select
import socket
import threading
import time
import traceback

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, u32_to_device
from ..kernels import launch_counts
from ..kernels.dispatch import select_probe_impl
from ..kernels.query_fused import BandHashes, hashes_to_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..store.sharded import shard_snapshot_path
from ..store.store import SketchStore, StoreConfig
from . import wire
from .faults import KILL_EXIT_CODE, FaultPlan
from .wire import Message, MsgType

GATE_LIMIT_ENV = "REPRO_GATE_LIMIT"
DEFAULT_GATE_LIMIT = 64

# overload control gates READS only: an OVERLOADED write leg would surface
# as a failed scatter round and poison the plane, so writes keep their
# backpressure (the bounded ingest pipeline) and the gate protects the
# latency-sensitive read path, where shedding is cheap and clean
_GATED_TYPES = (MsgType.QUERY, MsgType.BRUTE)


class AdmissionGate:
    """Bounded-inflight admission for a worker's read path.

    ``limit`` caps requests admitted concurrently (executing + waiting on
    the exec lock across all connection threads).  At the cap the worker
    answers ``OVERLOADED`` instead of queueing: an explicit reject is
    retryable within the caller's budget and deadline.
    """

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._n = 0
        self._lock = threading.Lock()
        reg = obs_metrics.default()
        self._depth_g = reg.gauge("worker.admission.depth")
        reg.gauge("worker.admission.limit").set(self.limit)
        self.n_overloaded = reg.counter("worker.overloaded")
        self.n_expired = reg.counter("worker.expired")

    @property
    def depth(self) -> int:
        return self._n

    def try_enter(self) -> bool:
        with self._lock:
            if self._n >= self.limit:
                return False
            self._n += 1
            self._depth_g.set(self._n)
            return True

    def leave(self) -> None:
        with self._lock:
            self._n -= 1
            self._depth_g.set(self._n)


def _overloaded_reply(reason: str, retry_after_us: int,
                      gate: "AdmissionGate | None") -> Message:
    f = {"reason": reason, "retry_after_us": int(retry_after_us)}
    if gate is not None:
        f["gate_depth"] = gate.depth
        f["gate_limit"] = gate.limit
    return Message(MsgType.OVERLOADED, f)


def _partial_reply(part) -> Message:
    return Message(MsgType.PARTIAL, {"ids": part.ids, "scores": part.scores,
                                     "has": part.has_candidates})


def _query_operands(store: SketchStore, hashes: np.ndarray,
                    qwords: np.ndarray) -> tuple[BandHashes, object]:
    """A QUERY's hashes and words where the store reads them: uploaded
    once each to the store's device for the fused pipeline (the probe
    reads the device hashes, the spill leg the host ones), or left on the
    host when the store walks on the host."""
    if store._resolve_query_impl() == "host":
        return BandHashes(host=hashes), qwords
    return (BandHashes(hashes_to_device(hashes, store.device), host=hashes),
            u32_to_device(qwords, store.device))


def _device_bytes(store: SketchStore) -> int:
    """Bytes this process holds allocated on the store's card (0 on the
    CPU): the worker's own evidence that it serves from the card."""
    if store.device.type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(store.device))


def _handle(store: SketchStore, msg: Message,
            shard: int = -1, replica: int = 0,
            gate: "AdmissionGate | None" = None) -> tuple[Message, bool]:
    """One request -> (reply, keep_serving)."""
    f = msg.fields
    if msg.type == MsgType.ADD:
        # a failed ADD reports whether it mutated the store: the
        # coordinator keeps a retry safe only when the batch provably did
        # not land (otherwise it poisons the plane instead of duplicating)
        before = (store.size, store.table.n_items)
        try:
            if "rows" in f:
                n = len(store.add(np.asarray(f["rows"], np.int32)))
            elif "words" in f:
                n = len(store.add_packed(np.asarray(f["words"], np.uint32)))
            else:
                raise wire.ProtocolError("ADD needs 'rows' or 'words'")
        except Exception as e:
            if (store.size, store.table.n_items) != before:
                e.add_dirty = True
            raise
        return Message(MsgType.OK, {"n": n}), True
    if msg.type == MsgType.QUERY:
        hashes, qwords = _query_operands(
            store, wire.join_u64(f["hash_lo"], f["hash_hi"]),
            np.asarray(f["qwords"], np.uint32))
        return _partial_reply(store.partial_topk_packed_hashed(
            hashes, qwords, int(f["top_k"]), mode=f["mode"])), True
    if msg.type == MsgType.BRUTE:
        # the fallback rows' words go up once; the collision kernel scores
        # them against the resident words
        return _partial_reply(store.planner.brute_partial_packed(
            np.asarray(f["qwords"], np.uint32), int(f["top_k"]))), True
    if msg.type == MsgType.STATS:
        # ``obs`` is this worker's registry snapshot as a JSON string (the
        # coordinator merges them with ``merge_snapshots``); ``launches``
        # is this process's per-kernel launch counts, also JSON; ``device``
        # and ``device_bytes`` say where the store lives
        return Message(MsgType.OK, {"size": store.size,
                                    "n_spilled": store.n_spilled,
                                    "n_rebuilds": store.n_rebuilds,
                                    "probe_impl": store.probe_impl,
                                    "query_impl": store.query_impl,
                                    "pid": os.getpid(),
                                    "shard": int(shard),
                                    "replica": int(replica),
                                    "gate_limit": gate.limit if gate else -1,
                                    "gate_depth": gate.depth if gate else 0,
                                    "n_overloaded":
                                        gate.n_overloaded.value if gate else 0,
                                    "n_expired":
                                        gate.n_expired.value if gate else 0,
                                    "obs": json.dumps(
                                        obs_metrics.default().snapshot()),
                                    "device": str(store.device),
                                    "device_bytes": _device_bytes(store),
                                    "launches": json.dumps(launch_counts()),
                                    }), True
    if msg.type == MsgType.DIGEST:
        return Message(MsgType.OK, store.digest()), True
    if msg.type == MsgType.SNAPSHOT:
        store.save(f["path"])
        return Message(MsgType.OK, {}), True
    if msg.type == MsgType.SHUTDOWN:
        return Message(MsgType.OK, {}), False
    raise wire.ProtocolError(f"unexpected message type {msg.type!r}")


def _serve_conn(store: SketchStore, conn: socket.socket,
                shard: int = -1, *,
                exec_lock: threading.Lock | None = None,
                slow: tuple[float, float] | None = None,
                replica: int = 0,
                gate: AdmissionGate | None = None,
                faults: FaultPlan | None = None) -> bool:
    """Serve one coordinator connection.  Returns False when SHUTDOWN.

    ``exec_lock`` serializes handler execution across this worker's
    connection threads.  ``slow`` is ``(prob, sleep_s)`` injected latency:
    each QUERY/BRUTE independently sleeps ``sleep_s`` with probability
    ``prob`` *before* taking the lock, so a hedged re-issue of the same
    request gets a fresh draw and can overtake a sleeping primary.

    ``gate`` bounds read inflight (OVERLOADED at the cap); expired-deadline
    reads are dropped before computing.  ``faults`` is the worker's
    deterministic fault schedule, consulted before handling: ``kill`` dies
    before mutating the store, ``drop`` closes without a reply,
    ``truncate`` sends half a frame.
    """
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if exec_lock is None:
        exec_lock = threading.Lock()
    rng = random.Random()
    reg = obs_metrics.default()
    tracer = obs_trace.default()
    bytes_in = reg.counter("worker.bytes_in")
    bytes_out = reg.counter("worker.bytes_out")
    errors = reg.counter("worker.errors")
    wire_errors = reg.counter("worker.wire_errors")
    backlog = reg.counter("worker.backlog")
    faults_fired = reg.counter("worker.faults_fired")
    handle_h = {t: reg.histogram(f"worker.handle.{t.name.lower()}")
                for t in MsgType}
    while True:
        try:
            msg = wire.recv_message(conn, meter=bytes_in.inc)
        except wire.ConnectionClosed:
            return True                          # client went away: re-accept
        except wire.WireError as e:              # stream out of sync: drop it
            wire_errors.inc()
            try:
                wire.send_message(conn, Message(
                    MsgType.ERROR, {"error": f"{type(e).__name__}: {e}"}),
                    meter=bytes_out.inc)
            except OSError:
                pass
            return True
        if faults is not None:
            for ev in faults.on_message(msg.type.name.lower()):
                faults_fired.inc()
                if ev.kind == "delay":
                    FaultPlan.sleep(ev)
                elif ev.kind == "drop":
                    return True                  # EOF mid-round, no reply
                elif ev.kind == "truncate":
                    frame = wire.message_bytes(Message(
                        MsgType.ERROR, {"error": "injected truncation"},
                        seq=msg.seq))
                    try:                         # half a frame, then hangup
                        conn.sendall(frame[:max(wire.HEADER_SIZE + 1,
                                                len(frame) // 2)])
                    except OSError:
                        pass
                    return True
                elif ev.kind == "kill":
                    # the fired-event log is already fsynced; die before
                    # handling so the store never half-mutates
                    os._exit(KILL_EXIT_CODE)
        # a request carrying trace fields joins the coordinator's trace
        ctx = None
        if wire.TRACE_ID_FIELD in msg.fields:
            ctx = obs_trace.TraceCtx(int(msg.fields[wire.TRACE_ID_FIELD]),
                                     int(msg.fields[wire.TRACE_PARENT_FIELD]))
        admitted = False
        if gate is not None and msg.type in _GATED_TYPES:
            dl = msg.fields.get(wire.DEADLINE_FIELD)
            if dl is not None and time.time() * 1e6 > int(dl):
                # the caller's deadline already passed: drop before
                # scoring, and say why
                gate.n_expired.inc()
                reply = _overloaded_reply("expired", 0, gate)
                reply.seq = msg.seq
                try:
                    wire.send_message(conn, reply, meter=bytes_out.inc)
                except OSError:
                    return True
                continue
            if not gate.try_enter():
                gate.n_overloaded.inc()
                # back off roughly one queue drain: mean read handle time
                # x current depth (2 ms floor when the worker is cold)
                h = handle_h[MsgType.QUERY]
                per = h.mean if h.count else 2e-3
                reply = _overloaded_reply(
                    "admission", int(max(per, 2e-3) * gate.depth * 1e6),
                    gate)
                reply.seq = msg.seq
                try:
                    wire.send_message(conn, reply, meter=bytes_out.inc)
                except OSError:
                    return True
                continue
            admitted = True
        if slow is not None and msg.type in (MsgType.QUERY, MsgType.BRUTE) \
                and rng.random() < slow[0]:
            time.sleep(slow[1])
        t0 = time.perf_counter()
        try:
            # with no ctx (the worker tracer samples nothing itself) this
            # is the shared no-op span: untraced requests pay nothing
            with tracer.span(f"worker.{msg.type.name.lower()}", parent=ctx):
                with exec_lock:
                    reply, keep = _handle(store, msg, shard, replica, gate)
        except Exception as e:                   # worker-side op failure
            errors.inc()
            reply, keep = Message(MsgType.ERROR, {
                "error": f"{type(e).__name__}: {e}",
                "dirty": int(getattr(e, "add_dirty", False)),
                "traceback": traceback.format_exc(limit=8)}), True
        finally:
            if admitted:
                gate.leave()
        handle_h[msg.type].observe(time.perf_counter() - t0)
        if ctx is not None:
            spans = tracer.drain()
            if spans:               # the reply carries this worker's spans
                reply.fields[wire.TRACE_SPANS_FIELD] = json.dumps(spans)
        reply.seq = msg.seq                      # pair reply to its request
        try:
            wire.send_message(conn, reply, meter=bytes_out.inc)
        except OSError:
            return keep    # client vanished before reading: back to accept
        if not keep:
            return False
        # queue-depth proxy: another request already readable the moment
        # one finishes means the coordinator is ahead of this worker
        try:
            if select.select([conn], [], [], 0)[0]:
                backlog.inc()
        except OSError:
            pass


def _boot_store(cfg: StoreConfig | None, snapshot: str | None,
                probe_impl: str, query_impl: str,
                device: str) -> SketchStore:
    """The worker's store on ``device`` (raises without the card), with
    ``probe_impl="auto"`` resolved against that device."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        # S workers on one host must not each take every core
        torch.set_num_threads(1)
    if probe_impl == "auto":
        probe_impl = select_probe_impl(dev.type)
    if snapshot is not None:
        store = SketchStore.load(snapshot, device=dev)
        store.probe_impl = probe_impl
        store.query_impl = query_impl
        return store
    if cfg is None:
        raise ValueError("worker needs a StoreConfig or a snapshot")
    return SketchStore(cfg, device=dev, probe_impl=probe_impl,
                       query_impl=query_impl)


def run_worker(ready_conn, cfg: StoreConfig | None, snapshot: str | None,
               probe_impl: str, host: str, port: int,
               shard: int = -1, query_impl: str = "auto",
               slow: tuple[float, float] | None = None,
               replica: int = 0, gate_limit: int | None = None,
               fault_spec: str | None = None,
               device: str = DEFAULT_DEVICE) -> None:
    """Worker entry point (spawn target; all arguments picklable).

    Boots a ``SketchStore`` on ``device`` (empty from ``cfg``, or from
    ``snapshot``), binds ``(host, port)`` (port 0 = ephemeral), reports the
    bound address through ``ready_conn``, and serves until SHUTDOWN.  A
    boot failure (no card for ``device="cuda"``, a bad snapshot) is sent
    through ``ready_conn`` as text and the worker exits non-zero.

    ``probe_impl="auto"`` resolves here, against this worker's device (the
    probe kernel on a card, the numpy walk on the CPU); ``query_impl``
    "auto" is the fused pipeline on the worker's device.  The resolved
    knobs are reported in STATS.

    ``gate_limit`` bounds admitted read inflight (``REPRO_GATE_LIMIT`` when
    None; default ``DEFAULT_GATE_LIMIT``; <= 0 admits nothing).
    ``fault_spec`` is a ``FaultPlan.encode()`` JSON schedule
    (``REPRO_FAULTS`` keyed ``"<shard>.<replica>"`` when None).
    """
    lane = f"{shard}.{replica}"
    try:
        if fault_spec is not None:
            faults = FaultPlan.decode(fault_spec, lane=lane)
        else:
            faults = FaultPlan.from_env(lane)
        if gate_limit is None:
            gate_limit = int(os.environ.get(GATE_LIMIT_ENV,
                                            DEFAULT_GATE_LIMIT))
        store = _boot_store(cfg, snapshot, probe_impl, query_impl, device)
    except BaseException as e:
        ready_conn.send(f"{type(e).__name__}: {e}")
        ready_conn.close()
        raise
    # the worker's own tracer, labelled with its shard, so a stitched trace
    # says which process each span ran in; its sample rate stays 0: worker
    # spans open only under a wire-propagated parent
    proc = f"shard{shard}" if shard >= 0 else f"worker-pid{os.getpid()}"
    if shard >= 0 and replica > 0:
        proc = f"shard{shard}r{replica}"
    obs_trace.set_default(obs_trace.Tracer(proc=proc))
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(8)
        ready_conn.send(lsock.getsockname())
        ready_conn.close()
        stop = threading.Event()
        exec_lock = threading.Lock()
        gate = AdmissionGate(gate_limit)

        def _serve(conn: socket.socket) -> None:
            try:
                with conn:
                    if not _serve_conn(store, conn, shard,
                                       exec_lock=exec_lock, slow=slow,
                                       replica=replica, gate=gate,
                                       faults=faults):
                        stop.set()
            except ConnectionResetError:
                # normal for a hedge twin: the coordinator closes it with an
                # unread stale reply still buffered
                pass
            except Exception:
                # a crashed serving thread must not take the worker down:
                # the coordinator sees the dropped connection and reacts
                traceback.print_exc()

        threads: list[threading.Thread] = []
        lsock.settimeout(0.25)       # bounded accept so SHUTDOWN is noticed
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            t = threading.Thread(target=_serve, args=(conn,), daemon=True,
                                 name=f"serve-shard{shard}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(5)
    finally:
        lsock.close()


class WorkerHandle:
    """A spawned shard worker: its process and its bound address."""

    def __init__(self, proc, address: tuple[str, int], shard: int,
                 replica: int = 0):
        self.proc = proc
        self.address = address
        self.shard = shard
        self.replica = replica

    @property
    def alive(self) -> bool:
        return self.proc.is_alive()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def join(self, timeout: float | None = None) -> None:
        self.proc.join(timeout)

    def terminate(self) -> None:
        """Hard stop (the graceful path is a client-side SHUTDOWN)."""
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(5)

    def __repr__(self) -> str:
        state = "alive" if self.alive else "dead"
        return f"WorkerHandle(shard={self.shard}, replica={self.replica}, " \
               f"addr={self.address[0]}:{self.address[1]}, {state})"


def spawn_workers(cfg: StoreConfig | None, n_workers: int, *,
                  device: str = DEFAULT_DEVICE,
                  snapshot_dir: str | None = None, probe_impl: str = "auto",
                  query_impl: str = "auto", host: str = "127.0.0.1",
                  start_timeout: float = 120.0,
                  slow_shards: dict[int, tuple[float, float]] | None = None,
                  shards: list[int] | None = None,
                  replicas: list[int] | None = None,
                  gate_limit: int | None = None,
                  faults: dict[int, "FaultPlan | str"] | None = None,
                  ) -> list[WorkerHandle]:
    """Spawn ``n_workers`` shard workers on localhost, each with its store
    on ``device``; returns their handles.

    Workers start in parallel with the ``spawn`` context (the dominant cost
    is each process importing torch; on a card, each also makes its own
    CUDA context, and the first to need a kernel library builds it) and
    each reports its ephemeral port back before this returns.  A worker
    that fails at boot (``device="cuda"`` with no card it can reach) makes
    this raise with the worker's message; the other workers are stopped.
    With ``snapshot_dir``, worker ``i`` boots from ``shard_{shards[i]}.npz``
    inside it (the ``ShardedSketchStore.save`` layout of either package)
    instead of empty from ``cfg``.

    ``shards``/``replicas`` give each worker its (shard, replica) lane; the
    default is worker ``i`` = shard ``i``, replica 0.  ``slow_shards``
    maps worker index -> ``(prob, sleep_s)`` injected read latency;
    ``gate_limit`` sets every worker's read admission cap; ``faults`` maps
    worker index -> ``FaultPlan`` (or its ``encode()`` JSON).
    """
    if shards is None:
        shards = list(range(n_workers))
    if replicas is None:
        replicas = [0] * n_workers
    if len(shards) != n_workers or len(replicas) != n_workers:
        raise ValueError("shards/replicas must have one entry per worker")
    ctx = multiprocessing.get_context("spawn")
    started = []
    try:
        for i in range(n_workers):
            snap = shard_snapshot_path(snapshot_dir, shards[i]) \
                if snapshot_dir is not None else None
            parent, child = ctx.Pipe(duplex=False)
            plan = faults.get(i) if faults else None
            if isinstance(plan, FaultPlan):
                plan = plan.encode()
            proc = ctx.Process(
                target=run_worker,
                args=(child, cfg, snap, probe_impl, host, 0, shards[i],
                      query_impl,
                      slow_shards.get(i) if slow_shards else None,
                      replicas[i], gate_limit, plan, str(device)),
                daemon=True, name=f"shard-worker-{shards[i]}r{replicas[i]}")
            proc.start()
            child.close()
            started.append((proc, parent, i))
        handles = []
        for proc, parent, i in started:
            if not parent.poll(start_timeout):
                if not proc.is_alive():
                    raise RuntimeError(
                        f"shard worker {i} exited (code {proc.exitcode}) "
                        "before reporting its address")
                raise TimeoutError(
                    f"shard worker {i} did not report its address within "
                    f"{start_timeout:.0f}s")
            try:
                got = parent.recv()
            except EOFError as e:
                proc.join(5)
                raise RuntimeError(
                    f"shard worker {i} died during startup "
                    f"(exitcode {proc.exitcode})") from e
            if isinstance(got, str):
                proc.join(5)
                raise RuntimeError(
                    f"shard worker {i} failed at boot on device "
                    f"{device!r} (exitcode {proc.exitcode}): {got}")
            handles.append(WorkerHandle(proc, tuple(got), shards[i],
                                        replicas[i]))
            parent.close()
        return handles
    except BaseException:
        for proc, _, _ in started:
            if proc.is_alive():
                proc.terminate()
            proc.join(5)
        raise
