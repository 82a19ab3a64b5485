"""A pool of rank processes on this host, joined by ``torch.distributed``.

``RankPool(world)`` starts ``world`` processes (the ``spawn`` context),
each a rank of one gloo process group over ``tcp://localhost:<free
port>``; ``pool.run(fn, *args)`` calls ``fn(*args)`` on every rank at once
and returns the ranks' results in rank order.  ``fn`` must be importable
(a module-level function) and its arguments and result picklable.  Each
call has a hard timeout: a rank that does not answer in time (a hang in a
collective, a crash) fails the call, and the pool is stopped, instead of
waiting on.  The process group's own timeout is the same, so a collective
that waits on a lost peer raises in the surviving ranks.

Several ranks may share one card (``device="cuda"``: every rank on
``cuda:0``); gloo carries their collectives, since NCCL takes one rank a
card.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import socket
import time
import traceback
from multiprocessing.connection import wait

_READY = "ready"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, device: str, timeout: float,
           threads: int | None, conn) -> None:
    import torch
    import torch.distributed as dist
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        return
    try:
        conn.send(_READY)
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args = task
            try:
                conn.send(("ok", fn(*args)))
            except BaseException:
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankPool:
    """``world`` rank processes serving calls; close it (or use ``with``)."""

    def __init__(self, world: int, *, device: str = "cuda",
                 timeout: float = 120.0, threads: int | None = None):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world, self.timeout = world, timeout
        self._conns, self._procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, daemon=True,
                            name=f"rank{rank}",
                            args=(rank, world, port, device, timeout, threads,
                                  child))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        try:
            for rank in range(world):
                msg = self._recv(rank, timeout)
                if msg != _READY:
                    raise RuntimeError(f"rank {rank} did not start: {msg}")
        except BaseException:
            self.close()
            raise

    def _recv(self, rank: int, timeout: float):
        conn = self._conns[rank]
        if not conn.poll(timeout):
            raise TimeoutError(f"rank {rank} gave no answer in {timeout} s")
        return conn.recv()

    def run(self, fn, *args, timeout: float | None = None) -> list:
        """``fn(*args)`` on every rank; the results in rank order.  A rank's
        error or a timeout stops the pool and raises (the other ranks may
        be waiting in a collective for the failed one)."""
        if not self.alive:
            raise RuntimeError("the rank pool is closed")
        for conn in self._conns:
            conn.send((fn, args))
        limit = timeout or self.timeout
        deadline = time.monotonic() + limit
        pending = dict(enumerate(self._conns))
        out: dict = {}
        try:
            while pending:
                ready = wait(list(pending.values()),
                             max(deadline - time.monotonic(), 0))
                if not ready:
                    raise TimeoutError(f"ranks {sorted(pending)} gave no "
                                       f"answer in {limit} s")
                for r, conn in list(pending.items()):
                    if conn in ready:
                        kind, res = conn.recv()
                        del pending[r]
                        if kind == "error":
                            raise RuntimeError(f"rank {r}:\n{res}")
                        out[r] = res
        except BaseException:
            self.close()
            raise
        return [out[r] for r in range(self.world)]

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def close(self) -> None:
        """Stop the ranks: ask, then terminate, then kill."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

