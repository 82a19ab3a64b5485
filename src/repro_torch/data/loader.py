"""Host data loading: packing deduplicated documents into token batches, a
prefetch thread that keeps batches ready (overlaps host data prep with
device work), and the placer that gives each rank of a mesh its rows.
Copies of ``repro.data.loader``'s ``PrefetchIterator``,
``device_placer`` and ``deduped_token_batches``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class PrefetchIterator:
    """Wraps a host iterator; a daemon thread keeps ``depth`` batches ready and
    (optionally) places them with ``place`` (e.g. a copy to the card)."""

    def __init__(self, it: Iterator, *, depth: int = 2,
                 place: Callable | None = None):
        self._it = it
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._it:
                if self._place is not None:
                    item = self._place(item)
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def device_placer(mesh, shardings_fn: Callable) -> Callable:
    """Returns a function placing a host batch onto the mesh with the given
    sharding builder (e.g. ``distributed.sharding.batch_shardings``): each
    rank gets its slice of every array (``local_slices``), on the mesh's
    device."""
    import torch

    device = torch.device(mesh.device_type)

    def place(batch: dict):
        shardings = shardings_fn(batch, mesh)
        out = {}
        for k, x in batch.items():
            x = x.cpu() if isinstance(x, torch.Tensor) else np.asarray(x)
            out[k] = torch.as_tensor(x[shardings[k].slices(x.shape)]) \
                .to(device)
        return out

    return place


def deduped_token_batches(docs: list[np.ndarray], keep: np.ndarray,
                          batch: int, seq: int, *, vocab: int,
                          seed: int = 0) -> Iterator[dict]:
    """Pack retained documents into fixed-length training batches (infinite,
    reshuffling each epoch)."""
    rng = np.random.default_rng(seed)
    kept = [docs[i] for i in keep]
    while True:
        order = rng.permutation(len(kept))
        stream = np.concatenate([kept[i] for i in order])
        stream = np.clip(stream, 0, vocab - 1).astype(np.int32)
        n_tok = batch * seq
        for off in range(0, len(stream) - n_tok + 1, n_tok):
            yield {"tokens": stream[off: off + n_tok].reshape(batch, seq)}
