"""b-bit packed signature buffer (the store's storage layer).

Signatures are stored columnar on the host: ``words`` has shape
``(n_words, capacity)`` uint32, word-lane major, appended in place with
capacity doubling.  ``device_words`` is the row-major copy resident on the
store's device, re-uploaded only after a mutation, that the fused query and
the brute-force fallback score against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import u32_to_device
from ..kernels.packfmt import PACK_BITS
from ._growth import grown

_MIN_CAPACITY = 8


@dataclasses.dataclass(frozen=True)
class PackedConfig:
    k: int                      # codes per signature
    b: int = 32                 # bits per stored code (1,2,4,8,16,32)
    capacity: int = 1024        # initial item capacity

    def __post_init__(self):
        if self.b not in PACK_BITS:
            raise ValueError(f"b must be one of {PACK_BITS} (got {self.b})")
        if self.k <= 0:
            raise ValueError("k must be positive")

    @property
    def codes_per_word(self) -> int:
        return 32 // self.b

    @property
    def n_words(self) -> int:
        return -(-self.k // self.codes_per_word)


class PackedSignatureBuffer:
    """Append-only packed store; host-authoritative, device copy cached."""

    def __init__(self, cfg: PackedConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        cap = max(_MIN_CAPACITY, cfg.capacity)
        self._words = np.zeros((cfg.n_words, cap), np.uint32)
        self._size = 0
        self._version = 0
        self._device: tuple[int, torch.Tensor] | None = None

    @property
    def size(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return self._words.shape[1]

    def append_packed(self, words) -> np.ndarray:
        """Append a (B, W) uint32 word batch; returns the new ids."""
        words = np.asarray(words, np.uint32)
        if words.ndim != 2 or words.shape[1] != self.cfg.n_words:
            raise ValueError(
                f"expected (B, {self.cfg.n_words}) packed words, "
                f"got {words.shape}")
        b = words.shape[0]
        self._words = grown(self._words, self._size + b, axis=1)
        self._words[:, self._size: self._size + b] = words.T
        ids = np.arange(self._size, self._size + b, dtype=np.int64)
        self._size += b
        self._version += 1
        return ids

    def gather(self, ids) -> np.ndarray:
        """(C,) ids -> (C, W) uint32 packed rows."""
        ids = np.asarray(ids, np.int64)
        return np.ascontiguousarray(self._words[:, ids].T)

    def all_packed(self) -> np.ndarray:
        """(size, W) packed rows for every stored item."""
        return np.ascontiguousarray(self._words[:, : self._size].T)

    def device_words(self) -> torch.Tensor:
        """(size, W) int32 packed rows resident on the device, uploaded
        again only after a mutation."""
        if self._device is None or self._device[0] != self._version:
            self._device = (self._version,
                            u32_to_device(self.all_packed(), self.device))
        return self._device[1]
