"""b-bit packed signature buffer (the store's storage layer).

Signatures are stored columnar on the host: ``words`` has shape
``(n_words, capacity)`` uint32, word-lane major, appended in place with
capacity doubling.  ``device_words`` is the row-major copy resident on the
store's device, re-uploaded only after a mutation, that the fused query and
the brute-force fallback score against.  ``save``/``load`` snapshot to
``.npz`` in the JAX package's format.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, u32_to_device
from ..kernels.packfmt import PACK_BITS, pack_codes, unpack_codes
from ._growth import grown

_MIN_CAPACITY = 8


def pack_host(sigs, b: int) -> np.ndarray:
    """(B, K) int32 signatures -> (B, W) uint32 packed words, on the host
    (``packfmt.pack_codes``)."""
    sigs = torch.from_numpy(np.asarray(sigs).astype(np.int32))
    return pack_codes(sigs, b).numpy().view(np.uint32)


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

    @property
    def nbytes(self) -> int:
        """Packed bytes actually holding data (the 32/b storage win)."""
        return self.cfg.n_words * self._size * 4

    def append(self, sigs) -> np.ndarray:
        """Pack and append a (B, K) int32 signature batch (packed on the
        host, ``packfmt.pack_codes``); returns the new ids."""
        sigs = np.asarray(sigs)
        if sigs.ndim != 2 or sigs.shape[1] != self.cfg.k:
            raise ValueError(f"expected (B, {self.cfg.k}), got {sigs.shape}")
        return self.append_packed(pack_host(sigs, self.cfg.b))

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

    def codes(self, ids) -> torch.Tensor:
        """(C,) ids -> (C, K) int32 unpacked b-bit codes on the device."""
        return unpack_codes(u32_to_device(self.gather(ids), self.device),
                            self.cfg.k, self.cfg.b)

    # -- snapshots ---------------------------------------------------------
    @classmethod
    def from_rows(cls, cfg: PackedConfig, rows,
                  device: torch.device) -> "PackedSignatureBuffer":
        """Rebuild a buffer from (N, W) row-major packed words (the
        ``gather``/``all_packed`` layout, what snapshots store)."""
        rows = np.asarray(rows, np.uint32)
        n = rows.shape[0]
        buf = cls(cfg, device)
        buf._words = grown(buf._words, n, axis=1)
        buf._words[:, :n] = rows.T
        buf._size = n
        buf._version += 1
        return buf

    def save(self, path: str) -> None:
        np.savez(path, words=self.all_packed(), k=self.cfg.k, b=self.cfg.b)

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = DEFAULT_DEVICE
             ) -> "PackedSignatureBuffer":
        with np.load(path) as z:
            words = z["words"]                         # (N, W) rows
            cfg = PackedConfig(k=int(z["k"]), b=int(z["b"]),
                               capacity=max(_MIN_CAPACITY, len(words)))
        return cls.from_rows(cfg, words, resolve_device(device))
