"""Device query pipeline pieces: band-hash fold, top-k scoring.

* **fold** — the polynomial band-hash fold ``h = h * BASE + x + 1;
  h ^= h >> 29`` over each band's R codes, in uint64.  The reference
  emulates it on two uint32 planes; the CUDA kernel (``csrc/fold.cu``)
  uses native 64-bit integers and the plain version wrapping int64 (with
  the logical shift written as an arithmetic shift and a mask).  Hashes
  travel as int64 tensors with uint64 bits and stay on the device
  (``BandHashes``), where the probe (``lsh_probe``) reads them; a host
  uint64 copy is made only for a host consumer.  Packed words
  zero-extend, raw int32 signature codes sign-extend, as the host fold
  does.
* **probe meta** — ``meta_from_hashes`` is the port of the reference's
  ``meta_from_planes`` (power-of-two ``n_slots``), held by its parity test;
  the probe kernel derives its operands itself and no card path calls it.
* **scorer** — ``score_topk`` ranks (Q, C) -1-padded candidate rows against
  the resident packed words: sort-by-id dedup, one row gather, b-bit
  unpack, integer collision counts, then a stable sort by id and a stable
  sort by -count, which is the reference's two-key ``lax.sort`` on
  (-count, id).  Scores are ``count.float32 / k`` on both sides.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..device import take_rows, u32_to_host
from . import _build, autotune
from .lsh_probe import META_COLS
from .packfmt import unpack_codes

BASE = 0x9E3779B97F4A7C15
_BASE_I64 = BASE - 2 ** 64              # the same bits as a signed int64
_LOW35 = (1 << 35) - 1                  # keeps the 35 bits a logical >> 29 keeps
_INVALID_ID = 2 ** 31 - 1               # in-scorer sentinel: sorts after ids
_LITTLE_ENDIAN = sys.byteorder == "little"

KERNEL = _build.CudaKernel("fold", [
    ctypes.c_void_p, ctypes.c_void_p,                    # rows, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,       # n_rows, nb, R
    ctypes.c_int, ctypes.c_int])                         # sign_extend, threads


def words_to_rows(words: torch.Tensor, n_bands: int) -> torch.Tensor:
    """(B, W) int32 packed words -> (B, n_bands, W/n_bands) band rows."""
    b, w = words.shape
    if w % n_bands:
        raise ValueError(f"W={w} not divisible by n_bands={n_bands}")
    return words.reshape(b, n_bands, w // n_bands)


def sig_to_rows(sig: torch.Tensor, n_bands: int,
                rows_per_band: int) -> torch.Tensor:
    """(B, K) int32 signatures -> (B, n_bands, rows_per_band) band rows."""
    b, k = sig.shape
    if n_bands * rows_per_band != k:
        raise ValueError(f"K={k} != n_bands*rows_per_band")
    return sig.reshape(b, n_bands, rows_per_band)


def fold_rows_plain(rows: torch.Tensor, *,
                    sign_extend: bool = False) -> torch.Tensor:
    """(B, nb, R) int32 codes -> (B, nb) int64 fold keys (uint64 bits)."""
    x = rows.to(torch.int64)
    if not sign_extend:
        x = x & 0xFFFFFFFF
    h = torch.zeros(rows.shape[:2], dtype=torch.int64, device=rows.device)
    for r in range(rows.shape[2]):
        h = h * _BASE_I64 + x[:, :, r] + 1            # wraps like uint64
        h = h ^ ((h >> 29) & _LOW35)                  # logical >> 29
    return h


def fold_rows_kernel(rows: torch.Tensor, *, sign_extend: bool = False,
                     threads: int | None = None) -> torch.Tensor:
    """(B, nb, R) int32 codes -> (B, nb) int64 fold keys: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor.  ``threads`` is
    the kernel's block size, from the autotuner's ``fold`` kind when not
    given; the plain version ignores it."""
    dev = rows.device
    if dev.type == "cpu":
        return fold_rows_plain(rows, sign_extend=sign_extend)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    threads = autotune.resolve("fold", *rows.shape, dev.type,
                               threads=threads)["threads"]
    _build.check_cuda_operand(rows, "rows", torch.int32, 3, dev)
    b, nb, r = rows.shape
    out = torch.empty((b, nb), dtype=torch.int64, device=dev)
    if b * nb:
        KERNEL.launch(dev, _build.ptr(rows), _build.ptr(out), b, nb, r,
                      int(sign_extend), threads)
    return out


def meta_from_hashes(h: torch.Tensor, *, n_slots: int) -> torch.Tensor:
    """(Q, nb) int64 fold keys -> (Q * nb, 5) int32 probe operands on the
    device: [band * n_slots, key & (n_slots - 1), key halves, valid].
    Needs power-of-two ``n_slots``.  The key halves follow the host byte
    order, as the records' native int32 view does."""
    if n_slots & (n_slots - 1):
        raise ValueError(f"meta_from_hashes needs pow2 n_slots (got "
                         f"{n_slots})")
    q, nb = h.shape
    flat = h.reshape(-1)
    lin_band = (torch.arange(nb, dtype=torch.int32, device=h.device)
                * n_slots).repeat(q)
    base = (flat & (n_slots - 1)).to(torch.int32)
    lo = flat & 0xFFFFFFFF
    klo = torch.where(lo >= 2 ** 31, lo - 2 ** 32, lo).to(torch.int32)
    khi = (flat >> 32).to(torch.int32)
    valid = (flat != -1).to(torch.int32)
    if not _LITTLE_ENDIAN:                      # pragma: no cover
        klo, khi = khi, klo
    cols = [lin_band, base, klo, khi, valid]
    assert len(cols) == META_COLS
    return torch.stack(cols, dim=1)


def hashes_to_host(h: torch.Tensor) -> np.ndarray:
    """(Q, nb) int64 fold keys -> host uint64 hashes (waits for the device
    work that produces ``h``)."""
    return np.array(h.cpu().numpy(), copy=True).view(np.uint64)


def hashes_to_device(hashes: np.ndarray,
                     device: torch.device) -> torch.Tensor:
    """Host (Q, nb) uint64 hashes -> int64 tensor with the same bits on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(hashes, np.uint64)
                            .view(np.int64)).to(device)


class BandHashes:
    """A query batch's (Q, n_bands) band hashes: ``dev``, int64 with the
    uint64 bits on the device, which the probe reads; and the host uint64
    copy, made at the first ``host()`` and kept, for the host consumers
    (the spill leg, the host walk).  So the copy is made once a batch, and
    only when a consumer needs it.  Hashes folded on the host come in as
    ``host=``: alone for the host walk (``query_impl="host"``), or beside
    their upload (the raw-signature query, which folds on the host and
    probes on the device)."""

    __slots__ = ("dev", "_host")

    def __init__(self, dev: torch.Tensor | None = None, *,
                 host: np.ndarray | None = None):
        if dev is None and host is None:
            raise ValueError("BandHashes takes a device tensor, host "
                             "hashes, or both")
        self.dev = dev
        self._host = host

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = hashes_to_host(self.dev)
        return self._host


class QueryWords:
    """A query batch's (Q, W) packed words as the coordinator holds them:
    ``dev``, int32 words on the device (a host uint32 array on the host
    walk), which in-process shards read; and the host uint32 copy, made at
    the first ``host()`` and kept, which remote shards put on the wire.
    However many remote shards a batch fans out to, the words come to the
    host once.  ``rows(em)`` is the brute-force leg's subset: its device
    rows, and its host rows sliced from the batch's host copy when that
    exists (so the fallback leg makes no second copy)."""

    __slots__ = ("dev", "_host")

    def __init__(self, dev, *, host: np.ndarray | None = None):
        self.dev = dev
        if host is None and not isinstance(dev, torch.Tensor):
            host = np.asarray(dev, np.uint32)
        self._host = host

    def __len__(self) -> int:
        return int(self.dev.shape[0])

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = u32_to_host(self.dev)
        return self._host

    def rows(self, em: np.ndarray) -> "QueryWords":
        return QueryWords(take_rows(self.dev, em),
                          host=None if self._host is None else self._host[em])


def score_topk(cand: torch.Tensor, words: torch.Tensor, qwords: torch.Tensor,
               *, k: int, b: int, top_k: int,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q, C) -1-padded candidate ids + resident (N, W) words -> ranked
    partials: ids (Q, top_k) int32 [-1 pad], scores (Q, top_k) float32
    [-inf pad], has_candidates (Q,) bool, ordered (score desc, id asc)."""
    qn, c = cand.shape
    dev = cand.device
    has = (cand >= 0).any(dim=1)
    ids = torch.where(cand >= 0, cand, _INVALID_ID).to(torch.int32)
    ids = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    valid = (ids != _INVALID_ID) & ~dup
    n = words.shape[0]
    rows = words[ids.clamp(0, max(n - 1, 0)).long()]           # (Q, C, W)
    ccodes = unpack_codes(rows.reshape(qn * c, -1), k, b).reshape(qn, c, k)
    qcodes = unpack_codes(qwords, k, b)                        # (Q, K)
    counts = (qcodes[:, None, :] == ccodes).sum(-1, dtype=torch.int32)
    counts = torch.where(valid, counts, -1)
    # (-count, id) lexicographic: ids are already ascending, so one stable
    # sort by -count keeps equal counts in id order
    order = torch.sort(-counts, dim=1, stable=True).indices
    neg = torch.gather(-counts, 1, order)
    ids = torch.gather(ids, 1, order)
    kk = min(top_k, c)
    out_ids = torch.full((qn, top_k), -1, dtype=torch.int32, device=dev)
    out_scores = torch.full((qn, top_k), float("-inf"), dtype=torch.float32,
                            device=dev)
    hit = neg[:, :kk] <= 0                                     # count >= 0
    out_ids[:, :kk] = torch.where(hit, ids[:, :kk], -1)
    out_scores[:, :kk] = torch.where(
        hit, (-neg[:, :kk]).to(torch.float32) / k, float("-inf"))
    return out_ids, out_scores, has
