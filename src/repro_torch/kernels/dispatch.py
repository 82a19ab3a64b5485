"""Kernel front door for the signing and query hot paths.

Every request lands here and goes to one kernel wrapper; the wrapper picks
the CUDA kernel or its plain version from the device of the tensors it is
given, never from a fallback.  Each entry bumps a ``kernel.<leg>.<impl>``
counter (``impl`` is ``cuda`` or ``plain``), as the reference's dispatch
does per resolved implementation; dense signing counts
``kernel.dense.<int8|packed>.<impl>``.

Dense (B, D) rows go to one of two kernels:

  * ``int8``   — ``cminhash_kernel``: the window-min over each row's set
                 bits, set bits x K + B*D work;
  * ``packed`` — ``cminhash_packed``: rows packed 32 positions to a word,
                 B*K*nnz work and an 8x smaller operand.

``impl="auto"`` takes ``packed`` from ``PACKED_MIN_D`` positions up and
``int8`` below, the reference's TPU policy, on either device: a CPU tensor
runs the chosen route's plain version.  There is no ``ref`` route.

Launch geometry is fixed inside each wrapper: the port has no autotuner.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.permutations import apply_permutation_dense, \
    apply_permutation_sparse
from ..obs import metrics as obs_metrics
from . import lsh_probe as _lsh_probe
from . import query_fused as _query_fused
from .cminhash_kernel import as_int8_mask, cminhash_dense_kernel
from .cminhash_packed import cminhash_packed
from .cminhash_sparse import cminhash_sparse_kernel

PACKED_MIN_D = 16384
DENSE_IMPLS = ("auto", "int8", "packed")


def _impl(t: torch.Tensor) -> str:
    return "cuda" if t.device.type == "cuda" else "plain"


def select_dense_impl(d: int, device_type: str) -> str:
    """Resolve ``impl="auto"`` for dense (B, d) rows on a ``cuda`` or
    ``cpu`` tensor.  The policy is the same on both; ``device_type``
    mirrors the reference's ``backend`` argument, so a caller names where
    the rows live and an unknown device is refused."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type must be cuda or cpu (got "
                         f"{device_type!r})")
    return "packed" if d >= PACKED_MIN_D else "int8"


def select_probe_impl(device_type: str) -> str:
    """Resolve ``probe_impl="auto"`` for a table on a ``cuda`` or ``cpu``
    device: the probe kernel on a card, the numpy host walk on the CPU.
    ``BandedLSHTable.lookup`` applies it per call, and a shard worker at
    boot, against its own device."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type must be cuda or cpu (got "
                         f"{device_type!r})")
    return "device" if device_type == "cuda" else "numpy"


def signatures_dense(v: torch.Tensor, pi: torch.Tensor, k: int,
                     sigma: torch.Tensor | None = None, *,
                     shift_offset: int = 1, impl: str = "auto",
                     pack_b: int | None = None) -> torch.Tensor:
    """(B, D) binary rows (an entry is set when > 0) -> (B, K) int32
    signatures, or (B, W) int32 packed words when ``pack_b`` is set."""
    if impl not in DENSE_IMPLS:
        raise ValueError(f"impl must be one of {DENSE_IMPLS} (got {impl!r})")
    if impl == "auto":
        impl = select_dense_impl(v.shape[-1], v.device.type)
    obs_metrics.default().counter(f"kernel.dense.{impl}.{_impl(v)}").inc()
    v = as_int8_mask(v)
    if sigma is not None:
        v = apply_permutation_dense(v, sigma)
    kernel = cminhash_dense_kernel if impl == "int8" else cminhash_packed
    return kernel(v.contiguous(), pi, k, shift_offset=shift_offset,
                  pack_b=pack_b)


def signatures_sparse(idx: torch.Tensor, pi: torch.Tensor, k: int,
                      sigma: torch.Tensor | None = None, *,
                      shift_offset: int = 1,
                      pack_b: int | None = None) -> torch.Tensor:
    """(B, NNZ) padded index lists -> (B, K) int32 signatures, or (B, W)
    int32 packed words when ``pack_b`` is set (fused sign -> pack)."""
    obs_metrics.default().counter(f"kernel.sparse.{_impl(idx)}").inc()
    if sigma is not None:
        idx = apply_permutation_sparse(idx, sigma)
    return cminhash_sparse_kernel(idx.to(torch.int32).contiguous(), pi, k,
                                  shift_offset=shift_offset, pack_b=pack_b)


def lsh_probe(records_dev: torch.Tensor, hashes: np.ndarray, *,
              n_slots: int, max_probes: int) -> np.ndarray:
    """(Q, n_bands) uint64 band hashes -> (Q, n_bands * W) candidate ids
    over the table's uploaded records (``BandedLSHTable.device_records``).
    The hashes go up as int64, 8 bytes an entry; the kernel derives the
    probe's operands from them."""
    obs_metrics.default().counter(f"kernel.probe.{_impl(records_dev)}").inc()
    q, nb = hashes.shape
    w = records_dev.shape[1] - 2
    h = _query_fused.hashes_to_device(hashes, records_dev.device)
    out = _lsh_probe.lsh_probe_hashes_kernel(records_dev, h, n_slots=n_slots,
                                             max_probes=max_probes)
    return out.cpu().numpy().reshape(q, nb * w)


def fold_hashes(qwords: torch.Tensor, *, n_bands: int) -> torch.Tensor:
    """(Q, W) int32 packed query words -> (Q, n_bands) int64 band hashes
    (uint64 bits) on the words' device, via the fold kernel; bit-identical
    to ``core.lsh.band_hashes_packed``.  The coordinator's fold leg: the
    hashes stay on the device for the shards' probes, and nothing here
    waits for the card."""
    obs_metrics.default().counter(f"kernel.fold.{_impl(qwords)}").inc()
    rows = _query_fused.words_to_rows(qwords.contiguous(), n_bands)
    return _query_fused.fold_rows_kernel(rows.contiguous())


def query_fused(records_dev: torch.Tensor, words_dev: torch.Tensor,
                qwords: torch.Tensor, *, n_bands: int, n_slots: int,
                max_probes: int, k: int, b: int, top_k: int,
                hashes: _query_fused.BandHashes | None = None,
                spill_lookup=None,
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold -> probe -> score over resident store state: (Q, W) packed
    query words -> ``(ids, scores, has_candidates)`` host arrays.

    * ``hashes=None``: the probe kernel folds the words itself, one launch
      (power-of-two ``n_slots``: the store gates, as the reference does).
    * ``hashes=`` the coordinator's ``BandHashes`` (folded once for every
      shard): the probe reads their device tensor directly.
    * ``spill_lookup``: optional ``hashes -> (Q, M) int64`` host callable
      for the table's spilled keys, given the host uint64 hashes and
      concatenated before scoring.  Only this leg makes a host copy of the
      hashes (once a batch, ``BandHashes.host``); without ``hashes`` the
      fold kernel runs once more for it.

    Returns ids (Q, top_k) int64 (-1 pad), scores (Q, top_k) float32
    (-inf pad), has_candidates (Q,) bool."""
    obs_metrics.default().counter(
        f"kernel.query_fused.{_impl(records_dev)}").inc()
    dev = records_dev.device
    qwords = qwords.to(dev).contiguous()
    q = qwords.shape[0]
    w = records_dev.shape[1] - 2
    if hashes is None:
        rows = _query_fused.words_to_rows(qwords, n_bands)
        cand = _query_fused.fold_probe_kernel(records_dev, rows,
                                              n_slots=n_slots,
                                              max_probes=max_probes)
    else:
        cand = _lsh_probe.lsh_probe_hashes_kernel(records_dev, hashes.dev,
                                                  n_slots=n_slots,
                                                  max_probes=max_probes)
    cand = cand.reshape(q, n_bands * w)
    if spill_lookup is not None:
        if hashes is None:
            hashes = _query_fused.BandHashes(fold_hashes(qwords,
                                                         n_bands=n_bands))
        spill = np.asarray(spill_lookup(hashes.host()))
        if spill.size:
            cand = torch.cat([cand, torch.tensor(spill.astype(np.int32),
                                                 device=dev)], dim=1)
    ids, scores, has = _query_fused.score_topk(cand, words_dev, qwords,
                                               k=k, b=b, top_k=top_k)
    return (ids.cpu().numpy().astype(np.int64), scores.cpu().numpy(),
            has.cpu().numpy())
