"""Top-k select over rows of counts (the brute-force fallback's ranking).

For each row of a (Q, U) int32 count matrix: the ``kk = min(kk, U)``
largest counts and their columns, ordered (count desc, column asc), the
order of a stable sort of ``-counts``.  With the columns in ascending id
order that is the reference's ``np.argsort(-scored, kind="stable")``.

* ``topk_select_plain`` — the plain PyTorch version: a full stable sort of
  ``-counts`` and a gather.
* ``topk_select_kernel`` — the wrapper of the CUDA kernel
  (``csrc/topk_select.cu``, one pass over the counts for each 32 of kk).
* ``topk_select`` — the select the planner calls: the kernel for a CUDA
  tensor, the plain version for any other; it names the path it took.

Counts lie in [-1, 2^31 - 1] (-1: a column masked out), as the kernel's
key assumes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = _build.CudaKernel("topk_select", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # counts, values, cols
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int])  # Q, U, kk


def topk_select_plain(counts: torch.Tensor,
                      kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, U) int32 -> (values (Q, kk') int32, columns (Q, kk') int64),
    kk' = min(kk, U): each row's first kk' columns by a stable sort on
    ``-counts``."""
    order = torch.sort(-counts, dim=1, stable=True).indices[:, :kk]
    return torch.gather(counts, 1, order), order


def _launch(counts: torch.Tensor,
            kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"counts must be on a CUDA device (got {dev})")
    _build.check_cuda_operand(counts, "counts", torch.int32, 2, dev)
    q, u = counts.shape
    kk = min(kk, u)
    values = torch.empty((q, kk), dtype=torch.int32, device=dev)
    cols = torch.empty((q, kk), dtype=torch.int64, device=dev)
    if q and kk:
        KERNEL.launch(dev, _build.ptr(counts), _build.ptr(values),
                      _build.ptr(cols), q, u, kk)
    return values, cols


def topk_select_kernel(counts: torch.Tensor,
                       kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, U) int32 -> (values (Q, kk') int32, columns (Q, kk') int64),
    kk' = min(kk, U), ordered (count desc, column asc): one call of the
    CUDA kernel (counts contiguous, on a CUDA device)."""
    if kk < 0:
        raise ValueError(f"kk must be >= 0 (got {kk})")
    return _launch(counts, kk)


def topk_select(counts: torch.Tensor, kk: int
                ) -> tuple[torch.Tensor, torch.Tensor, str]:
    """(Q, U) int32 -> (values (Q, kk') int32, columns (Q, kk') int64,
    path), kk' = min(kk, U), ordered (count desc, column asc): the kernel
    on a CUDA device (path ``"kernel"``), the plain version elsewhere
    (``"sort"``)."""
    if counts.device.type == "cuda":
        return (*topk_select_kernel(counts, kk), "kernel")
    return (*topk_select_plain(counts, kk), "sort")
