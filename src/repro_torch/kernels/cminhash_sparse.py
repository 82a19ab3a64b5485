"""Sparse C-MinHash via window-mins: the serving path's signing kernel.

The gather formulation computes ``h_q = min_j pi[(idx_j - q - off) mod D]``.
Reversing pi turns every hash index into a contiguous window read:

    rev[m]      = pi[(D - 1 - m) mod D]
    s_j         = (D - 1 - idx_j + off) mod D
    h_q         = min_j rev_ext[s_j + q],      q = 0..K-1

where ``rev_ext`` is rev extended circularly by the window length, with a
SENTINEL region that padding entries (idx < 0) point at.

* ``cminhash_sparse_plain`` — the plain PyTorch version of that scan (the
  counterpart of ``repro.kernels.cminhash_sparse.cminhash_sparse_windows``),
  in int32 throughout: torch has no ``minimum`` on uint16 on the CPU.
* ``cminhash_sparse_kernel`` — the wrapper: the CUDA kernel
  (``csrc/cminhash_sparse.cu``) for a CUDA tensor, the plain version for a
  CPU tensor.  Both take the fused ``pack_b`` epilogue and return words
  bit-identical to ``packfmt.pack_codes`` of the signatures.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.cminhash import _check
from . import _build, autotune
from .packfmt import pack_codes, pack_geometry

SENTINEL = 2 ** 31 - 1

KERNEL = _build.CudaKernel("cminhash_sparse", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # idx, pi, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, nnz, D, K
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # off, pack_b, n_words
    ctypes.c_int])                                       # placement


def window_table(pi: torch.Tensor, wl: int, dtype=torch.int32,
                 sentinel: int = SENTINEL) -> torch.Tensor:
    """(D,) pi -> (D + 2*wl - 1,) reversed, circularly extended window table
    followed by ``wl`` sentinel entries."""
    d = pi.shape[0]
    rev = pi.flip(0).to(dtype)
    reps = -(-(d + wl - 1) // d)
    ext = rev.repeat(reps)[: d + wl - 1]
    return torch.cat([ext, torch.full((wl,), sentinel, dtype=dtype,
                                      device=pi.device)])


def invalid_start(d: int, wl: int) -> int:
    """Window start whose wl-window lies wholly in the SENTINEL region."""
    return d + wl - 1


def window_starts(idx: torch.Tensor, d: int, wl: int, *,
                  shift_offset: int) -> torch.Tensor:
    """(B, NNZ) padded index lists -> (B, NNZ) int32 window starts; padding
    maps to the SENTINEL window."""
    s = torch.remainder(d - 1 - idx.long() + shift_offset, d)
    return torch.where(idx >= 0, s, invalid_start(d, wl)).to(torch.int32)


def cminhash_sparse_plain(idx: torch.Tensor, pi: torch.Tensor, k: int, *,
                          shift_offset: int = 1, block_j: int = 32,
                          pack_b: int | None = None) -> torch.Tensor:
    """Plain window-min scan: (B, NNZ) sigma-permuted index lists -> (B, K)
    int32 signatures, or (B, W) packed words when ``pack_b`` is set."""
    d = pi.shape[0]
    _check(d, k)
    b, nnz = idx.shape
    table = window_table(pi, k)
    s = window_starts(idx, d, k, shift_offset=shift_offset).long()
    cols = torch.arange(k, device=idx.device)
    acc = torch.full((b, k), SENTINEL, dtype=torch.int32, device=idx.device)
    for j0 in range(0, nnz, block_j):
        win = table[s[:, j0: j0 + block_j, None] + cols]   # (B, jt, K)
        acc = torch.minimum(acc, win.amin(dim=1))
    return acc if pack_b is None else pack_codes(acc, pack_b)


def cminhash_sparse_kernel(idx: torch.Tensor, pi: torch.Tensor, k: int, *,
                           shift_offset: int = 1, pack_b: int | None = None,
                           placement: int | None = None) -> torch.Tensor:
    """(B, NNZ) int32 index lists, already sigma-permuted (-1 = padding),
    and (D,) int32 pi -> (B, K) int32 signatures, or (B, ceil(K*b/32))
    int32 words (uint32 bits) when ``pack_b`` is set.

    An index >= D wraps mod D on both devices.  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel.  pi must hold values
    in [0, D), as a permutation does: the kernel keeps it as uint16 on the
    SM, so on the card a value outside gives other codes than on the
    CPU.  ``placement`` is where the kernel keeps pi
    (``autotune.PLACEMENTS``; -1 for its own pick), from the autotuner's
    ``sparse`` kind when not given; the plain version ignores it."""
    if shift_offset not in (0, 1):
        raise ValueError("shift_offset must be 0 or 1")
    d = pi.shape[0]
    _check(d, k)
    n_words = k if pack_b is None else pack_geometry(k, pack_b)[1]
    dev = idx.device
    if dev.type == "cpu":
        return cminhash_sparse_plain(idx, pi, k, shift_offset=shift_offset,
                                     pack_b=pack_b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    placement = autotune.resolve("sparse", idx.shape[0], d, k, dev.type,
                                 nnz=idx.shape[1],
                                 placement=placement)["placement"]
    _build.check_cuda_operand(idx, "idx", torch.int32, 2, dev)
    _build.check_cuda_operand(pi, "pi", torch.int32, 1, dev)
    b, nnz = idx.shape
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    if b:
        KERNEL.launch(dev, _build.ptr(idx), _build.ptr(pi), _build.ptr(out),
                      b, nnz, d, k, shift_offset, pack_b or 0, n_words,
                      placement)
    return out
