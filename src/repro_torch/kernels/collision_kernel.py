"""Pairwise signature collision counts (the brute-force scoring kernel).

count[q, n] = sum_k 1{sig_q[q, k] == sig_n[n, k]}: an "equality matmul".
Estimated Jaccard is count / K.

* ``collision_counts_plain`` — the plain PyTorch version on int32 codes;
  ``packed_collision_counts_plain`` unpacks b-bit words
  (``packfmt.unpack_codes``) and counts with it.
* ``collision_counts_kernel`` (int32 codes) and
  ``packed_collision_counts_kernel`` (b-bit words as the index stores them)
  — the wrappers: the CUDA kernel (``csrc/collision.cu``, which reads the
  words as they are, b = 32 being one code a word) for CUDA tensors, the
  plain version for CPU tensors.  Ragged edges and the codes past K in a
  row's last word are masked in the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, autotune
from .packfmt import pack_geometry, unpack_codes

KERNEL = _build.CudaKernel("collision", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # a, b, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Q, N, W
    ctypes.c_int, ctypes.c_int, ctypes.c_int])           # K, bits, block_q


def _check_widths(sig_q: torch.Tensor, sig_n: torch.Tensor) -> None:
    if sig_q.shape[1] != sig_n.shape[1]:
        raise ValueError(f"signature widths differ: {sig_q.shape[1]} vs "
                         f"{sig_n.shape[1]}")


def collision_counts_plain(sig_q: torch.Tensor,
                           sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, K) x (N, K) int32 -> (Q, N) int32 match counts."""
    _check_widths(sig_q, sig_n)
    return (sig_q[:, None, :] == sig_n[None, :, :]).sum(-1, dtype=torch.int32)


def packed_collision_counts_plain(words_q: torch.Tensor,
                                  words_n: torch.Tensor, k: int,
                                  b: int) -> torch.Tensor:
    """(Q, W) x (N, W) words of K b-bit codes -> (Q, N) int32 counts of
    equal codes."""
    return collision_counts_plain(unpack_codes(words_q, k, b),
                                  unpack_codes(words_n, k, b))


def _launch(words_q: torch.Tensor, words_n: torch.Tensor, k: int,
            b: int, block_q: int | None) -> torch.Tensor:
    dev = words_q.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    block_q = autotune.resolve("collision", words_q.shape[0],
                               words_n.shape[0], words_q.shape[1], dev.type,
                               block_q=block_q)["block_q"]
    _build.check_cuda_operand(words_q, "words_q", torch.int32, 2, dev)
    _build.check_cuda_operand(words_n, "words_n", torch.int32, 2, dev)
    q, w = words_q.shape
    n = words_n.shape[0]
    if w == 0:
        return torch.zeros((q, n), dtype=torch.int32, device=dev)
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    if q and n:
        KERNEL.launch(dev, _build.ptr(words_q), _build.ptr(words_n),
                      _build.ptr(out), q, n, w, k, b, block_q)
    return out


def collision_counts_kernel(sig_q: torch.Tensor, sig_n: torch.Tensor, *,
                            block_q: int | None = None) -> torch.Tensor:
    """(Q, K) x (N, K) int32 -> (Q, N) int32 match counts: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.  ``block_q`` is
    the kernel's query tile (16, 32 or 64 rows), from the autotuner's
    ``collision`` kind when not given; the plain version ignores it."""
    _check_widths(sig_q, sig_n)
    if sig_q.device.type == "cpu":
        return collision_counts_plain(sig_q, sig_n)
    return _launch(sig_q, sig_n, sig_q.shape[1], 32, block_q)


def packed_collision_counts_kernel(words_q: torch.Tensor,
                                   words_n: torch.Tensor, k: int, b: int, *,
                                   block_q: int | None = None
                                   ) -> torch.Tensor:
    """(Q, W) x (N, W) int32 words of K b-bit codes (``packfmt`` layout,
    W = ceil(K / (32/b))) -> (Q, N) int32 counts of equal codes: one launch
    of the CUDA kernel over the words as they are for CUDA tensors, the
    plain version for CPU tensors.  Bits of the last word past code K are
    ignored.  ``block_q`` as in ``collision_counts_kernel``."""
    n_words = pack_geometry(k, b)[1]
    for name, t in (("words_q", words_q), ("words_n", words_n)):
        if t.dim() != 2 or t.shape[1] != n_words:
            raise ValueError(f"{name} must be (rows, {n_words}) for K={k}, "
                             f"b={b} (got {tuple(t.shape)})")
    if words_q.device.type == "cpu":
        return packed_collision_counts_plain(words_q, words_n, k, b)
    return _launch(words_q, words_n, k, b, block_q)
