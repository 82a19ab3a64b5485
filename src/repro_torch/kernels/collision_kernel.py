"""Pairwise signature collision counts (the brute-force scoring kernel).

count[q, n] = sum_k 1{sig_q[q, k] == sig_n[n, k]}: an "equality matmul".
Estimated Jaccard is count / K.

* ``collision_counts_plain`` — the plain PyTorch version.
* ``collision_counts_kernel`` — the wrapper: the CUDA kernel
  (``csrc/collision.cu``) for CUDA tensors, the plain version for CPU
  tensors.  Ragged edges are masked in the kernel, so no sentinel padding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = _build.CudaKernel("collision", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # a, b, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int])           # Q, N, K


def _check_widths(sig_q: torch.Tensor, sig_n: torch.Tensor) -> None:
    if sig_q.shape[1] != sig_n.shape[1]:
        raise ValueError(f"signature widths differ: {sig_q.shape[1]} vs "
                         f"{sig_n.shape[1]}")


def collision_counts_plain(sig_q: torch.Tensor,
                           sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, K) x (N, K) int32 -> (Q, N) int32 match counts."""
    _check_widths(sig_q, sig_n)
    return (sig_q[:, None, :] == sig_n[None, :, :]).sum(-1, dtype=torch.int32)


def collision_counts_kernel(sig_q: torch.Tensor,
                            sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, K) x (N, K) int32 -> (Q, N) int32 match counts: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_widths(sig_q, sig_n)
    dev = sig_q.device
    if dev.type == "cpu":
        return collision_counts_plain(sig_q, sig_n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _build.check_cuda_operand(sig_q, "sig_q", torch.int32, 2, dev)
    _build.check_cuda_operand(sig_n, "sig_n", torch.int32, 2, dev)
    q, k = sig_q.shape
    n = sig_n.shape[0]
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    if q and n:
        KERNEL.launch(dev, _build.ptr(sig_q), _build.ptr(sig_n),
                      _build.ptr(out), q, n, k)
    return out
