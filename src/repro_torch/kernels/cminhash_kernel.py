"""Dense C-MinHash over int8 rows: the circulant min-reduce kernel.

    h_q = min_m { pi[m] : v[(m + q + off) mod D] > 0 },   q = 0..K-1

over (already sigma-permuted) rows v, the form
``repro.kernels.cminhash_kernel`` tiles for the TPU.

* ``cminhash_dense_plain`` — the plain PyTorch version (the window form of
  ``core.cminhash.cminhash_dense``, chunked so its temporaries stay bounded).
* ``cminhash_dense_kernel`` — the wrapper: the CUDA kernel
  (``csrc/cminhash_dense.cu``) for a CUDA tensor, the plain version for a
  CPU tensor.  Both take the fused ``pack_b`` epilogue and return words
  bit-identical to ``packfmt.pack_codes`` of the signatures.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.cminhash import _check, cminhash_dense
from . import _build, autotune
from .packfmt import pack_codes, pack_geometry

KERNEL = _build.CudaKernel("cminhash_dense", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # v, pi, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, D, K
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # off, pack_b, n_words
    ctypes.c_int])                                       # placement


def as_int8_mask(v: torch.Tensor) -> torch.Tensor:
    """Rows as int8 whose entries are > 0 exactly where ``v``'s are: int8
    as it is, bool as a view, any other type as a 0/1 copy."""
    if v.dtype == torch.int8:
        return v
    if v.dtype == torch.bool:
        return v.view(torch.int8)
    return (v > 0).to(torch.int8)


def cminhash_dense_plain(v: torch.Tensor, pi: torch.Tensor, k: int, *,
                         shift_offset: int = 1,
                         pack_b: int | None = None) -> torch.Tensor:
    """(B, D) rows -> (B, K) int32 signatures, or (B, W) packed words when
    ``pack_b`` is set."""
    sig = cminhash_dense(v, pi, k, shift_offset=shift_offset)
    return sig if pack_b is None else pack_codes(sig, pack_b)


def cminhash_dense_kernel(v: torch.Tensor, pi: torch.Tensor, k: int, *,
                          shift_offset: int = 1, pack_b: int | None = None,
                          placement: int | None = None) -> torch.Tensor:
    """(B, D) int8/bool/int rows, already sigma-permuted, and (D,) int32 pi
    -> (B, K) int32 signatures, or (B, ceil(K*b/32)) int32 words (uint32
    bits) when ``pack_b`` is set.  An entry is set when it is > 0.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (which reads int8 rows; bool rows are viewed, others copied as 0/1).
    pi must hold values in [0, D), as a permutation does: the kernel keeps
    it as uint16 on the SM, so on the card a value outside gives other
    codes than on the CPU.  ``placement`` is where the kernel keeps pi
    (``autotune.PLACEMENTS``; -1 for its own pick), from the autotuner's
    ``dense_rows`` kind when not given; the plain version ignores it."""
    if shift_offset not in (0, 1):
        raise ValueError("shift_offset must be 0 or 1")
    d = pi.shape[0]
    if v.dim() != 2 or v.shape[1] != d:
        raise ValueError(f"v must be (B, {d}) (got {tuple(v.shape)})")
    _check(d, k)
    n_words = k if pack_b is None else pack_geometry(k, pack_b)[1]
    dev = v.device
    if dev.type == "cpu":
        return cminhash_dense_plain(v, pi, k, shift_offset=shift_offset,
                                    pack_b=pack_b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    placement = autotune.resolve("dense_rows", v.shape[0], d, k, dev.type,
                                 placement=placement)["placement"]
    v8 = as_int8_mask(v)
    _build.check_cuda_operand(v8, "v", torch.int8, 2, dev)
    _build.check_cuda_operand(pi, "pi", torch.int32, 1, dev)
    b = v8.shape[0]
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    if b:
        KERNEL.launch(dev, _build.ptr(v8), _build.ptr(pi), _build.ptr(out),
                      b, d, k, shift_offset, pack_b or 0, n_words, placement)
    return out
