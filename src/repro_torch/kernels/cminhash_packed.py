"""Dense C-MinHash over bit-packed rows.

The same function as the int8 kernel (``cminhash_kernel``), read from rows
packed 32 positions to a word (``pack_bits``): the operand is 8x smaller,
and the work follows the set bits, B*K*nnz, instead of B*K*D.  Every set
position p of a row folds pi[(p - q - off) mod D] into hash q.

* ``pack_bits`` — (B, D) rows -> (B, ceil(D/32)) words, plain torch on
  both devices (as the reference's is jnp outside its Pallas kernel).
* ``cminhash_packed_plain`` — the plain PyTorch version on the words: the
  set positions of each row, then ``core.cminhash.cminhash_sparse``'s
  gather over them, in row chunks so its temporaries stay bounded.
* ``cminhash_packed_kernel`` — the wrapper: the CUDA kernel
  (``csrc/cminhash_packed.cu``, on the sparse and dense int8 kernels'
  window-min core ``csrc/window_fold.cuh``) for a CUDA tensor, the plain
  version for a CPU tensor.  Both take the fused ``pack_b`` epilogue.
* ``cminhash_packed`` — rows in, words packed, then the wrapper (the
  counterpart of ``repro.kernels.cminhash_packed.cminhash_packed_pallas``).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.cminhash import _BUDGET, _check, cminhash_sparse
from . import _build, autotune
from .packfmt import pack_codes, pack_geometry

KERNEL = _build.CudaKernel("cminhash_packed", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # words, pi, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, nw, D, K
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # off, pack_b, n_words
    ctypes.c_int])                                       # placement

_BYTE_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def n_row_words(d: int) -> int:
    return -(-d // 32)


def pack_bits(v: torch.Tensor) -> torch.Tensor:
    """(B, D) binary rows -> (B, ceil(D/32)) int32 words (uint32 bits),
    position 32w + j at bit j of word w; an entry is set when it is > 0.

    Eight positions fold into each byte as a uint8 weighted sum, and four
    little-endian bytes are viewed as one word, so the largest temporary is
    one byte per position."""
    b, d = v.shape
    nw = n_row_words(d)
    bits = (v > 0).to(torch.uint8)
    if nw * 32 != d:
        bits = torch.nn.functional.pad(bits, (0, nw * 32 - d))
    weights = torch.tensor(_BYTE_WEIGHTS, dtype=torch.uint8, device=v.device)
    packed = (bits.reshape(b, nw * 4, 8) * weights).sum(dim=-1,
                                                     dtype=torch.uint8)
    return packed.view(torch.int32)


def set_positions(words: torch.Tensor, d: int) -> torch.Tensor:
    """(B, W) words -> (B, max nnz) int32 set positions < d, ascending,
    padded with -1."""
    b = words.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(b, -1)[:, :d] != 0
    counts = bits.sum(dim=1)
    nnz = int(counts.max()) if b else 0
    out = torch.full((b, nnz), -1, dtype=torch.int32, device=words.device)
    rows, cols = bits.nonzero(as_tuple=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.numel(), device=words.device) - starts[rows]
    out[rows, slot] = cols.to(torch.int32)
    return out


def cminhash_packed_plain(words: torch.Tensor, pi: torch.Tensor, k: int, *,
                          shift_offset: int = 1,
                          pack_b: int | None = None) -> torch.Tensor:
    """(B, ceil(D/32)) words -> (B, K) int32 signatures, or (B, W) packed
    codes when ``pack_b`` is set."""
    d = pi.shape[0]
    _check(d, k)
    b, nw = words.shape
    sig = torch.empty((b, k), dtype=torch.int32, device=words.device)
    rows = max(1, _BUDGET // (nw * 32))
    for r0 in range(0, b, rows):
        pos = set_positions(words[r0: r0 + rows], d)
        sig[r0: r0 + rows] = cminhash_sparse(pos, pi, k,
                                             shift_offset=shift_offset)
    return sig if pack_b is None else pack_codes(sig, pack_b)


def cminhash_packed_kernel(words: torch.Tensor, pi: torch.Tensor, k: int, *,
                           shift_offset: int = 1, pack_b: int | None = None,
                           placement: int | None = None) -> torch.Tensor:
    """(B, ceil(D/32)) int32 words of already sigma-permuted rows and (D,)
    int32 pi -> (B, K) int32 signatures, or (B, ceil(K*b/32)) int32 words
    when ``pack_b`` is set.  Bits at positions >= D are ignored.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    pi must hold values in [0, D), as a permutation does: the kernel keeps
    it as uint16 on the SM, so on the card a value outside gives other
    codes than on the CPU.  ``placement`` is where the kernel keeps pi
    (``autotune.PLACEMENTS``; -1 for its own pick), from the autotuner's
    ``dense_bits`` kind when not given; the plain version ignores it."""
    if shift_offset not in (0, 1):
        raise ValueError("shift_offset must be 0 or 1")
    d = pi.shape[0]
    nw = n_row_words(d)
    if words.dim() != 2 or words.shape[1] != nw:
        raise ValueError(f"words must be (B, {nw}) for D={d} (got "
                         f"{tuple(words.shape)})")
    _check(d, k)
    n_words = k if pack_b is None else pack_geometry(k, pack_b)[1]
    dev = words.device
    if dev.type == "cpu":
        return cminhash_packed_plain(words, pi, k, shift_offset=shift_offset,
                                     pack_b=pack_b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    placement = autotune.resolve("dense_bits", words.shape[0], d, k,
                                 dev.type, placement=placement)["placement"]
    _build.check_cuda_operand(words, "words", torch.int32, 2, dev)
    _build.check_cuda_operand(pi, "pi", torch.int32, 1, dev)
    b = words.shape[0]
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    if b:
        KERNEL.launch(dev, _build.ptr(words), _build.ptr(pi),
                      _build.ptr(out), b, nw, d, k, shift_offset, pack_b or 0,
                      n_words, placement)
    return out


def cminhash_packed(v: torch.Tensor, pi: torch.Tensor, k: int, *,
                    shift_offset: int = 1, pack_b: int | None = None,
                    placement: int | None = None) -> torch.Tensor:
    """(B, D) rows, already sigma-permuted -> signatures (or packed codes)
    through ``pack_bits`` and the bit-packed kernel."""
    if v.dim() != 2 or v.shape[1] != pi.shape[0]:
        raise ValueError(f"v must be (B, {pi.shape[0]}) (got "
                         f"{tuple(v.shape)})")
    return cminhash_packed_kernel(pack_bits(v), pi, k,
                                  shift_offset=shift_offset, pack_b=pack_b,
                                  placement=placement)
