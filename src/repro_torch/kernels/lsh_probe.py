"""LSH bucket probe over the table's fused records, on the device.

``BandedLSHTable`` keeps, per band, an open-addressing array of fused
records

    records (n_bands, n_slots, 2 + W) int32
    records[b, s, :2] = band-hash halves (-1, -1 = unused)
    records[b, s, 2:] = posting item ids (-1 padded)

and uploads them once per mutation (``device_records``).  The uint64 leg
(``key % n_slots``) stays on the host in numpy (``probe_operands``), which
reduces every (query, band) entry to five int32s; the probe itself runs on
the device:

* ``lsh_probe_plain``  — the plain PyTorch version: one (E, 2+W) gather per
  probe depth, the single possible hit folded in with a select (the
  counterpart of ``repro.kernels.lsh_probe.lsh_probe_jnp``).
* ``lsh_probe_kernel`` — the wrapper: the CUDA kernel (``csrc/lsh_probe.cu``)
  for a CUDA tensor, the plain version for a CPU tensor.

Sentinel-valued hashes (the empty-slot key, spilled at insert) carry
valid = 0 and never match.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# the one definition of the probe geometry in the port: store/table.py
# walks the same chain and uses the same empty-slot sentinel
SENTINEL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)

META_COLS = 5    # lin_band, base_slot, key_lo, key_hi, valid

KERNEL = _build.CudaKernel("lsh_probe", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # records, meta, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,       # E, n_slots, probes
    ctypes.c_int])                                       # W


def probe_offset(t: int) -> int:
    """Quadratic (triangular) probe offset t(t+1)/2."""
    return t * (t + 1) // 2


def probe_operands(hashes: np.ndarray, n_slots: int) -> np.ndarray:
    """(Q, n_bands) uint64 band hashes -> (Q * n_bands, 5) int32 operands:
    [band * n_slots, key % n_slots, key_lo, key_hi, valid], key halves in
    the records' native-endian int32 view."""
    q, nb = hashes.shape
    key = np.ascontiguousarray(hashes.reshape(-1), dtype=np.uint64)
    meta = np.empty((q * nb, META_COLS), np.int32)
    meta[:, 0] = np.tile(np.arange(nb, dtype=np.int32) * n_slots, q)
    meta[:, 1] = (key % np.uint64(n_slots)).astype(np.int32)
    meta[:, 2:4] = key.view(np.int32).reshape(-1, 2)
    meta[:, 4] = key != SENTINEL_KEY
    return meta


def lsh_probe_plain(flat_records: torch.Tensor, meta: torch.Tensor, *,
                    n_slots: int, max_probes: int) -> torch.Tensor:
    """(E, 5) operands -> (E, W) candidate ids, -1 padded (fixed depth)."""
    w = flat_records.shape[1] - 2
    lin_band, base = meta[:, 0].long(), meta[:, 1].long()
    valid = meta[:, 4] != 0
    out = torch.full((meta.shape[0], w), -1, dtype=torch.int32,
                     device=meta.device)
    for t in range(max_probes):
        slot = (base + probe_offset(t)) % n_slots
        rec = flat_records[lin_band + slot]                   # (E, 2+W)
        hit = (rec[:, 0] == meta[:, 2]) & (rec[:, 1] == meta[:, 3]) & valid
        out = torch.where(hit[:, None], rec[:, 2:], out)
    return out


def lsh_probe_kernel(flat_records: torch.Tensor, meta: torch.Tensor, *,
                     n_slots: int, max_probes: int) -> torch.Tensor:
    """(n_bands * n_slots, 2 + W) int32 records and (E, 5) int32 operands
    -> (E, W) int32 candidate ids, -1 padded: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = meta.device
    if dev.type == "cpu":
        return lsh_probe_plain(flat_records, meta, n_slots=n_slots,
                               max_probes=max_probes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _build.check_cuda_operand(flat_records, "records", torch.int32, 2, dev)
    _build.check_cuda_operand(meta, "meta", torch.int32, 2, dev)
    if meta.shape[1] != META_COLS:
        raise ValueError(f"meta must be (E, {META_COLS})")
    e = meta.shape[0]
    w = flat_records.shape[1] - 2
    out = torch.empty((e, w), dtype=torch.int32, device=dev)
    if e:
        KERNEL.launch(dev, _build.ptr(flat_records), _build.ptr(meta),
                      _build.ptr(out), e, n_slots, max_probes, w)
    return out
