"""LSH bucket probe over the table's fused records, on the device.

``BandedLSHTable`` keeps, per band, an open-addressing array of fused
records

    records (n_bands, n_slots, 2 + W) int32
    records[b, s, :2] = band-hash halves (-1, -1 = unused)
    records[b, s, 2:] = posting item ids (-1 padded)

and uploads them once per mutation (``device_records``).  The probe takes
the (Q, n_bands) band hashes as int64 with the uint64 bits, as the fold
leaves them on the device, and derives each entry's operands itself (band,
``key mod n_slots`` unsigned, key halves, validity):

* ``lsh_probe_hashes_plain``  — the plain PyTorch version: the operands
  from the hashes with torch (``hash_operands``), then ``lsh_probe_plain``,
  one (E, 2+W) gather per probe depth with the single possible hit folded
  in by a select (the counterpart of ``repro.kernels.lsh_probe.
  lsh_probe_jnp``).
* ``lsh_probe_hashes_kernel`` — the wrapper: the CUDA kernel
  (``csrc/lsh_probe.cu``) for a CUDA tensor, the plain version for a CPU
  tensor.

``probe_operands`` is the reference's host uint64 leg, kept as its port
(the parity tests hold it); no path on the card calls it.  Sentinel-valued
hashes (the empty-slot key, spilled at insert) carry valid = 0 and never
match.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from . import _build, autotune

# the one definition of the probe geometry in the port: store/table.py
# walks the same chain and uses the same empty-slot sentinel
SENTINEL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)

META_COLS = 5    # lin_band, base_slot, key_lo, key_hi, valid
_LITTLE_ENDIAN = sys.byteorder == "little"

KERNEL = _build.CudaKernel("lsh_probe", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # records, hashes, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,       # E, n_bands, n_slots
    ctypes.c_int, ctypes.c_int,                          # max_probes, W
    ctypes.c_int, ctypes.c_int])                         # group, steps


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


def check_geometry(flat_records: torch.Tensor, n_bands: int,
                   n_slots: int) -> None:
    """Raise unless the records hold n_bands * n_slots rows of 2 + W, with
    0 < n_slots < 2^31 (the kernel's slot arithmetic)."""
    if not 0 < n_slots < 2 ** 31 or \
            flat_records.shape[0] != n_bands * n_slots or \
            flat_records.shape[1] < 2:
        raise ValueError(f"records {tuple(flat_records.shape)} are not "
                         f"({n_bands} * {n_slots}, 2 + W)")


def hash_operands(hashes: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(Q, n_bands) int64 band hashes (uint64 bits) -> (Q * n_bands, 5)
    int64 operands [band * n_slots, key mod n_slots, key_lo, key_hi, valid]
    on the hashes' device, for any ``n_slots``: ``probe_operands``'s values
    (int32 there).  torch has no uint64 ``%``, and a hash >= 2^63 is
    negative as int64, so the unsigned residue is taken from the halves:
    ``((hi mod n) * (2^32 mod n) + lo) mod n``, every term below 2^63."""
    q, nb = hashes.shape
    flat = hashes.reshape(-1)
    lo = flat & 0xFFFFFFFF
    hi = (flat >> 32) & 0xFFFFFFFF
    base = ((hi % n_slots) * (2 ** 32 % n_slots) + lo) % n_slots
    lin = (torch.arange(nb, dtype=torch.int64, device=flat.device)
           * n_slots).repeat(q)
    klo = torch.where(lo >= 2 ** 31, lo - 2 ** 32, lo)
    khi = torch.where(hi >= 2 ** 31, hi - 2 ** 32, hi)
    if not _LITTLE_ENDIAN:                      # pragma: no cover
        klo, khi = khi, klo
    valid = (flat != -1).to(torch.int64)
    return torch.stack([lin, base, klo, khi, valid], dim=1)


def lsh_probe_hashes_plain(flat_records: torch.Tensor, hashes: torch.Tensor,
                           *, n_slots: int, max_probes: int) -> torch.Tensor:
    """(Q, n_bands) int64 band hashes -> (Q * n_bands, W) candidate ids,
    -1 padded: ``hash_operands``, then the fixed-depth walk."""
    return lsh_probe_plain(flat_records, hash_operands(hashes, n_slots),
                           n_slots=n_slots, max_probes=max_probes)


def lsh_probe_hashes_kernel(flat_records: torch.Tensor, hashes: torch.Tensor,
                            *, n_slots: int, max_probes: int,
                            group: int | None = None,
                            steps: int | None = None) -> torch.Tensor:
    """(n_bands * n_slots, 2 + W) int32 records and (Q, n_bands) int64 band
    hashes -> (Q * n_bands, W) int32 candidate ids, -1 padded: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``group``
    (lanes an entry) and ``steps`` (probe steps a round trip) are the
    kernel's geometry, from the autotuner's ``probe`` kind where not given;
    the plain version ignores them."""
    dev = hashes.device
    if dev.type == "cpu":
        return lsh_probe_hashes_plain(flat_records, hashes, n_slots=n_slots,
                                      max_probes=max_probes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    geo = autotune.resolve("probe", hashes.numel(), n_slots,
                           flat_records.shape[1] - 2, dev.type, group=group,
                           steps=steps)
    _build.check_cuda_operand(flat_records, "records", torch.int32, 2, dev)
    _build.check_cuda_operand(hashes, "hashes", torch.int64, 2, dev)
    q, nb = hashes.shape
    w = flat_records.shape[1] - 2
    check_geometry(flat_records, nb, n_slots)
    out = torch.empty((q * nb, w), dtype=torch.int32, device=dev)
    if q * nb:
        KERNEL.launch(dev, _build.ptr(flat_records), _build.ptr(hashes),
                      _build.ptr(out), q * nb, nb, n_slots, max_probes, w,
                      geo["group"], geo["steps"])
    return out
