"""The Mamba-1 selective scan of a prompt (``models/ssm.py`` ``ssm_block``).

For dt (B, S, Di) float32, a (Di, N) float32, B and C (B, S, N), x (B, S,
Di) and h0 (B, Di, N) float32, from h = h0:

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * B_t) * x_t,   y_t = sum_n h_t * C_t

-> (y (B, S, Di) float32, h_final (B, Di, N) float32): the function of
``models.ssm._ssm_inner`` at ``scan_dtype=float32``, one position at a time
(the benchmark reference's order) with the state in float32.

* ``ssm_scan_plain`` — the plain PyTorch version: a float32 loop over the
  positions, the kernel's arithmetic.
* ``ssm_scan_kernel`` — the wrapper of the CUDA kernel
  (``csrc/ssm_scan.cu``: one launch, the state in registers).

B, C and x are read in their own dtype (float32 or bf16, the configs'
compute dtypes, the same for the three) and widened to float32, as
``_ssm_inner``'s ``.float()`` calls do.  N is 8 or 16.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = _build.CudaKernel("ssm_scan", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dt, a, B
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # C, x, h0
    ctypes.c_void_p, ctypes.c_void_p,                    # y, h_final
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,   # B, S, Di
    ctypes.c_int, ctypes.c_int, ctypes.c_int])           # N, dtype, lanes

STATES = (8, 16)                       # the compiled instances of N
THREADS = 128                          # a block: 128 / lanes channels
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssm_scan_plain(dt, a, bmat, cmat, xs, h0):
    """The scan as a float32 loop over the positions: (y, h_final)."""
    h = h0.float().clone()
    ys = []
    for t in range(dt.shape[1]):
        d = dt[:, t, :, None].float()                        # (B, Di, 1)
        h = torch.exp(d * a) * h + d * bmat[:, t, None, :].float() \
            * xs[:, t, :, None].float()
        ys.append((h * cmat[:, t, None, :].float()).sum(-1))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h


def scan_lanes(batch: int, d_inner: int, n_sms: int) -> int:
    """Threads a channel's N states are split over: 1, or 2 or 4 where
    one a channel gives fewer than two blocks an SM (a small batch)."""
    lanes = 1
    while lanes < 4 and batch * -(-d_inner * lanes // THREADS) < 2 * n_sms:
        lanes *= 2
    return lanes


def _check(dt, a, bmat, cmat, xs, h0) -> None:
    """Raise unless the operands are what the kernel takes: dtypes, shapes
    and N first, then one CUDA device and contiguity."""
    for name, t in (("dt", dt), ("a", a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32 (got {t.dtype})")
    if xs.dtype not in DTYPES:
        raise TypeError(f"xs must be one of {list(DTYPES)} (got {xs.dtype})")
    for name, t in (("bmat", bmat), ("cmat", cmat)):
        if t.dtype != xs.dtype:
            raise TypeError(f"{name} must be xs's dtype {xs.dtype} (got "
                            f"{t.dtype})")
    if dt.dim() != 3 or a.dim() != 2:
        raise ValueError(f"dt must be (B, S, Di) and a (Di, N) (got "
                         f"{tuple(dt.shape)} and {tuple(a.shape)})")
    (bsz, s, di), n = dt.shape, a.shape[1]
    if n not in STATES:
        raise ValueError(f"the scan kernel is built for N in {STATES} "
                         f"(got a of shape {tuple(a.shape)})")
    want = {"a": (di, n), "bmat": (bsz, s, n), "cmat": (bsz, s, n),
            "xs": (bsz, s, di), "h0": (bsz, di, n)}
    for name, t in (("a", a), ("bmat", bmat), ("cmat", cmat), ("xs", xs),
                    ("h0", h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be of shape {want[name]} for dt "
                             f"{tuple(dt.shape)} (got {tuple(t.shape)})")
    dev = dt.device
    if dev.type != "cuda":
        raise ValueError(f"dt must be on a CUDA device (got {dev})")
    for name, t in (("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat),
                    ("xs", xs), ("h0", h0)):
        _build.check_cuda_operand(t, name, t.dtype, t.dim(), dev)


def _launch(dt, a, bmat, cmat, xs, h0, lanes: int | None = None):
    _check(dt, a, bmat, cmat, xs, h0)
    (bsz, s, di), n, dev = dt.shape, a.shape[1], dt.device
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dev)
    h_final = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    if lanes is None:
        lanes = scan_lanes(bsz, di, torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    if bsz and di:
        KERNEL.launch(dev, *map(_build.ptr, (dt, a, bmat, cmat, xs, h0, y,
                                             h_final)),
                      bsz, s, di, n, DTYPES[xs.dtype], lanes)
    return y, h_final


def ssm_scan_kernel(dt, a, bmat, cmat, xs, h0):
    """(y (B, S, Di) float32, h_final (B, Di, N) float32): one launch of
    the CUDA kernel (every operand contiguous, on one CUDA device; no
    sync).  Raises on another device, dtype, shape or N."""
    return _launch(dt, a, bmat, cmat, xs, h0)
