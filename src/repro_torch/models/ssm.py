"""Mamba-1 selective SSM block: a chunked scan (prefill) and an O(1)-state
decode step.

A PyTorch copy of ``repro.models.ssm``.  Within a chunk of
``cfg.ssm_chunk`` positions the recurrence h_t = decay_t * h_{t-1} + bx_t
runs as an inclusive scan in ``cfg.ssm_scan_dtype``, in log2(chunk)
doubling steps (Hillis-Steele); the state carried between chunks stays
float32.  The reference combines the same pairs with
``jax.lax.associative_scan``, in another order, so the two round
differently: the tests hold them within stated tolerances.

On a CUDA device, where no gradient is wanted and the scan is float32,
``ssm_block`` runs the scan as one launch of the hand-written kernel
(``kernels/ssm_scan.py``), one position at a time with the state in
registers; the chunked scan stays the path of the CPU, of training and of
a lower ``ssm_scan_dtype``, and ``cfg.ssm_chunk`` shapes only it.

Over a mesh (``par``, a ``distributed.parallel.Parallel`` whose SSM
channels split) a rank runs its ``d_inner / tp`` channels: the conv, the
scan, ``dt_proj`` (column-parallel) and the ``h``/``conv`` caches are its
channels'; ``x_proj``'s partial sums are summed over ``model`` before
``dt``, ``B`` and ``C`` are cut from them, and ``out_proj``'s after it
(both row-parallel); ``in_proj`` goes through ``par.ssm_in``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ssm_scan
from .layers import normal_init, rmsnorm

Tensor = torch.Tensor


def init_ssm(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, di, n, r, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    dt_init = float(np.log(np.expm1(0.01)))
    p = {
        "in_proj": normal_init(gen, (d, 2 * di), d ** -0.5, dtype),
        "conv_w": normal_init(gen, (cw, di), cw ** -0.5, dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": normal_init(gen, (di, r + 2 * n), di ** -0.5, dtype),
        "dt_proj": normal_init(gen, (r, di), r ** -0.5, dtype),
        "dt_bias": torch.full((di,), dt_init, dtype=dtype, device=dev),
        "a_log": a_log.expand(di, n).clone(),
        "d_skip": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": normal_init(gen, (di, d),
                                di ** -0.5 / np.sqrt(2 * cfg.n_layers), dtype),
    }
    if cfg.ssm_dt_norms:
        p.update(dt_norm=torch.ones(r, dtype=dtype, device=dev),
                 b_norm=torch.ones(n, dtype=dtype, device=dev),
                 c_norm=torch.ones(n, dtype=dtype, device=dev))
    return p


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along S.  x: (B, S, Di), w: (cw, Di)."""
    cw = w.shape[0]
    out = x * w[-1]
    for i in range(1, cw):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[-1 - i]
    return out + b


def _scan(decay: Tensor, bx: Tensor) -> tuple[Tensor, Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under (a1, b1) then
    (a2, b2) -> (a1 * a2, a2 * b1 + b2): returns (the running product of
    the decays, h from h = 0), each in the inputs' dtype."""
    a, b = decay, bx
    q = a.shape[1]
    off = 1
    while off < q:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def _ssm_inner(dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor, xs: Tensor,
               h0: Tensor, chunk: int, scan_dtype: torch.dtype
               ) -> tuple[Tensor, Tensor]:
    """The selective scan, chunked along S.

    dt: (B,S,Di) float32; a: (Di,N) float32; bmat/cmat: (B,S,N); xs:
    (B,S,Di); h0: (B,Di,N) float32.  Returns (y: (B,S,Di) float32, h_final).
    The (B,q,Di,N) decay and increment tensors are built a chunk at a time;
    the last chunk is cut short where the reference pads it with decay 1
    and increment 0, which leaves h as it was.
    """
    s = dt.shape[1]
    q = min(chunk, s)
    h = h0
    ys = []
    for lo in range(0, s, q):
        dtc, bc = dt[:, lo: lo + q], bmat[:, lo: lo + q]
        cc, xc = cmat[:, lo: lo + q], xs[:, lo: lo + q]
        decay = torch.exp(dtc[..., None] * a).to(scan_dtype)    # (B,q,Di,N)
        bx = (dtc[..., None] * bc[:, :, None, :].float()
              * xc[..., None].float()).to(scan_dtype)
        a_cum, inner = _scan(decay, bx)
        h_t = a_cum.float() * h[:, None] + inner.float()        # (B,q,Di,N)
        ys.append(torch.einsum("bqdn,bqn->bqd", h_t, cc.float()))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def _scan_on_kernel(cfg, *operands: Tensor) -> bool:
    """The scan kernel's case: the operands on a CUDA device, no gradient
    wanted through them (the kernel has no backward) and a float32 scan
    (a lower ``ssm_scan_dtype`` is the chunked scan's alone)."""
    return (operands[0].device.type == "cuda"
            and cfg.ssm_scan_dtype == "float32"
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in operands)))


def _split(par) -> bool:
    return par is not None and par.ssm_split


def _in_proj(p, x: Tensor, par) -> tuple[Tensor, Tensor]:
    """(xs, z) of the rank's channels (all of them where they do not
    split)."""
    w = p["in_proj"].to(x.dtype)
    return par.ssm_in(x, w) if _split(par) else (x @ w).chunk(2, dim=-1)


def _x_proj(p, xc: Tensor, par) -> Tensor:
    """xc @ x_proj: over split channels, the partial sums summed over
    ``model`` and replicated into the rank's column-parallel uses."""
    proj = xc @ p["x_proj"].to(xc.dtype)
    return par.enter(par.exit(proj)) if _split(par) else proj


def _out_proj(p, y: Tensor, par) -> Tensor:
    out = y @ p["out_proj"].to(y.dtype)
    return par.exit(out) if _split(par) else out


def _dt_b_c(p, proj: Tensor, cfg) -> tuple[Tensor, Tensor, Tensor]:
    """``x_proj``'s output cut into (dt, B, C), each RMS-normalised where
    ``cfg.ssm_dt_norms`` (Jamba's mixer)."""
    parts = proj.split([cfg.dt_rank, cfg.ssm_state, cfg.ssm_state], dim=-1)
    if not cfg.ssm_dt_norms:
        return parts
    return tuple(rmsnorm(v, p[name], cfg.norm_eps)
                 for v, name in zip(parts, ("dt_norm", "b_norm", "c_norm")))


def ssm_block(p, x: Tensor, cfg, h0: Tensor | None = None,
              conv_init: Tensor | None = None, par=None
              ) -> tuple[Tensor, Tensor, Tensor]:
    """x: (B, S, D) -> (y: (B, S, D), h_final: (B, Di, N), conv_tail).

    ``h0``/``conv_init`` allow stateful chunked prefill; None means zeros.
    Over split channels (``par``), ``h_final`` and ``conv_tail`` are the
    rank's channels.
    """
    dtype = x.dtype
    bsz, s, _ = x.shape
    n, cw = cfg.ssm_state, cfg.ssm_conv

    xs, z = _in_proj(p, x, par)                      # (B, S, Di) each
    conv_w, conv_b = p["conv_w"].to(dtype), p["conv_b"].to(dtype)
    if conv_init is not None:
        xs_ext = torch.cat([conv_init.to(dtype), xs], dim=1)
        xs_conv = _causal_conv(xs_ext, conv_w, conv_b)[:, cw - 1:]
    else:
        xs_conv = _causal_conv(xs, conv_w, conv_b)
    conv_tail = (xs[:, -(cw - 1):] if s >= cw - 1
                 else F.pad(xs, (0, 0, cw - 1 - s, 0)))
    xs_conv = F.silu(xs_conv)

    proj = _x_proj(p, xs_conv, par)                 # (B, S, r + 2N)
    dt_raw, bmat, cmat = _dt_b_c(p, proj, cfg)
    dt = F.softplus((dt_raw @ p["dt_proj"].to(dtype)).float()
                    + p["dt_bias"].float())          # (B, S, Di) float32
    a = -torch.exp(p["a_log"].float())               # (Di, N)

    if h0 is None:
        h0 = torch.zeros(bsz, a.shape[0], n, dtype=torch.float32,
                         device=x.device)
    operands = (dt, a, bmat, cmat, xs_conv, h0)
    if _scan_on_kernel(cfg, *operands):
        y, h_final = ssm_scan.ssm_scan_kernel(
            *(t.contiguous() for t in operands))
    else:
        y, h_final = _ssm_inner(*operands, cfg.ssm_chunk,
                                getattr(torch, cfg.ssm_scan_dtype))
    y = y + xs_conv.float() * p["d_skip"].float()
    y = y.to(dtype) * F.silu(z)
    return _out_proj(p, y, par), h_final, conv_tail


def ssm_decode_step(p, x: Tensor, h: Tensor, conv_state: Tensor, cfg,
                    par=None) -> tuple[Tensor, Tensor, Tensor]:
    """One token.  x: (B, D); h: (B, Di, N) float32; conv_state: (B, cw-1,
    Di) (the rank's channels over a mesh).  Returns (y: (B, D), h',
    conv_state')."""
    dtype = x.dtype

    xs, z = _in_proj(p, x, par)                      # (B, Di)
    window = torch.cat([conv_state.to(dtype), xs[:, None]], dim=1)
    xc = torch.einsum("bcd,cd->bd", window, p["conv_w"].to(dtype)) \
        + p["conv_b"].to(dtype)
    xc = F.silu(xc)
    conv_state_new = window[:, 1:].to(conv_state.dtype)

    proj = _x_proj(p, xc, par)
    dt_raw, bvec, cvec = _dt_b_c(p, proj, cfg)
    dt = F.softplus((dt_raw @ p["dt_proj"].to(dtype)).float()
                    + p["dt_bias"].float())          # (B, Di)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt[..., None] * a)             # (B, Di, N)
    h_new = decay * h + (dt[..., None] * bvec.float()[:, None, :]
                         * xc.float()[..., None])
    y = torch.einsum("bdn,bn->bd", h_new, cvec.float())
    y = y + xc.float() * p["d_skip"].float()
    y = y.to(dtype) * F.silu(z)
    return _out_proj(p, y, par), h_new, conv_state_new
