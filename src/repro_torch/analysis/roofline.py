"""Three-term roofline from dry-run records, and the kernels' bounds.

Per (arch, shape, mesh) cell, every term in per-rank seconds a step:

    compute    = flops a rank / PEAK_FLOPS
    memory     = bytes a rank / HBM_BW
    collective = collective wire bytes a rank / LINK_BW

The counts come from ``analysis.hlo`` over a trace of rank 0's step
(``launch.dryrun``).  MODEL_FLOPS is the reference's formula: 6 N D for
training, 2 N D for a forward pass, N the active parameters (MoE: the
top-k experts only).

The card: NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, every constant
from NVIDIA's data sheet, none measured here:
    989.4 TFLOP/s dense bf16; 3.35 TB/s HBM; 80 GB of HBM;
    NVLink 900 GB/s a card, 450 GB/s each way, to the cards of its host;
    400 Gb/s (50 GB/s) of network a card between hosts.
A 256- or 512-rank mesh spans many 8-card hosts, so its collectives are
charged against the network link, one card's 50 GB/s (conservative: a
model axis inside one host would ride NVLink).  These are datasheet
estimates, not card timings.

``kernel_bound`` is the least time the card could take for a kernel's
work: the larger of its bytes over HBM_BW and its integer operations over
INT32_OPS (64 integer lanes an SM, 132 SMs, at the 1.98 GHz boost clock);
``cminhash_kernel_roofline`` counts that work for the dense signing
kernels as the port's kernels do it.
"""

from __future__ import annotations

import glob
import json
import os

PEAK_FLOPS = 989.4e12   # bf16 dense, a card
HBM_BW = 3.35e12        # bytes/s a card
LINK_BW = 50e9          # bytes/s a card between hosts (400 Gb/s)
NVLINK_BW = 450e9       # bytes/s a card each way within a host
HBM_PER_CHIP = 80e9     # bytes of HBM a card
INT32_OPS = 132 * 64 * 1.98e9   # integer operations/s a card


def model_flops(rec: dict) -> float:
    """The reference's definition, on the whole (global) step."""
    n = rec["active_params"]
    if rec["kind"] == "train":
        tokens = rec["global_batch"] * rec["seq_len"]
        return 6.0 * n * tokens
    if rec["kind"] == "prefill":
        tokens = rec["global_batch"] * rec["seq_len"]
        return 2.0 * n * tokens
    return 2.0 * n * rec["global_batch"]     # decode: one token per sequence


def roofline(rec: dict) -> dict:
    """The three terms and the bottleneck of one dry-run record."""
    hc = rec["hlo_cost"]
    chips = rec["n_chips"]
    compute_s = hc["flops"] / PEAK_FLOPS
    memory_s = hc["bytes"] / HBM_BW
    collective_s = hc["collective_bytes"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    useful = mf / (hc["flops"] * chips) if hc["flops"] else 0.0
    bound = max(terms.values())
    # the share of the roofline this step reaches if it ran exactly at the
    # dominant term (ideal overlap of the other two)
    step_ideal = mf / chips / PEAK_FLOPS   # time if compute were all useful
    frac = step_ideal / bound if bound > 0 else 0.0
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": mf, "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "hbm_args_frac": rec["memory"]["argument_bytes"] / HBM_PER_CHIP,
    }


def load_records(dirpath: str, mesh: str | None = None) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        recs.append(rec)
    return recs


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def report_markdown(dirpath: str, mesh: str = "single_pod") -> str:
    """Roofline table (single pod by default) and the dry run's status
    table."""
    recs = load_records(dirpath)
    lines = []

    lines.append(f"### Dry-run status ({len(recs)} cells)\n")
    lines.append("| mesh | arch | shape | status | compile | bytes/dev (args) | note |")
    lines.append("|---|---|---|---|---|---|---|")
    for r in recs:
        if r["status"] == "ok":
            note = (f"flops/dev {r['hlo_cost']['flops']:.2e}, "
                    f"coll {r['hlo_cost']['collective_bytes']:.2e} B")
            mem = f"{r['memory']['argument_bytes'] / 1e9:.2f} GB"
            comp = f"{r['compile_s']:.0f}s"
        elif r["status"] == "skipped":
            note, mem, comp = r["reason"], "-", "-"
        else:
            note, mem, comp = r.get("error", "?")[:80], "-", "-"
        lines.append(f"| {r['mesh']} | {r['arch']} | {r['shape']} | "
                     f"{r['status']} | {comp} | {mem} | {note} |")

    lines.append(f"\n### Roofline ({mesh}, per chip per step)\n")
    lines.append("| arch | shape | compute | memory | collective | dominant | "
                 "MODEL_FLOPS | useful ratio | roofline frac |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        t = roofline(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['model_flops']:.2e} | "
            f"{t['useful_flops_ratio']:.2f} | {t['roofline_fraction']:.2f} |")
    return "\n".join(lines)


def kernel_bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``n_bytes`` (each input read once, each output written
    once) and do ``n_ops`` integer operations, and which of the two bounds
    it."""
    t_bytes = n_bytes / HBM_BW
    t_ops = n_ops / INT32_OPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cminhash_kernel_roofline(b: int, d: int, k: int, *,
                             nnz: float | None = None, packed: bool = False,
                             n_out: int | None = None) -> dict:
    """Roofline of the dense signing kernels as the port runs them
    (``csrc/cminhash_dense.cu``, ``csrc/cminhash_packed.cu``): B rows of D
    positions, ``nnz`` set positions a row (D when None: every position
    set), K hashes, ``n_out`` int32 outputs a row (K; fewer with the pack
    epilogue).

    Bytes: the rows read once (a byte a position, or a bit packed 32 to a
    word), pi read once (the kernels stage it once a resident block, from
    L2), the outputs written once.  Operations: a min for each set position
    and hash, plus the scan for set positions: a compare a position (int8)
    or a word (packed)."""
    nnz = d if nnz is None else nnz
    n_out = k if n_out is None else n_out
    nw = -(-d // 32)
    rows = b * nw * 4 if packed else b * d
    bytes_ = rows + d * 4 + b * n_out * 4
    ops = b * nnz * k + (b * nw if packed else b * d)
    compute_s = ops / INT32_OPS
    memory_s = bytes_ / HBM_BW
    bound_s, bound_by = kernel_bound(bytes_, ops)
    return {
        "ops": ops, "bytes": bytes_,
        "compute_s": compute_s, "memory_s": memory_s,
        "dominant": "compute" if compute_s >= memory_s else "memory",
        "arith_intensity": ops / bytes_,
        "bound_s": bound_s, "bound_by": bound_by,
    }


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun")
    ap.add_argument("--mesh", default="single_pod")
    args = ap.parse_args()
    print(report_markdown(args.dir, args.mesh))


if __name__ == "__main__":
    main()
