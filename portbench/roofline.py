"""The yardstick's peaks and the work a kernel's inputs need.

A roofline share is the least time the card could take for the work these
inputs need, divided by the kernel's measured device time: the least time
is the larger of operations / the int32 rate and bytes / the memory
bandwidth.  The counts are made from the inputs (real rows and entries,
not padding), so a later kernel doing the same work is read against the
same bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (the part whose name ends in "HBM3"), at its
# 700 W limit.  Bandwidth: NVIDIA's H100 data sheet (3.35 TB/s).  The
# int32 rate is derived, not published as a rate: 132 SMs x 64 INT32 lanes
# an SM (NVIDIA H100 Tensor Core GPU Architecture whitepaper) x 1.98 GHz
# boost clock.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int32_ops_per_s": 132 * 64 * 1.98e9,
        "bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM5 data sheet (3.35 TB/s HBM3); int32 "
                  "rate derived: 132 SMs x 64 INT32 lanes x 1.98 GHz "
                  "(H100 architecture whitepaper)",
    },
}


def peaks(device_name: str) -> dict | None:
    """The card's peaks, or None for a card the table does not hold (its
    rooflines then stay silent)."""
    return PEAKS.get(device_name)


def least_s(ops: float, n_bytes: float, peak: dict) -> float:
    """The least time for ``ops`` int32 operations and ``n_bytes`` moved."""
    return max(ops / peak["int32_ops_per_s"], n_bytes / peak["bytes_per_s"])


def words_per_row(k: int, b: int) -> int:
    """uint32 words of one stored signature: K codes of b bits."""
    return -(-k // (32 // b))


def collision_work(rows: int, index_rows: int, k: int, b: int
                   ) -> tuple[float, float]:
    """Brute-force scoring of ``rows`` real query rows against the whole
    index: one compare a stored word pair (a word holds 32 / b codes), and
    the query words, the index words and the (rows, index_rows) int32
    counts each moved once."""
    w = words_per_row(k, b)
    ops = rows * index_rows * w
    n_bytes = 4 * (rows * w + index_rows * w + rows * index_rows)
    return float(ops), float(n_bytes)


def sign_work(entries: int, rows: int, d: int, k: int, b: int
              ) -> tuple[float, float]:
    """Signing ``rows`` sets of ``entries`` real entries in all: K table
    reads an entry; the entries, the (D,) table and the packed words out
    each moved once."""
    ops = entries * k
    n_bytes = 4 * (entries + d + rows * words_per_row(k, b))
    return float(ops), float(n_bytes)
