"""Shapes small enough for the CPU tests: each cell's configuration and
traffic cut down, its structure (clusters, near-copy share, banding,
b) kept."""

TINY = {
    "web_crawl_mixed": {
        "config": {"index_sets": 768, "ingest_batch": 256},
        "traffic": {"batch": 96, "pool_batches": 2,
                    "check_rows_per_batch": 48, "profile_steps": 2},
    },
    "ml10m_knn": {
        "config": {"index_sets": 512, "ingest_batch": 256,
                   "corpus": {"size_max": 160}},
        "traffic": {"batch": 32, "profile_steps": 2},
    },
}


def overrides(cell: str, **program) -> dict:
    """The tiny overrides of ``cell``; ``program`` SearchConfig fields
    the service runs with."""
    out = dict(TINY[cell])
    if program:
        out["program"] = program
    return out
