"""Cross-shard reductions (the serving plane's mergeable top-k)."""
