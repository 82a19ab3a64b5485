"""Documents -> shingles, and synthetic corpora with planted duplicates."""
