"""Serving front ends: the batched similarity-search service."""
