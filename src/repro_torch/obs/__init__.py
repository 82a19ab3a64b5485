"""Metrics registry and trace spans: the subset of ``repro.obs`` the serving
path calls, with the same metric names."""
