"""The port's benchmark harness (see README.md): cells, traffic, metric
readers and the plain reference that decides ``correct``."""
