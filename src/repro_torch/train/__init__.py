"""LM training on one device: AdamW, checkpoints in the JAX package's layout,
the fault-tolerant loop."""
