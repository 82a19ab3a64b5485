"""repro_torch — the C-MinHash similarity-search serving path in PyTorch + CUDA.

The second package beside ``repro`` (the JAX reference).  It mirrors the
reference's layout (``core/``, ``kernels/``, ``store/``, ``serve/``, ...)
so each module's counterpart is easy to find, and it imports neither
``jax`` nor anything of ``repro``.  Every TPU kernel on the serving path is
a hand-written CUDA kernel under ``csrc/`` with a plain PyTorch version
beside it in the same module; entry points run on the card by default
(``device="cuda"``) and raise without one.
"""

__version__ = "0.1.0"
