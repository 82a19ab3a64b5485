"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each kernel module holds a plain version and a wrapper: the wrapper runs the
plain version for a CPU tensor and launches the CUDA kernel for a CUDA
tensor, or raises.  ``dispatch`` is the front door the engine and the store
call.
"""
