"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each kernel module holds a plain version and a wrapper: the wrapper runs the
plain version for a CPU tensor and launches the CUDA kernel for a CUDA
tensor, or raises.  ``dispatch`` is the front door the engine and the store
call.
"""


def all_kernels() -> dict:
    """Every CUDA kernel's wrapper (``_build.CudaKernel``), by kernel name:
    the one list of the port's kernels, read wherever launches are
    counted."""
    from . import (cminhash_kernel, cminhash_packed, cminhash_sparse,
                   collision_kernel, lsh_probe, query_fused, ssm_scan,
                   topk_select)
    ks = (cminhash_sparse.KERNEL, query_fused.KERNEL, lsh_probe.KERNEL,
          collision_kernel.KERNEL, cminhash_kernel.KERNEL,
          cminhash_packed.KERNEL, topk_select.KERNEL, ssm_scan.KERNEL)
    return {k.name: k for k in ks}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel in this process so far, by kernel name:
    the wrappers' own counts (``_build.CudaKernel.launches``).  A shard
    worker reports them in its STATS reply, so a coordinator can show its
    workers' launches."""
    return {name: k.launches for name, k in all_kernels().items()}
