"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface: ``<name>_launch(...)``
enqueues the kernel on the stream it is given and returns
``cudaGetLastError()``; ``<name>_error(code)`` names an error code.  No
PyTorch header is included, so a source builds in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<digest>.so csrc/<name>.cu

The build happens at first use, from the sources in the checkout, into
``src/repro_torch/build/`` (listed in ``.gitignore``).  The file name
carries a digest of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header never loads a stale library; each build writes a temporary file and renames it,
so processes that race produce the same library.  ``build()`` starts one
nvcc per source together and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("cminhash_sparse", "fold", "lsh_probe", "collision",
           "cminhash_dense", "cminhash_packed", "topk_select")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand, "bin", "nvcc")
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a digest of the source, every header
    in ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, one nvcc
    each, all started together.  Returns ``{name: {"path", "seconds",
    "cached", "log"}}``; raises with nvcc's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = {"path": str(lib), "seconds": 0.0, "cached": True,
                         "log": ""}
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": str(lib), "seconds": time.perf_counter() - t0,
                     "cached": False, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One kernel's C entry point, bound lazily, with its launch count.

    ``launches`` goes up by one for every launch the card accepted, and
    nowhere else: it is how a run shows that a path went through the
    kernel.  A launch the runtime refuses raises ``RuntimeError``.
    The entry point is ``<name>_launch`` in the library built from
    ``csrc/<source>.cu`` (``source`` defaults to ``name``; a source may
    hold several entry points, each with its own count) and its errors are
    named by ``<source>_error``.  ``library`` binds an already built
    library instead of building the checkout's source (to time another
    version behind the same wrapper)."""

    def __init__(self, name: str, argtypes: list, library: str | None = None,
                 *, source: str | None = None):
        self.name = name
        self.source = source or name
        self.argtypes = argtypes
        self.library = library
        self.launches = 0
        self._lib = None
        self._fn = None
        self._err = None

    def _bind(self) -> None:
        path = self.library or build([self.source])[self.source]["path"]
        lib = self._lib = ctypes.CDLL(path)
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]     # + stream
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def entry(self, suffix: str, argtypes: list, restype=None):
        """Another C function of the kernel's library, ``<name>_<suffix>``
        (a test entry point such as ``force_placement``)."""
        if self._fn is None:
            self._bind()
        fn = getattr(self._lib, f"{self.name}_{suffix}")
        fn.argtypes, fn.restype = argtypes, restype
        return fn

    def launch(self, device: torch.device, *args) -> None:
        """Enqueue on ``device``'s current stream; no synchronisation."""
        if self._fn is None:
            self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = self._fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{code} ({self._err(code).decode()})")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                       ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``device`` (what every kernel's C interface assumes)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D (got shape "
                         f"{tuple(t.shape)})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
