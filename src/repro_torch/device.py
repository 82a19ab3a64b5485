"""Device selection and the integer views the port carries across devices.

Every entry point takes an explicit ``device``.  ``"cuda"`` is the default
everywhere and raises when no card is present: the port never moves to the
CPU on its own.  ``device="cpu"`` runs each kernel's plain PyTorch version
instead (what the CPU tests ask for).

torch has few unsigned integer ops, so the port carries uint32 words as
int32 tensors and uint64 band hashes as int64 tensors with the same bits.
The helpers below convert at the host boundary with ``numpy .view``.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu (got {device!r})")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


def resolve_or_meta(device: str | torch.device) -> torch.device:
    """``resolve_device``, or the meta device: shapes and dtypes with no
    storage (``launch.specs``)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def u32_to_device(words, device: torch.device) -> torch.Tensor:
    """Host uint32 array (any int array of uint32 values) -> int32 tensor
    with the same bits on ``device`` (always a copy)."""
    a = np.ascontiguousarray(np.asarray(words).astype(np.uint32, copy=False))
    return torch.tensor(a.view(np.int32), device=device)


def u32_to_host(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 bits -> host uint32 array (a copy; waits for
    the device work that produces ``t``)."""
    return np.array(t.detach().cpu().numpy(), copy=True).view(np.uint32)


def as_device_words(words, device: torch.device) -> torch.Tensor:
    """Packed words (a tensor or a host array) as an int32 tensor on
    ``device``; a tensor already there is not copied."""
    if isinstance(words, torch.Tensor):
        return words.to(device)
    return u32_to_device(words, device)


def as_host_words(words) -> np.ndarray:
    """Packed words as a host uint32 array (tensor or array in)."""
    if isinstance(words, torch.Tensor):
        return u32_to_host(words)
    return np.asarray(words, np.uint32)


def as_host_sigs(sigs) -> np.ndarray:
    """Raw (B, K) signatures (a tensor or a host array) as a host array."""
    if isinstance(sigs, torch.Tensor):
        return sigs.detach().cpu().numpy()
    return np.asarray(sigs)


def take_rows(words, rows: np.ndarray):
    """``words[rows]`` for a host array, or a tensor indexed on its own
    device (the row indices go there, the rows stay)."""
    if isinstance(words, torch.Tensor):
        return words[torch.from_numpy(np.asarray(rows, np.int64))
                     .to(words.device)]
    return words[rows]
