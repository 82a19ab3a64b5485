"""Padded rows of sets: int32 (n, width) tensors, each row's entries
first and -1 after them."""

from __future__ import annotations

import torch


def unique_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, w) int32 entries (-1 = none, others below 2^31 - 1) -> (n, w)
    int32: each row's distinct entries ascending, -1 after them."""
    x = x.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    s = torch.where(x < 0, big, x).sort(dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.where(dup, big, s).sort(dim=1).values
    return torch.where(s == big, -1, s)


def lengths(x: torch.Tensor) -> torch.Tensor:
    """(n,) int64 number of entries of each row."""
    return (x >= 0).sum(dim=1)


def trimmed(x: torch.Tensor) -> torch.Tensor:
    """``x`` without its trailing all-padding columns."""
    width = int(lengths(x).max()) if len(x) else 0
    return x[:, :width]


def cat(parts: list[torch.Tensor]) -> torch.Tensor:
    """Rows of ``parts`` one after another, padded to the widest."""
    parts = [p for p in parts if len(p)] or parts[:1]
    width = max(p.shape[1] for p in parts)
    return torch.cat([torch.nn.functional.pad(p, (0, width - p.shape[1]),
                                              value=-1) for p in parts])
