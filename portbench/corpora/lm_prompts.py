"""Prompts for a language model: token ids drawn uniformly from the
vocabulary, on ``device`` from one ``torch.Generator``.  With random
weights no text is more realistic than another; what a prompt costs is
its length."""

from __future__ import annotations

import torch


class Corpus:
    def __init__(self, params: dict, d: int, gen: torch.Generator,
                 device: torch.device):
        """``d``: the vocabulary's size."""
        self.p = params
        self.vocab = d
        self.gen = gen
        self.device = device

    def draw(self, n: int, length: int) -> torch.Tensor:
        """(n, length) int32 token ids, uniform below the vocabulary's
        size."""
        return torch.randint(0, self.vocab, (n, length), generator=self.gen,
                             device=self.device, dtype=torch.int32)
