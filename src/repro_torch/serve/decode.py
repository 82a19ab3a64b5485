"""Batched autoregressive generation on top of the model bundles.

A PyTorch copy of ``repro.serve.decode``: prefill the prompt batch, then a
Python loop of ``decode_step`` (the reference runs the loop as one
``lax.scan``).  Greedy decoding is the reference's token for token.
Sampling (``temperature > 0``) draws from a ``torch.Generator`` seeded by
``seed``, which cannot reproduce ``jax.random.categorical``'s draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

Tensor = torch.Tensor


def sample_token(logits: Tensor, gen: torch.Generator | None,
                 temperature: float) -> Tensor:
    """(B, V) logits -> (B,) int32: the argmax (the first on a tie, as
    ``jnp.argmax``) at ``temperature <= 0``, else a draw from
    softmax(logits / temperature)."""
    if temperature <= 0:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def generate(bundle, params, batch: dict, *, max_new_tokens: int,
             temperature: float = 0.0, seed: int = 0) -> np.ndarray:
    """Prefill the prompt batch and decode ``max_new_tokens`` tokens.

    Returns (B, max_new_tokens) int32 numpy, as the reference: the token
    sampled from the prompt's logits, then one a decode step ((B, 0) at
    ``max_new_tokens=0``, with no prefill).  The reference also runs a last
    step whose token it drops; that step is not run here.  Nothing waits
    for the card until the tokens come back.
    """
    dev = resolve_device(bundle.device)
    prompt_len = batch["tokens"].shape[1]
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0 (got {max_new_tokens})")
    if max_new_tokens == 0:
        return np.zeros((len(batch["tokens"]), 0), np.int32)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if temperature > 0 else None)
    with torch.no_grad():
        logits, cache = bundle.prefill(params, batch,
                                       max_len=prompt_len + max_new_tokens)
        toks = [sample_token(logits, gen, temperature)]
        for _ in range(max_new_tokens - 1):
            logits, cache = bundle.decode_step(params, cache, toks[-1])
            toks.append(sample_token(logits, gen, temperature))
    return torch.stack(toks, dim=1).cpu().numpy()
