"""Batched autoregressive generation on top of the model bundles.

A PyTorch copy of ``repro.serve.decode``: prefill the prompt batch, then a
Python loop of ``decode_step`` (the reference runs the loop as one
``lax.scan``).  Greedy decoding is the reference's token for token.
Sampling (``temperature > 0``) draws from a ``torch.Generator`` seeded by
``seed``, which cannot reproduce ``jax.random.categorical``'s draws.

Over a mesh ``generate`` is collective: every rank calls it with the same
host batch and its own slices of the parameters, and every rank gets the
whole (B, max_new_tokens) back (see ``generate``).

Spans (the default tracer; a call is a trace of its own): ``lm.generate``
(tags ``batch``, ``prompt_len``, ``new_tokens``) over ``lm.prefill`` (the
prompt and the first token) and ``lm.decode`` (the other tokens, tag
``steps``; it closes once the tokens are on the host).  These are the
host's launches: nothing waits for the card before the tokens' copy, so
the host may enter ``lm.decode`` while the card still runs the prompt.
The card's times come from CUDA events, read after
the tokens' copy to the host (no wait of their own), so they land on
the spans still open then: ``lm.decode`` gets ``device_ms`` and
``lm.generate`` ``prefill_device_ms`` (the prompt and the first token).
With dropless experts, ``lm.generate`` gets ``max_load`` (the most
assignments one expert took in one layer of the prompt) and
``lm.decode`` ``experts_hit`` (the expert weights a decode step read,
over all MoE layers, on average), from the cache's counters, read with
the tokens.  On a CUDA device ``lm.generate`` gets ``ssm_scan_launches``,
the scan kernel's launches over the call (one a Mamba layer of the
prompt), from the wrapper's host count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import collectives as col
from ..distributed import sharding
from ..kernels import ssm_scan
from ..obs import trace as obs_trace

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
             temperature: float = 0.0, seed: int = 0,
             mesh=None, keep_logits: bool = False):
    """Prefill the prompt batch and decode ``max_new_tokens`` tokens.

    Returns (B, max_new_tokens) int32 numpy, as the reference: the token
    sampled from the prompt's logits, then one a decode step ((B, 0) at
    ``max_new_tokens=0``, with no prefill).  The reference also runs a last
    step whose token it drops; that step is not run here.  Nothing waits
    for the card until the tokens come back.

    With ``mesh`` the call is collective: every rank passes the same host
    ``batch`` and its slices of the parameters (``sharding.shard_tree``),
    takes its rows (``sharding.batch_shardings``: split over the batch
    axes where they divide B, else replicated), and runs prefill (``tp``
    the mesh's ``model`` axis) and each decode step over the mesh, the
    vocab-split logits gathered before sampling.  Split rows' tokens are
    all-gathered over the batch axes at the end (one counted all-gather;
    none where the rows are replicated, and none at ``max_new_tokens=0``),
    so every rank returns the whole batch's tokens.

    ``keep_logits``: return (tokens, logits), the logits each token was
    chosen from as a (B, max_new_tokens, V) float32 tensor on the device.
    """
    dev = resolve_device(bundle.device)
    prompt_len = batch["tokens"].shape[1]
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0 (got {max_new_tokens})")
    if max_new_tokens == 0:
        return np.zeros((len(batch["tokens"]), 0), np.int32)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if temperature > 0 else None)
    tp, split = 1, False
    if mesh is not None:
        from ..data.loader import device_placer
        split = sharding.batch_shardings(batch, mesh)["tokens"].spec[0] \
            is not None
        batch = device_placer(mesh, sharding.batch_shardings)(batch)
        tp = sharding.mesh_shape(mesh).get("model", 1)
    tracer = obs_trace.default()
    steps = max_new_tokens - 1
    scans = ssm_scan.KERNEL.launches
    with tracer.span("lm.generate") as root, torch.no_grad():
        root.tag("batch", len(batch["tokens"])).tag(
            "prompt_len", prompt_len).tag("new_tokens", max_new_tokens)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if root.sampled and dev.type == "cuda" else None
        with tracer.child("lm.prefill"):
            _record(events, 0)
            logits, cache = bundle.prefill(params, batch, mesh=mesh, tp=tp,
                                           max_len=prompt_len + max_new_tokens)
            toks = [sample_token(logits, gen, temperature)]
            _record(events, 1)
            kept = [logits.float()] if keep_logits else None
            load = cache["expert_load"].clone() \
                if root.sampled and "expert_load" in cache else None
        with tracer.child("lm.decode") as dec:
            for _ in range(steps):
                logits, cache = bundle.decode_step(params, cache, toks[-1],
                                                   mesh=mesh)
                toks.append(sample_token(logits, gen, temperature))
                if keep_logits:
                    kept.append(logits.float())
            _record(events, 2)
            out = torch.stack(toks, dim=1)
            if split:
                out = col.all_gather(out, mesh, sharding.batch_axes(mesh), 0)
            out = out.cpu().numpy()
            dec.tag("steps", steps)
            if events is not None:
                dec.tag("device_ms", events[1].elapsed_time(events[2]))
            if load is not None and steps:
                dec.tag("experts_hit",
                        int(cache["expert_hits"].sum()) / steps)
        if events is not None:
            root.tag("prefill_device_ms",
                     events[0].elapsed_time(events[1]))
        if load is not None:
            root.tag("max_load", int(load.max()))
        if dev.type == "cuda":
            root.tag("ssm_scan_launches", ssm_scan.KERNEL.launches - scans)
    if keep_logits:
        return out, torch.stack(kept, dim=1)
    return out


def _record(events: list | None, i: int) -> None:
    if events is not None:
        events[i].record()
