"""The work of a Jamba language model's serving step, from its published
sizes (the configuration's ``config.json`` keys): the model FLOPs of a
``generate`` call, and the least bytes a decode step moves.  The readers
of ``lm_mfu`` and ``lm_decode_roofline`` divide these by the card's peaks.

FLOPs count two a multiply-add: every weight product a token goes
through (the router, its top-k experts, not the others), attention's
scores and values over the positions it sees (causal: a prompt of S
positions sees S (S + 1) / 2 pairs), the depthwise conv, and the Mamba
recurrence's three multiply-adds a state element (decay times h, delta B
times x, C times h).  The head runs on the last prompt position and on
each decode step's token only, as the program's prefill and decode run
it.  Elementwise work (norms, activations, softmax) is left out.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (80 GB HBM3) dense bf16 tensor-core rate, NVIDIA's H100
# data sheet (989.4 TFLOP/s without sparsity), at the 700 W limit.
BF16_FLOPS_PER_S = 989.4e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _sizes(spec: dict) -> dict:
    d, h = spec["hidden_size"], spec["num_attention_heads"]
    return {"d": d, "h": h, "kv": spec["num_key_value_heads"],
            "hd": spec.get("head_dim") or d // h,
            "f": spec["intermediate_size"], "e": spec["num_experts"],
            "k": spec["num_experts_per_tok"],
            "di": spec["mamba_expand"] * d, "n": spec["mamba_d_state"],
            "r": spec["mamba_dt_rank"], "cw": spec["mamba_d_conv"],
            "v": spec["vocab_size"]}


def layers(spec: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of each layer: ("attn" | "ssm", "moe" | "mlp")."""
    return [("attn" if i % spec["attn_layer_period"]
             == spec["attn_layer_offset"] else "ssm",
             "moe" if i % spec["expert_layer_period"]
             == spec["expert_layer_offset"] else "mlp")
            for i in range(spec["num_hidden_layers"])]


def _weights(spec: dict) -> dict:
    """Weights of one layer of each kind, and of the head."""
    s = _sizes(spec)
    d, di, n, r = s["d"], s["di"], s["n"], s["r"]
    return {
        "attn": d * s["h"] * s["hd"] * 2 + 2 * d * s["kv"] * s["hd"],
        # in_proj, x_proj, dt_proj, out_proj; conv (w, b), dt_bias, A_log,
        # D and the dt/B/C norms beside them
        "ssm_mm": 2 * d * di + di * (r + 2 * n) + r * di + di * d,
        "ssm_rest": s["cw"] * di + 3 * di + di * n + r + 2 * n,
        "expert": 3 * d * s["f"], "router": d * s["e"],
        "mlp": 3 * d * s["f"], "norms": 2 * d, "head": d * s["v"],
    }


def token_flops(spec: dict, context: int) -> float:
    """FLOPs of one token through every layer, attending to ``context``
    positions, without the head."""
    s, w = _sizes(spec), _weights(spec)
    total = 0.0
    for mixer, ffn in layers(spec):
        if mixer == "attn":
            total += 2 * w["attn"] + 4 * s["h"] * s["hd"] * context
        else:
            total += 2 * w["ssm_mm"] + 2 * s["cw"] * s["di"] \
                + 6 * s["di"] * s["n"]
        total += 2 * (s["k"] * w["expert"] + w["router"]) if ffn == "moe" \
            else 2 * w["mlp"]
    return total


def generate_flops(spec: dict, batch: int, prompt_len: int,
                   new_tokens: int) -> float:
    """Model FLOPs of ``generate``: the prompt (every position, the head
    at the last), then ``new_tokens - 1`` decode steps of one token a
    row."""
    head = 2 * _weights(spec)["head"]
    s, per_row = prompt_len, 0.0
    n_attn = sum(m == "attn" for m, _ in layers(spec))
    sz = _sizes(spec)
    # the prompt: token flops at context 0, then the causal pairs
    per_row += s * token_flops(spec, 0) + head \
        + n_attn * 4 * sz["h"] * sz["hd"] * s * (s + 1) / 2
    for j in range(new_tokens - 1):
        per_row += token_flops(spec, s + j + 1) + head
    return batch * per_row


def decode_step_bytes(spec: dict, batch: int, context: float,
                      experts_hit: float) -> float:
    """The least bytes of one decode step: every weight but the experts
    and the embedding table, read once (in the configuration's
    ``dtype``); ``experts_hit`` experts' weights (summed over the MoE
    layers); the batch's embedding rows; each attention layer's K and V
    over ``context`` positions; each Mamba layer's state (float32 ``h``
    and the conv window) read and written."""
    s, w = _sizes(spec), _weights(spec)
    wb = BYTES[spec.get("dtype", "bfloat16")]
    kinds = layers(spec)
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_ssm = len(kinds) - n_attn
    weights = w["head"] + len(kinds) * w["norms"] + s["d"]   # final norm
    for mixer, ffn in kinds:
        weights += w["attn"] if mixer == "attn" \
            else w["ssm_mm"] + w["ssm_rest"]
        weights += w["router"] if ffn == "moe" else w["mlp"]
    weights += experts_hit * w["expert"] + batch * s["d"]
    kv = n_attn * batch * context * 2 * s["kv"] * s["hd"] * wb
    state = n_ssm * batch * 2 * (s["di"] * s["n"] * 4
                                 + (s["cw"] - 1) * s["di"] * wb)
    return weights * wb + kv + state
