"""The plain reference of a Jamba language model: the full forward pass
of AI21's Jamba layer equations in float32 with plain ``torch``, no cache
and no batching tricks.  It imports nothing of the program; the CPU tests
in ``tests/`` use this same file.

``spec`` holds the model's sizes under the keys of the published
``config.json`` (``hidden_size``, ``num_attention_heads``, ...; a
``head_dim`` of None or none at all is ``hidden_size /
num_attention_heads``).  The
weights come as nested ``params[...]`` lookups with the program's
layout (``embed`` (V, D), ``lm_head`` (D, V), ``layers[i]["attn"]["wq"]``
(D, H, hd), ...): on the card the reference reads the program's own
weights and upcasts each where it is used, one layer (one expert) at a
time, so it fits beside them.

Layer ``i``, on the residual ``x``:

    x += Mixer_i(RMSNorm(x));  x += FFN_i(RMSNorm(x))

and after the last layer a final RMSNorm and the untied head.  The mixer
is causal GQA attention without positional encoding (``softmax(q k^T /
sqrt(hd))``, no biases) where ``i % attn_layer_period ==
attn_layer_offset``, else Mamba-1: ``x, z = in_proj(u)``; ``x =
silu(conv1d_causal(x) + b)``; ``dt, B, C = split(x_proj(x))``, each
RMS-normalised; ``delta = softplus(dt_proj(dt) + b_dt)``, ``A =
-exp(A_log)``; ``h_t = exp(delta A) h_{t-1} + delta B_t x_t`` one position
after another; ``y = (C_t h_t + D x_t) silu(z)``; ``out_proj(y)``.  The FFN
is a mixture of experts where ``i % expert_layer_period ==
expert_layer_offset``: ``p = softmax(router(u))`` in float32, the top
``num_experts_per_tok`` kept (ties to the lower expert id), their gates
not renormalised (transformers' ``JambaSparseMoeBlock``), ``sum_k p_k
down(silu(gate(u)) * up(u))`` with no token dropped; elsewhere a dense
SwiGLU.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@contextlib.contextmanager
def full_float32():
    """float32 products in float32: on a card TF32 is off inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _f(w: Tensor) -> Tensor:
    return w.detach().float()


def rmsnorm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(w)


def attention(p, u: Tensor, spec: dict) -> Tensor:
    """Causal GQA without positional encoding.  u: (B, S, D)."""
    b, s, d = u.shape
    h, kv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd = spec.get("head_dim") or d // h
    q = (u @ _f(p["wq"]).reshape(d, -1)).reshape(b, s, h, hd)
    k = (u @ _f(p["wk"]).reshape(d, -1)).reshape(b, s, kv, hd)
    v = (u @ _f(p["wv"]).reshape(d, -1)).reshape(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    return out @ _f(p["wo"]).reshape(h * hd, d)


def mamba(p, u: Tensor, spec: dict) -> Tensor:
    """Mamba-1 with RMS-normalised dt, B and C; the recurrence one
    position at a time.  u: (B, S, D)."""
    b, s, _ = u.shape
    n, r = spec["mamba_d_state"], spec["mamba_dt_rank"]
    eps = spec["rms_norm_eps"]
    x, z = (u @ _f(p["in_proj"])).chunk(2, dim=-1)        # (B, S, Di)
    w = _f(p["conv_w"])                                   # (cw, Di)
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    x = sum(xp[:, j: j + s] * w[j] for j in range(cw)) + _f(p["conv_b"])
    x = F.silu(x)
    dt, bm, cm = (x @ _f(p["x_proj"])).split([r, n, n], dim=-1)
    dt = rmsnorm(dt, p["dt_norm"], eps)
    bm = rmsnorm(bm, p["b_norm"], eps)
    cm = rmsnorm(cm, p["c_norm"], eps)
    delta = F.softplus(dt @ _f(p["dt_proj"]) + _f(p["dt_bias"]))
    a = -torch.exp(_f(p["a_log"]))                        # (Di, N)
    h = torch.zeros(b, x.shape[-1], n, device=u.device)
    ys = []
    for t in range(s):
        h = torch.exp(delta[:, t, :, None] * a) * h \
            + delta[:, t, :, None] * bm[:, t, None, :] * x[:, t, :, None]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, dim=1) + _f(p["d_skip"]) * x) * F.silu(z)
    return y @ _f(p["out_proj"])


def swiglu(u: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    return (F.silu(u @ _f(wg)) * (u @ _f(wu))) @ _f(wd)


def route(p, u: Tensor, spec: dict) -> tuple[Tensor, Tensor]:
    """(gates, expert ids), each (T, k), of the rows of u (T, D): the
    largest router probabilities first, the lower id first on a tie."""
    probs = torch.softmax(u @ _f(p["router"]), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = spec["num_experts_per_tok"]
    return gates[:, :k], ids[:, :k]


def route_margin(p, u: Tensor, spec: dict) -> Tensor:
    """(T,) how far the k-th largest router log-probability of each row
    of u (T, D) lies above the next: the room a selection has before
    another rounding of the router would change it."""
    probs = torch.softmax(u @ _f(p["router"]), dim=-1)
    top = probs.topk(spec["num_experts_per_tok"] + 1, dim=-1).values
    return torch.log(top[:, -2]) - torch.log(top[:, -1])


def experts(p, u: Tensor, spec: dict) -> Tensor:
    """The mixture of experts on u (B, S, D): every token through each of
    its top-k experts, weighted by its gate."""
    flat = u.reshape(-1, u.shape[-1])
    gates, ids = route(p, flat, spec)
    y = torch.zeros_like(flat)
    for e in range(spec["num_experts"]):
        hit = ids == e                                    # (T, k)
        rows = hit.any(dim=1).nonzero()[:, 0]
        if len(rows):
            g = (gates * hit).sum(dim=1)[rows, None]
            y[rows] += g * swiglu(flat[rows], p["e_gate"][e], p["e_up"][e],
                                  p["e_down"][e])
    return y.reshape(u.shape)


def logits(params, spec: dict, tokens: Tensor,
           positions: Tensor | None = None,
           layer_io: list | None = None) -> Tensor:
    """tokens: (B, S) int -> the float32 logits (B, P, V) at
    ``positions`` (P of the S; all of them where None).  ``layer_io``,
    where given, gains (i, kind, u, y) for the Mamba mixer (kind "ssm")
    and the mixture of experts ("moe") of each layer i that has one: its
    input u (B, S, D), the normalised residual, and its output y."""
    eps = spec["rms_norm_eps"]
    with torch.no_grad(), full_float32():
        x = _f(params["embed"][tokens.long()])
        for i in range(spec["num_hidden_layers"]):
            lp = params["layers"][i]
            u = rmsnorm(x, lp["ln1"], eps)
            if i % spec["attn_layer_period"] == spec["attn_layer_offset"]:
                x = x + attention(lp["attn"], u, spec)
            else:
                y = mamba(lp["ssm"], u, spec)
                if layer_io is not None:
                    layer_io.append((i, "ssm", u, y))
                x = x + y
            u = rmsnorm(x, lp["ln2"], eps)
            if i % spec["expert_layer_period"] \
                    == spec["expert_layer_offset"]:
                y = experts(lp["moe"], u, spec)
                if layer_io is not None:
                    layer_io.append((i, "moe", u, y))
                x = x + y
            else:
                m = lp["mlp"]
                x = x + swiglu(u, m["w_gate"], m["w_up"], m["w_down"])
        if positions is not None:
            x = x[:, positions]
        x = rmsnorm(x, params["final_norm"], eps)
        head = params["embed"].T if spec["tie_word_embeddings"] \
            else params["lm_head"]
        return x @ _f(head)
