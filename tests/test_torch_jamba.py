"""AI21-Jamba2-Mini on the port's LM path, on the CPU, against the plain
reference ``portbench/references/jamba_lm.py`` (the benchmark's own, so
there is no second copy to drift).

Tiny widths: one period of 8 layers, d_model 64, 4 experts top-2, seeded
weights, float32.  Tolerances: 1e-4 on every logit (observed <= 1e-5: the
port's chunked scan and grouped products sum in other orders than the
reference's plain loops); the no-RoPE test 1e-5 (the same sums over
permuted keys).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, all_configs, get_config, reduced
from repro_torch.models import build, moe, transformer
from repro_torch.obs import trace
from repro_torch.serve.decode import generate

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from portbench.references import jamba_lm as ref  # noqa: E402

TOL = 1e-4


def tiny(**changes):
    cfg = reduced(get_config("jamba2_mini"), d_model=64)
    return dataclasses.replace(cfg, **{"n_experts": 4, "dtype": "float32",
                                       "param_dtype": "float32", **changes})


def spec(cfg) -> dict:
    """The reference's sizes of ``cfg``, under config.json's keys."""
    return {"hidden_size": cfg.d_model, "head_dim": cfg.head_dim,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "mamba_d_state": cfg.ssm_state, "mamba_dt_rank": cfg.dt_rank,
            "rms_norm_eps": cfg.norm_eps, "num_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.top_k,
            "num_hidden_layers": cfg.n_layers,
            "attn_layer_period": cfg.attn_layer_period,
            "attn_layer_offset": cfg.attn_layer_offset,
            "expert_layer_period": cfg.expert_layer_period,
            "expert_layer_offset": cfg.expert_layer_offset,
            "tie_word_embeddings": cfg.tie_embeddings}


@pytest.fixture(scope="module")
def model():
    cfg = tiny()
    bundle = build(cfg, device="cpu")
    return cfg, bundle, bundle.init(3)


def tokens(cfg, b=2, s=24, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32)


def test_config_is_port_only_with_published_sizes():
    cfg = get_config("jamba2_mini")
    assert "jamba2_mini" not in ARCH_IDS
    assert "jamba2_mini" not in all_configs()
    assert 51.5e9 <= cfg.param_count() <= 52e9
    assert 11.5e9 <= cfg.active_param_count() <= 12.5e9
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.ssm_state,
            cfg.dt_rank, cfg.d_inner, cfg.ssm_conv, cfg.vocab_size) == (
        32, 4096, 32, 8, 128, 14336, 16, 2, 16, 256, 8192, 4, 65536)
    assert not cfg.tie_embeddings and cfg.norm_eps == 1e-6
    assert (cfg.dtype, cfg.param_dtype) == ("bfloat16", "bfloat16")
    assert (cfg.use_rope, cfg.ssm_dt_norms, cfg.renorm_gates,
            cfg.dropless) == (False, True, False, True)
    # reduced keeps one whole period
    assert reduced(cfg).n_layers == 8 and reduced(cfg, layers=9).n_layers \
        == 16


def test_parameters_follow_the_layer_pattern(model):
    cfg, _, params = model
    kinds = [(cfg.mixer(i), cfg.ffn(i)) for i in range(8)]
    assert kinds == [("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"),
                     ("ssm", "moe"), ("attn", "mlp"), ("ssm", "moe"),
                     ("ssm", "mlp"), ("ssm", "moe")]
    for lp, (mixer, ffn) in zip(params["layers"], kinds):
        names = set(lp._modules)
        assert names == {mixer, ffn}
        if mixer == "ssm":
            assert {"dt_norm", "b_norm", "c_norm"} <= set(
                lp["ssm"]._parameters)
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()


def test_forward_equals_the_reference(model):
    cfg, bundle, params = model
    tok = tokens(cfg, s=40)
    got = bundle.forward(params, {"tokens": tok})
    want = ref.logits(params, spec(cfg), tok)
    assert float((got - want).abs().max()) <= TOL


def test_prefill_and_decode_through_the_cache_equal_the_full_forward(model):
    cfg, bundle, params = model
    tok = tokens(cfg, s=20, seed=1)
    want = ref.logits(params, spec(cfg), tok)
    logits, cache = bundle.prefill(params, {"tokens": tok[:, :12]},
                                   max_len=20)
    errs = [float((logits - want[:, 11]).abs().max())]
    for j in range(12, 20):
        logits, cache = bundle.decode_step(params, cache, tok[:, j])
        errs.append(float((logits - want[:, j]).abs().max()))
    assert max(errs) <= TOL, errs
    # generate's kept logits are those its greedy tokens came from
    out, kept = generate(bundle, params, {"tokens": tok[:, :12]},
                         max_new_tokens=6, keep_logits=True)
    seq = torch.cat([tok[:, :12], torch.as_tensor(out[:, :-1])], dim=1)
    want = ref.logits(params, spec(cfg), seq, torch.arange(11, 17))
    assert float((kept - want).abs().max()) <= TOL
    assert np.array_equal(out, kept.argmax(-1).numpy())


def test_cache_holds_kv_for_the_attention_layer_and_state_for_mamba(model):
    cfg, bundle, params = model
    b, s, total = 2, 10, 16
    fresh = transformer.init_cache(cfg, b, total, "cpu")
    _, filled = bundle.prefill(params, {"tokens": tokens(cfg, b, s)},
                               max_len=total)
    want = {"k": (1, b, total, cfg.n_kv_heads, cfg.head_dim),
            "v": (1, b, total, cfg.n_kv_heads, cfg.head_dim),
            "entry_pos": (total,), "t": (),
            "h": (7, b, cfg.d_inner, cfg.ssm_state),
            "conv": (7, b, cfg.ssm_conv - 1, cfg.d_inner),
            "expert_load": (4, cfg.n_experts),
            "expert_hits": (4, cfg.n_experts)}
    for cache in (fresh, filled):
        assert {k: tuple(v.shape) for k, v in cache.items()} == want
    # the prompt's assignments: every token to top_k experts a MoE layer
    assert filled["expert_load"].sum(dim=1).tolist() == [b * s * 2] * 4
    _, filled = bundle.decode_step(params, filled,
                                   torch.zeros(b, dtype=torch.int32))
    assert filled["expert_load"].sum(dim=1).tolist() == [(b * s + b) * 2] * 4
    assert 2 <= int(filled["expert_hits"][0].sum()) <= min(4, 2 * b)


def test_attention_has_no_positional_encoding(monkeypatch):
    """A one-layer model whose only mixer is the attention layer: the
    last position's logits do not move when the tokens before it are
    permuted (with RoPE they would)."""
    cfg = tiny(n_layers=1, attn_layer_period=1, attn_layer_offset=0,
               expert_layer_period=2, expert_layer_offset=1)
    assert (cfg.mixer(0), cfg.ffn(0)) == ("attn", "mlp")
    bundle = build(cfg, device="cpu")
    params = bundle.init(5)
    tok = tokens(cfg, b=1, s=16, seed=2)
    perm = torch.cat([torch.randperm(15, generator=torch.Generator()
                                     .manual_seed(0)), torch.tensor([15])])
    last = bundle.forward(params, {"tokens": tok})[:, -1]
    moved = bundle.forward(params, {"tokens": tok[:, perm]})[:, -1]
    assert float((last - moved).abs().max()) <= 1e-5
    monkeypatch.setattr(type(cfg), "use_rope", True)
    a = bundle.forward(params, {"tokens": tok})[:, -1]
    b = bundle.forward(params, {"tokens": tok[:, perm]})[:, -1]
    assert float((a - b).abs().max()) > 1e-3


def test_gates_are_not_renormalised(model, monkeypatch):
    cfg, _, params = model
    p = params["layers"][1]["moe"]
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    flat = x.reshape(-1, cfg.d_model)
    gates, idx, _ = moe._route(flat, p["router"], cfg.n_experts, cfg.top_k,
                               renorm=False)
    probs = torch.softmax(flat @ p["router"], dim=-1)
    assert torch.allclose(gates, probs.gather(1, idx))
    assert float(gates.sum(-1).max()) < 1.0
    y, _ = moe.moe_block(p, x, cfg)
    want = ref.experts(p, x, spec(cfg))
    assert float((y - want).abs().max()) <= TOL
    monkeypatch.setattr(type(cfg), "renorm_gates", True)
    renormed, _ = moe.moe_block(p, x, cfg)
    assert float((renormed - want).abs().max()) > 1e-2


@pytest.mark.parametrize("rows", [1, 2, 64])
def test_no_token_is_dropped_when_every_token_picks_the_same_experts(
        model, rows, monkeypatch):
    """A router of zeros ties every expert, so every token goes to experts
    0 and 1 (the lower ids): all of them computed, at a decode step's
    rows and at a prompt's.  At a fixed capacity those past it are
    dropped."""
    cfg, _, params = model
    p = params["layers"][3]["moe"]
    tied = {name: getattr(p, name) for name in ("e_gate", "e_up", "e_down")}
    tied["router"] = torch.zeros_like(p["router"])
    x = torch.randn(rows, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(rows))
    counts = []
    y, _ = moe.moe_block(tied, x, cfg, counts=counts)
    assert counts[0].tolist() == [rows * 3, rows * 3, 0, 0]
    want = ref.experts(tied, x, spec(cfg))
    assert float((y - want).abs().max()) <= TOL
    assert bool((want.norm(dim=-1) > 0).all())
    monkeypatch.setattr(type(cfg), "dropless", False)
    capped, _ = moe.moe_block(tied, x, cfg)
    cap = moe._capacity(rows * 3, cfg.n_experts, cfg.top_k,
                        cfg.capacity_factor)
    dropped = int((capped.norm(dim=-1) == 0).sum())
    assert dropped == max(0, rows * 3 - cap)
    assert dropped > 0 or rows < 64


def test_a_mesh_is_refused(model):
    cfg, bundle, params = model
    tok = tokens(cfg, s=8)
    mesh = object()          # refused before the mesh is read
    with pytest.raises(NotImplementedError, match="follow a pattern.*one device"):
        bundle.forward(params, {"tokens": tok}, mesh=mesh)
    with pytest.raises(NotImplementedError, match="follow a pattern"):
        bundle.prefill(params, {"tokens": tok}, mesh=mesh)
    _, cache = bundle.prefill(params, {"tokens": tok}, max_len=10)
    with pytest.raises(NotImplementedError, match="follow a pattern"):
        bundle.decode_step(params, cache, tok[:, 0], mesh=mesh)


def test_generate_spans_and_expert_counters(model):
    cfg, bundle, params = model
    tracer = trace.Tracer(sample_rate=1.0)
    before = trace.set_default(tracer)
    try:
        out = generate(bundle, params, {"tokens": tokens(cfg, b=3, s=10)},
                       max_new_tokens=5)
    finally:
        trace.set_default(before)
    spans = {s["name"]: s for s in tracer.drain()}
    root = spans["lm.generate"]
    max_load = root["tags"].pop("max_load")
    assert root["tags"] == {"batch": 3, "prompt_len": 10, "new_tokens": 5}
    pre, dec = spans["lm.prefill"], spans["lm.decode"]
    assert pre["parent"] == dec["parent"] == root["span"]
    assert dec["tags"]["steps"] == 4 and "device_ms" not in dec["tags"]
    # 4 MoE layers a step, each hitting 2 to 4 of its 4 experts
    assert 4 * 2 <= dec["tags"]["experts_hit"] <= 4 * 4
    assert pre["tags"] == {}
    assert 3 * 10 * 2 / 4 <= max_load <= 3 * 10
    assert out.shape == (3, 5)


@pytest.mark.cuda
def test_a_decode_step_never_waits_for_the_card():
    """The dropless dispatch, the layer pattern's cache and the sampling
    of a decode step queue their work without a host sync (the grouped
    products in bf16, as deployed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    cfg = tiny(dtype="bfloat16", param_dtype="bfloat16")
    bundle = build(cfg, device="cuda")
    params = bundle.init(3)
    tok = tokens(cfg, b=4, s=12).cuda()
    logits, cache = bundle.prefill(params, {"tokens": tok}, max_len=16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            nxt = logits.argmax(-1).to(torch.int32)
            logits, cache = bundle.decode_step(params, cache, nxt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache["t"]) == 15
    assigned = (4 * 12 + 3 * 4) * 2         # prompt + 3 steps, top-2
    assert cache["expert_load"].sum(dim=1).tolist() == [assigned] * 4


def test_serve_lm_runs_the_reduced_preset_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--arch", "jamba2_mini", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[serve] jamba2_mini: generated 8 tokens")
