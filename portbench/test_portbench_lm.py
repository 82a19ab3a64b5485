"""The language-model cell (``jamba2_mini_chat_b16``) driven end to end on
the CPU at a tiny size, its check against planted faults, the work its
metrics divide by, and their readers on hand-made spans."""

import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import harness, lm_cost, roofline
from portbench.clients import lm_generate

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CELL = "jamba2_mini_chat_b16"
SEED = 2 ** 31 + 7
# the period's structure at tiny widths, in float32 (the limits are set for
# bf16 at published widths: a sound float32 run reads ~1e-5 on each)
TINY = {"config": {"hidden_size": 64, "head_dim": 16,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "intermediate_size": 128, "vocab_size": 256,
                   "num_experts": 4, "mamba_d_state": 8,
                   "mamba_dt_rank": 8, "dtype": "float32"},
        "traffic": {"batch": 4, "prompt_len": 16, "new_tokens": 4,
                    "pool_batches": 2, "check_rows": 2, "profile_steps": 2}}
CHECKS = ("replay_rows_differ", "logit_rows_off", "token_rows_off",
          "expert_rows_off", "ssm_rows_off")


def run(trace=False, **program):
    out = harness.run(ROOT, CELL, SEED, 0.3, trace, device="cpu",
                      overrides={**TINY, "program": program})
    return out, {k: c["value"] for k, c in out["checks"].items()}


def conf(**changes):
    return {**harness.load_json(BENCH, "configs", "jamba2_mini_period"),
            **changes}


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    out, checks = run(trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert checks == dict.fromkeys(CHECKS, 0)
    notes = out["_notes"]["checked"]
    assert max(notes["logit_err"]) < 1e-4
    assert max(notes["expert_miss"]) < 1e-4
    assert max(notes["ssm_miss"]) < 1e-4
    if trace:    # no card: the device times and the shares of peaks silent
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"queries_per_s", "batch_p95_ms",
                                       "setup_s"}
        assert out["metrics"]["queries_per_s"]["value"] > 0


def _renormalised(monkeypatch):
    from repro_torch.models import moe
    route = moe._route

    def renormalised(xf, router_w, e, k, par=None, renorm=False):
        return route(xf, router_w, e, k, par, True)
    monkeypatch.setattr(moe, "_route", renormalised)


def _swapped(monkeypatch):
    """Expert 0's weights where expert 1's should be, and back."""
    from repro_torch.models import moe
    ffn = moe._dropless_ffn

    def swapped(xf, idx, gates, *w):
        order = [1, 0, *range(2, len(w[0]))]
        return ffn(xf, idx, gates, *(t[order] for t in w))
    monkeypatch.setattr(moe, "_dropless_ffn", swapped)


def _unnormed(monkeypatch):
    """The Mamba mixers' dt, B and C without their RMSNorms."""
    from repro_torch.models import ssm

    def unnormed(p, proj, cfg):
        return proj.split([cfg.dt_rank, cfg.ssm_state, cfg.ssm_state], -1)
    monkeypatch.setattr(ssm, "_dt_b_c", unnormed)


@pytest.mark.parametrize("fault,check", [
    (_renormalised, "expert_rows_off"), (_swapped, "expert_rows_off"),
    (_unnormed, "ssm_rows_off")],
    ids=["renormalised_gates", "swapped_experts", "unnormed_mamba"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, check):
    fault(monkeypatch)
    out, checks = run()
    assert not out["correct"]
    assert checks[check] > 0


def test_the_control_rounds_the_experts_and_is_not_correct():
    out, checks = run(expert_dtype="float8_e4m3fn")
    assert not out["correct"] and checks["expert_rows_off"] > 0
    from repro_torch.models import moe
    assert moe._dropless_ffn.__name__ == "_dropless_ffn"     # restored


def test_the_scan_control_holds_the_mamba_state_in_bf16():
    """At these float32 widths the control moves each Mamba layer by
    ~0.4% (a sound run: < 1e-6); at published widths in bf16 its
    readings set ``ssm_tol`` (PERF.md)."""
    out, _ = run(ssm_scan_dtype="bfloat16")
    assert max(out["_notes"]["checked"]["ssm_miss"]) > 1e-3


def test_the_same_seed_gives_the_same_prompts_and_weights():
    def inputs(seed):
        cfg = harness._merge(conf(), TINY["config"])
        tr = harness._merge(harness.load_json(BENCH, "traffic",
                                              "lm_batch_1k_32"),
                            TINY["traffic"])
        c = lm_generate.Client(BENCH, cfg, tr, seed=seed,
                               device=torch.device("cpu"))
        c.setup()
        return c.pool, c.params["layers"][1]["moe"]["e_up"].detach()
    a, b, c = inputs(2 ** 33 + 1), inputs(2 ** 33 + 1), inputs(2 ** 33 + 2)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])
    assert not torch.equal(a[0][0], c[0][0]) and not torch.equal(a[1], c[1])


def test_the_configuration_is_the_published_period():
    cfg = lm_generate.model_config(conf())
    assert cfg.n_layers == 8 and cfg.param_count() == 13_295_237_088
    assert dataclasses.replace(cfg, n_layers=32).param_count() \
        == 51_570_323_328
    assert [(cfg.mixer(i), cfg.ffn(i)) for i in range(8)] \
        == lm_cost.layers(conf())
    with pytest.raises(ValueError, match="mamba_proj_bias"):
        lm_generate.model_config(conf(mamba_proj_bias=True))


def test_lm_cost_of_the_period():
    c = conf()
    # the prompt: ~2 x 2.89e9 weights a token over 16 x 1,024 tokens
    prefill = lm_cost.generate_flops(c, 16, 1024, 1)
    assert 94e12 <= prefill <= 97e12
    one = lm_cost.generate_flops(c, 1, 8, 2) - lm_cost.generate_flops(
        c, 1, 8, 1)
    assert one == lm_cost.token_flops(c, 9) + 2 * 4096 * 65536
    # every weight but the embedding table, the 64 experts of the 4 MoE
    # layers all hit: the period's 26.59 GB less the 0.54 GB table
    all_hit = lm_cost.decode_step_bytes(c, 1, 0, 64)
    assert all_hit - 2 * 4096 == pytest.approx(
        2 * (13_295_237_088 - 65536 * 4096), rel=1e-9, abs=7 * 2 * (
            8192 * 16 * 4 + 3 * 8192 * 2))
    none_hit = lm_cost.decode_step_bytes(c, 1, 0, 0)
    assert all_hit - none_hit == 64 * 3 * 4096 * 14336 * 2
    kv = lm_cost.decode_step_bytes(c, 16, 1040, 0) \
        - lm_cost.decode_step_bytes(c, 16, 0, 0)
    assert kv == 16 * 1040 * 2 * 8 * 128 * 2


def test_the_readers_on_hand_made_spans():
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    spans = []
    for k in range(2):
        spans += [
            {"name": "lm.generate", "span": 10 + k, "parent": None,
             "dur_s": 2.0, "tags": {"batch": 16, "prompt_len": 1024,
                                    "new_tokens": 32,
                                    "prefill_device_ms": 1500.0 + k,
                                    "max_load": 3000}},
            {"name": "lm.prefill", "span": 20 + k, "parent": 10 + k,
             "dur_s": 0.01, "tags": {}},
            {"name": "lm.decode", "span": 30 + k, "parent": 10 + k,
             "dur_s": 0.62, "tags": {"steps": 31, "device_ms": 600.0,
                                     "experts_hit": 56.0}}]
    run = harness.Run(config=conf(), setup_s=1.0, window_s=4.0,
                      latencies_s=[2.0, 2.0], rows=32, steps=2, failed=0,
                      spans=spans, peak=peak)

    def read(name):
        return harness.load_module(BENCH, "metrics", name).read(run)
    assert read("lm_prefill_ms") == 1500.5
    assert read("lm_decode_step_ms") == pytest.approx(600.0 / 31)
    flops = lm_cost.generate_flops(conf(), 16, 1024, 32)
    assert read("lm_mfu") == pytest.approx(100 * flops / (2.0 * 989.4e12))
    least = 31 * lm_cost.decode_step_bytes(conf(), 16, 1024 + 16, 56.0) \
        / 3.35e12
    assert read("lm_decode_roofline") == pytest.approx(100 * least / 0.6)
    run.peak = None                        # another card: shares silent
    assert read("lm_mfu") is None and read("lm_decode_roofline") is None
