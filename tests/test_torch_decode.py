"""The port's decoding against its own forward and against the JAX
package's, on the CPU: teacher-forced decode, the sliding-window ring
cache, greedy generation, sampling, the prompts' synthetic tokens and the
``--mode lm`` launcher.

Tolerances: teacher-forced decode against the port's own forward within
1e-4 in float32 (the reference's ``test_decode_matches_forward_fp32``
bound; observed <= 3e-6); the ring cache against the reference within
1e-4 (observed <= 4e-6); greedy tokens and ``token_batches`` exactly.
Greedy generation is compared in float32: in bf16 the two frameworks
round at other places, so a near-tie between two logits could pick
another token.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synth
from repro.serve.decode import generate as ref_generate
from repro_torch.data import synthetic as t_synth
from repro_torch.models import build
from repro_torch.serve.decode import generate, sample_token
from test_torch_models import _assert_caches, _batch, _cfgs, _err, _models

ROOT = Path(__file__).resolve().parent.parent
FAMILY_ARCH = {"dense": "llama3_2_1b", "moe": "qwen3_moe_30b_a3b",
               "ssm": "falcon_mamba_7b", "hybrid": "hymba_1_5b",
               "vlm": "pixtral_12b", "encdec": "seamless_m4t_medium"}


@pytest.mark.parametrize("arch,extra", [
    ("llama3_2_1b", {}),
    ("h2o_danube3_4b", {"sliding_window": 16}),      # ring buffer exercised
    ("falcon_mamba_7b", {}),
    ("hymba_1_5b", {"sliding_window": 16}),
    ("qwen3_moe_30b_a3b", {"capacity_factor": 64.0}),  # no token drops
    ("seamless_m4t_medium", {}),
    ("pixtral_12b", {}),
])
def test_decode_matches_forward_fp32(arch, extra):
    """Teacher-forced decode reproduces the port's own forward (float32, no
    capacity drops): caches, rings and the SSM state carry.  The VLM gets
    the same patches in both (the reference's test cuts them with the
    prompt, and skips the check)."""
    _, cfg = _cfgs(arch, dtype="float32", **extra)
    bundle = build(cfg, device="cpu")
    params = bundle.init(0)
    s, s0 = 40, 25
    batch = _batch(cfg, np.random.default_rng(2), s=s, n_patches=3)
    full = bundle.forward(params, batch)
    logits, cache = bundle.prefill(params, dict(batch, tokens=batch[
        "tokens"][:, :s0]), max_len=s)
    errs = [_err(logits, full[:, s0 - 1])]
    for t in range(s0, s):
        logits, cache = bundle.decode_step(params, cache,
                                           batch["tokens"][:, t])
        errs.append(_err(logits, full[:, t]))
    assert max(errs) < 1e-4, errs
    assert int(cache["t"]) == s


@pytest.mark.parametrize("arch,s0", [
    ("h2o_danube3_4b", 25),     # S > C: the last 16 entries at pos % 16
    ("h2o_danube3_4b", 16),     # S == C
    ("h2o_danube3_4b", 10),     # S < C: padded, then filled by decode
    ("hymba_1_5b", 25),
])
def test_ring_cache_matches_reference(arch, s0):
    rb, params, tb, tp = _models(arch, dtype="float32", sliding_window=16)
    batch = _batch(tb.cfg, np.random.default_rng(12), s=s0 + 12)
    pb = dict(batch, tokens=batch["tokens"][:, :s0])
    rlog, rcache = rb.prefill(params, pb, max_len=s0 + 12)
    tlog, tcache = tb.prefill(tp, pb, max_len=s0 + 12)
    assert tcache["k"].shape[2] == 16
    assert _err(rlog, tlog) < 1e-4
    _assert_caches(rcache, tcache, 1e-4, "prefill")
    step = jax.jit(rb.decode_step)
    for t in range(s0, s0 + 12):        # past the ring's wrap
        tok = batch["tokens"][:, t]
        rlog, rcache = step(params, rcache, jnp.asarray(tok))
        tlog, tcache = tb.decode_step(tp, tcache, tok)
        assert _err(rlog, tlog) < 1e-4, t
        _assert_caches(rcache, tcache, 1e-4, f"step {t}")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_greedy_generate_matches_reference(family):
    rb, params, tb, tp = _models(FAMILY_ARCH[family], dtype="float32")
    batch = _batch(tb.cfg, np.random.default_rng(13), b=3, s=16)
    want = ref_generate(rb, params, batch, max_new_tokens=10)
    got = generate(tb, tp, batch, max_new_tokens=10)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("n_new", [0, 1])
def test_generate_of_zero_and_one_tokens_matches_reference(n_new):
    """At 0 new tokens the reference scans over no keys and returns (B, 0);
    at 1, the token sampled from the prompt's logits."""
    rb, params, tb, tp = _models("llama3_2_1b", dtype="float32")
    batch = _batch(tb.cfg, np.random.default_rng(2), b=2, s=8)
    want = ref_generate(rb, params, batch, max_new_tokens=n_new)
    got = generate(tb, tp, batch, max_new_tokens=n_new)
    assert want.shape == (2, n_new)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(want, got)


def test_sample_token():
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [5.0, 1.0, 0.0, 5.0]])
    # greedy: the first maximum, as jnp.argmax
    greedy = sample_token(logits, None, 0.0)
    assert greedy.dtype == torch.int32
    assert greedy.tolist() == np.asarray(
        jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist() == [1, 0]
    # sampled: from softmax(logits / T), reproducible from the seed
    probs = torch.softmax(torch.tensor([1.0, 0.0, -1.0, 2.0]) / 0.7, -1)
    many = probs.log().expand(20000, 4)

    def draw(seed):
        return sample_token(many, torch.Generator().manual_seed(seed), 1.0)
    a = draw(5)
    assert torch.equal(a, draw(5)) and not torch.equal(a, draw(6))
    freq = torch.bincount(a.long(), minlength=4).double() / len(a)
    assert torch.allclose(freq, probs.double(), atol=0.015)
    hot = sample_token(logits * 1e3, torch.Generator().manual_seed(0), 1e-3)
    assert hot.tolist()[0] in (1, 2) and hot.tolist()[1] in (0, 3)


def test_sampled_generate_is_seeded_and_in_range():
    _, cfg = _cfgs("llama3_2_1b")
    bundle = build(cfg, device="cpu")
    params = bundle.init(1)
    batch = _batch(cfg, np.random.default_rng(14), b=2, s=8)
    a = generate(bundle, params, batch, max_new_tokens=6, temperature=1.0,
                 seed=3)
    assert np.array_equal(a, generate(bundle, params, batch,
                                      max_new_tokens=6, temperature=1.0,
                                      seed=3))
    assert a.shape == (2, 6) and a.min() >= 0 and a.max() < cfg.vocab_size


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 8, 32, 0),
                                                  (128256, 2, 5, 7)])
def test_token_batches_match_reference(vocab, batch, seq, seed):
    ref = ref_synth.token_batches(vocab, batch, seq, seed)
    port = t_synth.token_batches(vocab, batch, seq, seed)
    for _ in range(3):
        a, b = next(ref), next(port)
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert np.array_equal(a["tokens"], b["tokens"])


def test_serve_lm_on_the_cpu_prints_the_serve_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--arch", "hymba_1_5b", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] hymba_1_5b: generated 8 tokens in ")
    assert lines[0].endswith(" tok/s, batch=2)")
    sample = eval(lines[1].removeprefix("[serve] sample: "))
    assert len(sample) == 4 and all(0 <= t < 512 for t in sample)


def test_serve_defaults_match_reference(monkeypatch):
    """``--mode`` defaults to lm, with the reference's LM flags."""
    from repro_torch.launch import serve
    seen = {}
    monkeypatch.setattr(serve, "serve_lm", lambda args: seen.update(vars(args)))
    monkeypatch.setattr(sys, "argv", ["serve"])
    serve.main()
    assert {k: seen[k] for k in ("mode", "arch", "batch", "prompt_len",
                                 "new_tokens", "temperature", "device")} == {
        "mode": "lm", "arch": "llama3_2_1b", "batch": 8, "prompt_len": 32,
        "new_tokens": 32, "temperature": 0.0, "device": "cuda"}
