"""The port's LM stack against the JAX package's, on the CPU.

The same weights (the reference's ``init``, carried across by
``convert.lm_params_from_jax``) and the same seeded numpy inputs go
through ``repro.models`` and ``repro_torch.models``.  Tolerances:

  * float32 (every reduced arch at d_model = 64): forward logits, the
    loss, prefill logits and every cache tensor, 8 decode steps' logits and
    the caches after them within 1e-4 absolute, the reference's own decode
    bound (observed <= 5e-6; the two sum in other orders, and the SSM scan
    combines its pairs in another order than ``associative_scan``);
  * bfloat16 forward: 0.125 (16 bf16 ulps at 1.0) on every logit
    (observed <= 0.07: the two frameworks round bf16 intermediates at other
    places).  The MoE families run it at top_k = n_experts: in bf16 a
    token whose router meets a near-tie may pick another expert in the
    two, and later tokens see the change through attention (observed: up
    to 7 rows in 80 beyond 0.125 at top_k = 2); the selection itself is
    held exactly in float32;
  * ``ssm_scan_dtype="bfloat16"`` (float32 compute): 2e-2 on the logits,
    where the in-chunk scan's bf16 products round in another order;
  * the layers one by one: 1e-5 in float32 (observed ~1e-6), integers and
    masks exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import ARCH_IDS
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.models import build
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm

CPU = torch.device("cpu")


def _cfgs(arch, **changes):
    """(reference cfg, port cfg), reduced to d_model = 64, with changes."""
    ref = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch), d_model=64),
        **changes)
    port = dataclasses.replace(
        t_configs.reduced(t_configs.get_config(arch), d_model=64), **changes)
    return ref, port


def _models(arch, seed=0, **changes):
    """The reference bundle and params, the port bundle and the same
    params carried across."""
    rcfg, tcfg = _cfgs(arch, **changes)
    rb = ref_build(rcfg)
    params = rb.init(jax.random.PRNGKey(seed))
    tb = build(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    "cpu")
    return rb, params, tb, tp


def _batch(cfg, rng, b=2, s=40, n_patches=None):
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (b, s))
             .astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(
            size=(b, n_patches or s // 8, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "frames":
        batch["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return batch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _err(a, b) -> float:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0


def _assert_caches(ref: dict, got: dict, tol: float, what: str):
    assert set(ref) == set(got), (what, sorted(ref), sorted(got))
    for name in ref:
        if name in ("t", "entry_pos"):
            assert np.array_equal(_np(ref[name]), _np(got[name])), (what, name)
            assert got[name].dtype == torch.int32
        else:
            assert _err(ref[name], got[name]) < tol, (what, name)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    ref, port = ref_configs.get_config(arch), t_configs.get_config(arch)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for kw in ({}, {"d_model": 64}, {"layers": 3, "vocab": 256}):
        r = ref_configs.reduced(ref, **kw)
        p = t_configs.reduced(port, **kw)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert r.param_count() == p.param_count()
        assert r.active_param_count() == p.active_param_count()
        assert (r.d_inner, r.is_encdec, r.subquadratic) == \
            (p.d_inner, p.is_encdec, p.subquadratic)
    assert ref.param_count() == port.param_count()
    assert ref.active_param_count() == port.active_param_count()


def test_config_registry_and_shapes_equal_reference():
    from repro.configs import base as ref_base
    from repro_torch.configs import base as t_base
    assert t_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert [dataclasses.asdict(s) for s in t_base.SHAPES] == \
        [dataclasses.asdict(s) for s in ref_base.SHAPES]
    assert t_base.shape_by_name("decode_32k").seq_len == 32768
    assert dataclasses.asdict(t_base.TrainConfig()) == \
        dataclasses.asdict(ref_base.TrainConfig())
    assert set(t_configs.all_configs()) == set(ARCH_IDS)
    assert t_configs.get_config("llama3.2-1b").name == "llama3_2_1b"
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get_config("gpt5")
    with pytest.raises(ValueError, match="moe family"):
        t_base.ModelConfig(name="x", family="moe", n_layers=1, d_model=8,
                           n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_count_equals_config(arch):
    cfg = t_configs.reduced(t_configs.get_config(arch))
    params = build(cfg, device="cpu").init(0)
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count()
    assert all(p.dtype == torch.float32 and p.device == CPU
               for p in params.parameters())
    # one module a layer, as the reference's layers stacked on L
    layers = params["dec_layers"] if cfg.is_encdec else params["layers"]
    assert len(layers) == cfg.n_layers


# -- the whole model, float32 --------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_matches_reference_fp32(arch):
    rb, params, tb, tp = _models(arch, dtype="float32")
    cfg = tb.cfg
    batch = _batch(cfg, np.random.default_rng(0))
    assert _err(rb.forward(params, batch), tb.forward(tp, batch)) < 1e-4
    (rl, rm), (tl, tm) = rb.loss_fn(params, batch), tb.loss_fn(tp, batch)
    assert abs(float(rl) - float(tl)) < 1e-4
    assert abs(float(rm["aux"]) - float(tm["aux"])) < 1e-6
    mask = (np.random.default_rng(1).random(batch["tokens"].shape) < 0.5
            ).astype(np.float32)
    assert abs(float(rb.loss_fn(params, dict(batch, mask=jnp.asarray(mask)))[0])
               - float(tb.loss_fn(tp, dict(batch, mask=mask))[0])) < 1e-4

    s0, max_len = 25, 40
    pb = dict(batch, tokens=batch["tokens"][:, :s0])
    rlog, rcache = rb.prefill(params, pb, max_len=max_len)
    tlog, tcache = tb.prefill(tp, pb, max_len=max_len)
    assert _err(rlog, tlog) < 1e-4
    _assert_caches(rcache, tcache, 1e-4, "prefill")
    step = jax.jit(rb.decode_step)
    for t in range(s0, s0 + 8):
        tok = batch["tokens"][:, t]
        rlog, rcache = step(params, rcache, jnp.asarray(tok))
        tlog, tcache = tb.decode_step(tp, tcache, tok)
        assert _err(rlog, tlog) < 1e-4, t
    _assert_caches(rcache, tcache, 1e-4, "after 8 decode steps")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_bf16_within_bound(arch):
    every_expert = ({"top_k": 8} if ref_configs.get_config(arch).n_experts
                    else {})
    rb, params, tb, tp = _models(arch, **every_expert)
    assert tb.cfg.dtype == "bfloat16"
    batch = _batch(tb.cfg, np.random.default_rng(1))
    got = tb.forward(tp, batch)
    assert got.dtype == torch.bfloat16
    assert _err(rb.forward(params, batch), got) < 0.125


def test_moe_capacity_drops_match_reference():
    """At capacity_factor 1.0 tokens are dropped, and the port drops the
    same ones: the token-major place of each assignment decides."""
    rb, params, tb, tp = _models("qwen3_moe_30b_a3b", dtype="float32",
                                 capacity_factor=1.0)
    cfg = tb.cfg
    batch = _batch(cfg, np.random.default_rng(3), s=64)
    got = tb.forward(tp, batch)
    assert _err(rb.forward(params, batch), got) < 1e-4
    # drops happen: with room for every assignment the logits move
    roomy = build(dataclasses.replace(cfg, capacity_factor=64.0),
                  device="cpu")
    assert _err(roomy.forward(tp, batch), got) > 1e-2
    (rl, rm), (tl, tm) = rb.loss_fn(params, batch), tb.loss_fn(tp, batch)
    assert abs(float(rl) - float(tl)) < 1e-4
    assert float(tm["aux"]) > 0


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b"])
def test_ssm_bf16_scan_dtype_is_honoured(arch):
    rb, params, tb, tp = _models(arch, dtype="float32",
                                 ssm_scan_dtype="bfloat16")
    batch = _batch(tb.cfg, np.random.default_rng(4))
    ref, got = rb.forward(params, batch), tb.forward(tp, batch)
    assert _err(ref, got) < 2e-2
    # and the scan dtype matters: float32 scans land elsewhere
    f32 = build(dataclasses.replace(tb.cfg, ssm_scan_dtype="float32"),
                device="cpu").forward(tp, batch)
    assert _err(got, f32) > 1e-4


def test_lm_params_from_jax_checks_depth_and_count():
    rcfg, tcfg = _cfgs("llama3_2_1b")
    params = jax.tree.map(np.asarray,
                          ref_build(rcfg).init(jax.random.PRNGKey(0)))
    deeper = dataclasses.replace(tcfg, n_layers=3)
    with pytest.raises(ValueError, match="layers stacked"):
        convert.lm_params_from_jax(params, deeper, "cpu")
    untied = dataclasses.replace(tcfg, tie_embeddings=False)
    with pytest.raises(ValueError, match="parameters"):
        convert.lm_params_from_jax(params, untied, "cpu")


# -- the layers one by one -------------------------------------------------------

def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(5)
    x, w = _rand(rng, 2, 9, 64), _rand(rng, 64)
    assert _err(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5),
                t_layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                                 1e-5)) < 1e-5
    q = _rand(rng, 2, 9, 4, 32)
    pos = np.arange(9)
    for theta in (1e4, 5e5):
        assert _err(ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                          theta),
                    t_layers.apply_rope(torch.from_numpy(q),
                                        torch.from_numpy(pos), theta)) < 1e-5
    assert np.array_equal(ref_layers.rope_frequencies(32, 1e4),
                          t_layers.rope_frequencies(32, 1e4))


@pytest.mark.parametrize("s,s_kv,window,q_chunk,causal", [
    (40, 40, 0, 16, True),      # full causal, a short last chunk
    (40, 40, 16, 16, True),     # SWA: the window + chunk key slice
    (40, 40, 8, 64, True),      # one chunk longer than S
    (24, 40, 0, 16, False),     # cross-attention shape
    (33, 33, 5, 7, True),       # nothing divides
])
def test_chunked_attention_matches_reference(s, s_kv, window, q_chunk,
                                             causal):
    rng = np.random.default_rng(6)
    q = _rand(rng, 2, s, 4, 32)
    k, v = _rand(rng, 2, s_kv, 2, 32), _rand(rng, 2, s_kv, 2, 32)
    want = ref_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=q_chunk)
    got = t_layers.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_chunk=q_chunk)
    assert _err(want, got) < 1e-5


@pytest.mark.parametrize("t,window", [(5, 0), (20, 0), (20, 16), (37, 16)])
def test_decode_attention_masks_match_reference(t, window):
    rng = np.random.default_rng(7)
    c = 16 if window else 24
    q = _rand(rng, 2, 4, 32)
    kc, vc = _rand(rng, 2, c, 2, 32), _rand(rng, 2, c, 2, 32)
    # a ring (SWA) or a linear cache filled up to t, -1 past it
    if window:
        entry = np.array([max(t - ((t - s) % c), -1) for s in range(c)],
                         np.int32)
    else:
        entry = np.where(np.arange(c) <= t, np.arange(c), -1).astype(np.int32)
    want = ref_layers.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(entry),
        jnp.asarray(t, jnp.int32), window=window)
    got = t_layers.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(entry), t, window=window)
    assert _err(want, got) < 1e-5


def test_route_keeps_the_reference_tie_order():
    """Exact ties in the router's probabilities: lax.top_k takes the lower
    expert first, and so does the port's stable sort."""
    e, k = 8, 3
    xf = np.zeros((4, 8), np.float32)
    xf[1, 0] = 1.0
    xf[2, :] = 0.5
    router = np.zeros((8, e), np.float32)
    router[0, [2, 5, 6]] = 1.0                 # row 1: 2, 5, 6 tie at the top
    for x in (xf, np.random.default_rng(8).normal(size=(4, 8)).astype(
            np.float32)):
        rg, ri, ra = ref_moe._route(jnp.asarray(x), jnp.asarray(router), e, k)
        tg, ti, ta = t_moe._route(torch.from_numpy(x),
                                  torch.from_numpy(router), e, k)
        assert np.array_equal(np.asarray(ri), ti.numpy())
        assert _err(rg, tg) < 1e-6 and abs(float(ra) - float(ta)) < 1e-6
    assert ti.dtype == torch.int64


@pytest.mark.parametrize("n_tokens,factor", [(8, 1.25), (80, 1.25),
                                             (80, 1.0), (640, 64.0), (1, 0.1)])
def test_capacity_matches_reference(n_tokens, factor):
    for e, k in ((8, 2), (128, 8), (384, 8)):
        assert t_moe._capacity(n_tokens, e, k, factor) == \
            ref_moe._capacity(n_tokens, e, k, factor)


def test_expert_ffn_matches_reference_with_drops():
    rng = np.random.default_rng(9)
    t, k, e, d, f = 24, 2, 4, 16, 32
    xf = _rand(rng, t, d)
    idx = rng.integers(0, e, (t, k)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + rng.integers(0, e - 1, t)) % e
    idx[:12, 0] = 0                         # expert 0 overflows capacity 8
    gates = rng.random((t, k)).astype(np.float32)
    wg, wu, wd = _rand(rng, e, d, f), _rand(rng, e, d, f), _rand(rng, e, f, d)
    want = ref_moe._expert_ffn(
        jnp.asarray(xf), jnp.asarray(idx), jnp.asarray(gates),
        jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd), e_offset=0,
        n_experts_total=e, capacity=8)
    got = t_moe._expert_ffn(
        torch.from_numpy(xf), torch.from_numpy(idx).long(),
        torch.from_numpy(gates), torch.from_numpy(wg), torch.from_numpy(wu),
        torch.from_numpy(wd), capacity=8)
    assert _err(want, got) < 1e-4
    # the dropped assignments contribute nothing
    full = t_moe._expert_ffn(
        torch.from_numpy(xf), torch.from_numpy(idx).long(),
        torch.from_numpy(gates), torch.from_numpy(wg), torch.from_numpy(wu),
        torch.from_numpy(wd), capacity=32)
    assert _err(full, got) > 1e-3


def test_moe_mesh_branch_raises():
    """The layout the expert-parallel branch once refused, experts split
    over ``model`` with d_model not divisible by it, now runs it: the
    features are whole on every model rank, so nothing splits them.  The
    ``tp`` ranks' outputs summed equal the reference's ``moe_block`` (which
    leaves that layout to GSPMD; capacity 64: no drops), and every rank's
    aux loss is the reference's."""
    import types
    from repro_torch.distributed.parallel import parallel_for
    tp = 8
    rcfg, tcfg = _cfgs("qwen3_moe_30b_a3b", d_model=100, dtype="float32",
                       capacity_factor=64.0)
    for r in range(tp):
        mesh = types.SimpleNamespace(
            shape={"data": 1, "model": tp}, axis_names=("data", "model"),
            get_coordinate=lambda r=r: (0, r))
        par = parallel_for(mesh, tcfg)
        assert par.ep and par.rank == r and tcfg.d_model % par.tp
    rp = ref_moe.init_moe(jax.random.PRNGKey(5), rcfg, jnp.float32)
    tp_ = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    x = _rand(np.random.default_rng(15), 2, 6, tcfg.d_model)
    ry, raux = ref_moe.moe_block(rp, jnp.asarray(x), rcfg)
    el = tcfg.n_experts // tp
    y, auxes = 0, []
    for r in range(tp):
        local = dict(tp_, **{k: tp_[k][r * el:(r + 1) * el]
                             for k in ("e_gate", "e_up", "e_down")})
        yr, ar = t_moe.moe_block(local, torch.from_numpy(x), tcfg,
                                 mesh=_OneRankOf(tp, r))
        y, auxes = y + yr, auxes + [float(ar)]
    assert _err(ry, y) < 1e-5
    assert all(abs(a - float(raux)) < 1e-6 for a in auxes)


class _OneRankOf:
    """A ``distributed.parallel.Parallel`` stand-in: rank ``rank`` of
    ``tp`` over ``model``, its collectives the identity, so a rank's
    partial sums are summed by the caller."""

    def __init__(self, tp, rank):
        self.ep, self.tp, self.rank = True, tp, rank

    def enter(self, x):
        return x

    def exit(self, y):
        return y

    def batch_mean(self, x):
        return x


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_moe_expert_parallel_body_sums_to_the_reference(tp):
    """Each of ``tp`` ranks runs its E/tp experts on the same tokens (ids
    offset by rank x E/tp); their outputs summed equal the reference's
    single-device ``moe_block`` (capacity 64: no drops), and every rank's
    aux loss is the reference's."""
    rcfg, tcfg = _cfgs("qwen3_moe_30b_a3b", dtype="float32",
                       capacity_factor=64.0)
    rp = ref_moe.init_moe(jax.random.PRNGKey(3), rcfg, jnp.float32)
    tp_ = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    x = _rand(np.random.default_rng(13), 2, 12, tcfg.d_model)
    ry, raux = ref_moe.moe_block(rp, jnp.asarray(x), rcfg)
    el = tcfg.n_experts // tp
    y, auxes = 0, []
    for r in range(tp):
        local = dict(tp_, **{k: tp_[k][r * el:(r + 1) * el]
                             for k in ("e_gate", "e_up", "e_down")})
        yr, ar = t_moe.moe_block(local, torch.from_numpy(x), tcfg,
                                 mesh=_OneRankOf(tp, r))
        y, auxes = y + yr, auxes + [float(ar)]
    assert _err(ry, y) < 1e-5
    assert all(abs(a - float(raux)) < 1e-6 for a in auxes)


@pytest.mark.parametrize("s,chunk,scan_dtype", [
    (40, 16, "float32"), (40, 64, "float32"), (7, 4, "float32"),
    (40, 16, "bfloat16")])
def test_ssm_inner_matches_reference(s, chunk, scan_dtype):
    rng = np.random.default_rng(10)
    b, di, n = 2, 12, 8
    dt = np.abs(_rand(rng, b, s, di)) * 0.1
    a = -np.exp(_rand(rng, di, n) * 0.3)
    bm, cm, xs = _rand(rng, b, s, n), _rand(rng, b, s, n), _rand(rng, b, s, di)
    h0 = _rand(rng, b, di, n)
    ry, rh = ref_ssm._ssm_inner(*map(jnp.asarray, (dt, a, bm, cm, xs, h0)),
                                chunk, jnp.dtype(scan_dtype))
    ty, th = t_ssm._ssm_inner(*map(torch.from_numpy, (dt, a, bm, cm, xs, h0)),
                              chunk, getattr(torch, scan_dtype))
    tol = 1e-5 if scan_dtype == "float32" else 5e-2
    assert _err(ry, ty) < tol and _err(rh, th) < tol


def test_ssm_block_carries_state_like_reference():
    """``h0``/``conv_init`` (stateful chunked prefill): the second half of a
    sequence from the first half's state, as the reference runs it, and
    equal to the whole sequence's second half."""
    rcfg, tcfg = _cfgs("hymba_1_5b", dtype="float32")
    rp = ref_ssm.init_ssm(jax.random.PRNGKey(2), rcfg, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    x = _rand(np.random.default_rng(12), 2, 40, tcfg.d_model)
    ty, th, tail = t_ssm.ssm_block(tp, torch.from_numpy(x[:, :17]), tcfg)
    ry, rh, rtail = ref_ssm.ssm_block(rp, jnp.asarray(x[:, :17]), rcfg)
    assert _err(ry, ty) < 1e-5 and _err(rh, th) < 1e-5
    assert _err(rtail, tail) < 1e-5
    want = ref_ssm.ssm_block(rp, jnp.asarray(x[:, 17:]), rcfg, h0=rh,
                             conv_init=rtail)
    got = t_ssm.ssm_block(tp, torch.from_numpy(x[:, 17:]), tcfg, h0=th,
                          conv_init=tail)
    for r, g in zip(want, got):
        assert _err(r, g) < 1e-5
    whole, h_all, _ = t_ssm.ssm_block(tp, torch.from_numpy(x), tcfg)
    assert _err(whole[:, 17:], got[0]) < 1e-5 and _err(h_all, got[1]) < 1e-5


def test_init_cache_matches_reference():
    from repro.models import transformer as ref_tf
    from repro_torch.models import transformer as t_tf
    for arch, extra in (("hymba_1_5b", {"sliding_window": 16}),
                        ("llama3_2_1b", {}), ("falcon_mamba_7b", {})):
        rcfg, tcfg = _cfgs(arch, **extra)
        want = ref_tf.init_cache(rcfg, 3, 24)
        got = t_tf.init_cache(tcfg, 3, 24, "cpu")
        assert set(want) == set(got)
        for name in want:
            assert np.array_equal(_np(want[name]), _np(got[name])), name
            assert str(got[name].dtype) == f"torch.{jnp.asarray(want[name]).dtype}"
    with pytest.raises(NotImplementedError, match="prefill"):
        build(_cfgs("seamless_m4t_medium")[1], device="cpu").init_cache(2, 8)
    # KV heads replicated up to the TP degree where that divides cleanly
    for arch in ARCH_IDS:
        rcfg, tcfg = ref_configs.get_config(arch), t_configs.get_config(arch)
        for tp in (1, 2, 4, 8, 16, 3):
            assert t_tf.kv_eff_heads(tcfg, tp=tp) == \
                ref_tf.kv_eff_heads(rcfg, tp), (arch, tp)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "seamless_m4t_medium"])
def test_init_cache_and_prefill_take_tp(arch):
    """``tp=1`` (the reference's keyword) gives what the call without it
    gives; ``tp=2`` gives the reference's caches, KV heads replicated up to
    the TP degree where that divides cleanly (llama's reduced kv = 2 stays
    2)."""
    rb, params, tb, tp = _models(arch, dtype="float32")
    batch = _batch(tb.cfg, np.random.default_rng(4), b=2, s=12)
    (l1, c1), (l0, c0) = (tb.prefill(tp, batch, max_len=16, tp=1),
                          tb.prefill(tp, batch, max_len=16))
    assert torch.equal(l1, l0) and set(c1) == set(c0)
    assert all(torch.equal(c1[k], c0[k]) for k in c0)
    rl, rc = rb.prefill(params, batch, tp=2, max_len=16)
    l2, c2 = tb.prefill(tp, batch, max_len=16, tp=2)
    assert _err(rl, l2) < 1e-4 and set(rc) == set(c2)
    for k in rc:
        assert tuple(c2[k].shape) == tuple(np.shape(rc[k])), k
        assert _err(rc[k], c2[k]) < 1e-4, k
    if tb.cfg.is_encdec:
        with pytest.raises(NotImplementedError, match="prefill"):
            tb.init_cache(2, 16, tp=1)
        return
    ones, none = tb.init_cache(2, 16, tp=1), tb.init_cache(2, 16)
    assert set(ones) == set(none)
    assert all(torch.equal(ones[k], none[k]) for k in none)
    want = rb.init_cache(2, 16, tp=1)
    assert all(np.array_equal(_np(want[k]), _np(ones[k])) for k in want)
    want2, got2 = rb.init_cache(2, 16, tp=2), tb.init_cache(2, 16, tp=2)
    assert all(np.array_equal(_np(want2[k]), _np(got2[k])) for k in want2)


def test_causal_conv_and_ssm_decode_step_match_reference():
    rng = np.random.default_rng(11)
    x, w, b = _rand(rng, 2, 9, 12), _rand(rng, 4, 12), _rand(rng, 12)
    assert _err(ref_ssm._causal_conv(*map(jnp.asarray, (x, w, b))),
                t_ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))) < 1e-5
    rcfg, tcfg = _cfgs("falcon_mamba_7b", dtype="float32")
    rp = ref_ssm.init_ssm(jax.random.PRNGKey(1), rcfg, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    xt = _rand(rng, 2, tcfg.d_model)
    h = _rand(rng, 2, tcfg.d_inner, tcfg.ssm_state)
    conv = _rand(rng, 2, tcfg.ssm_conv - 1, tcfg.d_inner)
    want = ref_ssm.ssm_decode_step(rp, *map(jnp.asarray, (xt, h, conv)), rcfg)
    got = t_ssm.ssm_decode_step(tp, *map(torch.from_numpy, (xt, h, conv)),
                                tcfg)
    for r, g in zip(want, got):
        assert _err(r, g) < 1e-5
