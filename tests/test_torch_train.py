"""The port's LM training side against the JAX package's, on the CPU.

Every case of ``tests/test_train.py`` on the port, and the port against
``repro.train`` on the same inputs: the reference's weights carried across
by ``convert.lm_params_from_jax``, the same seeded numpy batches and
gradients.  Tolerances (float32 throughout):

  * the schedule: 1e-6 relative at every step of a 0..total sweep (both
    compute in float32; ``cos`` may differ by an ulp);
  * ``global_norm``, clipping and one ``adamw_update`` fed the same numpy
    gradients: 1e-6 (observed <= 1e-7: the sum of squares runs in another
    order);
  * ``loss_fn`` gradients, one reduced arch a family at d_model 64: each
    leaf within 1e-5 + 1e-4 x its largest |gradient| (observed <= 2e-6
    absolute: sums in other orders, the SSM scan's pairs combined in
    another order);
  * 5 ``make_train_step`` steps (plain, ``microbatches=2``,
    ``grad_compression="bf16"``): losses within 1e-5, parameters after
    within 5e-5 (observed <= 1e-6 and <= 7e-6).
"""

import dataclasses
import itertools
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro.train import optimizer as ref_opt
from repro.train.train_loop import make_train_step as ref_make_train_step
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.data.loader import PrefetchIterator, deduped_token_batches
from repro_torch.data.synthetic import token_batches
from repro_torch.models import build
from repro_torch.models import layers as t_layers
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (adamw_update, global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.train_loop import (StragglerMonitor, TrainLoop,
                                          loss_and_grads, make_train_step)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are tiny, and the suite runs
    its files in parallel processes, where a thread pool a process
    oversubscribes the cores (measured: 10x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**changes):
    cfg = dataclasses.replace(
        t_configs.reduced(t_configs.get_config("llama3_2_1b"), d_model=64,
                          vocab=256), **changes)
    return cfg, build(cfg, device="cpu")


def _both(arch="llama3_2_1b", seed=0, **changes):
    """(reference bundle, its params, port bundle, the same params), reduced
    to d_model 64."""
    rcfg = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch), d_model=64),
        **changes)
    tcfg = dataclasses.replace(
        t_configs.reduced(t_configs.get_config(arch), d_model=64), **changes)
    rb = ref_build(rcfg)
    params = rb.init(jax.random.PRNGKey(seed))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    "cpu")
    return rb, params, build(tcfg, device="cpu"), tp


def _max_err(ref_tree, port_tree) -> float:
    """Largest |difference| over the leaves of the reference's pytree and
    the port's ``ParamTree`` (or its host form)."""
    got = (convert.lm_params_to_numpy(port_tree)
           if isinstance(port_tree, torch.nn.Module) else port_tree)
    return max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a, np.float64) - b).max()),
        ref_tree, got)))


def _grad_tree(params, grads: list):
    """Gradients in ``params.parameters()`` order as a tree like params."""
    by_name = dict(zip((n for n, _ in params.named_parameters()), grads))
    return params.map(lambda n, _: by_name[n])


# -- the schedule, the norm, clipping, one update ----------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (5, 5)])
def test_lr_schedule_matches_reference_every_step(warmup, total):
    kw = dict(learning_rate=1e-3, warmup_steps=warmup, total_steps=total)
    tc, rtc = TrainConfig(**kw), RefTrainConfig(**kw)
    for s in range(total + 1):
        got = lr_schedule(torch.tensor(s, dtype=torch.int32), tc)
        want = float(ref_opt.lr_schedule(jnp.asarray(s, jnp.int32), rtc))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), s


def test_lr_schedule_shape():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(torch.tensor(s), tc)) for s in (0, 5, 10, 55,
                                                            100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.01)  # 10% floor


def test_global_norm():
    t = {"a": torch.ones(3) * 2.0, "b": torch.zeros(4)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(12.0))
    rng = np.random.default_rng(0)
    arrays = {"x": rng.normal(size=(7, 5)).astype(np.float32),
              "y": {"z": rng.normal(size=(300,)).astype(np.float32)}}
    want = float(ref_opt.global_norm(jax.tree.map(jnp.asarray, arrays)))
    got = float(global_norm(jax.tree.map(torch.from_numpy, arrays)))
    assert got == pytest.approx(want, rel=1e-6)


def _update_case(seed, scale, **tc_kw):
    """One ``adamw_update`` on both sides from the reference's weights, the
    same numpy gradients (x ``scale``) and moments one step in."""
    rb, params, tb, tp = _both(dtype="float32")
    rng = np.random.default_rng(seed)
    grads_np = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
        jax.tree.map(np.asarray, params))
    tc_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, **tc_kw)
    rtc, tc = RefTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    ropt = ref_opt.init_opt_state(params)
    topt = init_opt_state(tp)
    grads_t = list(convert.lm_params_from_jax(grads_np, tb.cfg,
                                              "cpu").parameters())
    ref_update = jax.jit(lambda p, g, s: ref_opt.adamw_update(p, g, s, rtc))
    for _ in range(2):     # the second step runs on non-zero moments
        params, ropt, rstats = ref_update(
            params, jax.tree.map(jnp.asarray, grads_np), ropt)
        tp, topt, tstats = adamw_update(tp, grads_t, topt, tc)
    return params, ropt, rstats, tp, topt, tstats


@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (0.0, 0.0), (1e3, 0.1)])
def test_adamw_update_matches_reference(clip, decay):
    params, ropt, rstats, tp, topt, tstats = _update_case(
        1, 0.01, grad_clip=clip, weight_decay=decay)
    assert int(topt.step) == int(ropt.step) == 2
    assert topt.step.dtype == torch.int32 and topt.step.shape == ()
    assert _max_err(params, tp) < 1e-6
    assert _max_err(ropt.mu, topt.mu) < 1e-6
    assert _max_err(ropt.nu, topt.nu) < 1e-6
    for k in ("lr", "grad_norm"):
        assert float(tstats[k]) == pytest.approx(float(rstats[k]), rel=1e-6)
    for tree in (topt.mu, topt.nu):
        assert all(m.dtype == torch.float32 for m in tree.parameters())


def test_grad_clip():
    """Gradients of 100: the pre-clip norm is reported (the reference's
    case), and the clipped update equals the reference's."""
    cfg, bundle = _tiny()
    params = bundle.init(0)
    grads = [torch.ones_like(p) * 100 for p in params.parameters()]
    _, _, stats = adamw_update(params, grads, init_opt_state(params),
                               TrainConfig(grad_clip=1.0))
    assert float(stats["grad_norm"]) > 1.0
    params, ropt, rstats, tp, topt, tstats = _update_case(2, 100.0,
                                                          grad_clip=1.0)
    assert float(tstats["grad_norm"]) == pytest.approx(
        float(rstats["grad_norm"]), rel=1e-6)
    assert _max_err(params, tp) < 1e-6


def test_adamw_updates_in_place_and_builds_no_graph():
    cfg, bundle = _tiny()
    params = bundle.init(0)
    opt = init_opt_state(params)
    before = [p.clone() for p in params.parameters()]
    ids = [id(p) for p in params.parameters()]
    grads = [torch.full_like(p, 0.5) for p in params.parameters()]
    out, opt2, _ = adamw_update(params, grads, opt, TrainConfig())
    assert out is params and opt2.mu is opt.mu and opt2.nu is opt.nu
    assert [id(p) for p in out.parameters()] == ids
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     out.parameters()))
    assert not any(p.requires_grad for p in out.parameters())


# -- gradients against jax.grad ------------------------------------------------

FAMILY_ARCH = {"dense": "llama3_2_1b", "moe": "qwen3_moe_30b_a3b",
               "ssm": "falcon_mamba_7b", "hybrid": "hymba_1_5b",
               "vlm": "pixtral_12b", "encdec": "seamless_m4t_medium"}


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_loss_grads_match_reference(family):
    rb, params, tb, tp = _both(FAMILY_ARCH[family], dtype="float32")
    cfg = tb.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (2, 40))
             .astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(2, 5, 64)).astype(np.float32)
    if cfg.frontend == "frames":
        batch["frames"] = rng.normal(size=(2, 40, 64)).astype(np.float32)
    assert cfg.remat == "block"
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rb.loss_fn(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(params)
    loss, metrics, grads = loss_and_grads(tb, tp, batch)
    assert float(loss) == pytest.approx(float(rloss), abs=1e-5)
    assert set(metrics) == {"ce", "aux"}
    assert not any(p.requires_grad for p in tp.parameters())
    got = convert.lm_params_to_numpy(_grad_tree(tp, grads))
    assert jax.tree.structure(got) == jax.tree.structure(rgrads)
    for (path, want), have in zip(
            jax.tree_util.tree_flatten_with_path(rgrads)[0],
            jax.tree.leaves(got)):
        want = np.asarray(want)
        assert have.shape == want.shape, path
        tol = 1e-5 + 1e-4 * float(np.abs(want).max())
        assert float(np.abs(have - want).max()) < tol, path


def test_remat_changes_no_gradient():
    """``remat="block"`` recomputes each block in the backward pass and
    gives the gradients of ``remat="none"`` exactly; under ``no_grad``
    (serving) it is not applied."""
    for arch in ("llama3_2_1b", "seamless_m4t_medium"):
        cfg = dataclasses.replace(
            t_configs.reduced(t_configs.get_config(arch), d_model=64),
            dtype="float32")
        params = build(cfg, device="cpu").init(0)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (2, 24))
                 .astype(np.int32)}
        if cfg.frontend == "frames":
            batch["frames"] = rng.normal(size=(2, 24, 64)).astype(np.float32)
        outs = [loss_and_grads(build(dataclasses.replace(cfg, remat=r),
                                     device="cpu"), params, batch)
                for r in ("block", "none")]
        assert torch.equal(outs[0][0], outs[1][0])
        for a, b in zip(outs[0][2], outs[1][2]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_fused_qkv_grad_matches_reference_bwd(fused):
    """Autograd through the port's one fused product (or the three
    unfused) against the reference's ``_qkv_fused_bwd`` on the same
    cotangents."""
    cfg = dataclasses.replace(
        t_configs.reduced(t_configs.get_config("llama3_2_1b"), d_model=64),
        dtype="float32", fused_qkv=fused)
    rng = np.random.default_rng(3)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    w = {"wq": rng.normal(size=(d, h, hd)), "wk": rng.normal(size=(d, kv, hd)),
         "wv": rng.normal(size=(d, kv, hd))}
    w = {k: (v * d ** -0.5).astype(np.float32) for k, v in w.items()}
    cts = [rng.normal(size=(2, 9, n, hd)).astype(np.float32)
           for n in (h, kv, kv)]
    want = ref_layers._qkv_fused_bwd(
        (jnp.asarray(x), *(jnp.asarray(w[k]) for k in ("wq", "wk", "wv"))),
        tuple(jnp.asarray(c) for c in cts))
    tx = torch.tensor(x, requires_grad=True)
    tw = t_layers.ParamTree({k: torch.tensor(v) for k, v in w.items()})
    for p in tw.parameters():
        p.requires_grad_(True)
    outs = t_layers.qkv_project(tw, tx, cfg)
    got = torch.autograd.grad(
        outs, [tx, tw["wq"], tw["wk"], tw["wv"]],
        grad_outputs=[torch.tensor(c) for c in cts])
    for g, r in zip(got, want):
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) < 1e-5


# -- the train step ------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"microbatches": 2},
                                {"grad_compression": "bf16"}],
                         ids=["plain", "microbatches2", "bf16"])
def test_train_steps_match_reference(kw):
    """5 steps from the reference's weights on the same batches: the same
    losses, lr and grad norms, and the same parameters after."""
    rb, params, tb, tp = _both(dtype="float32")
    common = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5, **kw)
    rstep = jax.jit(ref_make_train_step(rb, RefTrainConfig(**common)))
    tstep = make_train_step(tb, TrainConfig(**common))
    ropt, topt = ref_opt.init_opt_state(params), init_opt_state(tp)
    data = token_batches(tb.cfg.vocab_size_real, 4, 32, seed=3)
    for _ in range(5):
        batch = next(data)
        params, ropt, rm = rstep(params, ropt, jax.tree.map(jnp.asarray,
                                                            batch))
        tp, topt, tm = tstep(tp, topt, batch)
        assert set(tm) == set(rm)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  abs=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    assert _max_err(params, tp) < 5e-5
    assert int(topt.step) == 5


def test_adamw_decreases_loss():
    cfg, bundle = _tiny()
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=30,
                     weight_decay=0.0)
    params = bundle.init(0)
    opt = init_opt_state(params)
    batch = next(token_batches(cfg.vocab_size_real, 8, 32, seed=0))
    step = make_train_step(bundle, tc)
    losses = []
    for _ in range(30):                          # overfit one batch
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_microbatch_equals_full_batch():
    """Gradient accumulation matches the single-batch gradient step."""
    cfg, bundle = _tiny(dtype="float32")
    params = bundle.init(0)
    batch = next(token_batches(cfg.vocab_size_real, 8, 32, seed=1))
    out = []
    for n in (1, 4):
        p = params.map(lambda _, x: x.clone())
        tc = TrainConfig(microbatches=n, learning_rate=1e-3, warmup_steps=0)
        out.append(make_train_step(bundle, tc)(p, init_opt_state(p),
                                               batch)[0])
    diff = max(float((a - b).abs().max()) for a, b in
               zip(out[0].parameters(), out[1].parameters()))
    assert diff < 2e-5, diff
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(bundle, TrainConfig(microbatches=3))(
            params, init_opt_state(params), batch)


def test_mesh_step_on_one_rank_is_the_plain_step():
    """A (1,1) mesh of this process alone: nothing shards, and the mesh step
    (``jit_train_step``, the host batch placed by its layout) gives the
    reference's single-device step, as the plain step does."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_loop import init_train_state, jit_train_step
    rb, tree, tb, params = _both(dtype="float32")
    tree = jax.tree.map(np.asarray, tree)
    batch = next(token_batches(tb.cfg.vocab_size_real, 4, 16, seed=3))
    rp, _, rm = jax.jit(ref_make_train_step(rb, RefTrainConfig(
        warmup_steps=0, learning_rate=1e-3)))(tree, ref_opt.init_opt_state(
            tree), batch)
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3)
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        p, o = init_train_state(params, tc, mesh)
        p, o, m = jit_train_step(tb, tc, mesh)(p, o, batch)
    finally:
        dist.destroy_process_group()
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), abs=1e-5)
    assert _max_err(rp, p) < 5e-5


# -- the loop ------------------------------------------------------------------

def test_train_loop_restart_resumes(tmp_path):
    cfg, bundle = _tiny()
    tc = TrainConfig(total_steps=6, checkpoint_every=2, warmup_steps=2)
    data = PrefetchIterator(token_batches(cfg.vocab_size_real, 4, 32))
    out = TrainLoop(bundle, tc, data, str(tmp_path), log=lambda *_: None).run()
    assert len(out["losses"]) == 6
    # second run restores the final step and trains 0 steps
    data2 = PrefetchIterator(token_batches(cfg.vocab_size_real, 4, 32))
    out2 = TrainLoop(bundle, tc, data2, str(tmp_path),
                     log=lambda *_: None).run()
    assert len(out2["losses"]) == 0
    assert int(out2["opt"].step) == 6


def test_stopped_loop_resumes_with_an_uninterrupted_runs_losses(tmp_path):
    """SIGTERM while the 4th batch is fetched: the step runs, the loop saves
    at the next boundary and returns; a new loop restores that step and
    its losses continue an uninterrupted run's exactly.  The previous
    signal handler is back after each run."""
    cfg, bundle = _tiny(dtype="float32")
    tc = TrainConfig(total_steps=7, checkpoint_every=3, keep_checkpoints=1,
                     warmup_steps=2)
    batches = list(itertools.islice(
        token_batches(cfg.vocab_size_real, 4, 32, seed=5), 7))
    whole = TrainLoop(bundle, tc, iter(batches), str(tmp_path / "a"),
                      log=lambda *_: None).run()

    def signalling():
        for i, b in enumerate(batches):
            if i == 3:
                # the loop's handler, never the default (which would kill)
                assert signal.getsignal(signal.SIGTERM) not in (
                    before, signal.SIG_DFL, signal.SIG_IGN, None)
                signal.raise_signal(signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    logs = []
    first = TrainLoop(bundle, tc, signalling(), str(tmp_path / "b"),
                      log=logs.append).run()
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(first["losses"]) == 4
    assert any("preemption signal at step 4" in m for m in logs)
    assert ckpt.committed_steps(str(tmp_path / "b")) == [4]
    start = ckpt.latest_step(str(tmp_path / "b"))
    second = TrainLoop(bundle, tc, iter(batches[start:]),
                       str(tmp_path / "b"), log=logs.append).run()
    assert any("restored step 4" in m for m in logs)
    assert first["losses"] + second["losses"] == whole["losses"]
    for a, b in zip(whole["params"].parameters(),
                    second["params"].parameters()):
        assert torch.equal(a, b)
    assert ckpt.committed_steps(str(tmp_path / "b")) == [7]


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor()
    assert [m.observe(dt) for dt in (1.0, 1.0, 5.0, 1.0)] == \
        [False, False, True, False]
    assert m.flagged == 1


def test_deduped_loader_respects_keep():
    docs = [np.full(16, i, np.int32) for i in range(10)]
    keep = np.asarray([0, 2, 4])
    it = deduped_token_batches(docs, keep, batch=2, seq=8, vocab=100, seed=0)
    batch = next(it)
    assert set(np.unique(batch["tokens"])).issubset({0, 2, 4})


def test_serving_builds_no_graph_after_a_train_step():
    cfg, bundle = _tiny()
    params = bundle.init(0)
    batch = next(token_batches(cfg.vocab_size_real, 2, 16))
    make_train_step(bundle, TrainConfig())(params, init_opt_state(params),
                                           batch)
    assert not any(p.requires_grad for p in params.parameters())
    with torch.enable_grad():
        loss, _ = bundle.loss_fn(params, batch)
    assert not loss.requires_grad
    assert not bundle.forward(params, batch).requires_grad
